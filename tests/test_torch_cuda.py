"""The port's CUDA kernels (decode and flash attention) on a card, held
against their plain torch versions. Every test here is marked ``cuda`` and skips without a
card; the file imports neither JAX nor ``horovod_tpu``, so on a machine
with a card and no JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import bert, llama, moe_lm
from horovod_tpu_torch.models.resnet import ResNetTiny
from horovod_tpu_torch.ops import attention as flash
from horovod_tpu_torch.ops import decode_attention as ops

# float32: only the reduction order differs from the plain version.
F32_TOL = dict(atol=2e-5, rtol=1e-4)
# bfloat16: the output is rounded to bf16 (one ulp = 2^-8 relative), and
# p is rounded to bf16 against a running max (kernel) or the final max
# (plain version), so the two may land one ulp apart on either rounding.
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
# bfloat16 flash outputs are mostly far below BF16_TOL's atol, so each is
# held to its own scale: within 2e-2 of (|want| + rms(want)) elementwise.
FLASH_BF16_REL = 2e-2


def _assert_flash_close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32_TOL)
        return
    rms = float(want.pow(2).mean().sqrt())
    torch.testing.assert_close(got, want, rtol=FLASH_BF16_REL,
                               atol=FLASH_BF16_REL * rms)


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _randn(gen, device, dtype, *shape):
    return (torch.randn(*shape, generator=gen, device=device)
            * 0.5).to(dtype)


def _pools(k, v, tables, block_size):
    """Scatter logical windows (B, L, F) into a pool through ``tables``;
    the null block 0 holds garbage that must never reach a sum."""
    b, window, f = k.shape
    n_phys = tables.numel()
    kp = torch.full((n_phys + 1, block_size, f), 9.0, dtype=k.dtype,
                    device=k.device)
    vp = torch.full_like(kp, -9.0)
    kp[tables.view(-1).long()] = k.view(-1, block_size, f)
    vp[tables.view(-1).long()] = v.view(-1, block_size, f)
    return kp, vp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,hkv,d", [
    (16, 8, 64), (32, 8, 128), (8, 1, 64),
    # The widened operand range: Llama-tiny's heads (D=16), D=32, and
    # group 16 at D=64 and D=128 (the merge buffer in the cp.async ring);
    # D=256 (two 16-byte pieces a lane in float32), at group 2 and 16; and
    # groups no block width equals (3: one head a block; 6: two; 12: four).
    (4, 2, 16), (4, 4, 32), (16, 1, 64), (32, 2, 128), (8, 4, 256),
    (16, 1, 256), (3, 1, 64), (12, 2, 16), (24, 2, 128)])
def test_kernels_match_plain(cuda_device, dtype, h, hkv, d):
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, window, bs = 4, 192, 16
    q = _randn(gen, cuda_device, dtype, b, 1, h, d)
    k = _randn(gen, cuda_device, dtype, b, window, hkv * d)
    v = _randn(gen, cuda_device, dtype, b, window, hkv * d)
    for idx in (0, 77, window - 1):
        before = ops.LAUNCHES["decode_attention"]
        got = ops.decode_attention(q, k, v, idx, hkv)
        want = ops.decode_attention_plain(q, k, v, idx, hkv)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["decode_attention"] == before + 1
        torch.testing.assert_close(got.float(), want.float(), **tol)
    slots = window // bs
    tables = (torch.randperm(b * slots, generator=gen, device=cuda_device)
              + 1).view(b, slots).to(torch.int32)
    kp, vp = _pools(k, v, tables, bs)
    lens = torch.tensor([0, 15, 100, window - 1], dtype=torch.int32,
                        device=cuda_device)
    got = ops.paged_decode_attention(q, kp, vp, tables, lens, hkv)
    want = ops.paged_decode_attention_plain(q, kp, vp, tables, lens, hkv)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    ident = (torch.arange(b * slots, device=cuda_device) + 1).view(
        b, slots).to(torch.int32)
    kp_i, vp_i = _pools(k, v, ident, bs)
    assert torch.equal(
        got, ops.paged_decode_attention(q, kp_i, vp_i, ident, lens, hkv))

    # A window of several chunks that is no multiple of the chunk, with
    # bounds on and around the chunk edges.
    c = ops.DECODE_CHUNK
    window = 2 * c + 80
    assert ops.decode_plan(b, h, d, window).chunks == 3
    k = _randn(gen, cuda_device, dtype, b, window, hkv * d)
    v = _randn(gen, cuda_device, dtype, b, window, hkv * d)
    for idx in (c - 1, c, c + 1, window - 1):
        got = ops.decode_attention(q, k, v, idx, hkv)
        want = ops.decode_attention_plain(q, k, v, idx, hkv)
        torch.testing.assert_close(got.float(), want.float(), **tol)
    slots = window // bs
    tables = (torch.randperm(b * slots, generator=gen, device=cuda_device)
              + 1).view(b, slots).to(torch.int32)
    kp, vp = _pools(k, v, tables, bs)
    lens = torch.tensor([c - 1, c, c + 1, window - 1], dtype=torch.int32,
                        device=cuda_device)
    got = ops.paged_decode_attention(q, kp, vp, tables, lens, hkv)
    want = ops.paged_decode_attention_plain(q, kp, vp, tables, lens, hkv)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_same_rows_give_the_same_output_at_two_windows(cuda_device, dtype):
    """Chunks start at fixed logical positions, so the same rows in a
    wider cache or block table (more chunks) give the same bits, and a
    window of one chunk (no combine pass) gives the bits of a wider one."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    c, bs = ops.DECODE_CHUNK, 16
    b, h, hkv, d = 4, 16, 2, 128
    bounds = [0, c // 2, c - 1, c + 17]
    q = _randn(gen, cuda_device, dtype, b, 1, h, d)
    k = _randn(gen, cuda_device, dtype, b, 4 * c, hkv * d)
    v = _randn(gen, cuda_device, dtype, b, 4 * c, hkv * d)
    for idx in bounds:
        wide = ops.decode_attention(q, k, v, idx, hkv)
        for window in (2 * c, c + 32, c):
            if idx < window:
                narrow = ops.decode_attention(
                    q, k[:, :window].contiguous(), v[:, :window].contiguous(),
                    idx, hkv)
                assert torch.equal(narrow, wide), (idx, window)
    slots = 4 * c // bs
    tables = (torch.randperm(b * slots, generator=gen, device=cuda_device)
              + 1).view(b, slots).to(torch.int32)
    kp, vp = _pools(k, v, tables, bs)
    lens = torch.tensor(bounds, dtype=torch.int32, device=cuda_device)
    wide = ops.paged_decode_attention(q, kp, vp, tables, lens, hkv)
    for window in (2 * c, c):
        narrow = ops.paged_decode_attention(
            q, kp, vp, tables[:, :window // bs].contiguous(), lens, hkv)
        held = [i for i, n in enumerate(bounds) if n < window]
        assert torch.equal(narrow[held], wide[held]), window


@pytest.mark.cuda
def test_paged_single_block_bitwise_matches_contiguous(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    b, h, hkv, d, bs = 3, 16, 8, 64, 64
    q = _randn(gen, cuda_device, torch.float32, b, 1, h, d)
    k = _randn(gen, cuda_device, torch.float32, b, bs, hkv * d)
    v = _randn(gen, cuda_device, torch.float32, b, bs, hkv * d)
    tables = torch.tensor([[2], [3], [1]], dtype=torch.int32,
                          device=cuda_device)
    kp, vp = _pools(k, v, tables, bs)
    lens = [5, 40, 63]
    out = ops.paged_decode_attention(
        q, kp, vp, tables,
        torch.tensor(lens, dtype=torch.int32, device=cuda_device), hkv)
    for i in range(b):
        contig = ops.decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                      lens[i], hkv)
        assert torch.equal(out[i], contig[0]), f"seq {i}"


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernel_cannot_take(cuda_device):
    q = torch.zeros((1, 1, 4, 24), device=cuda_device)      # D=24
    k = torch.zeros((1, 8, 2 * 24), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q, k, k, 3, 2)
    q = torch.zeros((1, 1, 3, 288), device=cuda_device)     # D=288
    k = torch.zeros((1, 8, 288), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q, k, k, 3, 1)
    q = torch.zeros((1, 1, 4, 64), dtype=torch.float16, device=cuda_device)
    k = torch.zeros((1, 8, 2 * 64), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.decode_attention(q, k, k, 3, 2)
    with pytest.raises(ValueError, match="one device"):
        ops.decode_attention(q.float(), k.float().cpu(), k.float().cpu(), 3,
                             2)


@pytest.mark.cuda
def test_generate_through_the_kernel_equals_einsum_path(cuda_device):
    cfg = dataclasses.replace(llama.LLAMA_TINY, dim=256, num_heads=4,
                              num_kv_heads=2, ffn_hidden=512,
                              dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = llama.LlamaLM(cfg, seed=0)
    assert model.device.type == "cuda"
    prompt = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 9)))
    ops.reset_launch_counts()
    tokens = llama.generate(model, prompt, max_new_tokens=6)
    assert ops.LAUNCHES["decode_attention"] == cfg.num_layers * 5
    with llama.decode_kernel_disabled():
        einsum = llama.generate(model, prompt, max_new_tokens=6)
    assert torch.equal(tokens, einsum)


@pytest.mark.cuda
def test_generate_at_llama_tiny_runs_the_kernel(cuda_device):
    """LLAMA_TINY's heads are 16 wide: the decode kernel takes them and
    gives the einsum path's tokens."""
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = llama.LlamaLM(cfg, seed=0)
    prompt = torch.from_numpy(
        np.random.RandomState(1).randint(0, cfg.vocab_size, (3, 11)))
    ops.reset_launch_counts()
    tokens = llama.generate(model, prompt, max_new_tokens=9)
    assert ops.LAUNCHES["decode_attention"] == cfg.num_layers * 8
    with llama.decode_kernel_disabled():
        einsum = llama.generate(model, prompt, max_new_tokens=9)
    assert torch.equal(tokens, einsum)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,sq,sk,h,hkv,d,causal,masked",
    [(2, 128, 128, 16, 8, 64, True, False),
     (2, 197, 197, 4, 2, 64, False, True),      # awkward length, key mask
     (1, 64, 300, 8, 1, 128, True, False),      # causal, sq < sk
     (2, 96, 40, 4, 4, 64, True, True),         # sq > sk: dead rows
     # The TMA kernels' edges: tiles of 128 keys (64-row query tiles in
     # dk/dv) whose boxes run past S must read zeros, never the next
     # sequence's rows; a diagonal offset that is no multiple of a tile puts
     # two tiles on the diagonal.
     (3, 197, 197, 8, 4, 64, True, False),      # b=3, Sk % 128 != 0
     (2, 100, 261, 4, 2, 64, True, False),      # sq < sk, offset 161
     (2, 300, 133, 4, 1, 128, True, False),     # sq > sk, offset -167
     (3, 197, 261, 16, 2, 128, True, True),     # group 8, D=128, key mask
     (2, 70, 1, 4, 2, 64, False, False),        # a single key
     # BERT-base and ViT-B/16 heads: group 1, non-causal.
     (4, 512, 512, 12, 12, 64, False, True),
     (2, 197, 197, 12, 12, 64, False, False),
     # The widened operand range (D zero-padded to 64, K/V repeated):
     # Llama-tiny's D=16, BERT-tiny's D=32 with a key mask, group 16, and
     # group 3 at D=16.
     (2, 96, 96, 4, 2, 16, True, False),
     (2, 77, 77, 2, 2, 32, False, True),
     (1, 200, 200, 16, 1, 64, True, False),
     (2, 50, 70, 6, 2, 16, True, True),
     # head_dim 192 (padded to 256) and 256: the FMA family, 32 rows a
     # block, both types.
     (2, 96, 96, 4, 2, 192, True, False),
     (2, 77, 100, 4, 1, 256, True, True),
     (1, 130, 130, 2, 2, 256, False, False)])
def test_flash_kernels_match_plain(cuda_device, dtype, b, sq, sk, h, hkv, d,
                                   causal, masked):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q = _randn(gen, cuda_device, dtype, b, sq, h, d)
    k = _randn(gen, cuda_device, dtype, b, sk, hkv, d)
    v = _randn(gen, cuda_device, dtype, b, sk, hkv, d)
    g = _randn(gen, cuda_device, dtype, b, sq, h, d)
    mask = None
    if masked:
        mask = torch.rand(b, sk, generator=gen, device=cuda_device) > 0.3
        # Under causal, query row 0 of batch 0 then has no allowed key.
        mask[0, :max(sk - sq, 0) + 1] = False
    flash.reset_launch_counts()
    out, lse = flash._flash_forward(q, k, v, mask, causal)
    want_out, want_lse = flash.flash_attention_forward_plain(q, k, v, mask,
                                                             causal)
    delta = flash.flash_delta(want_out, g)
    dq = flash.flash_backward_dq(q, k, v, mask, g, want_lse, delta, causal)
    dk, dv = flash.flash_backward_dkdv(q, k, v, mask, g, want_lse, delta,
                                       causal)
    torch.cuda.synchronize()
    assert flash.LAUNCHES == {"flash_forward": 1, "flash_backward_dq": 1,
                              "flash_backward_dkdv": 1}
    _assert_flash_close(out, want_out, dtype)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    if masked and causal:
        assert not bool(out[0, 0].ne(0).any())
        assert float(lse[0, 0, 0]) <= -1e29
    want_dq = flash.flash_backward_dq_plain(q, k, v, mask, g, want_lse,
                                            delta, causal)
    want_dk, want_dv = flash.flash_backward_dkdv_plain(
        q, k, v, mask, g, want_lse, delta, causal)
    if sk == 1:
        # One key: p = 1 and ds = dp - delta = 0, so the exact dq and dk are
        # 0 and both sides are f32 rounding noise, held at F32_TOL's atol.
        for t in (dq, want_dq, dk, want_dk):
            torch.testing.assert_close(t.float(), torch.zeros_like(t.float()),
                                       atol=F32_TOL["atol"], rtol=0)
        _assert_flash_close(dv, want_dv, dtype)
    else:
        for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
            _assert_flash_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("sk", [1, 63, 64, 65, 197, 512])
def test_flash_mask_words_kernel_matches_plain(cuda_device, sk):
    gen = torch.Generator(device=cuda_device).manual_seed(sk)
    mask = torch.rand(5, sk, generator=gen, device=cuda_device) > 0.4
    mask[1] = True
    mask[2] = False
    flash.reset_launch_counts()
    for m in (mask, mask.to(torch.uint8)):
        words = flash.flash_mask_words(m)
        torch.cuda.synchronize()
        assert torch.equal(words, flash.mask_words_plain(m))
    assert flash.MASK_LAUNCHES == {"flash_mask_words": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_never_reads_fully_masked_key_tiles(cuda_device, causal):
    """bf16 (the TMA kernels): NaN in K and V at every key of a 128-key
    tile the mask wholly leaves out reaches no output, and dk, dv are 0
    at the masked keys."""
    b, s, h, hkv, d = 3, 640, 4, 2, 64
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, g = (_randn(gen, cuda_device, torch.bfloat16, b, s, n, d)
                  for n in (h, hkv, hkv, h))
    mask = torch.ones(b, s, dtype=torch.bool, device=cuda_device)
    mask[0, 128:384] = False           # two forward tiles
    mask[1, 300:] = False              # padding: tiles 3 and 4 out
    mask[2] = False                    # a fully padded sequence
    out, lse = flash.flash_attention_forward_plain(q, k, v, mask, causal)
    delta = flash.flash_delta(out, g)

    def run(k_, v_):
        o, l_ = flash._flash_forward(q, k_, v_, mask, causal)
        return (o, l_,
                flash.flash_backward_dq(q, k_, v_, mask, g, lse, delta,
                                        causal),
                *flash.flash_backward_dkdv(q, k_, v_, mask, g, lse, delta,
                                           causal))

    clean = run(k, v)
    skipped = torch.zeros_like(mask)
    skipped[0, 128:384] = True
    skipped[1, 384:] = True
    skipped[2] = True
    nan = (k.masked_fill(skipped[:, :, None, None], float("nan")),
           v.masked_fill(skipped[:, :, None, None], float("nan")))
    dirty = run(*nan)
    torch.cuda.synchronize()
    for a, b_ in zip(clean[:3], dirty[:3]):
        assert torch.equal(a, b_)
    for a, b_ in zip(clean[3:], dirty[3:]):
        assert torch.equal(a[mask], b_[mask])
        assert not bool(b_[~mask].ne(0).any())
    _assert_flash_close(clean[0], out, torch.bfloat16)


@pytest.mark.cuda
def test_flash_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    q = torch.zeros((1, 8, 4, 288), device=cuda_device)      # D=288
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 8, 4, 64), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash.flash_attention(q, q[:, :, :2].contiguous(),
                              q[:, :, :2].contiguous())


@pytest.mark.cuda
def test_training_step_runs_the_flash_kernels_per_layer(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(llama.LLAMA_TINY, dim=256, num_heads=4,
                              num_kv_heads=2, ffn_hidden=512,
                              dtype=torch.float32)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 64))).to(cuda_device)
    grads = []
    for use_flash in (True, False):
        model = llama.LlamaLM(
            cfg, seed=0, param_dtype=torch.float32,
            attention_fn=flash.make_attention_fn(causal=True,
                                                 use_flash=use_flash))
        flash.reset_launch_counts()
        loss = llama.causal_lm_loss(model(ids), ids)
        loss.backward()
        torch.cuda.synchronize()
        want = cfg.num_layers if use_flash else 0
        assert flash.LAUNCHES == {"flash_forward": want,
                                  "flash_backward_dq": want,
                                  "flash_backward_dkdv": want}
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
def test_bert_step_runs_the_flash_kernels_per_layer(cuda_device):
    """BERT's path (non-causal, a key mask with padded tails, group 1)
    through the kernels against the plain path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(bert.BERT_TINY, hidden_size=256, num_heads=4,
                              intermediate_size=512, dtype=torch.float32)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 128))).to(cuda_device)
    mask = torch.ones(4, 128, dtype=torch.bool, device=cuda_device)
    mask[::2, 96:] = False
    grads = []
    for use_flash in (True, False):
        model = bert.BertEncoder(
            cfg, flash.make_attention_fn(use_flash=use_flash), seed=0)
        flash.reset_launch_counts()
        loss = bert.mlm_loss(model(ids, attention_mask=mask), ids,
                             torch.ones_like(mask))
        loss.backward()
        torch.cuda.synchronize()
        want = cfg.num_layers if use_flash else 0
        assert flash.LAUNCHES == {"flash_forward": want,
                                  "flash_backward_dq": want,
                                  "flash_backward_dkdv": want}
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
def test_resnet_tiny_on_the_card_matches_the_cpu(cuda_device):
    """cuDNN in channels_last against the CPU, float32 (TF32 off): the
    logits, every gradient and the new running statistics."""
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(np.random.RandomState(0).rand(
        4, 36, 36, 3).astype(np.float32))
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        model = ResNetTiny(dtype=torch.float32, device=device, seed=0)
        out = model(x.to(device), train=True)
        (out ** 2).sum().backward()
        runs.append((out, model))
    (out, card), (want, cpu) = runs
    torch.testing.assert_close(out.cpu(), want, **F32_TOL)
    for (name, p), (_, r) in zip(card.named_parameters(),
                                 cpu.named_parameters()):
        scale = float(r.grad.abs().max())
        torch.testing.assert_close(p.grad.cpu(), r.grad, rtol=0,
                                   atol=1e-5 + 1e-4 * scale, msg=name)
    for (name, t), (_, r) in zip(card.named_buffers(), cpu.named_buffers()):
        torch.testing.assert_close(t.cpu(), r, **F32_TOL, msg=name)


def _moe_tiny_f32():
    return dataclasses.replace(moe_lm.MOE_TINY, dtype=torch.float32)


@pytest.mark.cuda
def test_moe_training_step_runs_the_flash_kernels_per_layer(cuda_device):
    """MOE_TINY at D=16 (padded to 64), causal, group 2: one launch per
    kernel per layer, and the gradients of the plain path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_tiny_f32()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 64))).to(cuda_device)
    grads = []
    for use_flash in (True, False):
        model = moe_lm.MoeLM(
            cfg, seed=0, param_dtype=torch.float32,
            attention_fn=flash.make_attention_fn(causal=True,
                                                 use_flash=use_flash))
        flash.reset_launch_counts()
        logits, aux = model(ids, return_aux=True)
        (llama.causal_lm_loss(logits, ids) + 0.01 * aux).backward()
        torch.cuda.synchronize()
        want = cfg.num_layers if use_flash else 0
        assert flash.LAUNCHES == {"flash_forward": want,
                                  "flash_backward_dq": want,
                                  "flash_backward_dkdv": want}
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
def test_generate_and_engine_at_moe_tiny_run_the_kernels(cuda_device):
    """MoeLM through generate() (the contiguous kernel) and the serving
    engine (the paged kernel): the einsum path's tokens, and generate()'s."""
    from horovod_tpu_torch.serving import ServingConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_tiny_f32()
    model = moe_lm.MoeLM(cfg, seed=0)
    prompt = torch.from_numpy(
        np.random.RandomState(1).randint(0, cfg.vocab_size, (3, 11)))
    ops.reset_launch_counts()
    tokens = llama.generate(model, prompt, max_new_tokens=9)
    assert ops.LAUNCHES["decode_attention"] == cfg.num_layers * 8
    with llama.decode_kernel_disabled():
        assert torch.equal(tokens,
                           llama.generate(model, prompt, max_new_tokens=9))
    engine = ServingEngine(model, config=ServingConfig(
        max_batch=4, block_size=16, max_seq_len=64))
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 17, 9, 30, 12)]
    handles = [engine.submit(p, 7) for p in prompts]
    ops.reset_launch_counts()
    engine.run_until_idle()
    assert ops.LAUNCHES["paged_decode_attention"] > 0
    for p, handle in zip(prompts, handles):
        want = llama.generate(model, torch.from_numpy(p[None]),
                              max_new_tokens=7)[0, len(p):].tolist()
        assert handle.result(timeout=0) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,sq,sk,h,hkv,d,causal",
    # Ring blocks of Llama-300M at seq 2048 over 2 ranks (the diagonal
    # block and a past block), zigzag half-blocks of 512 (a triangle, and
    # the late half over a whole block), and Ulysses' full sequence at
    # H/2, Hkv/2 — at batch 1.
    [(1, 1024, 1024, 16, 8, 64, True),
     (1, 1024, 1024, 16, 8, 64, False),
     (1, 512, 512, 16, 8, 64, True),
     (1, 512, 1024, 16, 8, 64, False),
     (1, 2048, 2048, 8, 4, 64, True)])
def test_flash_backward_with_dlse_matches_plain(cuda_device, dtype, b, sq,
                                                sk, h, hkv, d, causal):
    """Ring attention's merge gives lse a cotangent: the backward's delta
    shifts by it (``flash_delta(out, g, dlse)``), and kernels 2 and 3
    take the shifted delta as they take any."""
    from horovod_tpu_torch.parallel.sequence import _FlashBlockPair

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q = _randn(gen, cuda_device, dtype, b, sq, h, d)
    k = _randn(gen, cuda_device, dtype, b, sk, hkv, d)
    v = _randn(gen, cuda_device, dtype, b, sk, hkv, d)
    g = _randn(gen, cuda_device, dtype, b, sq, h, d)
    dlse = torch.randn(b * h, 1, sq, generator=gen, device=cuda_device)
    out, lse = flash.flash_attention_forward_plain(q, k, v, None, causal)
    delta = flash.flash_delta(out, g, dlse)
    assert not torch.equal(delta, flash.flash_delta(out, g))
    flash.reset_launch_counts()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got_out, got_lse = _FlashBlockPair.apply(*leaves, None, causal, None)
    torch.autograd.backward((got_out, got_lse), (g, dlse))
    torch.cuda.synchronize()
    assert flash.LAUNCHES == {"flash_forward": 1, "flash_backward_dq": 1,
                              "flash_backward_dkdv": 1}
    _assert_flash_close(got_out, out, dtype)
    torch.testing.assert_close(got_lse, lse, **F32_TOL)
    want_dq = flash.flash_backward_dq_plain(q, k, v, None, g, lse, delta,
                                            causal)
    want_dk, want_dv = flash.flash_backward_dkdv_plain(q, k, v, None, g, lse,
                                                       delta, causal)
    for leaf, want in zip(leaves, (want_dq, want_dk, want_dv)):
        _assert_flash_close(leaf.grad, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,hkv", [(8, 4), (2, 1)])
def test_decode_kernels_at_tensor_parallel_shard_shapes(cuda_device, dtype,
                                                        h, hkv):
    """A tensor-parallel rank's heads: Llama-300M's H16/Hkv8 over tp 2
    (H8/Hkv4) and LLAMA_TINY's H4/Hkv2 over tp 2 (H2/Hkv1), D 64, through
    the sharded steps (row write, then the kernel on the shard)."""
    class OneRankOfTwo:
        """The steps read only the axis size: one rank of a tp-2 axis."""

        def axis_size(self, axis):
            return 2

    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    mesh = OneRankOfTwo()
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, window, bs, d = 8, 256, 16, 64
    q = _randn(gen, cuda_device, dtype, b, 1, h, d)
    kn = _randn(gen, cuda_device, dtype, b, 1, hkv, d)
    vn = _randn(gen, cuda_device, dtype, b, 1, hkv, d)
    k = _randn(gen, cuda_device, dtype, b, window, hkv * d)
    v = _randn(gen, cuda_device, dtype, b, window, hkv * d)
    idx = 200
    ops.reset_launch_counts()
    got, k2, v2 = ops.sharded_decode_step(q, kn, vn, k.clone(), v.clone(),
                                          idx, 2 * hkv, mesh=mesh,
                                          head_axis="model")
    k[:, idx], v[:, idx] = kn.reshape(b, -1), vn.reshape(b, -1)
    torch.testing.assert_close(k2, k, atol=0, rtol=0)
    want = ops.decode_attention_plain(q, k, v, idx, hkv)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    slots = window // bs
    tables = (torch.randperm(b * slots, generator=gen, device=cuda_device)
              + 1).view(b, slots).to(torch.int32)
    kp, vp = _pools(k, v, tables, bs)
    lens = torch.tensor([0, 15, 16, 47, 100, 191, 240, 254],
                        dtype=torch.int32, device=cuda_device)
    want_p = ops.paged_decode_attention_plain(
        q, *ops.paged_cache_write(kp.clone(), vp.clone(), kn, vn, tables,
                                  lens), tables, lens, hkv)
    got_p, _, _ = ops.sharded_paged_decode_step(
        q, kn, vn, kp, vp, tables, lens, 2 * hkv, mesh=mesh,
        head_axis="model")
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"decode_attention": 1,
                            "paged_decode_attention": 1}
    torch.testing.assert_close(got_p.float(), want_p.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_engine_decode_graph_equals_the_eager_step(cuda_device, temperature):
    """The engine's decode step captured as a CUDA graph gives the eager
    step's tokens (greedy, and sampled from the same seed) and the same
    paged-kernel launch count (the capture's launches counted at each
    replay)."""
    from horovod_tpu_torch import serving
    from horovod_tpu_torch.serving import engine as engine_mod

    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    model = llama.LlamaLM(cfg, device=cuda_device, seed=0)
    scfg = serving.ServingConfig(max_batch=4, block_size=16, num_blocks=0,
                                 queue_depth=16, max_seq_len=128)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, int(rng.randint(8, 40)))
               for _ in range(6)]
    runs = {}
    for graphed in (True, False):
        if graphed:
            engine = serving.ServingEngine(model, scfg, seed=3)
        else:
            with engine_mod._eager_decode():
                engine = serving.ServingEngine(model, scfg, seed=3)
        assert (engine._graphs is not None) == graphed
        handles = [engine.submit(p, 12, temperature) for p in prompts]
        ops.reset_launch_counts()
        engine.run_until_idle()
        runs[graphed] = ([h.result(timeout=0) for h in handles],
                         ops.LAUNCHES["paged_decode_attention"],
                         engine.stats()["steps"])
        engine.shutdown()
    assert runs[True] == runs[False]
    tokens, launches, steps = runs[True]
    assert launches == cfg.num_layers * steps > 0
