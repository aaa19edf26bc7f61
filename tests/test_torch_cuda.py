"""The port's CUDA decode kernels on a card, held against their plain
torch versions. Every test here is marked ``cuda`` and skips without a
card; the file imports neither JAX nor ``horovod_tpu``, so on a machine
with a card and no JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import llama
from horovod_tpu_torch.ops import decode_attention as ops

# float32: only the reduction order differs from the plain version.
F32_TOL = dict(atol=2e-5, rtol=1e-4)
# bfloat16: the output is rounded to bf16 (one ulp = 2^-8 relative), and
# p is rounded to bf16 against a running max (kernel) or the final max
# (plain version), so the two may land one ulp apart on either rounding.
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


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
@pytest.mark.parametrize("h,hkv,d", [(16, 8, 64), (32, 8, 128), (8, 1, 64)])
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
    q = torch.zeros((1, 1, 4, 16), device=cuda_device)      # D=16
    k = torch.zeros((1, 8, 2 * 16), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q, k, k, 3, 2)
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
