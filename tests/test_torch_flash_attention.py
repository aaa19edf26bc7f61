"""The port's flash attention (``horovod_tpu_torch.ops.attention``) held
against the JAX package's on the same numpy inputs.

On the CPU the port's wrappers run their plain versions (the CUDA kernels
are checked against those on the card, ``tests/test_torch_cuda.py`` and
``chip_smoke.py``); the JAX side runs its Pallas kernels in interpret
mode, as its own tests do. Mirrors ``tests/test_attention.py``: causal
and not, causal with sq != sk (rows before the first key are zeros),
key mask, a fully masked row, awkward lengths, bf16, GQA groups, and the
``dlse`` term of the backward.

Tolerances: float32 atol 2e-5 / rtol 1e-4 (the two differ in summation
order and in blocking of the online softmax only); bfloat16 atol 1e-2 /
rtol 1e-2 (p and the outputs round to bf16 at different points: per key
block against a running max in JAX, once against the final max here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import attention as jattn
from horovod_tpu_torch.ops import attention as tattn

B, S, H, D = 2, 64, 2, 16
F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=1e-2, rtol=1e-2)


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) * 0.3 for s in shapes]


def _qkv(seed, sq=S, sk=S, h=H, hkv=H, d=D):
    return _arrays(seed, (B, sq, h, d), (B, sk, hkv, d), (B, sk, hkv, d))


def _jax_flash(q, k, v, mask=None, causal=False, dtype=jnp.float32,
               blocks=(16, 16)):
    kw = {} if blocks is None else dict(block_q=blocks[0],
                                        block_k=blocks[1])

    def fn(q, k, v):
        return jattn.flash_attention(
            q, k, v, key_mask=None if mask is None else jnp.asarray(mask),
            causal=causal, **kw)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out = fn(*args)
    grads = jax.grad(lambda *a: (fn(*a).astype(jnp.float32) ** 2).sum(),
                     argnums=(0, 1, 2))(*args)
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port_flash(q, k, v, mask=None, causal=False, dtype=torch.float32):
    args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = tattn.flash_attention(
        *args, key_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    (out.float() ** 2).sum().backward()
    return (out.detach().float().numpy(),
            [a.grad.float().numpy() for a in args])


def _close(port, jax_, tol):
    out_p, grads_p = port
    out_j, grads_j = jax_
    np.testing.assert_allclose(out_p, out_j, **tol)
    for name, gp, gj in zip("qkv", grads_p, grads_j):
        np.testing.assert_allclose(gp, gj, **tol, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax(causal):
    q, k, v = _qkv(0)
    tattn.reset_launch_counts()
    _close(_port_flash(q, k, v, causal=causal),
           _jax_flash(q, k, v, causal=causal), F32)
    # The CPU path is the plain version: no kernel launched.
    assert sorted(tattn.LAUNCHES.values()) == [0, 0, 0]


@pytest.mark.parametrize("sq,sk", [(4, 8), (16, 64), (32, 64)])
def test_flash_causal_sq_ne_sk(sq, sk):
    q, k, v = _qkv(11, sq=sq, sk=sk)
    _close(_port_flash(q, k, v, causal=True),
           _jax_flash(q, k, v, causal=True), F32)


def test_flash_causal_sq_gt_sk_rows_zero_with_grads():
    sq, sk = 32, 16
    q, k, v = _qkv(17, sq=sq, sk=sk)
    port = _port_flash(q, k, v, causal=True)
    np.testing.assert_array_equal(port[0][:, :sq - sk], 0.0)
    np.testing.assert_array_equal(port[1][0][:, :sq - sk], 0.0)
    _close(port, _jax_flash(q, k, v, causal=True, blocks=(8, 8)), F32)


def test_flash_key_mask():
    q, k, v = _qkv(1)
    mask = np.random.RandomState(2).rand(B, S) > 0.3
    _close(_port_flash(q, k, v, mask), _jax_flash(q, k, v, mask), F32)


def test_flash_fully_masked_row_outputs_zero_with_grads():
    q, k, v = _qkv(4)
    mask = np.random.RandomState(5).rand(B, S) > 0.3
    mask[0, :] = False
    port = _port_flash(q, k, v, mask)
    np.testing.assert_array_equal(port[0][0], 0.0)
    for g in port[1]:
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g[0], 0.0)
    _close(port, _jax_flash(q, k, v, mask), F32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [197, 67])
def test_flash_awkward_lengths_match_jax_auto_pad(s, causal):
    # The JAX package pads these to a 128 multiple (default blocks); the
    # port's kernels bounds-check instead. Same result.
    q, k, v = _qkv(5, sq=s, sk=s)
    _close(_port_flash(q, k, v, causal=causal),
           _jax_flash(q, k, v, causal=causal, blocks=None), F32)


def test_flash_awkward_length_with_mask_and_grads():
    s = 197
    q, k, v = _qkv(6, sq=s, sk=s)
    mask = np.random.RandomState(7).rand(B, s) > 0.2
    _close(_port_flash(q, k, v, mask),
           _jax_flash(q, k, v, mask, blocks=None), F32)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_matches_jax(causal):
    q, k, v = _qkv(21)
    _close(_port_flash(q, k, v, causal=causal, dtype=torch.bfloat16),
           _jax_flash(q, k, v, causal=causal, dtype=jnp.bfloat16), BF16)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_gqa_groups_match_jax(group):
    q, k, v = _qkv(23, h=4, hkv=4 // group)
    _close(_port_flash(q, k, v, causal=True),
           _jax_flash(q, k, v, causal=True), F32)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_forward_and_backward_with_dlse_match_jax(masked):
    """``_flash_forward`` (out, lse) and ``_flash_backward`` with a
    cotangent on lse, side by side with the JAX package's."""
    h, hkv = 4, 2
    q, k, v, g = _arrays(29, (B, S, h, D), (B, S, hkv, D), (B, S, hkv, D),
                         (B, S, h, D))
    dlse = np.random.RandomState(31).randn(B * h, 1, S).astype(np.float32)
    mask = np.random.RandomState(37).rand(B, S) > 0.25 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    j_out, j_lse = jattn._flash_forward(jq, jk, jv, jmask, True, None, 16,
                                        16, True, has_mask=masked)
    j_grads = jattn._flash_backward(jq, jk, jv, jmask, j_out, j_lse, jg,
                                    True, None, 16, 16, True,
                                    dlse=jnp.asarray(dlse), has_mask=masked)

    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tmask = None if mask is None else torch.from_numpy(mask)
    t_out, t_lse = tattn._flash_forward(tq, tk, tv, tmask, True)
    t_grads = tattn._flash_backward(tq, tk, tv, tmask, t_out, t_lse, tg,
                                    True, dlse=torch.from_numpy(dlse))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **F32)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **F32)
    for name, a, b in zip(("dq", "dk", "dv"), t_grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32,
                                   err_msg=name)


def test_make_attention_fn_auto_switches_at_min_seq(monkeypatch):
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append("flash") or a[0])
    fn = tattn.make_attention_fn(causal=True)
    assert fn.supports_gqa
    short = torch.zeros(1, tattn.FLASH_AUTO_MIN_SEQ - 1, 2, 16)
    kv = torch.zeros(1, tattn.FLASH_AUTO_MIN_SEQ - 1, 1, 16)
    fn(short, kv, kv, None)
    assert calls == []
    long = torch.zeros(1, tattn.FLASH_AUTO_MIN_SEQ, 2, 16)
    fn(long, long[:, :, :1], long[:, :, :1], None)
    assert calls == ["flash"]
