"""The port's decode attention (``horovod_tpu_torch.ops.decode_attention``)
held against the JAX package's Pallas decode kernels.

On the CPU the port's wrappers run their plain versions (the kernels'
arithmetic in torch); the JAX side runs its Pallas kernels in interpret
mode, as its own tests do. Inputs come from ``numpy.random.RandomState``
and cross as numpy arrays. The CUDA kernels themselves are held against
the plain versions on a card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import decode_attention as jax_ops
from horovod_tpu_torch.ops import decode_attention as ops
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# f32: the JAX decode tests' own bar (tests/test_serving.py). Only the
# reduction order differs between the two (tile order, exp library).
F32_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16: each output is rounded to bf16 (one ulp = 2^-8 relative) and p is
# rounded to bf16 before P·V, relative to a running max that differs with
# the tiling; the two sides may land one bf16 ulp apart on either step.
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _np(x):
    return np.asarray(x, np.float32)


def _contiguous_case(seed, b, hkv, h, d, L, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, 1, h, d) * 0.4).astype(dtype)
    k = (rng.randn(b, L, hkv * d) * 0.4).astype(dtype)
    v = (rng.randn(b, L, hkv * d) * 0.4).astype(dtype)
    return q, k, v


def _paged_case(seed, b, hkv, h, d, bs, nb_per_seq, scramble=True):
    """Logically contiguous per-sequence windows scattered into a
    (optionally scrambled) physical pool; block 0 holds garbage, as the
    null block may."""
    rng = np.random.RandomState(seed)
    f = hkv * d
    window = nb_per_seq * bs
    q = (rng.randn(b, 1, h, d) * 0.4).astype(np.float32)
    k_win = (rng.randn(b, window, f) * 0.4).astype(np.float32)
    v_win = (rng.randn(b, window, f) * 0.4).astype(np.float32)
    n_phys = b * nb_per_seq
    order = (rng.permutation(n_phys) if scramble else np.arange(n_phys)) + 1
    tables = order.reshape(b, nb_per_seq).astype(np.int32)
    k_pool = np.full((n_phys + 1, bs, f), 7.0, np.float32)
    v_pool = np.full((n_phys + 1, bs, f), -7.0, np.float32)
    for i in range(b):
        for t in range(nb_per_seq):
            k_pool[tables[i, t]] = k_win[i, t * bs:(t + 1) * bs]
            v_pool[tables[i, t]] = v_win[i, t * bs:(t + 1) * bs]
    return q, k_pool, v_pool, tables, k_win, v_win


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("hkv,h", [(2, 4), (1, 8), (4, 16)])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_decode_plain_matches_jax(hkv, h, where):
    b, d, L = 2, 16, 40
    idx = {"first": 0, "mid": L // 2, "last": L - 1}[where]
    q, k, v = _contiguous_case(0, b, hkv, h, d, L)
    want = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), idx, hkv)
    got = ops.decode_attention(_t(q), _t(k), _t(v), idx, hkv)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)


@pytest.mark.parametrize("d,L", [(128, 48), (64, 4224)])
def test_decode_plain_matches_jax_wide_and_multi_tile(d, L):
    """D=128, and a window whose K/V bytes exceed the JAX kernel's
    single-tile budget (4224 rows x 128 f32 lanes x 2 > 4 MiB), so the
    Pallas side runs L-tiled with its running softmax across tiles."""
    b, hkv, h = 1, 2, 4
    q, k, v = _contiguous_case(1, b, hkv, h, d, L)
    for idx in (3, L - 1):
        want = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), idx, hkv)
        got = ops.decode_attention(_t(q), _t(k), _t(v), idx, hkv)
        np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)


def test_decode_plain_matches_jax_bf16():
    b, hkv, h, d, L = 2, 2, 8, 64, 96
    q, k, v = _contiguous_case(2, b, hkv, h, d, L)
    want = jax_ops.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), 70, hkv)
    got = ops.decode_attention(_t(q).bfloat16(), _t(k).bfloat16(),
                               _t(v).bfloat16(), 70, hkv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want.astype(
        jnp.float32)), **BF16_TOL)


@pytest.mark.parametrize("hkv,h", [(2, 4), (1, 8), (4, 16)])
def test_paged_plain_matches_jax(hkv, h):
    b, d, bs, nb = 4, 16, 8, 4
    # 0, a last row of a block, mid-block, the window's last row.
    lens = np.asarray([0, 15, 20, 31], np.int32)
    q, kp, vp, tables, _, _ = _paged_case(0, b, hkv, h, d, bs, nb)
    want = jax_ops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), hkv)
    got = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                     _t(lens), hkv)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)


def test_paged_scrambled_table_bit_identical_to_identity():
    b, hkv, h, d, bs, nb = 3, 2, 4, 16, 8, 4
    lens = _t(np.asarray([7, 12, 31], np.int32))
    q, kp_s, vp_s, tbl_s, _, _ = _paged_case(1, b, hkv, h, d, bs, nb,
                                             scramble=True)
    q2, kp_i, vp_i, tbl_i, _, _ = _paged_case(1, b, hkv, h, d, bs, nb,
                                              scramble=False)
    np.testing.assert_array_equal(q, q2)
    assert not np.array_equal(tbl_s, tbl_i)
    out_s = ops.paged_decode_attention(_t(q), _t(kp_s), _t(vp_s),
                                       _t(tbl_s), lens, hkv)
    out_i = ops.paged_decode_attention(_t(q), _t(kp_i), _t(vp_i),
                                       _t(tbl_i), lens, hkv)
    assert torch.equal(out_s, out_i)


def test_paged_single_block_bitwise_matches_contiguous():
    b, hkv, h, d, bs = 2, 2, 4, 16, 32
    lens = [9, 25]
    q, kp, vp, tables, k_win, v_win = _paged_case(2, b, hkv, h, d, bs, 1)
    out_paged = ops.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(np.asarray(lens, np.int32)),
        hkv)
    for i in range(b):
        out_contig = ops.decode_attention(_t(q[i:i + 1]), _t(k_win[i:i + 1]),
                                          _t(v_win[i:i + 1]), lens[i], hkv)
        assert torch.equal(out_paged[i], out_contig[0]), f"seq {i}"


def test_paged_cache_write_lands_where_jax_does():
    b, hkv, d, bs, nb = 2, 2, 4, 4, 3
    f = hkv * d
    tables = np.arange(b * nb).reshape(b, nb).astype(np.int32) + 1
    lens = np.asarray([5, 8], np.int32)    # page 1 offset 1 / page 2 off 0
    k_new = np.random.RandomState(0).randn(b, 1, hkv, d).astype(np.float32)
    v_new = -k_new
    pool = np.zeros((b * nb + 1, bs, f), np.float32)
    jk, jv = jax_ops.paged_cache_write(
        jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(tables), jnp.asarray(lens))
    tk, tv = _t(pool.copy()), _t(pool.copy())
    out_k, out_v = ops.paged_cache_write(tk, tv, _t(k_new), _t(v_new),
                                         _t(tables), _t(lens))
    assert out_k is tk and out_v is tv             # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int((tk != 0).any(dim=-1).sum()) == 2


def test_paged_gather_matches_paged_and_jax():
    b, hkv, h, d, bs, nb = 2, 2, 8, 16, 8, 3
    lens = np.asarray([3, 20], np.int32)
    q, kp, vp, tables, _, _ = _paged_case(3, b, hkv, h, d, bs, nb)
    args = (_t(q), _t(kp), _t(vp), _t(tables), _t(lens), hkv)
    out_g = ops.paged_gather_attention(*args)
    out_k = ops.paged_decode_attention(*args)
    np.testing.assert_allclose(out_g.numpy(), out_k.numpy(), **F32_TOL)
    want = jax_ops.paged_gather_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), hkv)
    np.testing.assert_allclose(out_g.numpy(), _np(want), **F32_TOL)


def test_cpu_calls_never_launch_and_odd_devices_raise():
    ops.reset_launch_counts()
    q, k, v = _contiguous_case(4, 1, 2, 4, 16, 8)
    ops.decode_attention(_t(q), _t(k), _t(v), 3, 2)
    assert ops.LAUNCHES == {"decode_attention": 0,
                            "paged_decode_attention": 0}
    # A tensor on neither the CPU nor a card has no silent fallback.
    meta = torch.empty((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="one device"):
        ops.decode_attention(meta, _t(k), _t(v), 3, 2)
    with pytest.raises(ValueError, match="single-token"):
        ops.decode_attention(_t(np.zeros((1, 2, 4, 16), np.float32)),
                             _t(k), _t(v), 3, 2)


@pytest.mark.parametrize("b,h,d,window,chunk,chunks", [
    (8, 16, 64, 256, 256, 1),       # the serving slice: one chunk
    (8, 16, 64, 255, 256, 1),
    (8, 16, 64, 257, 256, 2),       # one position past a chunk
    (8, 32, 128, 4096, 256, 16),    # Llama-8B's window
    (6, 32, 128, 848, 256, 4),      # no multiple of the chunk
    (2, 4, 64, 848, 128, 7)])
def test_decode_plan_is_a_rule_of_shapes(b, h, d, window, chunk, chunks):
    """The decode kernels' host-side plan: chunks of the window, the f32
    scratch of the partials, and CUDA launches per call. One chunk means
    no scratch and one launch."""
    plan = ops.decode_plan(b, h, d, window, chunk)
    assert plan.chunks == chunks
    if chunks == 1:
        assert plan == ops.DecodePlan(1, None, 1)
    else:
        assert plan == ops.DecodePlan(chunks, (b * h, chunks, d + 2), 2)


def test_decode_plan_reads_no_lengths():
    """The chunk rule depends on shapes alone, never on the sequences'
    lengths or the table's contents, and the serving slice's window of 256
    stays one launch at the default chunk."""
    assert list(inspect.signature(ops.decode_plan).parameters) == [
        "b", "h", "d", "window", "chunk"]
    assert ops.decode_plan(8, 16, 64, 256).launches == 1
    with pytest.raises(ValueError, match="positive"):
        ops.decode_plan(1, 4, 64, 0)
