"""Decode-step attention over the KV cache (single-token queries): the
counterpart of ``horovod_tpu/ops/decode_attention.py``.

Same signatures and layouts as the JAX module: q ``(B, 1, H, D)``; a
row-flat contiguous cache ``(B, L, Hkv*D)`` or a paged pool
``(N, block_size, Hkv*D)`` addressed through ``(B, T)`` int32 block
tables with per-sequence positions ``(B,)``.

Routing: a CUDA tensor always goes to the hand-written kernel in
``csrc/decode_attention.cu`` (built at first use by ``_build``), and the
call raises if the kernel cannot take it — there is no fallback. Only
CPU tensors take the plain versions (``decode_attention_plain``,
``paged_decode_attention_plain``), which repeat the kernel's arithmetic
in torch; the CPU tests hold those against the JAX package, and
``chip_smoke.py`` holds the kernels against them on the card.

Flash-decoding: the kernels split the logical window into chunks of
``DECODE_CHUNK`` positions at fixed boundaries, one block per (sequence,
KV head, chunk), and a second small kernel merges the chunks' partials in
chunk order. :func:`decode_plan` is the host-side rule (chunk count, f32
scratch shape, CUDA launches per call); it reads shapes only, never the
sequences' lengths. A window of one chunk (the serving slice's 256) is
one launch with no scratch.

``LAUNCHES`` counts wrapper calls that launched the kernels (one per
call, whether the plan ran one CUDA launch or two, and nowhere else), so
a run can show its main path went through the kernels. A CUDA graph's
capture launches nothing: under :func:`recording_launches` a thread's
wrapper calls are recorded instead of counted, and each replay of the
graph adds the record (:func:`count_replay`), since a replay runs the
kernels without the Python that counts them.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from . import _build
from .attention import NEG_INF

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
LAUNCHES: Dict[str, int] = {"decode_attention": 0,
                            "paged_decode_attention": 0}
_launch_lock = threading.Lock()
_recording = threading.local()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k_cache, v_cache, out, part, b, h, hkv, d, window, cache_index,
    # chunk, scale, dtype, stream
    "hvd_decode_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _I, _P),
    # q, k_pool, v_pool, out, part, tables, lens, b, h, hkv, d,
    # table_slots, block_size, chunk, scale, dtype, stream
    "hvd_paged_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _I, _F, _I, _P),
}

#: Positions per block of the decode kernels: the window splits at 0,
#: DECODE_CHUNK, 2 * DECODE_CHUNK, ...
DECODE_CHUNK = 1024


class DecodePlan(NamedTuple):
    """How one decode kernel call runs: ``chunks`` blocks per (sequence,
    KV head); ``scratch``: the shape of the f32 partials (B*H, chunks,
    D + 2), None for one chunk; ``launches``: CUDA launches (the split
    kernel, then the combine when there is more than one chunk)."""
    chunks: int
    scratch: Optional[Tuple[int, int, int]]
    launches: int


def decode_plan(b: int, h: int, d: int, window: int,
                chunk: int = DECODE_CHUNK) -> DecodePlan:
    """The host-side plan of a decode call over a logical ``window``
    (L, or table slots x block size): from shapes alone."""
    if window <= 0 or chunk <= 0:
        raise ValueError(f"decode_plan: window ({window}) and chunk "
                         f"({chunk}) must be positive")
    chunks = -(-window // chunk)
    if chunks == 1:
        return DecodePlan(1, None, 1)
    return DecodePlan(chunks, (b * h, chunks, d + 2), 2)


def _scratch(plan: DecodePlan, device) -> Optional[torch.Tensor]:
    if plan.scratch is None:
        return None
    return torch.empty(plan.scratch, dtype=torch.float32, device=device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def reset_launch_counts() -> None:
    with _launch_lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def _count_launch(name: str) -> None:
    """One launch of ``name``'s kernel. Under a lock: several serving
    loops (fleet replicas) launch from their own threads."""
    record = getattr(_recording, "counts", None)
    if record is not None:
        record[name] += 1
        return
    with _launch_lock:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[str, int]]:
    """Within the context, this thread's wrapper calls are recorded into
    the yielded counter and not counted: the CUDA graph capture they run
    in launches nothing."""
    record: Dict[str, int] = collections.Counter()
    _recording.counts = record
    try:
        yield record
    finally:
        _recording.counts = None


def count_replay(record: Dict[str, int]) -> None:
    """One replay of a captured graph: its recorded launches ran."""
    with _launch_lock:
        for name, n in record.items():
            LAUNCHES[name] += n


def _attend_plain(q, k4, v4, lens, scale):
    """The kernels' arithmetic in torch: (q·k) in f32 times ``scale``,
    keys at positions <= lens[i], softmax in f32, p rounded to V's dtype
    before P·V, ``acc / max(l, 1e-30)`` in q's dtype. ``k4``/``v4``:
    (B, L, Hkv, D) windows; ``lens``: (B,) int64."""
    b, _, h, d = q.shape
    window, hkv = k4.shape[1], k4.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    s = torch.einsum("bhgd,blhd->bhgl", qg, k4.float()) * scale
    valid = (torch.arange(window, device=q.device)[None, :]
             <= lens[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgl,blhd->bhgd", p.to(v4.dtype).float(),
                       v4.float())
    return (acc / l.clamp_min(1e-30)).reshape(b, 1, h, d).to(q.dtype)


def _check_decode(name, q, k_cache, v_cache, num_kv_heads):
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"{name} is single-token (s={s})")
    f = k_cache.shape[-1]
    if h % num_kv_heads or f != num_kv_heads * d:
        raise ValueError(
            f"H ({h}) must be a multiple of Hkv ({num_kv_heads}) and the "
            f"flat cache width ({f}) must equal Hkv*D ({num_kv_heads * d})")
    if v_cache.shape != k_cache.shape:
        raise ValueError(
            f"k/v caches disagree: {tuple(k_cache.shape)} vs "
            f"{tuple(v_cache.shape)}")


def decode_attention_plain(q, k_cache, v_cache, cache_index, num_kv_heads,
                           sm_scale=None):
    """Plain torch version of :func:`decode_attention` (the CPU path, and
    the yardstick ``chip_smoke.py`` holds the kernel against)."""
    _check_decode("decode_attention", q, k_cache, v_cache, num_kv_heads)
    b, _, _, d = q.shape
    L = k_cache.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    lens = torch.full((b,), int(cache_index), dtype=torch.int64,
                      device=q.device)
    return _attend_plain(q, k_cache.view(b, L, num_kv_heads, d),
                         v_cache.view(b, L, num_kv_heads, d), lens, scale)


def decode_attention(q, k_cache, v_cache, cache_index, num_kv_heads,
                     sm_scale=None):
    """Masked single-token attention over the FLAT cache window.

    ``q``: (B, 1, H, D); ``k_cache``/``v_cache``: (B, L, Hkv*D);
    ``cache_index``: the query's global position (an int) — keys at
    positions <= it attend (the new row must already be written).
    Returns (B, 1, H, D). CUDA tensors run the kernel that replaces
    ``_decode_kernel`` of ``horovod_tpu/ops/decode_attention.py``."""
    _check_decode("decode_attention", q, k_cache, v_cache, num_kv_heads)
    if not _build.on_card("decode attention", q, k_cache, v_cache):
        return decode_attention_plain(q, k_cache, v_cache, cache_index,
                                      num_kv_heads, sm_scale)
    b, _, h, d = q.shape
    _build.check_operands("decode_attention", _build.DECODE_WIDTHS, q=q,
                          k=k_cache, v=v_cache)
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if b == 0:
        return out
    window = k_cache.shape[1]
    part = _scratch(decode_plan(b, h, d, window, DECODE_CHUNK), q.device)
    lib = _build.library("decode_attention", _SIGNATURES)
    code = lib.hvd_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), _ptr(part), b, h, num_kv_heads, d, window,
        int(cache_index), DECODE_CHUNK, float(scale),
        _build.KERNEL_DTYPES[q.dtype], _build.stream(q.device))
    _build.check(lib, "hvd_decode_attention", code)
    _count_launch("decode_attention")
    return out


def _check_paged(q, k_pool, v_pool, block_tables, context_lens,
                 num_kv_heads):
    _check_decode("paged_decode_attention", q, k_pool, v_pool, num_kv_heads)
    b = q.shape[0]
    if block_tables.shape[0] != b or tuple(context_lens.shape) != (b,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / context_lens "
            f"{tuple(context_lens.shape)} do not cover the batch ({b})")


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                 context_lens, num_kv_heads, sm_scale=None):
    """Plain torch version of :func:`paged_decode_attention`: gather each
    sequence's blocks into its logical window, then the kernels'
    arithmetic."""
    _check_paged(q, k_pool, v_pool, block_tables, context_lens,
                 num_kv_heads)
    b, _, _, d = q.shape
    block_size = k_pool.shape[1]
    window = block_tables.shape[1] * block_size
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    tables = block_tables.long()
    k_win = k_pool[tables].reshape(b, window, num_kv_heads, d)
    v_win = v_pool[tables].reshape(b, window, num_kv_heads, d)
    return _attend_plain(q, k_win, v_win, context_lens.long(), scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens,
                           num_kv_heads, sm_scale=None):
    """Single-token attention over a PAGED cache (the vLLM layout on the
    row-flat GQA cache). ``k_pool``/``v_pool``: (N, block_size, Hkv*D),
    block 0 the null block; ``block_tables``: (B, T) int — sequence i's
    logical block t is physical block ``block_tables[i, t]``;
    ``context_lens``: (B,) int — keys at positions <= lens[i] attend (the
    new row must already be written, see :func:`paged_cache_write`).
    Returns (B, 1, H, D). CUDA tensors run the kernel that replaces
    ``_paged_decode_kernel`` of ``horovod_tpu/ops/decode_attention.py``."""
    _check_paged(q, k_pool, v_pool, block_tables, context_lens,
                 num_kv_heads)
    if not _build.on_card("decode attention", q, k_pool, v_pool,
                          block_tables, context_lens):
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            context_lens, num_kv_heads,
                                            sm_scale)
    b, _, h, d = q.shape
    _build.check_operands("paged_decode_attention", _build.DECODE_WIDTHS,
                          q=q, k=k_pool, v=v_pool)
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    tables = block_tables.to(torch.int32).contiguous()
    lens = context_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    slots, block_size = tables.shape[1], k_pool.shape[1]
    part = _scratch(decode_plan(b, h, d, slots * block_size,
                                 DECODE_CHUNK), q.device)
    lib = _build.library("decode_attention", _SIGNATURES)
    code = lib.hvd_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        _ptr(part), tables.data_ptr(), lens.data_ptr(), b, h, num_kv_heads,
        d, slots, block_size, DECODE_CHUNK, float(scale),
        _build.KERNEL_DTYPES[q.dtype], _build.stream(q.device))
    _build.check(lib, "hvd_paged_decode_attention", code)
    _count_launch("paged_decode_attention")
    return out


def paged_gather_attention(q, k_pool, v_pool, block_tables, context_lens,
                           num_kv_heads, sm_scale: Optional[float] = None):
    """The einsum path for the paged layout (``decode_kernel_disabled()``):
    gather each sequence's blocks into a contiguous window, then the
    masked einsum with the per-sequence causal bound — softmax in f32
    with ``finfo(f32).min`` masking, probabilities cast to q's dtype.
    Same semantics as :func:`paged_decode_attention`; plain torch on any
    device."""
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"paged_gather_attention is single-token (s={s})")
    hkv = num_kv_heads
    block_size = k_pool.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    window = block_tables.shape[1] * block_size
    tables = block_tables.long()
    k_win = k_pool[tables].reshape(b, window, hkv, d)
    v_win = v_pool[tables].reshape(b, window, hkv, d)
    qg = q.reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bshgd,blhd->bshgl", qg, k_win).float() * scale
    mask = (torch.arange(window, device=q.device)[None, :]
            <= context_lens.long()[:, None])
    logits = logits.masked_fill(~mask[:, None, None, None, :],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bshgl,blhd->bshgd", probs, v_win).reshape(
        b, s, h, d)


def paged_cache_write(k_pool, v_pool, k_new, v_new, block_tables,
                      context_lens):
    """Write each sequence's fresh K/V row (position ``context_lens[i]``)
    into its block, IN PLACE (``index_put_``; the JAX version donates the
    pool and XLA makes the same update in place): rows land at
    ``(block_tables[i, lens // bs], lens % bs)``. ``k_new``/``v_new``:
    (B, 1, Hkv, D) in the pool dtype. Inactive batch slots point at the
    null block with lens 0 — their write lands there, harmless and masked
    everywhere. Returns ``(k_pool, v_pool)``."""
    b = k_new.shape[0]
    block_size = k_pool.shape[1]
    lens = context_lens.long()
    blk = block_tables.long()[torch.arange(b, device=lens.device),
                              lens // block_size]
    off = lens % block_size
    k_pool.index_put_((blk, off), k_new.reshape(b, -1))
    v_pool.index_put_((blk, off), v_new.reshape(b, -1))
    return k_pool, v_pool


# ---------------------------------------------------------------------------
# Tensor-parallel steps (``sharded_decode_step`` and
# ``sharded_paged_decode_step`` of the JAX module). The JAX functions take
# global arrays and ``shard_map`` the step over the heads axis; here each
# rank already holds its shard, so a step is this rank's own row write
# and the unmodified kernel on its heads. No collective runs inside the
# step: the head concat is implicit in the layout, and the sum after
# ``wo`` is the model's.


def _tp_heads(name, q, k_new, num_kv_heads, mesh, head_axis):
    """(tp, this rank's K/V heads) after the JAX functions' checks, on
    the GLOBAL head counts this rank's shard implies."""
    b, s, h_local, d = q.shape
    if s != 1:
        raise ValueError(f"{name} is single-token (s={s})")
    tp = mesh.axis_size(head_axis)
    hkv, h = num_kv_heads, h_local * tp
    if hkv % tp or h % hkv:
        raise ValueError(
            f"heads not shardable over {head_axis!r} (size {tp}): need "
            f"Hkv ({hkv}) % tp == 0 and H ({h}) % Hkv == 0")
    if k_new.shape[2] != hkv // tp:
        raise ValueError(
            f"{name}: this rank holds {k_new.shape[2]} K/V heads, "
            f"expected Hkv/tp = {hkv // tp}")
    return tp, hkv // tp


def sharded_decode_step(q, k_new, v_new, k_cache, v_cache, cache_index,
                        num_kv_heads, *, mesh, head_axis, batch_axis=None,
                        sm_scale=None):
    """One TP-sharded decode step on this rank's shard: write its one
    cache row, then run the decode kernel on its H/tp query heads and
    Hkv/tp K/V heads.

    ``q``: (B, 1, H/tp, D); ``k_new``/``v_new``: (B, 1, Hkv/tp, D) in the
    cache dtype; ``k_cache``/``v_cache``: (B, L, (Hkv/tp)*D) row-flat,
    updated in place. ``mesh``/``head_axis``: the axis sharding heads
    (its size must divide ``num_kv_heads``, the model's global count);
    ``batch_axis``: an axis sharding the batch (dp x tp serving) — each
    rank's batch is already its own, so it is only checked to exist.
    Returns ``(ctx, k_cache, v_cache)``."""
    _, hkv_local = _tp_heads("sharded_decode_step", q, k_new, num_kv_heads,
                             mesh, head_axis)
    if batch_axis is not None:
        mesh.axis_size(batch_axis)
    b = q.shape[0]
    k_cache[:, cache_index] = k_new.reshape(b, -1)
    v_cache[:, cache_index] = v_new.reshape(b, -1)
    ctx = decode_attention(q, k_cache, v_cache, cache_index, hkv_local,
                           sm_scale=sm_scale)
    return ctx, k_cache, v_cache


def sharded_paged_decode_step(q, k_new, v_new, k_pool, v_pool, block_tables,
                              context_lens, num_kv_heads, *, mesh,
                              head_axis, batch_axis=None, sm_scale=None):
    """One TP-sharded PAGED decode step: this rank's block-row write and
    the paged kernel on its heads. The pool shards on its flat
    head-width axis (each rank holds its Hkv/tp head columns of every
    block: (N, block, (Hkv/tp)*D)); block tables and lengths are the
    same on every rank.

    ``batch_axis`` is refused, as in the JAX package: the pool has no
    batch dim, so under a dp-sharded batch each dp group would write
    only its own sequences' rows into its copy of a pool meant to be
    one, and the copies would silently diverge — run one engine per dp
    replica instead."""
    _, hkv_local = _tp_heads("sharded_paged_decode_step", q, k_new,
                             num_kv_heads, mesh, head_axis)
    if batch_axis is not None:
        raise NotImplementedError(
            "paged decode does not support a dp-sharded batch: the "
            "shared block pool has no batch dim to shard, so dp "
            "replicas of it would diverge — run one serving engine per "
            "dp replica instead")
    paged_cache_write(k_pool, v_pool, k_new, v_new, block_tables,
                      context_lens)
    ctx = paged_decode_attention(q, k_pool, v_pool, block_tables,
                                 context_lens, hkv_local, sm_scale=sm_scale)
    return ctx, k_pool, v_pool
