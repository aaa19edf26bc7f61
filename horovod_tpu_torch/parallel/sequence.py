"""Sequence/context parallelism: ring attention and Ulysses all-to-all —
the port's counterpart of ``horovod_tpu/parallel/sequence.py``.

* ``ring_attention`` — blockwise attention with K/V shards rotating
  around a process group (``parallel.exchange.ring_rotations``, one
  neighbour hop per step), merged with the online-softmax recurrence.
  The sequence scales with the number of ranks; a forward without
  gradients holds one K/V block at a time (O(S_local) per rank), and
  with gradients the ring's blocks stay for the backward, as JAX's scan
  keeps them.
* ``ulysses_attention`` — all-to-all head/sequence reshard: each rank
  attends over the FULL sequence for 1/N of the heads, then reshards
  back (two of the port's differentiable ``alltoall``).

Both take this rank's shard of the sequence and a ``group`` (one axis of
``parallel.make_mesh``) where the JAX functions run inside ``shard_map``
with an ``axis_name``. The JAX ``lax.cond`` / ``lax.scan`` become Python
control flow, so blocks a causal step does not need are skipped, not
merged as empty contributions (identical results: an empty block merges
with weight 0).

The flash inner path runs each ring block (or zigzag half-block) through
the hand-written kernels as an autograd Function returning ``(out,
lse)`` — the counterpart of ``_flash_block_pair``: kernel 1 forward,
kernels 2 and 3 backward, with the cotangent of ``lse`` folded into
delta (``ops.attention.flash_delta``). Where the JAX block pair passes an
all-true mask for "no mask", this one passes none: a mask pointer sends
every tile of the kernels down their byte-by-byte mask branch.
``HOROVOD_FLASH_XLA_BWD`` (the JAX escape hatch to a dense backward) makes
the block pair's backward differentiate the dense ``(out, lse)`` pair of
kernel 1's plain version (``flash_attention_forward_plain``) instead of
running kernels 2 and 3, the cotangent of ``lse`` included. It is read at
each backward call (the JAX package reads it when it traces the step).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..common import config
from ..ops.attention import (
    FLASH_AUTO_MIN_SEQ,
    _check_gqa_heads,
    _dense_vjp,
    _flash_backward,
    _flash_forward,
    flash_attention_forward_plain,
    flash_call_words,
    make_attention_fn,
    repeat_kv,
)
from ..torch.mpi_ops import _alltoall_equal
from .exchange import ring_rotations
from .mesh import group_rank, group_size

NEG_INF = -1e30


def _block_attend(q, k, v, sm_scale, q_pos, k_pos, causal, key_mask):
    """One (Sq_local x Sk_block) attention block in f32: the
    (unnormalised acc, running max, running sum) contribution. ``q_pos``
    / ``k_pos`` are the GLOBAL positions of the local rows/keys, so any
    layout uses the same math. Grouped K/V heads are repeated here."""
    k, v = repeat_kv(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    if causal:
        allowed = k_pos[None, :] <= q_pos[:, None]
        s = s.masked_fill(~allowed[None, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                   # (b,h,q,1)
    # Guard fully-masked blocks: exp(NEG_INF - NEG_INF) would be 1.
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe) * (m > NEG_INF / 2)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return acc, m_safe, l


def zigzag_positions(idx: int, s_local: int, axis_size: int,
                     device=None) -> torch.Tensor:
    """Global positions held by shard ``idx`` in the zigzag layout: the
    sequence is cut into 2N blocks and shard i holds blocks (i, 2N-1-i),
    so every shard owns an equal share of early AND late positions."""
    half = s_local // 2
    lo = idx * half + torch.arange(half, device=device)
    hi = (2 * axis_size - 1 - idx) * half + torch.arange(half, device=device)
    return torch.cat([lo, hi])


def _zigzag_order(axis_size: int):
    order = []
    for i in range(axis_size):
        order += [i, 2 * axis_size - 1 - i]
    return order


def _zigzag_split(x, axis_size: int, axis: int):
    n2 = 2 * axis_size
    s = x.shape[axis]
    if s % n2:
        raise ValueError(
            f"zigzag layout needs the sequence ({s}) divisible by "
            f"2*axis_size ({n2})")
    return torch.chunk(x, n2, dim=axis)


def zigzag_shard(x, axis_size: int, axis: int = 1):
    """Reorder a GLOBAL sequence axis into zigzag shard order: after
    this, splitting the axis into ``axis_size`` equal chunks gives each
    shard its (i, 2N-1-i) block pair. Inverse: ``zigzag_unshard``."""
    blocks = _zigzag_split(x, axis_size, axis)
    return torch.cat([blocks[i] for i in _zigzag_order(axis_size)],
                     dim=axis)


def zigzag_unshard(x, axis_size: int, axis: int = 1):
    """Inverse of ``zigzag_shard``."""
    blocks = _zigzag_split(x, axis_size, axis)
    order = _zigzag_order(axis_size)
    inverse = [0] * len(order)
    for pos, blk in enumerate(order):
        inverse[blk] = pos
    return torch.cat([blocks[inverse[i]] for i in range(len(order))],
                     dim=axis)


def _half_attend(qh, kh, vh, sm_scale, mask, tri):
    """Attention of q rows over one K/V half-block (``tri``: the two
    blocks share a global offset, so causality is the plain triangle)."""
    return _block_attend(qh, kh, vh, sm_scale,
                         torch.arange(qh.shape[1], device=qh.device),
                         torch.arange(kh.shape[1], device=qh.device), tri,
                         mask)


def _merge_contrib(a, b):
    """Merge two online-softmax contributions for the same q rows."""
    acc_a, m_a, l_a = a
    acc_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    alpha = torch.exp(m_a - m)
    beta = torch.exp(m_b - m)
    return acc_a * alpha + acc_b * beta, m, l_a * alpha + l_b * beta


def _zigzag_causal_cases(q, k, v, key_mask, my_idx: int, src: int, attend):
    """Causal zigzag step computing ONLY the allowed half-block products
    (half a dense block per rank per step). With q halves (block i,
    block 2N-1-i) and the source's K/V halves (block j, block 2N-1-j):
      j == i: lo x lo triangular; hi x lo full; hi x hi triangular
      j <  i: both q halves attend lo fully (hi keys are all later)
      j >  i: only the hi queries attend, over both key halves fully
    ``attend(qh, kh, vh, mask_h, tri)`` returns one half-block's
    (acc, m, l); the dense and flash paths share this analysis."""
    b, s_local, hn, d = q.shape
    h = s_local // 2
    qlo, qhi = q[:, :h], q[:, h:]
    klo, khi = k[:, :h], k[:, h:]
    vlo, vhi = v[:, :h], v[:, h:]
    mlo = key_mask[:, :h] if key_mask is not None else None
    mhi = key_mask[:, h:] if key_mask is not None else None

    def none_rows(n):
        return (q.new_zeros((b, hn, n, d), dtype=torch.float32),
                q.new_full((b, hn, n, 1), NEG_INF / 2, dtype=torch.float32),
                q.new_zeros((b, hn, n, 1), dtype=torch.float32))

    def cat(lo, hi):
        return tuple(torch.cat([x, y], dim=2) for x, y in zip(lo, hi))

    if src == my_idx:
        lo = attend(qlo, klo, vlo, mlo, True)
        hi = _merge_contrib(attend(qhi, klo, vlo, mlo, False),
                            attend(qhi, khi, vhi, mhi, True))
        return cat(lo, hi)
    if src < my_idx:        # src holds a strictly earlier lo block
        return attend(q, klo, vlo, mlo, False)
    # Only the hi queries are late enough to see src's keys.
    return cat(none_rows(h), attend(qhi, k, v, key_mask, False))


class _FlashBlockPair(torch.autograd.Function):
    """``(out, lse)`` of one ring block through the flash kernels,
    forward AND backward: ``lse`` carries real gradient through the
    cross-block merge, and a cotangent on it is a per-row shift of the
    backward's delta (``flash_delta``), so the backward streams K/V tiles
    through kernels 2 and 3 instead of building the dense block."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        words = flash_call_words(q, mask)
        out, lse = _flash_forward(q, k, v, mask, causal, scale, words)
        ctx.save_for_backward(q, k, v, mask, words, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, mask, words, out, lse = ctx.saved_tensors
        if config.flash_xla_bwd():
            dq, dk, dv = _dense_vjp(
                lambda q_, k_, v_: flash_attention_forward_plain(
                    q_, k_, v_, mask, ctx.causal, ctx.scale),
                (q, k, v), (do, dlse))
        else:
            dq, dk, dv = _flash_backward(q, k, v, mask, out, lse,
                                         do.contiguous(), ctx.causal,
                                         ctx.scale, dlse=dlse, words=words)
        return dq, dk, dv, None, None, None


def _flash_contrib_triple(qh, kh, vh, mask_h, tri, scale):
    """One block (or zigzag half-block) through the flash kernels as an
    online-softmax triple for ``qh``'s rows: the normalised (out, lse)
    pair re-enters the merge as acc=out, m=lse, l=1. ``tri``: causality
    is the plain within-block triangle, the kernels' causal mode. A row
    with no allowed key has lse ~ NEG_INF and out 0, so it merges with
    weight 0 beside any block that has keys for it."""
    b, sq, hn, _ = qh.shape
    o, lse = _FlashBlockPair.apply(qh, kh, vh, mask_h, tri, scale)
    a = o.permute(0, 2, 1, 3).float()
    m = lse.reshape(b, hn, sq)[..., None]
    return a, m, torch.ones_like(m)


def ring_attention(q, k, v, group=None, causal: bool = False,
                   sm_scale: Optional[float] = None, key_mask=None,
                   layout: str = "contiguous", use_flash="auto"):
    """Attention over a sequence sharded over ``group`` (None: the
    job's world).

    Args (this rank's shards):
      q, k, v: (B, S_local, H, D); the global sequence is the shards in
        group-rank order. k/v may carry fewer (grouped) heads, H % Hkv
        == 0: the ring rotates K/V, so GQA cuts the bytes per step to
        Hkv/H, and the flash kernels route query-head groups natively
        (the dense path repeats locally).
      key_mask: optional (B, S_local) bool for the local keys.
      layout: "contiguous" (shard i holds positions [i*S_local, ...)) or
        "zigzag" (shard i holds blocks (i, 2N-1-i), see ``zigzag_shard``;
        balances causal work across ranks).
      use_flash: run each block through the flash kernels; "auto" from
        ``FLASH_AUTO_MIN_SEQ`` tokens per kernel call (S_local, or
        S_local/2 for causal zigzag, whose calls take half-blocks).
    Returns (B, S_local, H, D): attention of the local queries over the
    FULL sequence, in the layout of the inputs.
    """
    _check_gqa_heads(q, k, v, "ring_attention")
    n = group_size(group)
    my_idx = group_rank(group)
    b, s_local, hn, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring_attention layout: {layout!r}")
    if layout == "zigzag" and s_local % 2:
        raise ValueError(
            f"zigzag layout needs an even local sequence (got {s_local})")
    if use_flash == "auto":
        flash_tokens = (s_local // 2 if causal and layout == "zigzag"
                        else s_local)
        use_flash = flash_tokens >= FLASH_AUTO_MIN_SEQ

    def positions(idx):
        if layout == "zigzag":
            return zigzag_positions(idx, s_local, n, q.device)
        return idx * s_local + torch.arange(s_local, device=q.device)

    q_pos = positions(my_idx)

    def flash_half(qh, kh, vh, mh, tri):
        return _flash_contrib_triple(qh, kh, vh, mh, tri, scale)

    def dense_half(qh, kh, vh, mh, tri):
        return _half_attend(qh, kh, vh, scale, mh, tri)

    def contributions(k_blk, v_blk, mask_blk, src):
        """The block's (acc, m, l), or None where causality leaves it
        nothing to give."""
        if use_flash:
            if not causal:
                return flash_half(q, k_blk, v_blk, mask_blk, False)
            if layout == "zigzag":
                return _zigzag_causal_cases(q, k_blk, v_blk, mask_blk,
                                            my_idx, src, flash_half)
            # Contiguous causal: past blocks attend fully, the diagonal
            # block is intra-block causal, later blocks are skipped.
            if src < my_idx:
                return flash_half(q, k_blk, v_blk, mask_blk, False)
            if src == my_idx:
                return flash_half(q, k_blk, v_blk, mask_blk, True)
            return None
        if causal and layout == "zigzag":
            return _zigzag_causal_cases(q, k_blk, v_blk, mask_blk, my_idx,
                                        src, dense_half)
        if causal and src > my_idx:
            return None      # contiguous: the block lies wholly later
        return _block_attend(q, k_blk, v_blk, scale, q_pos, positions(src),
                             causal, mask_blk)

    m = q.new_full((b, hn, s_local, 1), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, hn, s_local, 1), dtype=torch.float32)
    acc = q.new_zeros((b, hn, s_local, d), dtype=torch.float32)
    # Step s holds the K/V (and mask) blocks of rank my_idx - s: the
    # ring's n - 1 hops, as one differentiable node under autograd (a
    # causal rank skips some blocks, yet must still pass their
    # cotangents along), one hop at a time without.
    kv = ring_rotations([k, v], group)
    masks = (ring_rotations([key_mask], group) if key_mask is not None
             else [[None]] * n)
    for step, ((k_blk, v_blk), (mask_blk,)) in enumerate(zip(kv, masks)):
        contrib = contributions(k_blk, v_blk, mask_blk, (my_idx - step) % n)
        if contrib is not None:
            a, bm, bl = contrib
            m_new = torch.maximum(m, bm)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(bm - m_new)
            l = l * alpha + bl * beta
            acc = acc * alpha + a * beta
            m = m_new

    out = acc / torch.clamp(l, min=1e-30)   # zeros for fully-masked rows
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _alltoall(x, group):
    if group_size(group) == 1:
        return x
    return _alltoall_equal(x.contiguous(), group)


def ulysses_attention(q, k, v, group=None, causal: bool = False,
                      sm_scale: Optional[float] = None, attention_fn=None):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): reshard
    (B, S_local, H, D) -> (B, S_global, H/N, D), attend over the full
    sequence with 1/N of the heads, reshard back. Two ``alltoall``s
    (each differentiable) replace N-1 ring hops. ``attention_fn``:
    ``(q, k, v, mask) -> ctx`` on the resharded tensors, default
    ``make_attention_fn(causal, sm_scale=...)`` (the flash kernels from
    ``FLASH_AUTO_MIN_SEQ`` tokens of the FULL sequence)."""
    n = group_size(group)
    hn = q.shape[2]
    _check_gqa_heads(q, k, v, "ulysses_attention")
    if hn % n or k.shape[2] % n:
        raise ValueError(
            f"ulysses_attention: query heads ({hn}) and K/V heads "
            f"({k.shape[2]}) must both divide by axis size ({n}); "
            "use ring_attention instead")

    def scatter_heads(x):
        # (B, S_l, H, D) -> blocks of H/N heads, block j to rank j ->
        # (B, N*S_l, H/N, D) with the sequence in rank order.
        b, s, h, d = x.shape
        blocks = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
        got = _alltoall(blocks.reshape(n * b, s, h // n, d), group)
        got = got.reshape(n, b, s, h // n, d).permute(1, 0, 2, 3, 4)
        return got.reshape(b, n * s, h // n, d)

    def gather_heads(x):
        b, sg, hl, d = x.shape
        s = sg // n
        blocks = x.reshape(b, n, s, hl, d).permute(1, 0, 2, 3, 4)
        got = _alltoall(blocks.reshape(n * b, s, hl, d), group)
        got = got.reshape(n, b, s, hl, d).permute(1, 2, 0, 3, 4)
        return got.reshape(b, s, n * hl, d)

    qg, kg, vg = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    if attention_fn is None:
        attention_fn = make_attention_fn(causal=causal, sm_scale=sm_scale)
    return gather_heads(attention_fn(qg, kg, vg, None))
