"""The neighbour exchange — the port's counterpart of ``lax.ppermute``
over a ring, which ``parallel/sequence.py`` (K/V rotation, the loss's
next-token fetch) and ``parallel/pipeline.py`` (activations forward,
cotangents back) build on — and the differentiable group sums the
parallel modes share (``group_sum``, ``group_copy``,
``group_gather_last``: ``lax.psum`` and friends with the gradients a
per-rank backward needs).

``ring_exchange(tensors, group, shift)``: group member ``i`` sends each
tensor to member ``(i + shift) % n`` and receives the one member
``(i - shift) % n`` sent, through one ``dist.batch_isend_irecv``.
Differentiable for floating tensors: the backward sends the cotangents
the other way. ``ring_rotations`` gives all ``n`` rotations at once, as
one autograd node, for callers (ring attention) whose ranks use
different subsets of them.

Transport: NCCL (or gloo on the CPU) moves the tensors as they are.
A gloo group cannot move a CUDA tensor point to point (its TCP pairs
read the device pointer as host memory and the process aborts), and
gloo is what two processes sharing one card must use, since NCCL
refuses two ranks on one device. So for a gloo group only, CUDA
tensors are staged through host memory inside this exchange: copied to
the CPU, exchanged, copied back. Nothing else takes that route.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Sequence

import torch
import torch.distributed as dist

from .mesh import global_rank, group_rank, group_size


def stages_through_host(group, tensor: torch.Tensor) -> bool:
    """True when the exchange stages ``tensor`` through host memory: a
    CUDA tensor on a gloo group."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def _shift(tensors: Sequence[torch.Tensor], group,
           shift: int) -> List[torch.Tensor]:
    n = group_size(group)
    i = group_rank(group)
    dst = global_rank(group, (i + shift) % n)
    src = global_rank(group, (i - shift) % n)
    staged = stages_through_host(group, tensors[0])
    send = [(t.detach().cpu() if staged else t.detach()).contiguous()
            for t in tensors]
    send = [t.view(torch.uint8) if t.dtype == torch.bool else t
            for t in send]
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for s, r in zip(send, recv):
        ops.append(dist.P2POp(dist.isend, s, dst, group))
        ops.append(dist.P2POp(dist.irecv, r, src, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = []
    for t, r in zip(tensors, recv):
        if t.dtype == torch.bool:
            r = r.view(torch.bool)
        out.append(r.to(t.device) if staged else r)
    return out


class _RingExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *tensors):
        ctx.group, ctx.shift = group, shift
        return tuple(_shift(tensors, group, shift))

    @staticmethod
    def backward(ctx, *grads):
        back = _shift([g.contiguous() for g in grads], ctx.group,
                      -ctx.shift)
        return (None, None, *back)


def ring_exchange(tensors: Sequence[torch.Tensor], group=None,
                  shift: int = 1) -> List[torch.Tensor]:
    """Send every tensor ``shift`` places along the ring of ``group``
    (None: the job's world) and return what arrived, in the same order.
    Floating tensors that require grad get the reverse exchange as
    their backward; ints and bools ride along without one. At size 1
    the tensors come back as copies."""
    tensors = list(tensors)
    if group_size(group) == 1:
        return [t.clone() for t in tensors]
    if any(t.requires_grad for t in tensors) and torch.is_grad_enabled():
        if not all(t.is_floating_point() for t in tensors):
            raise ValueError("ring_exchange: exchange integer or bool "
                             "tensors in a call of their own when others "
                             "carry gradients")
        return list(_RingExchange.apply(group, shift, *tensors))
    return _shift(tensors, group, shift)


class _RingRotations(torch.autograd.Function):
    """Every rotation of the inputs, as one node: its backward runs
    whenever any rotation is used (the rotation 0 is the input itself),
    so every rank takes part in all n - 1 reverse exchanges even where
    its own later rotations feed nothing (a causal ring's first rank)."""

    @staticmethod
    def forward(ctx, group, count, *tensors):
        ctx.group, ctx.count = group, count
        n = group_size(group)
        steps = [list(tensors)]
        for _ in range(n - 1):
            steps.append(_shift(steps[-1], group, 1))
        return tuple(t.view_as(t) if s == 0 else t
                     for s, step in enumerate(steps) for t in step)

    @staticmethod
    def backward(ctx, *grads):
        count = ctx.count
        n = len(grads) // count
        acc = [g.contiguous() for g in grads[(n - 1) * count:]]
        for s in range(n - 1, 0, -1):
            # acc holds the cotangents of rotation s, which came from s
            # ranks back: one step back along the ring, plus rotation
            # s - 1's own.
            back = _shift(acc, ctx.group, -1)
            acc = [a + g for a, g in zip(
                back, grads[(s - 1) * count:s * count])]
        return (None, None, *acc)


def _streamed_rotations(tensors, group, n) -> Iterator[List[torch.Tensor]]:
    step = tensors
    for s in range(n):
        yield step
        if s + 1 < n:
            step = _shift(step, group, 1)


def ring_rotations(tensors: Sequence[torch.Tensor],
                   group=None) -> Iterable[List[torch.Tensor]]:
    """The ``n`` rotations of ``tensors`` around ``group``'s ring, in
    order: rotation ``s`` holds what member ``i - s`` passed in (rotation
    0 the inputs), as ``s`` calls of :func:`ring_exchange` give it.

    With gradients, all of them at once as one autograd node (see
    ``_RingRotations``; the backward keeps them all anyway): the form to
    use where a rank may leave some rotations unused, since a chain of
    separate exchanges would then skip that rank's share of the
    backward. Without, an iterator that makes each hop when the caller
    reaches it, so one rotation is live at a time."""
    tensors = list(tensors)
    n = group_size(group)
    if n == 1:
        return [tensors]
    if any(t.requires_grad for t in tensors) and torch.is_grad_enabled():
        if not all(t.is_floating_point() for t in tensors):
            raise ValueError("ring_rotations: rotate integer or bool "
                             "tensors in a call of their own when others "
                             "carry gradients")
        flat = _RingRotations.apply(group, len(tensors), *tensors)
        k = len(tensors)
        return [list(flat[s * k:(s + 1) * k]) for s in range(n)]
    return _streamed_rotations(tensors, group, n)


# ---------------------------------------------------------------------------
# Group sums with per-rank gradients


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GroupCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GroupGatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(group_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.rank, ctx.width = group_rank(group), x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.width:(ctx.rank + 1) * ctx.width], None


def group_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over ``group``. Backward: the identity — each rank's
    term of the sum receives the sum's gradient as it is (the right rule
    when every rank goes on to compute the same loss from the sum)."""
    if group_size(group) == 1:
        return x
    return _GroupSum.apply(x, group)


def group_copy(x: torch.Tensor, group=None) -> torch.Tensor:
    """The identity. Backward: the sum over ``group`` — the entry of a
    sharded computation whose ranks each see part of the input's
    gradient (Megatron's ``f``; ``group_sum`` is its ``g``)."""
    if group_size(group) == 1:
        return x
    return _GroupCopy.apply(x, group)


def group_gather_last(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's slices concatenated along the last dim, in rank
    order. Backward: this rank's slice of the gradient."""
    if group_size(group) == 1:
        return x
    return _GroupGatherLast.apply(x, group)
