"""Collectives over ``torch.distributed`` — the port's counterpart of
``horovod_tpu/torch/mpi_ops.py`` with the semantics of
``horovod_tpu/ops/collective_ops.py``.

Sync, async and in-place variants of ``allreduce``, ``grouped_allreduce``,
``allgather`` and ``broadcast``; ``synchronize``/``poll`` on handles;
``barrier``. Each runs on the tensor's own device over the process group
``init()`` built (NCCL on a card, gloo on the CPU). ``average=`` and
``op=`` (``Sum``/``Average``) are exclusive; neither means Average.
``name`` is accepted for the JAX package's signatures. At size 1 every
op is the identity (the out-of-place ones return a copy), as in the JAX
package. ``reducescatter``, ``alltoall`` and the object collectives are
not ported yet.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ..common import basics

Sum = "Sum"
Average = "Average"


class Handle:
    """An in-flight collective: ``wait()`` joins it and returns its
    result; ``done()`` polls."""

    def __init__(self, result: torch.Tensor, work=None,
                 finish: Optional[Callable[[], torch.Tensor]] = None,
                 tensor_sizes: Optional[List[int]] = None):
        self._result = result
        self._work = work
        self._finish = finish
        self.tensor_sizes = tensor_sizes

    def done(self) -> bool:
        return self._work is None or self._work.is_completed()

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._finish is not None:
            self._result = self._finish()
            self._finish = None
        return self._result


def _resolve_average(average: Optional[bool], op: Optional[str]) -> bool:
    if op is not None:
        if average is not None:
            raise ValueError("specify either average= or op=, not both")
        if op not in (Sum, Average):
            raise ValueError(f"op must be Sum or Average, got {op!r}")
        return op == Average
    return True if average is None else bool(average)


def _size() -> int:
    return basics.size()


def _check_root(root_rank: int) -> None:
    if not 0 <= root_rank < _size():
        raise ValueError(
            f"root_rank {root_rank} out of range for size {_size()}")


def _reduce(buf: torch.Tensor, avg: bool, result: torch.Tensor) -> Handle:
    """Sum ``buf`` across ranks in place; on join divide by the size when
    averaging (integers with floor division) and return ``result``."""
    work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, async_op=True)
    n = _size()

    def finish():
        if avg:
            if buf.is_floating_point() or buf.is_complex():
                buf.div_(n)
            else:
                buf.floor_divide_(n)
        return result

    return Handle(result, work, finish)


def allreduce_async(tensor: torch.Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None,
                    op: Optional[str] = None) -> Handle:
    """Mean (or sum) of ``tensor`` over all ranks, into a new tensor."""
    avg = _resolve_average(average, op)
    out = tensor.detach().clone()
    if _size() == 1:
        return Handle(out)
    return _reduce(out, avg, out)


def allreduce_async_(tensor: torch.Tensor, average: Optional[bool] = None,
                     name: Optional[str] = None,
                     op: Optional[str] = None) -> Handle:
    """In-place :func:`allreduce_async`: ``tensor`` receives the result."""
    avg = _resolve_average(average, op)
    if _size() == 1:
        return Handle(tensor)
    return _reduce(tensor.detach(), avg, tensor)


def grouped_allreduce_async(tensors, average: Optional[bool] = None,
                            name: Optional[str] = None,
                            op: Optional[str] = None) -> list:
    """One handle per member of the list, in order."""
    if not isinstance(tensors, (list, tuple)):
        raise TypeError(
            "grouped_allreduce_async expects a list/tuple of tensors")
    avg = _resolve_average(average, op)
    return [allreduce_async(t, average=avg) for t in tensors]


def grouped_allreduce(tensors, average: Optional[bool] = None,
                      name: Optional[str] = None,
                      op: Optional[str] = None) -> list:
    """Allreduce a list of tensors; returns new tensors in order."""
    return [h.wait() for h in grouped_allreduce_async(tensors, average,
                                                      name, op)]


def grouped_allreduce_(tensors, average: Optional[bool] = None,
                       name: Optional[str] = None,
                       op: Optional[str] = None) -> list:
    """In-place grouped allreduce: each tensor receives its result."""
    if not isinstance(tensors, (list, tuple)):
        raise TypeError("grouped_allreduce_ expects a list/tuple of tensors")
    avg = _resolve_average(average, op)
    handles = [allreduce_async_(t, average=avg) for t in tensors]
    return [h.wait() for h in handles]


def allgather_async(tensor: torch.Tensor,
                    name: Optional[str] = None) -> Handle:
    """Concatenation of ``tensor`` from all ranks along dim 0, in rank
    order; ranks may contribute different first dims."""
    t = tensor.detach()
    if _size() == 1:
        return Handle(t.clone(), tensor_sizes=[t.shape[0]])
    n = _size()
    mine = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(sizes, mine)
    sizes = [int(s) for s in sizes]
    longest = max(sizes)
    if t.shape[0] < longest:
        pad = t.new_zeros((longest - t.shape[0],) + tuple(t.shape[1:]))
        t = torch.cat([t, pad])
    parts = [torch.empty_like(t) for _ in range(n)]
    work = dist.all_gather(parts, t.contiguous(), async_op=True)
    return Handle(None, work,
                  lambda: torch.cat([p[:s] for p, s in zip(parts, sizes)]),
                  tensor_sizes=sizes)


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None) -> Handle:
    """Root's ``tensor`` on every rank, into a new tensor."""
    _check_root(root_rank)
    out = tensor.detach().clone()
    if _size() == 1:
        return Handle(out)
    return Handle(out, dist.broadcast(out, src=root_rank, async_op=True))


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> Handle:
    """In-place :func:`broadcast_async`."""
    _check_root(root_rank)
    if _size() == 1:
        return Handle(tensor)
    return Handle(tensor, dist.broadcast(tensor.detach(), src=root_rank,
                                         async_op=True))


def synchronize(handle: Handle) -> torch.Tensor:
    """Join an async op and return its result."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    return handle.done()


def barrier(name: Optional[str] = None) -> None:
    """Block until every rank has reached the barrier."""
    if _size() > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# autograd-aware sync ops


class _AllreduceFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, average, name):
        ctx.average = average
        return allreduce_async(tensor, average, name).wait()

    @staticmethod
    def backward(ctx, grad_output):
        # The gradient of a sum/mean over ranks is the same reduction of
        # the upstream gradient.
        return allreduce_async(grad_output, ctx.average).wait(), None, None


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, compression=None,
              op: Optional[str] = None) -> torch.Tensor:
    avg = _resolve_average(average, op)
    if compression is not None:
        compressed, cctx = compression.compress(tensor)
        out = _AllreduceFunction.apply(compressed, avg, name)
        return compression.decompress(out, cctx)
    return _AllreduceFunction.apply(tensor, avg, name)


def allreduce_(tensor: torch.Tensor, average: Optional[bool] = None,
               name: Optional[str] = None,
               op: Optional[str] = None) -> torch.Tensor:
    return allreduce_async_(tensor, average, name, op).wait()


class _AllgatherFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, name):
        handle = allgather_async(tensor, name)
        result = handle.wait()
        ctx.dim0 = tensor.shape[0]
        ctx.offset = sum(handle.tensor_sizes[:basics.rank()])
        return result

    @staticmethod
    def backward(ctx, grad_output):
        # Sum the gathered gradient over ranks, then take this rank's rows.
        grad = allreduce_async(grad_output, average=False).wait()
        return grad[ctx.offset:ctx.offset + ctx.dim0], None


def allgather(tensor: torch.Tensor, name: Optional[str] = None):
    return _AllgatherFunction.apply(tensor, name)


class _BroadcastFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        return broadcast_async(tensor, root_rank, name).wait()

    @staticmethod
    def backward(ctx, grad_output):
        # Gradients reduce to the root; other ranks' inputs get zero.
        grad = allreduce_async(grad_output, average=False).wait()
        if basics.rank() != ctx.root_rank:
            grad = grad * 0
        return grad, None, None


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    return _BroadcastFunction.apply(tensor, root_rank, name)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    return broadcast_async_(tensor, root_rank, name).wait()
