"""Collectives over ``torch.distributed`` — the port's counterpart of
``horovod_tpu/torch/mpi_ops.py`` with the semantics of
``horovod_tpu/ops/collective_ops.py``.

Sync, async and in-place variants of ``allreduce``, ``grouped_allreduce``,
``allgather`` and ``broadcast``; ``reducescatter`` and ``alltoall``
(differentiable); ``broadcast_object`` and ``allgather_object``;
``synchronize``/``poll`` on handles; ``barrier``. Each runs on the tensor's own device over the process group
``init()`` built (NCCL on a card, gloo on the CPU), or over ``group=``
(a ``torch.distributed`` process group, e.g. one axis of
``parallel.make_mesh``) where the reductions and gathers take one: the
counterpart of the JAX package's ``axis_name=``. ``average=`` and
``op=`` (``Sum``/``Average``) are exclusive; neither means Average.
``name`` is accepted for the JAX package's signatures. At size 1 every
op is the identity (the out-of-place ones return a copy; the object
collectives a pickled round trip), as in the JAX package.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, List, Optional

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


def _size(group=None) -> int:
    return basics.size() if group is None else dist.get_world_size(group)


def _rank(group=None) -> int:
    return basics.rank() if group is None else dist.get_rank(group)


def _check_root(root_rank: int) -> None:
    if not 0 <= root_rank < _size():
        raise ValueError(
            f"root_rank {root_rank} out of range for size {_size()}")


def _reduce(buf: torch.Tensor, avg: bool, result: torch.Tensor,
            group=None) -> Handle:
    """Sum ``buf`` across ranks in place; on join divide by the size when
    averaging (integers with floor division) and return ``result``."""
    work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group,
                           async_op=True)
    n = _size(group)

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
                    op: Optional[str] = None, group=None) -> Handle:
    """Mean (or sum) of ``tensor`` over all ranks (of ``group``), into a
    new tensor."""
    avg = _resolve_average(average, op)
    out = tensor.detach().clone()
    if _size(group) == 1:
        return Handle(out)
    return _reduce(out, avg, out, group)


def allreduce_async_(tensor: torch.Tensor, average: Optional[bool] = None,
                     name: Optional[str] = None,
                     op: Optional[str] = None, group=None) -> Handle:
    """In-place :func:`allreduce_async`: ``tensor`` receives the result."""
    avg = _resolve_average(average, op)
    if _size(group) == 1:
        return Handle(tensor)
    return _reduce(tensor.detach(), avg, tensor, group)


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


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    group=None) -> Handle:
    """Concatenation of ``tensor`` from all ranks (of ``group``) along dim
    0, in rank order; ranks may contribute different first dims."""
    t = tensor.detach()
    n = _size(group)
    if n == 1:
        return Handle(t.clone(), tensor_sizes=[t.shape[0]])
    mine = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(sizes, mine, group=group)
    sizes = [int(s) for s in sizes]
    longest = max(sizes)
    if t.shape[0] < longest:
        pad = t.new_zeros((longest - t.shape[0],) + tuple(t.shape[1:]))
        t = torch.cat([t, pad])
    parts = [torch.empty_like(t) for _ in range(n)]
    work = dist.all_gather(parts, t.contiguous(), group=group,
                           async_op=True)
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
    def forward(ctx, tensor, average, name, group):
        ctx.average, ctx.group = average, group
        return allreduce_async(tensor, average, name, group=group).wait()

    @staticmethod
    def backward(ctx, grad_output):
        # The gradient of a sum/mean over ranks is the same reduction of
        # the upstream gradient.
        return (allreduce_async(grad_output, ctx.average,
                                group=ctx.group).wait(), None, None, None)


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, compression=None,
              op: Optional[str] = None, group=None) -> torch.Tensor:
    avg = _resolve_average(average, op)
    if compression is not None:
        compressed, cctx = compression.compress(tensor)
        out = _AllreduceFunction.apply(compressed, avg, name, group)
        return compression.decompress(out, cctx)
    return _AllreduceFunction.apply(tensor, avg, name, group)


def allreduce_(tensor: torch.Tensor, average: Optional[bool] = None,
               name: Optional[str] = None,
               op: Optional[str] = None, group=None) -> torch.Tensor:
    return allreduce_async_(tensor, average, name, op, group).wait()


class _AllgatherFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, name, group):
        handle = allgather_async(tensor, name, group)
        result = handle.wait()
        ctx.dim0, ctx.group = tensor.shape[0], group
        ctx.offset = sum(handle.tensor_sizes[:_rank(group)])
        return result

    @staticmethod
    def backward(ctx, grad_output):
        # Sum the gathered gradient over ranks, then take this rank's rows.
        grad = allreduce_async(grad_output, average=False,
                               group=ctx.group).wait()
        return grad[ctx.offset:ctx.offset + ctx.dim0], None, None


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              group=None):
    return _AllgatherFunction.apply(tensor, name, group)


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


# ---------------------------------------------------------------------------
# reducescatter, alltoall and the object collectives
# (``horovod_tpu/ops/collective_ops.py:325-438`` with the semantics of
# ``controller.composed_reducescatter`` / ``composed_alltoall``)


def _require_dim(tensor: torch.Tensor, op: str) -> None:
    # Before any size-1 shortcut: what raises must not depend on the size.
    if tensor.ndim == 0:
        raise ValueError(
            f"{op} requires at least one dimension (got a scalar)")


def _split_counts(n: int, size: int) -> List[int]:
    """``np.array_split``'s block sizes: the lower ranks get the larger
    blocks."""
    base, rem = divmod(n, size)
    return [base + (1 if r < rem else 0) for r in range(size)]


class _Identity(torch.autograd.Function):
    """A copy whose gradient passes through: the size-1 collectives."""

    @staticmethod
    def forward(ctx, tensor):
        return tensor.detach().clone()

    @staticmethod
    def backward(ctx, grad_output):
        return grad_output


class _ReducescatterFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, average, group):
        ctx.average, ctx.group = average, group
        full = allreduce_async(tensor, average, group=group).wait()
        counts = _split_counts(tensor.shape[0], _size(group))
        rank = _rank(group)
        off = sum(counts[:rank])
        return full[off:off + counts[rank]].clone()

    @staticmethod
    def backward(ctx, grad_output):
        # Every rank's input reaches every block: gather the blocks' cotangents
        # back to full length, scaled as the forward reduction was.
        grad = allgather_async(grad_output.contiguous(),
                               group=ctx.group).wait()
        if ctx.average:
            grad = grad / _size(ctx.group)
        return grad, None, None


def reducescatter(tensor: torch.Tensor, average: Optional[bool] = None,
                  op: Optional[str] = None,
                  name: Optional[str] = None, group=None) -> torch.Tensor:
    """Reduce over ranks (mean by default), then keep this rank's block
    of dim 0; an uneven dim 0 splits like ``np.array_split``.
    Differentiable: the backward gathers the blocks' gradients."""
    avg = _resolve_average(average, op)
    _require_dim(tensor, "reducescatter")
    if _size(group) == 1:
        return _Identity.apply(tensor)
    return _ReducescatterFunction.apply(tensor, avg, group)


def _alltoall_splits(tensor: torch.Tensor, group) -> List[int]:
    """Every rank's dim 0, agreed through an allgather so that an
    indivisible one raises the same error on every rank (instead of
    hanging the exchange)."""
    n = dist.get_world_size(group)
    mine = torch.tensor([tensor.shape[0]], dtype=torch.int64,
                        device=tensor.device)
    dims = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(dims, mine, group=group)
    dims = [int(d) for d in dims]
    for r, d in enumerate(dims):
        if d % n:
            raise ValueError(
                f"alltoall requires every rank's first dimension to be "
                f"divisible by size {n}; rank {r} has dim 0 = {d}")
    return dims


def _exchange(tensor: torch.Tensor, send: List[int], recv: List[int],
              group) -> torch.Tensor:
    out = tensor.new_empty((sum(recv),) + tuple(tensor.shape[1:]))
    dist.all_to_all_single(out, tensor.contiguous(), output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out


class _AlltoallFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group, equal):
        n = dist.get_world_size(group)
        dims = ([tensor.shape[0]] * n if equal
                else _alltoall_splits(tensor, group))
        send = [tensor.shape[0] // n] * n
        recv = [d // n for d in dims]
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return _exchange(tensor.detach(), send, recv, group)

    @staticmethod
    def backward(ctx, grad_output):
        # The inverse exchange: block j of the output came from rank j.
        return (_exchange(grad_output, ctx.recv, ctx.send, ctx.group),
                None, None)


def alltoall(tensor: torch.Tensor, name: Optional[str] = None,
             group=None) -> torch.Tensor:
    """Exchange dim-0 blocks: rank r's result is the concatenation, in
    rank order, of every rank's r-th block. Each rank's own dim 0 must
    be divisible by the size (block sizes may differ between ranks).
    Differentiable: the backward is the inverse exchange. ``group``: a
    ``torch.distributed`` process group (None: the job's)."""
    _require_dim(tensor, "alltoall")
    size = _size() if group is None else dist.get_world_size(group)
    if size == 1:
        return _Identity.apply(tensor)
    return _AlltoallFunction.apply(tensor, group, False)


def _alltoall_equal(tensor: torch.Tensor, group) -> torch.Tensor:
    """:func:`alltoall` for a caller that knows every rank's dim 0 is the
    same multiple of the group's size (``moe_apply``'s ``[E, C, D]``
    buffers, E the group's size): no agreement round, so no extra
    collective and no host sync per exchange."""
    if dist.get_world_size(group) == 1:
        return _Identity.apply(tensor)
    return _AlltoallFunction.apply(tensor, group, True)


def _byte_tensor(payload: bytes) -> torch.Tensor:
    dev = basics.device()
    return torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """Root's picklable ``obj`` on every rank: the pickled length first,
    then the bytes. Unpickling trusts the job's own ranks."""
    _check_root(root_rank)
    if _size() == 1:
        return pickle.loads(pickle.dumps(obj))
    dev = basics.device()
    if basics.rank() == root_rank:
        payload = _byte_tensor(pickle.dumps(obj))
        length = torch.tensor([payload.numel()], dtype=torch.int64,
                              device=dev)
    else:
        payload = None
        length = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(length, src=root_rank)
    if payload is None:
        payload = torch.empty(int(length[0]), dtype=torch.uint8, device=dev)
    dist.broadcast(payload, src=root_rank)
    return pickle.loads(payload.cpu().numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None) -> list:
    """One picklable object per rank, in rank order: the lengths are
    gathered first, then the bytes (padded to the longest)."""
    if _size() == 1:
        return [pickle.loads(pickle.dumps(obj))]
    blob = allgather_async(_byte_tensor(pickle.dumps(obj)))
    data = blob.wait().cpu().numpy()
    out, off = [], 0
    for n in blob.tensor_sizes:
        out.append(pickle.loads(data[off:off + n].tobytes()))
        off += n
    return out
