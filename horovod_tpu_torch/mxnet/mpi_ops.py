"""MXNet collective ops over the port's eager tier — the counterpart of
``horovod_tpu/mxnet/mpi_ops.py``.

Same surface: ``allreduce``, ``allreduce_``, ``allreduce_async_``,
``allgather``, ``broadcast``, ``broadcast_``, ``broadcast_async_`` each
taking ``(tensor, ..., name, priority)``, and ``synchronize``. An NDArray
crosses to the controller (``common.basics.controller()``) as numpy,
then a CPU torch tensor, and the result comes back into an NDArray in
the tensor's context: MXNet arrays live in host memory here, device math
belongs to the torch tier, so ``init`` binds the CPU.

``priority`` is accepted for API parity. The reference forwards it to
the MXNet engine's scheduler; the controller negotiates readiness per
cycle the same way regardless of the hint, so it is a no-op here
(documented, not silent).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..common import basics
from ..common.basics import (  # noqa: F401  (re-exported, API parity)
    shutdown, rank, size, local_rank, local_size, mpi_threads_supported,
)


def init(ranks=None, device="cpu") -> None:
    """``hvd.init`` on the CPU: NDArrays live in host memory, and the
    job's ranks need no card (several may share a host's one)."""
    basics.init(ranks, device=device)


def _mx():
    import mxnet as mx
    return mx


def _to_torch(tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(tensor.asnumpy()))


def _to_numpy(value) -> np.ndarray:
    return value.detach().cpu().numpy() if torch.is_tensor(value) \
        else np.asarray(value)


def _new_like(tensor, arr: np.ndarray):
    """A fresh NDArray holding ``arr`` in ``tensor``'s context."""
    mx = _mx()
    kwargs = {}
    ctx = getattr(tensor, "context", None) or getattr(tensor, "ctx", None)
    if ctx is not None:
        kwargs["ctx"] = ctx
    return mx.nd.array(arr, dtype=arr.dtype, **kwargs)


def _copy_into(tensor, value):
    tensor[:] = _to_numpy(value).reshape(tensor.shape)
    return tensor


def _controller():
    return basics.controller()


class _Pending:
    """A controller handle whose result lands in an NDArray when waited
    on (the reference's engine push writes in place)."""

    def __init__(self, handle, finish: Callable):
        self._handle, self._finish = handle, finish

    def wait(self):
        return self._finish(self._handle.wait())


def allreduce(tensor, average: bool = True, name: Optional[str] = None,
              priority: int = 0):
    """Sum/average ``tensor`` across ranks; returns a new NDArray."""
    if basics.size() == 1:
        return _new_like(tensor, tensor.asnumpy())
    out = _controller().allreduce(_to_torch(tensor), average=average,
                                  name=name)
    return _new_like(tensor, _to_numpy(out))


def allreduce_(tensor, average: bool = True, name: Optional[str] = None,
               priority: int = 0):
    """In-place allreduce."""
    synchronize(allreduce_async_(tensor, average=average, name=name,
                                 priority=priority))
    return tensor


def allreduce_async_(tensor, average: bool = True,
                     name: Optional[str] = None, priority: int = 0):
    """Enqueue an in-place allreduce; returns a handle for
    ``synchronize`` (None at size 1). Enqueueing a batch of gradients
    through this lets tensor fusion pack them into one collective."""
    if basics.size() == 1:
        return None
    return _Pending(_controller().allreduce_async(
        _to_torch(tensor), average=average, name=name),
        lambda out: _copy_into(tensor, out))


def broadcast_async_(tensor, root_rank: int, name: Optional[str] = None,
                     priority: int = 0):
    """Enqueue an in-place broadcast; returns a handle for
    ``synchronize`` (None at size 1)."""
    if basics.size() == 1:
        if root_rank != 0:
            raise ValueError(f"root_rank {root_rank} out of range for size 1")
        return None
    return _Pending(_controller().broadcast_async(
        _to_torch(tensor), root_rank=root_rank, name=name),
        lambda out: _copy_into(tensor, out))


def synchronize(handles):
    """Wait for one handle or a list of them (None entries are size-1
    no-ops)."""
    if handles is None:
        return
    if not isinstance(handles, (tuple, list)):
        handles = [handles]
    for h in handles:
        if h is not None:
            h.wait()


def allgather(tensor, name: Optional[str] = None, priority: int = 0):
    """Concatenate ``tensor`` from all ranks along the first dimension;
    first dims may differ per rank."""
    if basics.size() == 1:
        return _new_like(tensor, tensor.asnumpy())
    out = _controller().allgather(_to_torch(tensor), name=name)
    return _new_like(tensor, _to_numpy(out))


def broadcast(tensor, root_rank: int, name: Optional[str] = None,
              priority: int = 0):
    """Broadcast from ``root_rank``; returns a new NDArray."""
    if basics.size() == 1:
        if root_rank != 0:
            raise ValueError(f"root_rank {root_rank} out of range for size 1")
        return _new_like(tensor, tensor.asnumpy())
    out = _controller().broadcast(_to_torch(tensor), root_rank=root_rank,
                                  name=name)
    return _new_like(tensor, _to_numpy(out))


def broadcast_(tensor, root_rank: int, name: Optional[str] = None,
               priority: int = 0):
    """In-place broadcast."""
    synchronize(broadcast_async_(tensor, root_rank=root_rank, name=name,
                                 priority=priority))
    return tensor
