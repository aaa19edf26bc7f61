"""PyTorch user API: ``import horovod_tpu_torch as hvd`` (the package root
re-exports this module) — the port's counterpart of
``horovod_tpu/torch/__init__.py``: ``DistributedOptimizer`` with
per-parameter gradient hooks, ``broadcast_parameters``,
``broadcast_optimizer_state`` and the collectives of ``.mpi_ops``, on the
card through NCCL.
"""

from __future__ import annotations

import collections

import torch

from ..common.basics import (  # noqa: F401
    cross_rank,
    cross_size,
    device,
    init,
    is_initialized,
    local_num_devices,
    local_rank,
    local_size,
    num_devices,
    rank,
    shutdown,
    size,
)
from .compression import Compression  # noqa: F401
from .mpi_ops import (  # noqa: F401
    Average,
    Handle,
    Sum,
    allgather,
    allgather_async,
    allgather_object,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    broadcast_object,
    grouped_allreduce,
    grouped_allreduce_,
    grouped_allreduce_async,
    poll,
    reducescatter,
    synchronize,
)

__all__ = [
    "init", "shutdown", "is_initialized", "device", "rank", "size",
    "local_rank", "local_size", "cross_rank", "cross_size", "num_devices",
    "local_num_devices", "Compression", "Sum", "Average", "Handle",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_", "grouped_allreduce_async",
    "allgather", "allgather_async", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "synchronize", "poll", "barrier",
    "reducescatter", "alltoall", "broadcast_object", "allgather_object",
    "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state",
]


class _DistributedOptimizer(torch.optim.Optimizer):
    """Fires ``allreduce_async_`` per parameter as soon as its gradient
    is accumulated (``register_post_accumulate_grad_hook``), then joins
    the handles in ``step()``."""

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1, group=None):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._group = group
        self._reduces = (size() if group is None
                         else torch.distributed.get_world_size(group)) > 1

        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [
                (f"allreduce.param_group_{gi}.param_{pi}", p)
                for gi, group in enumerate(self.param_groups)
                for pi, p in enumerate(group["params"])
            ]
        all_params = {
            id(p) for group in self.param_groups for p in group["params"]}
        dups = _find_duplicates([name for name, _ in named_parameters])
        if dups:
            raise ValueError(
                f"named_parameters contains duplicate names: {sorted(dups)}")
        named_ids = {id(p) for _, p in named_parameters}
        if len(named_parameters) != len(all_params & named_ids):
            raise ValueError(
                "named_parameters must cover exactly the parameters passed "
                "to the optimizer")

        self._parameter_names = {id(p): name for name, p in named_parameters}
        self._handles = {}
        self._grad_accs = []
        self._backward_count = collections.defaultdict(int)
        if self._reduces:
            self._register_hooks()

    def _register_hooks(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self._grad_accs.append(
                        p.register_post_accumulate_grad_hook(self._make_hook()))

    def _make_hook(self):
        def hook(p):
            self._backward_count[id(p)] += 1
            if self._backward_count[id(p)] % self.backward_passes_per_step == 0:
                name = self._parameter_names.get(id(p))
                compressed, ctx = self._compression.compress(p.grad)
                handle = allreduce_async_(compressed, average=True, name=name,
                                          group=self._group)
                self._handles[p] = (handle, ctx, compressed)
        return hook

    def synchronize(self):
        """Join every in-flight gradient reduction."""
        for p, (handle, ctx, compressed) in list(self._handles.items()):
            synchronize(handle)
            if compressed is not p.grad:
                with torch.no_grad():
                    p.grad.copy_(self._compression.decompress(compressed, ctx))
        self._handles.clear()

    def step(self, closure=None):
        if self._reduces:
            self.synchronize()
        return super(self.__class__, self).step(closure)


def _find_duplicates(names):
    seen, dups = set(), set()
    for n in names:
        if n in seen:
            dups.add(n)
        seen.add(n)
    return dups


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1, group=None):
    """Wrap a torch optimizer with cross-rank gradient averaging: a
    subclass of the optimizer's own class, so user code keeps its API.
    ``group``: average over this process group only (the JAX
    ``DistributedOptimizer``'s ``axis_name``, e.g. the ``data`` axis of
    a ``data x seq`` mesh); None averages over the whole job."""
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, group)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """In-place broadcast of a ``state_dict`` or an iterable of
    ``(name, tensor)``."""
    items = sorted(params.items()) if isinstance(params, dict) \
        else list(params)
    handles = [broadcast_async_(p, root_rank, name=f"broadcast.{name}")
               for name, p in items if p is not None]
    for h in handles:
        synchronize(h)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast optimizer state from root so every rank resumes
    identically (state not yet created is materialised by a zero-gradient
    step first; scalars travel as tensors and keep their Python type)."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")

    state_dict = optimizer.state_dict()
    if not state_dict["state"]:
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and p.grad is None:
                    p.grad = p.data.new_zeros(p.size())
        optimizer.step()
        state_dict = optimizer.state_dict()

    tensors, scalars = {}, {}
    for pid, pstate in state_dict["state"].items():
        for key, value in pstate.items():
            name = f"optimizer.{pid}.{key}"
            if torch.is_tensor(value):
                tensors[name] = value
            else:
                scalars[name] = (pstate, key, value)

    # State may live off the bound device (torch keeps AdamW's ``step`` on
    # the CPU); NCCL moves only device tensors, so those travel as copies.
    pending = []
    for name, t in sorted(tensors.items()):
        buf = t.to(device())
        pending.append((t, buf, broadcast_async_(buf, root_rank, name=name)))
    for t, buf, h in pending:
        synchronize(h)
        if buf is not t:
            t.copy_(buf)
    for name, (pstate, key, value) in sorted(scalars.items()):
        t = torch.tensor(float(value), dtype=torch.float64,
                         device=device())
        pstate[key] = type(value)(broadcast(t, root_rank, name=name).item())
    optimizer.load_state_dict(state_dict)
