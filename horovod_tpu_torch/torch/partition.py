"""What ZeRO (``zero.py``) and FSDP (``fsdp.py``) share: the partition
spec, the flat collectives over a process group, and the optimizer state
a ``torch.optim`` optimizer would create, evaluated without memory.

``PartitionSpec``: a tuple of per-dimension entries (an axis name, a
tuple of names, or None), as ``jax.sharding.PartitionSpec`` is; ``P()``
is replicated. Eager tensors carry no sharding, so a spec here only
names which dimension a parameter is cut along; the process group of
that axis does the moving.

``gather_rows(flat, group)`` gives every member's equal-length flat
buffer as the rows of one ``(n, L)`` tensor; ``reduce_scatter_rows(rows,
group)`` sums the ``(n, L)`` buffers of the members and gives this
member its row. On NCCL (and on any backend with tensor collectives,
such as the fake backend that tests profile) they are
``all_gather_into_tensor`` and ``reduce_scatter_tensor``. gloo has no
reduce-scatter, so there it is an allreduce of the whole buffer and a
row taken, the composition ``mpi_ops.reducescatter`` uses. Each runs
inside its ``hvd.allgather`` / ``hvd.reducescatter`` profiler label.
"""

from __future__ import annotations

import collections
import copy
from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import group_rank, group_size
from .mpi_ops import _label


class PartitionSpec(tuple):
    """Per-dimension axis names of a sharded tensor (None: not cut)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis name ``spec`` uses, in order."""
    out = []
    for e in spec or ():
        if e is None:
            continue
        out.extend(e if isinstance(e, tuple) else (e,))
    return tuple(out)


def _tensor_collectives(group) -> bool:
    """Whether the backend has the flat-tensor collectives (gloo has
    not)."""
    return dist.get_backend(group) != "gloo"




def gather_rows(flat: torch.Tensor, group=None) -> torch.Tensor:
    """``(n, L)``: row ``i`` is member ``i``'s ``flat`` (length L on every
    member)."""
    n = group_size(group)
    flat = flat.contiguous()
    if n == 1:
        return flat[None]
    out = flat.new_empty((n,) + tuple(flat.shape))
    with _label("allgather", None, flat, group):
        if _tensor_collectives(group):
            # (1, L) in, (n, L) out: the shapes every backend accepts.
            dist.all_gather_into_tensor(out, flat[None], group=group)
        else:
            dist.all_gather(list(out.unbind(0)), flat, group=group)
    return out


def reduce_scatter_rows(rows: torch.Tensor, group=None) -> torch.Tensor:
    """This member's row of the sum over members of ``rows`` ``(n, L)``.
    ``rows`` may be overwritten."""
    n = group_size(group)
    if n == 1:
        return rows[0]
    rows = rows.contiguous()
    with _label("reducescatter", None, rows, group):
        if _tensor_collectives(group):
            out = rows.new_empty((1,) + tuple(rows.shape[1:]))
            dist.reduce_scatter_tensor(out, rows, group=group)
            return out[0]
        dist.all_reduce(rows, group=group)
    return rows[group_rank(group)]


def abstract_state(optimizer: torch.optim.Optimizer,
                   params: Mapping[str, Tuple[object, tuple, torch.dtype]]
                   ) -> Dict[str, Dict[str, object]]:
    """The state ``optimizer`` keeps per parameter, without memory: a
    throwaway copy of it steps once over ``meta`` tensors of the given
    shapes with zero gradients (``jax.eval_shape(optimizer.init)``'s
    counterpart; CPU zeros where the step reads a value, as Adafactor's
    does). ``params``: name -> (the parameter it stands for, or
    None; shape; dtype); each takes the hyperparameters of the group that
    holds that parameter (the first group otherwise). Returns name ->
    {state key -> value} (meta tensors, or the 0-d tensors and Python
    scalars the optimizer keeps as they are)."""
    try:
        return _step_once(optimizer, params, "meta")
    except (RuntimeError, NotImplementedError):
        # An optimizer whose step reads a value (Adafactor's .item())
        # cannot run on meta tensors: zeros on the CPU then.
        return _step_once(optimizer, params, "cpu")


def _step_once(optimizer, params, device: str):
    groups = optimizer.param_groups
    members = collections.defaultdict(list)
    for name, (param, shape, dtype) in params.items():
        gi = next((i for i, g in enumerate(groups)
                   if any(param is q for q in g["params"])), 0)
        members[gi].append((name, torch.zeros(
            shape, dtype=dtype, device=device, requires_grad=True)))
    clone = copy.copy(optimizer)
    clone.state = collections.defaultdict(dict)
    clone.param_groups = []
    for gi, entries in sorted(members.items()):
        hyper = {k: v for k, v in groups[gi].items()
                 if k not in ("params", "param_names")}
        clone.param_groups.append({**hyper,
                                   "params": [t for _, t in entries]})
    for _, entries in members.items():
        for _, t in entries:
            t.grad = torch.zeros_like(t)
    clone.step()
    return {name: dict(clone.state[t])
            for entries in members.values() for name, t in entries}
