"""Two-level (hierarchical) collectives — the port's counterpart of
``horovod_tpu/parallel/hierarchical.py``.

With a 2-D ``(outer, inner)`` mesh (``make_multislice_mesh``: inner =
the ranks of one host over NVLink, outer = across hosts) an allreduce
sends the least volume over the slow outer fabric:

    reduce-scatter over inner  ->  allreduce over outer (1/|inner| of
    the bytes)  ->  allgather over inner

the reference's ``NCCLHierarchicalAllreduce``, as three of the port's
collectives with ``group=``. Both functions are differentiable through
those collectives.
"""

from __future__ import annotations

import torch

from ..torch.mpi_ops import Sum, allgather, allreduce, reducescatter
from .mesh import group_size


def hierarchical_allreduce(x: torch.Tensor, inner_group, outer_group,
                           average: bool = False) -> torch.Tensor:
    """Allreduce (sum, or mean with ``average``) over inner x outer with
    the cross-outer traffic cut to 1/|inner| of the payload. Any shape:
    flattened and zero-padded to a multiple of the inner size, as the
    reference pads fused buffers."""
    inner = group_size(inner_group)
    outer = group_size(outer_group)
    shape = x.shape
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % inner
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat
    if inner > 1:
        shard = reducescatter(shard, op=Sum, group=inner_group)
    if outer > 1:
        shard = allreduce(shard, op=Sum, group=outer_group)
    full = allgather(shard, group=inner_group) if inner > 1 else shard
    out = full[:n].reshape(shape)
    if average:
        out = out / (inner * outer)
    return out


def hierarchical_allgather(x: torch.Tensor, inner_group,
                           outer_group) -> torch.Tensor:
    """Two-level allgather along dim 0: within the inner group first,
    then across the outer one. Rank order follows (outer, inner) mesh
    order."""
    if group_size(inner_group) > 1:
        x = allgather(x, group=inner_group)
    if group_size(outer_group) > 1:
        x = allgather(x, group=outer_group)
    return x
