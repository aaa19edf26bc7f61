"""Process meshes — the port's counterpart of
``horovod_tpu/parallel/mesh.py``.

The JAX package lays the job's devices on a ``jax.sharding.Mesh`` and
names its axes; collectives then run "over an axis" inside
``shard_map``. Here the unit is the process (one per card, or one per
CPU slot under gloo), and an axis is a family of ``torch.distributed``
process groups: :func:`make_mesh` lays the ranks out in the JAX order
(earlier axes change slowest) and builds one group per slice of every
axis, and :meth:`Mesh.group` hands this rank the group of its slice —
the ``group=`` of the port's collectives, ring attention, pipelines and
tensor parallelism, where the JAX package takes ``axis_name=``.

Not ported, because they describe JAX ``NamedSharding`` placements that
eager tensors do not carry: ``sharding_axes``, ``common_mesh``,
``data_sharding`` and ``replicated_sharding``. Their role here is the
mesh itself, carried by what is sharded (``LlamaLM(mesh=...)`` holds its
tensor-parallel axis, and the decode-path classifier reads it there).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"

_lock = threading.Lock()
_global_mesh: Optional["Mesh"] = None


def group_size(group=None) -> int:
    """Ranks in ``group``; ``None`` is the job's world (one process when
    no process group was initialised)."""
    if group is None and not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This process's index in ``group`` (0 without a process group)."""
    if group is None and not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def global_rank(group, index: int) -> int:
    """The job rank of ``group``'s member ``index``."""
    if group is None:
        return index
    return dist.get_global_rank(group, index)


class Mesh:
    """Ranks laid out on named axes. ``devices``: the rank grid (an int
    array of the axis sizes, named as the JAX mesh names its device
    grid); ``shape``: axis name -> size. Every process of the job builds
    the same mesh (group creation is collective)."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh: {self.devices.ndim}-d rank grid for axes "
                f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self.rank = group_rank(None)
        where = np.argwhere(self.devices == self.rank)
        self._coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups: Dict[str, object] = {}
        self._members: Dict[str, List[int]] = {}
        for axis_i, axis in enumerate(self.axis_names):
            moved = np.moveaxis(self.devices, axis_i, -1)
            for members in moved.reshape(-1, moved.shape[-1]).tolist():
                group = (dist.new_group(members)
                         if dist.is_initialized() else None)
                if self.rank in members:
                    self._groups[axis] = group
                    self._members[axis] = members

    def _check(self, axis: str) -> None:
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes "
                             f"{self.axis_names})")
        if self._coords is None:
            raise ValueError(f"rank {self.rank} is not on this mesh")

    def group(self, axis: str):
        """The process group of this rank's slice along ``axis``."""
        self._check(axis)
        return self._groups[axis]

    def ranks(self, axis: str) -> List[int]:
        """The job ranks of this rank's slice along ``axis``, in axis
        order."""
        self._check(axis)
        return list(self._members[axis])

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        self._check(axis)
        return self._coords[self.axis_names.index(axis)]

    def axis_size(self, axis: str) -> int:
        self._check(axis)
        return self.shape[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _world_ranks(ranks: Optional[Sequence[int]]) -> List[int]:
    if ranks is None:
        return list(range(group_size(None)))
    return [int(r) for r in ranks]


def axis_size(axis_name: str, m: Optional[Mesh] = None) -> int:
    """Size of a mesh axis (of ``m``, default the global mesh)."""
    return (m or mesh()).axis_size(axis_name)


def make_mesh(axes: Optional[Mapping[str, int]] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh. Default: 1-D ``("data",)`` over every rank.

    ``axes`` maps axis name -> size; one axis may be -1 (inferred).
    Earlier axes change slowest, as in the JAX package, so put the axis
    with the most traffic (``model``, ``seq``) last: its slices are
    runs of consecutive ranks, which a launcher places on one host.
    ``ranks`` (default every rank of the job) are the processes laid
    out; every process of the job must call this."""
    ranks = _world_ranks(ranks)
    n = len(ranks)
    if not axes:
        axes = {DATA_AXIS: n}
    names = tuple(axes.keys())
    sizes = [int(s) for s in axes.values()]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        if n % known:
            raise ValueError(f"cannot infer axis: {n} ranks not divisible "
                             f"by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} != {n} ranks")
    return Mesh(np.array(ranks).reshape(sizes), names)


def make_multislice_mesh(n_slices: Optional[int] = None,
                         dcn_axis: str = "dcn", ici_axis: str = "ici",
                         ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A 2-D ``(dcn, ici)`` mesh for hierarchical collectives: the outer
    axis crosses slice boundaries (the slow network), the inner axis
    stays within a slice (the fast fabric) — feed its groups to
    ``hierarchical_allreduce``. The ranks are grouped contiguously into
    ``n_slices`` slices, as a launcher numbers the ranks of a host
    consecutively (the JAX package reads a device's ``slice_index``,
    which processes do not carry)."""
    ranks = _world_ranks(ranks)
    n = len(ranks)
    if n_slices is None:
        raise ValueError(
            "n_slices is required to split these ranks: processes carry "
            "no slice index")
    if n % n_slices:
        raise ValueError(f"{n} ranks not divisible by {n_slices} slices")
    return Mesh(np.array(ranks).reshape(n_slices, n // n_slices),
                (dcn_axis, ici_axis))


def mesh() -> Mesh:
    """The process-global mesh, lazily a 1-D data mesh over every rank."""
    global _global_mesh
    with _lock:
        if _global_mesh is None:
            _global_mesh = make_mesh()
        return _global_mesh


def set_mesh(m: Mesh) -> None:
    global _global_mesh
    with _lock:
        _global_mesh = m


def reset_mesh() -> None:
    global _global_mesh
    with _lock:
        _global_mesh = None


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, m: Optional[Mesh] = None):
    """This rank's slice of a global batch: every leaf (a tensor or
    array with the batch on dim 0) cut into ``data``-axis-size equal
    blocks, this rank's block kept. The counterpart of placing the
    global batch sharded along ``data``: here each process holds only
    its block."""
    m = m or mesh()
    n = m.axis_size(DATA_AXIS)
    i = m.axis_index(DATA_AXIS)

    def take(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"shard_batch: batch {b} not divisible by "
                             f"the data axis ({n})")
        return x[i * (b // n):(i + 1) * (b // n)]

    return _map_tree(take, tree)


def replicate(tree, m: Optional[Mesh] = None):
    """Every tensor leaf as the mesh's first rank holds it, on every
    rank (a broadcast per leaf; copies, the inputs stay untouched)."""
    m = m or mesh()
    root = int(m.devices.flat[0])
    world = group_size(None) > 1

    def bcast(x):
        if not torch.is_tensor(x):
            return x
        out = x.detach().clone()
        if world:
            dist.broadcast(out, src=root)
        return out

    return _map_tree(bcast, tree)
