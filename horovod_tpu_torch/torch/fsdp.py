"""ZeRO-3 / FSDP: parameters, gradients and optimizer state sharded 1/N
over a process group — the port's counterpart of
``horovod_tpu/jax/fsdp.py``.

The layout half is the JAX module's, as pure functions over a
name -> tensor (or shape) mapping, nested or flat (``dict(model.
named_parameters())``): ``fsdp_param_specs`` gives each parameter the
largest free dimension divisible by the shard count (ties to the leading
dimension; below ``min_leaf_elems`` elements, or with no such dimension,
the base spec), composing with a tensor-parallel base spec;
``fsdp_state_specs`` gives the optimizer's per-parameter state its
parameter's spec; ``sharded_size_bytes`` is the per-rank budget.

The mechanism half is what XLA derives from the JAX module's pinned
shardings, done by hand on eager tensors (``fsdp_shardings``, which
builds those ``NamedSharding``s, has no counterpart: the process group
and the shards ``fully_shard`` keeps are what they describe).
``fully_shard(model, specs, group)`` replaces every sharded parameter by
its contiguous shard along the dimension its spec names and, for each
gather unit (each block of ``model.layers``, and the root with the
embedding and the head):

* all-gathers the unit's shards as ONE flat buffer just before the unit
  runs (sized from the specs: no size exchange), and calls the unit's
  own ``forward`` with the full tensors swapped in for the shards —
  the model code is untouched;
* a block runs under ``torch.utils.checkpoint``: autograd saves only
  its input, and the backward re-gathers the parameters and recomputes
  the block, so no layer's full weights outlive its use (a naive gather
  would keep them all until the backward: a replicated model's peak);
* the gather is a ``torch.autograd.Function`` whose backward
  reduce-scatters the unit's full gradients, averaged over ``group``,
  into the shards' gradients (again one flat buffer, the sharded dim
  moved to the front of each);
* parameters that stay replicated (norm scales, small leaves) get their
  gradients averaged over ``group`` as they accumulate.

The optimizer is a plain ``torch.optim`` optimizer over the model's
parameters (now the shards), with no ``DistributedOptimizer`` on top: its
state is sharded because its parameters are. ``model.full_state_dict()``
gathers the shards back under the ordinary ``state_dict`` names.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import DATA_AXIS, group_rank, group_size
from .mpi_ops import _label
from .partition import (P, PartitionSpec, abstract_state, gather_rows,
                        reduce_scatter_rows, spec_axes)

__all__ = [
    "FSDP_MIN_LEAF_ELEMS",
    "FSDPModule",
    "fsdp_param_specs",
    "fsdp_state_specs",
    "fully_shard",
    "sharded_size_bytes",
]

# Leaves smaller than this many elements stay at their base spec: sharding
# a (dim,) norm scale saves nothing and costs a gather.
FSDP_MIN_LEAF_ELEMS = 2 ** 16

# State entries that match no parameter are replicated up to this many
# elements and refused above it: a silent full-size replica would void
# the memory the sharding is for.
_STATE_REPLICATE_MAX_ELEMS = 2 ** 20


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def _is_leaf(x) -> bool:
    return not isinstance(x, Mapping)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested mappings (``rest``: trees of the
    same keys; a missing key gives None)."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    return {k: _map(fn, v, *[None if r is None else r.get(k)
                             for r in rest])
            for k, v in tree.items()}


def _flat(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(dotted name, leaf) of nested mappings, keys sorted at every
    level."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += _flat(tree[k], f"{prefix}.{k}" if prefix else str(k))
    return out


def _entries(spec, ndim: int) -> list:
    entries = list(spec) if spec is not None else []
    return entries + [None] * (ndim - len(entries))


def fsdp_param_specs(params, num_shards: int, axis: str = "data",
                     base_specs=None,
                     min_leaf_elems: int = FSDP_MIN_LEAF_ELEMS):
    """``PartitionSpec`` for each parameter (same keys as ``params``:
    tensors or shapes), sharding it 1/``num_shards`` over ``axis``.

    Per leaf, the largest dimension that is divisible by ``num_shards``
    and free in ``base_specs`` gets ``axis`` (ties to the leading dim).
    Leaves below ``min_leaf_elems`` elements, and leaves with no such
    dimension, keep their base spec: replicated over ``axis``, which is
    correct, only not memory-saving. ``base_specs`` (None leaves mean
    replicated): an existing layout, e.g. ``models.llama.
    llama_tp_param_specs``, to compose with for dp x tp."""
    if num_shards < 1:
        raise ValueError(f"fsdp_param_specs: num_shards={num_shards} < 1")

    def spec_for(p, base):
        shape = _shape(p)
        entries = _entries(base, len(shape))
        if axis in spec_axes(entries):
            raise ValueError(
                f"fsdp_param_specs: base spec {base} already uses axis "
                f"{axis!r}; pick a distinct FSDP axis")
        keep = P(*base) if base is not None else P()
        if num_shards == 1 or math.prod(shape) < min_leaf_elems:
            return keep
        best = None
        for d, size in enumerate(shape):
            if entries[d] is not None or size % num_shards:
                continue
            if best is None or size > shape[best]:
                best = d
        if best is None:
            return keep
        entries[best] = axis
        return P(*entries)

    return _map(spec_for, params, base_specs)


def fsdp_state_specs(optimizer: torch.optim.Optimizer, param_specs):
    """Name -> {state key -> ``PartitionSpec``} for ``optimizer``'s state,
    mirroring ``param_specs`` (keyed by parameter name, nested or flat).

    ``optimizer.state`` is keyed by the parameter, so the match is
    direct: an entry of its parameter's shape (Adam's moments, a momentum
    buffer) takes the parameter's spec, a 0-d entry (``step``)
    replicates, and any other entry replicates up to
    ``_STATE_REPLICATE_MAX_ELEMS`` elements and raises above it. The
    state is evaluated without memory (``partition.abstract_state``).
    The optimizer must be built from ``named_parameters()`` (its groups
    then carry the names)."""
    specs = dict(_flat(param_specs))
    params = {}
    for g in optimizer.param_groups:
        names = g.get("param_names")
        if names is None:
            raise ValueError(
                "fsdp_state_specs: build the optimizer from "
                "model.named_parameters() so its state can be matched "
                "to the parameter specs by name")
        for name, p in zip(names, g["params"]):
            params[name] = (p, tuple(p.shape), p.dtype)
    state = abstract_state(optimizer, params)

    def classify(name, key, value):
        if not torch.is_tensor(value) or value.ndim == 0:
            return P()
        if tuple(value.shape) == params[name][1]:
            spec = specs.get(name)
            return P() if spec is None else spec
        if value.numel() <= _STATE_REPLICATE_MAX_ELEMS:
            return P()
        raise ValueError(
            f"fsdp_state_specs: state leaf at {name}/{key} (shape "
            f"{tuple(value.shape)}) matches no parameter path/shape and is "
            "too large to replicate silently. Shard it explicitly, or "
            "compose that transformation outside the FSDP step.")

    return {name: {key: classify(name, key, v) for key, v in entry.items()}
            for name, entry in state.items()}


def _leaf_bytes(leaf) -> int:
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    if hasattr(leaf, "nbytes"):
        return int(leaf.nbytes)
    return 0            # a Python scalar the optimizer keeps as it is


def sharded_size_bytes(tree, specs, num_shards_by_axis) -> int:
    """Per-rank bytes of ``tree`` (nested mappings of tensors, meta ones
    included) under ``specs`` (the same keys): each leaf's bytes over
    the product of its spec's axis sizes (exact: every spec'd dimension
    divides by construction). ``num_shards_by_axis``: axis name -> size,
    e.g. ``mesh.shape``."""
    leaves = _flat(tree)
    spec_leaves = _flat(specs)
    if [k for k, _ in leaves] != [k for k, _ in spec_leaves]:
        raise ValueError(
            f"sharded_size_bytes: {len(leaves)} tree leaves vs "
            f"{len(spec_leaves)} spec leaves, or different names — "
            "mismatched trees would silently corrupt the budget")
    total = 0
    for (_, leaf), (_, spec) in zip(leaves, spec_leaves):
        denom = 1
        for a in spec_axes(spec):
            denom *= num_shards_by_axis[a]
        total += _leaf_bytes(leaf) // denom
    return total


# ---------------------------------------------------------------------------
# The mechanism


class _Unit:
    """One gather unit: the sharded parameters it owns, as (module,
    attribute, sharded dim, full shape), and the group they are sharded
    over."""

    def __init__(self, entries, group, recompute: bool):
        self.entries = entries
        self.group = group
        self.recompute = recompute
        self.n = group_size(group)

    def shards(self) -> List[torch.Tensor]:
        return [m._parameters[a] for m, a, _, _ in self.entries]

    @contextlib.contextmanager
    def swapped(self, fulls):
        """The full tensors in place of the shards for the duration."""
        try:
            for (m, a, _, _), full in zip(self.entries, fulls):
                m._parameters[a] = full
            yield
        finally:
            for (m, a, _, _), shard in zip(self.entries, self._held):
                m._parameters[a] = shard

    def gather(self):
        self._held = self.shards()
        return _GatherFn.apply(self, *self._held)


class _GatherFn(torch.autograd.Function):
    """Forward: the unit's shards -> its full parameters, through one
    all-gather of their concatenation. Backward: the full gradients ->
    the shards', through one reduce-scatter, averaged over the group."""

    @staticmethod
    def forward(ctx, unit, *shards):
        ctx.unit = unit
        n = unit.n
        rows = gather_rows(torch.cat([s.detach().reshape(-1)
                                      for s in shards]), unit.group)
        fulls, off = [], 0
        for (_, _, dim, full_shape), s in zip(unit.entries, shards):
            k = s.numel()
            chunk = rows[:, off:off + k].reshape((n,) + tuple(s.shape))
            fulls.append(chunk.movedim(0, dim).reshape(full_shape))
            off += k
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.unit
        n = unit.n
        pieces = []
        for g, (_, _, dim, full) in zip(grads, unit.entries):
            split = full[:dim] + (n, full[dim] // n) + full[dim + 1:]
            pieces.append(g.reshape(split).movedim(dim, 0).reshape(n, -1))
        mine = reduce_scatter_rows(torch.cat(pieces, dim=1), unit.group)
        if n > 1:
            mine = mine / n
        out, off = [], 0
        for (_, _, dim, full) in unit.entries:
            shape = full[:dim] + (full[dim] // n,) + full[dim + 1:]
            k = math.prod(shape)
            out.append(mine[off:off + k].reshape(shape))
            off += k
        return (None, *out)


class FSDPModule:
    """Mixed into the class of every module ``fully_shard`` made a gather
    unit (the model and its blocks), ahead of the module's own class."""

    _fsdp_unit: _Unit

    def forward(self, *args, **kwargs):
        unit = self._fsdp_unit
        if unit.recompute and unit.entries and torch.is_grad_enabled():
            return checkpoint(self._fsdp_forward, *args, use_reentrant=False,
                              **kwargs)
        return self._fsdp_forward(*args, **kwargs)

    def _fsdp_forward(self, *args, **kwargs):
        unit = self._fsdp_unit
        if not unit.entries:
            return super(FSDPModule, self).forward(*args, **kwargs)
        fulls = unit.gather()
        with unit.swapped(fulls):
            return super(FSDPModule, self).forward(*args, **kwargs)

    @torch.no_grad()
    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The ordinary ``state_dict`` with every shard gathered back to
        its full parameter (a collective: every rank of the group calls
        it). ``models.convert.llama_to_flax`` reads a model that loads
        it."""
        names = self._fsdp_names
        sd = self.state_dict()
        for unit in self._fsdp_units:
            if not unit.entries:
                continue
            fulls = _GatherFn.apply(unit, *unit.shards())
            for (m, a, _, _), full in zip(unit.entries, fulls):
                sd[names[(id(m), a)]] = full.detach().clone()
        return sd


def _spec_dim(spec, axis: str, name: str) -> Optional[int]:
    for d, e in enumerate(spec or ()):
        if e == axis:
            return d
        if isinstance(e, tuple) and axis in e:
            raise ValueError(f"fully_shard: {name}'s spec {spec} shards "
                             f"{axis!r} jointly with other axes on one dim")
    return None


def _make_unit(module: nn.Module) -> None:
    cls = module.__class__
    module.__class__ = type(f"FSDP{cls.__name__}", (FSDPModule, cls), {})


def fully_shard(model: nn.Module, specs: Mapping[str, PartitionSpec],
                group=None) -> nn.Module:
    """Shard ``model`` in place over ``group`` (a process group, None: the
    job; its size is the shard count) by ``specs``: name (as in
    ``model.named_parameters()``) -> spec, as ``fsdp_param_specs`` gives
    over the ``data`` axis; a parameter whose spec does not use ``data``
    stays replicated. The gather units below the root are the blocks of
    ``model.layers``, each recomputed in the backward. Returns ``model``,
    now also an ``FSDPModule``. Every rank passes the same full weights
    (the same seed, or a loaded checkpoint)."""
    n, r = group_size(group), group_rank(group)
    names = {}
    for qual, p in model.named_parameters():
        mod_name, _, attr = qual.rpartition(".")
        names[(id(model.get_submodule(mod_name)), attr)] = qual
    units = list(getattr(model, "layers", []))
    unit_of = {}
    for i, u in enumerate(units):
        for m in u.modules():
            unit_of.setdefault(id(m), i)
    entries: List[list] = [[] for _ in units] + [[]]
    replicated = []
    for qual, p in list(model.named_parameters()):
        mod_name, _, attr = qual.rpartition(".")
        module = model.get_submodule(mod_name)
        dim = _spec_dim(specs.get(qual), DATA_AXIS, qual)
        if dim is None or n == 1:
            replicated.append(p)
            continue
        if p.shape[dim] % n:
            raise ValueError(f"fully_shard: {qual} dim {dim} of size "
                             f"{p.shape[dim]} does not split over {n} ranks")
        width = p.shape[dim] // n
        shard = nn.Parameter(p.detach().narrow(dim, r * width, width)
                             .clone(), requires_grad=p.requires_grad)
        module._parameters[attr] = shard
        entries[unit_of.get(id(module), len(units))].append(
            (module, attr, dim, tuple(p.shape)))
    all_units = []
    for i, u in enumerate(units + [model]):
        dtypes = {m._parameters[a].dtype for m, a, _, _ in entries[i]}
        if len(dtypes) > 1:
            raise ValueError(f"fully_shard: one gather unit holds shards of "
                             f"several dtypes {sorted(map(str, dtypes))}")
        _make_unit(u)
        u._fsdp_unit = _Unit(entries[i], group, recompute=u is not model)
        all_units.append(u._fsdp_unit)
    model._fsdp_units = all_units
    model._fsdp_names = names
    if n > 1:
        for p in replicated:
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(_averager(group, n))
    return model


def _averager(group, n: int):
    def hook(p):
        with _label("allreduce", None, p.grad, group):
            dist.all_reduce(p.grad, group=group)
        p.grad.div_(n)
    return hook
