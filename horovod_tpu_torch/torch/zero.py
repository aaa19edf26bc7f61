"""ZeRO-1: optimizer state sharded 1/N over a process group — the port's
counterpart of ``horovod_tpu/jax/zero.py``.

``DistributedOptimizer`` keeps the whole optimizer state on every rank
(f32 Adam moments are 8 bytes a parameter). ``zero_sharded_optimizer``
wraps a ``torch.optim`` optimizer the way ``DistributedOptimizer`` does
(a subclass of the optimizer's own class, so user code keeps its API)
and shards that state, ZeRO stage-1 style (Rajbhandari et al. 2020):

1. every parameter is flattened and zero-padded to a multiple of the
   group's size; the inner optimizer owns only this rank's 1/N slice of
   each (its moments are 1/N of the replicated optimizer's);
2. ``step()`` reduce-scatters each padded flat gradient over ``group``
   (averaged), so each rank gets the fully reduced slice it owns, and
   the inner optimizer updates that slice;
3. the updated slices are all-gathered back into the full parameters.

The JAX package gathers the slices' *updates* and every device adds
them; this port gathers the updated *slices*. In float32 the two are
equal element by element: a slice is an exact copy of the parameter's
elements, so ``slice + update`` on the owner is the same number every
device would have computed. Elementwise optimizers (SGD, momentum, Adam,
AdamW) then match the unsharded optimizer exactly; a global norm
(clipping) would need its own reduction, before this wrapper.

``state_dict()`` gathers the slices into full padded leaves (the global
array the JAX state's ``out_specs=P("data")`` exposes: 56 entries for a
13x4 parameter on 8 ranks) so a checkpoint holds every rank's state;
``load_state_dict()`` keeps this rank's slice of them.
"""

from __future__ import annotations

import collections
from typing import Mapping

import torch

from ..parallel.mesh import group_rank, group_size
from .partition import P, abstract_state, gather_rows, reduce_scatter_rows

__all__ = ["zero_sharded_optimizer", "zero_state_specs"]


def _pad_len(n: int, world: int) -> int:
    return (world - n % world) % world


def _padded(x: torch.Tensor, world: int) -> torch.Tensor:
    """``x`` flattened and zero-padded to a multiple of ``world``."""
    flat = x.reshape(-1)
    pad = _pad_len(flat.numel(), world)
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def _shard_leaf(x: torch.Tensor, idx: int, world: int) -> torch.Tensor:
    """This rank's 1/N slice of a (replicated) leaf, zero-padded so every
    slice is equal-sized."""
    flat = _padded(x, world)
    n = flat.numel() // world
    return flat[idx * n:(idx + 1) * n]


def _unknown_leaf(shape, slice_shapes) -> ValueError:
    return ValueError(
        f"zero_state_specs: optimizer state leaf of shape {tuple(shape)} "
        f"matches no sliced-param shape {sorted(slice_shapes)} and is "
        "not a scalar; its sharding cannot be inferred. Keep such "
        "state (e.g. optax.inject_hyperparams arrays, schedule "
        "tables) as 0-d scalars, or compose that transformation "
        "outside the ZeRO wrapper.")


def zero_state_specs(optimizer: torch.optim.Optimizer,
                     params: Mapping[str, torch.Tensor],
                     axis_name: str, num_shards: int):
    """Name -> {state key -> ``PartitionSpec``} for ``optimizer``'s state
    under ZeRO over ``axis_name`` of ``num_shards`` ranks: entries of a
    slice's shape are sharded, 0-d entries (Adam's ``step``) replicated,
    and anything else raises (it cannot be a per-parameter moment).
    ``optimizer`` is the INNER (not yet wrapped) optimizer, ``params``
    the full parameters by name; the state is evaluated on the sliced
    shapes, without memory (``partition.abstract_state``), so the
    moments of a scalar parameter (one entry a rank) classify as sharded.
    Caveat, as in the JAX package: a replicated 1-d table whose length
    happens to equal a slice's is taken for a moment."""
    sliced = {}
    for name, p in params.items():
        n = p.numel()
        sliced[name] = (p, ((n + _pad_len(n, num_shards)) // num_shards,),
                        p.dtype)
    slice_shapes = {shape for _, shape, _ in sliced.values()}
    state = abstract_state(optimizer, sliced)

    def classify(value):
        if not torch.is_tensor(value) or value.ndim == 0:
            return P()
        if tuple(value.shape) in slice_shapes:
            return P(axis_name)
        raise _unknown_leaf(value.shape, slice_shapes)

    return {name: {key: classify(v) for key, v in entry.items()}
            for name, entry in state.items()}


class _ZeroOptimizer(torch.optim.Optimizer):
    """The slices are the optimizer's parameters; ``_pairs`` ties each to
    the full parameter it is cut from."""

    def __init__(self, optimizer, group, average):
        self._group = group
        self._average = average
        self._world = group_size(group)
        self._index = group_rank(group)
        self._pairs = []
        groups = []
        for g in optimizer.param_groups:
            slices = []
            for p in g["params"]:
                s = _shard_leaf(p.detach(), self._index,
                                self._world).clone()
                s.requires_grad_(p.requires_grad)
                slices.append(s)
                self._pairs.append((p, s))
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": slices})
        super(self.__class__, self).__init__(groups)

    def _buckets(self, pairs):
        """The pairs by (dtype, device): one collective each."""
        out = collections.defaultdict(list)
        for p, s in pairs:
            out[(s.dtype, s.device)].append((p, s))
        return out.values()

    def zero_grad(self, set_to_none: bool = True):
        super(self.__class__, self).zero_grad(set_to_none)
        for p, _ in self._pairs:
            if p.grad is None:
                continue
            if set_to_none:
                p.grad = None
            else:
                p.grad.detach_()
                p.grad.zero_()

    @torch.no_grad()
    def _scatter_grads(self):
        """Reduce-scatter every full gradient into its slice's ``grad``."""
        n = self._world
        for bucket in self._buckets(
                [(p, s) for p, s in self._pairs if p.grad is not None]):
            rows = torch.cat([_padded(p.grad.to(s.dtype), n).view(n, -1)
                              for p, s in bucket], dim=1)
            mine = reduce_scatter_rows(rows, self._group)
            # A fresh buffer the slices' gradients are views of (not of
            # ``rows``, which is n times longer).
            mine = mine / n if self._average and n > 1 else mine.clone()
            off = 0
            for _, s in bucket:
                s.grad = mine[off:off + s.numel()].view_as(s)
                off += s.numel()

    @torch.no_grad()
    def _gather_params(self):
        """All-gather the updated slices back into the full parameters."""
        for bucket in self._buckets(self._pairs):
            rows = gather_rows(torch.cat([s.reshape(-1) for _, s in bucket]),
                               self._group)
            off = 0
            for p, s in bucket:
                full = rows[:, off:off + s.numel()].reshape(-1)
                p.copy_(full[:p.numel()].view_as(p))
                off += s.numel()

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._scatter_grads()
        super(self.__class__, self).step()
        self._gather_params()
        return loss

    def _slice_shapes(self):
        return {tuple(s.shape) for _, s in self._pairs}

    def state_dict(self):
        """The inner state with every slice-shaped entry gathered into its
        full padded leaf (a collective: every rank calls it)."""
        sd = super(self.__class__, self).state_dict()
        shapes = self._slice_shapes()
        state = {}
        for idx in sorted(sd["state"]):
            entry = {}
            for key, value in sd["state"][idx].items():
                if torch.is_tensor(value) and value.ndim > 0:
                    if tuple(value.shape) not in shapes:
                        raise _unknown_leaf(value.shape, shapes)
                    value = gather_rows(value.reshape(-1),
                                        self._group).reshape(-1)
                entry[key] = value
            state[idx] = entry
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, state_dict):
        """Keep this rank's slice of every gathered leaf."""
        slices = [s for g in self.param_groups for s in g["params"]]
        state = {}
        for idx, entry in state_dict["state"].items():
            s = slices[int(idx)]
            mine = {}
            for key, value in entry.items():
                if torch.is_tensor(value) and value.ndim > 0:
                    width = s.numel()
                    if value.numel() != width * self._world:
                        raise ValueError(
                            f"zero load_state_dict: state {idx}/{key} has "
                            f"{value.numel()} entries, expected "
                            f"{width * self._world} (a full padded leaf "
                            f"over {self._world} ranks)")
                    value = value.reshape(-1)[self._index * width:
                                              (self._index + 1) * width]
                mine[key] = value
            state[idx] = mine
        super(self.__class__, self).load_state_dict(
            {"state": state, "param_groups": state_dict["param_groups"]})


def zero_sharded_optimizer(optimizer: torch.optim.Optimizer, group=None,
                           average: bool = True) -> torch.optim.Optimizer:
    """Wrap ``optimizer`` so its state is sharded 1/N over ``group`` (a
    ``torch.distributed`` process group, None: the job; the JAX
    ``axis_name``). Parameters stay whole and replicated; build the
    wrapper before the first step (the wrapped optimizer's existing
    state is not carried over). ``average``: mean the gradients over the
    group (True) or sum them."""
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_ZeroOptimizer.__dict__))
    return cls(optimizer, group, average)

