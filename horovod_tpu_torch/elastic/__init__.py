"""Elastic training API — the port's counterpart of
``horovod_tpu/elastic/__init__.py``, in the shape upstream Horovod's
elastic mode standardized (``hvd.elastic.run`` + a state object)::

    state = hvd.elastic.State(step=0, params=model.state_dict(),
                              opt=optimizer.state_dict())

    @hvd.elastic.run
    def train(state):
        while state.step < total_steps:
            ...
            state.step += 1
            if state.step % 100 == 0:
                state.commit()

``commit()`` snapshots every tracked value; ``restore()`` rolls back to
the last commit with rank 0's copy authoritative on every rank — the
reference's broadcast-from-root consistency contract: rank 0's committed
tree is re-broadcast (tensors and arrays leaf by leaf, other values
pickled). A ZeRO optimizer's ``state_dict()`` is already gathered whole,
and an FSDP model's ``full_state_dict()`` too: commit those, never a
rank's raw slices.

``commit()`` also hands this rank's 1/world_size share of the snapshot's
flat leaves to the async ``hvd-ckpt-writer`` thread when
``HOROVOD_CKPT_DIR`` is set (or :meth:`State.enable_sharded_checkpoint`
was called); rank 0 adds the manifest. The files are the JAX package's
format (``utils.checkpoint``). The step loop never blocks on storage:
tensors are copied to the host on the writer thread.

Not ported yet, because they ride the JAX package's controller and wire,
which the port does not have: the reshape fence and the
``RanksChangedError`` the controller raises, the p2p shard restore
(digest-matched survivors keeping their copies, ``elastic/shards.py``)
and its digest thread. ``run`` catches the port's own
:class:`RanksChangedError`, which nothing in the port raises yet.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..common import basics
from ..common import config as config_mod
from ..common import hvd_logging as logging
from ..utils import checkpoint as ckpt

__all__ = ["RanksChangedError", "State", "run", "epoch"]


class RanksChangedError(RuntimeError):
    """The job's membership changed under an in-flight collective: the
    elastic ``run`` loop restores the last commit and calls the training
    function again."""


def epoch() -> int:
    """Current membership epoch: 1 at rendezvous, and always 1 without a
    controller that reshapes the job (the port's case)."""
    return 1


def _is_array_tree(value: Any) -> bool:
    leaves = ckpt.tree_flatten(value)[0]
    return bool(leaves) and all(
        torch.is_tensor(leaf) or isinstance(leaf, np.ndarray)
        for leaf in leaves)


def _topology() -> tuple:
    """(rank, size), (0, 1) before ``hvd.init()``: ``commit()`` stays
    purely local, so a State may be built before init."""
    if not basics.is_initialized():
        return 0, 1
    return basics.rank(), basics.size()


class State:
    """Tracked training state: every keyword becomes an attribute.
    ``commit()`` snapshots the current values; ``restore()`` rolls back
    to the last commit, rank 0's copy authoritative on every rank."""

    def __init__(self, **objects: Any):
        if not objects:
            raise ValueError(
                "hvd.elastic.State needs at least one tracked value, e.g. "
                "State(step=0, params=model.state_dict())")
        self._names = tuple(sorted(objects))
        for name, value in objects.items():
            setattr(self, name, value)
        self._committed: Dict[str, Any] = {}
        self._commit_world = 1
        self._flat_cache: Optional[tuple] = None
        self._writer: Optional[ckpt.AsyncShardWriter] = None
        self._save_step = 0
        ckpt_dir = config_mod.elastic_ckpt_dir()
        if ckpt_dir:
            self.enable_sharded_checkpoint(ckpt_dir)
        self.commit()

    # ------------------------------------------------------------- storage

    def enable_sharded_checkpoint(self, directory: str,
                                  keep: Optional[int] = None) -> None:
        """Turn on the continuous async disk tier: every ``commit()``
        hands this rank's shard to the ``hvd-ckpt-writer`` thread (rank
        0 adds the manifest)."""
        if self._writer is not None:
            return
        self._writer = ckpt.AsyncShardWriter(
            directory, keep=keep if keep is not None
            else config_mod.elastic_ckpt_keep())
        self._save_step = self._writer.next_step()

    def flush_checkpoints(self, timeout: float = 30.0) -> bool:
        """Wait for the writer to drain (teardown and tests only)."""
        return self._writer.flush(timeout) if self._writer else True

    @property
    def checkpoint_dir(self) -> Optional[str]:
        return self._writer.directory if self._writer else None

    def close(self) -> None:
        """Stop the disk writer (a daemon; optional, but a process that
        builds many States should not keep their snapshots pinned)."""
        if self._writer is not None:
            self._writer.close()

    # -------------------------------------------------------------- commit

    def commit(self) -> None:
        """Snapshot the current values as the restore point. Purely local
        (no collective): call it at a point every rank reaches in the
        same iteration. With the disk tier on, also enqueues this rank's
        shard for the async writer; a leaf the shared format cannot hold
        (bfloat16) raises here, with its name."""
        self._commit_world = max(1, _topology()[1])
        self._committed = {name: copy.deepcopy(getattr(self, name))
                           for name in self._names}
        self._flat_cache = None
        if self._writer is not None:
            self._check_leaves()
            try:
                self._submit_shards()
            except Exception as exc:  # storage must never fail the step
                logging.warning(
                    "elastic: sharded checkpoint submit skipped: %s", exc)

    def _flat_commit(self) -> tuple:
        """``(flat, structure, array_ids, objects)`` of the committed
        dict: flat leaves in JAX's order, the indices that shard (arrays
        and tensors), and the object leaves that ride the manifest.
        Cached per commit."""
        if self._flat_cache is not None:
            return self._flat_cache
        tree = {name: self._committed[name] for name in self._names}
        flat, structure = ckpt.tree_flatten(tree)
        array_ids = [i for i, leaf in enumerate(flat) if ckpt.is_array(leaf)]
        objects = {i: leaf for i, leaf in enumerate(flat)
                   if not ckpt.is_array(leaf)}
        self._flat_cache = (flat, structure, array_ids, objects)
        return self._flat_cache

    def _check_leaves(self) -> None:
        flat, structure, array_ids, _ = self._flat_commit()
        paths = ckpt.leaf_paths(structure)
        for i in array_ids:
            ckpt.check_numpy_dtype(flat[i], paths[i])

    def _layout(self, flat: List[Any], array_ids: List[int],
                world: int) -> List[List[int]]:
        """The commit's flat-id shard map: the deterministic
        lightest-shard walk over the array leaves' byte sizes."""
        nbytes = [ckpt.leaf_nbytes(flat[i]) for i in array_ids]
        positions = ckpt.shard_layout(nbytes, world)
        return [[array_ids[p] for p in shard] for shard in positions]

    def _submit_shards(self) -> None:
        rank = _topology()[0]
        world = self._commit_world
        if rank >= world:
            return
        flat, _structure, array_ids, objects = self._flat_commit()
        layout = self._layout(flat, array_ids, world)
        # The committed leaves themselves (the snapshot is never mutated):
        # the writer thread copies them to the host and hashes them.
        mine = [flat[i] for i in layout[rank]]
        step = self._save_step
        self._save_step += 1
        manifest = None
        if rank == 0:
            def manifest(flat=flat, layout=layout, objects=objects,
                         step=step, world=world):
                return {"step": step, "epoch": epoch(), "world_size": world,
                        "layout": layout,
                        "digests": [ckpt.shard_digest([flat[i] for i in ids])
                                    for ids in layout],
                        "objects_hex": ckpt.pack_objects(objects)}
        self._writer.submit(step, rank, world, mine, manifest=manifest)

    # ------------------------------------------------------------- restore

    def restore(self) -> None:
        """Roll every tracked value back to the last commit, consistent
        with rank 0 on every rank (rank 0 re-broadcasts its commit)."""
        if _topology()[1] <= 1:
            for name in self._names:
                setattr(self, name, copy.deepcopy(self._committed[name]))
            return
        self._restore_broadcast()

    def _restore_broadcast(self) -> None:
        """Rank 0's committed tree on every rank, one materialization per
        tracked value (the committed snapshot is broadcast as it is and
        the live attribute is the one fresh copy)."""
        from ..torch import broadcast_object

        restored: Dict[str, Any] = {}
        for name in self._names:
            value = self._committed[name]
            if _is_array_tree(value):
                value = ckpt.broadcast_tree(value, root_rank=0)
            else:
                value = broadcast_object(value, root_rank=0,
                                         name=f"elastic.state.{name}")
            restored[name] = value
            setattr(self, name, copy.deepcopy(value))
        self._committed = restored
        self._flat_cache = None


def run(func):
    """Decorate the training loop for elastic execution: restore the
    last commit (rank 0's values everywhere), run ``func(state, *args,
    **kwargs)``, and on :class:`RanksChangedError` restore and run it
    again. Any other exception propagates unchanged."""

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        while True:
            try:
                state.restore()
                return func(state, *args, **kwargs)
            except RanksChangedError as exc:
                logging.warning(
                    "elastic: %s; restoring state and resuming the "
                    "training loop", exc)
                continue

    return wrapper
