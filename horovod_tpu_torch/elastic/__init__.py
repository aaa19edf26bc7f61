"""Elastic training API — the port's counterpart of
``horovod_tpu/elastic/__init__.py``, in the shape upstream Horovod's
elastic mode standardized (``hvd.elastic.run`` + a state object)::

    state = hvd.elastic.State(step=0, model=model, optimizer=optimizer)

    @hvd.elastic.run
    def train(state):
        while state.step < total_steps:
            ...                                # hvd collectives
            state.step += 1
            state.commit()

An ``nn.Module`` or ``torch.optim.Optimizer`` is tracked by its
``state_dict()``: a commit snapshots it (on the device its tensors live
on) and a restore loads the snapshot back with ``load_state_dict``, in
place, so the parameter objects that optimizers and autograd hooks hold
stay the same. Every other value is deep-copied. An FSDP model's
``full_state_dict()`` or a ZeRO optimizer's gathered state are not
sharded here: elastic jobs run neither.

The runtime half lives in the controller (``HOROVOD_ELASTIC=1``): when a
rank dies or a joiner is admitted, the coordinator re-forms the world at
a bumped membership epoch and every in-flight collective fails with
:class:`RanksChangedError`. ``run`` catches it, acknowledges the reshape
(clearing the controller's fence), rolls every tracked value back to the
last ``commit()`` and calls the function again.

Restore keeps the reference's rank-0 consistency contract. Under elastic
membership it takes the **p2p** path (``HOROVOD_ELASTIC_RESTORE=p2p``,
the default): rank 0 publishes its commit as tiny metadata (the flat
layout and per-shard content digests, ``utils.checkpoint.shard_digest``);
a member whose committed shards hash to those digests keeps its local
copy, so no bytes move; only mismatching or missing shards (a joiner's
everything) are fetched from surviving holders over the existing wires
(``elastic/shards.py``), with a manifest-validated on-disk fallback. A
joiner whose tracked structure differs from rank 0's (an optimizer
without state yet) adopts rank 0's. The hvd-ckpt-digest thread hashes
each commit off the step loop, copying it to the host once, so a
survivor's restore looks digests up rather than hashing the model.
``HOROVOD_ELASTIC_RESTORE=broadcast``, and any job without the Python
controller, takes the other path: rank 0 re-broadcasts its whole commit.

``commit()`` also hands this rank's 1/world_size share of the flat
leaves to the async ``hvd-ckpt-writer`` thread when ``HOROVOD_CKPT_DIR``
is set (or :meth:`State.enable_sharded_checkpoint` was called); rank 0
adds the manifest. The files are the JAX package's format.
"""

from __future__ import annotations

import copy
import functools
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import metrics
from ..common import basics
from ..common import config as config_mod
from ..common import hvd_logging as logging
from ..common.wire import RanksChangedError
from ..utils import checkpoint as ckpt
from . import shards as shards_mod

__all__ = ["RanksChangedError", "State", "run", "epoch"]

_em = None


def _elastic_metrics():
    """The restore plane's series, registered lazily beside the
    controller's reshape ones, under the JAX package's names."""
    global _em
    if _em is None:
        from types import SimpleNamespace

        _em = SimpleNamespace(
            restore_seconds=metrics.histogram(
                "hvd_elastic_restore_seconds",
                "Wall time of one State.restore(): authority metadata "
                "sync + shard verification + any fetches."),
            restore_bytes=metrics.counter(
                "hvd_elastic_restore_bytes_total",
                "Committed-state bytes materialized per restore, by source "
                "(local = digest-matched in-memory copy, peer = fetched "
                "shard, disk = manifest-validated fallback).", ("source",)),
            fetches=metrics.counter(
                "hvd_elastic_shard_fetches_total",
                "Checkpoint-shard fetches resolved during restores, by "
                "source.", ("source",)),
        )
    return _em


def epoch() -> int:
    """Current membership epoch: 1 at rendezvous (and always 1 for
    single-process or non-elastic jobs), bumped by every reshape."""
    if not basics.is_initialized():
        return 1
    ctl = basics.controller()
    return int(getattr(ctl, "membership_epoch", 1)) if ctl else 1


def _topology() -> tuple:
    """(rank, size), (0, 1) before ``hvd.init()``: ``commit()`` stays
    purely local, so a State may be built before init."""
    if not basics.is_initialized():
        return 0, 1
    return basics.rank(), basics.size()


def _snapshot(value: Any) -> Any:
    """The committed copy of one tracked value (on its own device)."""
    if isinstance(value, torch.nn.Module):
        sd = value.state_dict()
        return type(sd)((k, v.detach().clone()) for k, v in sd.items())
    if isinstance(value, torch.optim.Optimizer):
        return copy.deepcopy(value.state_dict())
    return copy.deepcopy(value)


def _leaf_kind(leaf: Any) -> str:
    """Where an array leaf lives: ``cuda``, ``cpu`` or ``numpy``."""
    if torch.is_tensor(leaf):
        return "cuda" if leaf.is_cuda else "cpu"
    return "numpy"


def _dtype_name(leaf: Any) -> str:
    """numpy's name of an array leaf's dtype (``bfloat16`` included)."""
    if torch.is_tensor(leaf):
        return str(leaf.dtype).rpartition(".")[2]
    return str(np.asarray(leaf).dtype)


def _as_leaf(arr: np.ndarray, kind: str, shape) -> Any:
    """A fetched host array as the leaf it replaces: a tensor on this
    rank's card (``cuda``) or the CPU, or an array, in the authority's
    ``shape`` (a 0-d leaf travels as shape (1,), as
    ``np.ascontiguousarray`` makes it)."""
    arr = np.require(arr, requirements=("C", "W")).reshape(tuple(shape))
    if kind == "numpy":
        return arr
    t = torch.from_numpy(arr)
    return t.to(basics.device()) if kind == "cuda" else t


class State:
    """Tracked training state: every keyword becomes an attribute.
    ``commit()`` snapshots the current values; ``restore()`` rolls back
    to the last commit, rank 0's copy authoritative on every rank."""

    def __init__(self, **objects: Any):
        if not objects:
            raise ValueError(
                "hvd.elastic.State needs at least one tracked value, e.g. "
                "State(step=0, model=model, optimizer=optimizer)")
        self._names = tuple(sorted(objects))
        for name, value in objects.items():
            setattr(self, name, value)
        self._committed: Dict[str, Any] = {}
        self._commit_id = 0
        self._commit_world = 1
        self._flat_cache: Optional[tuple] = None
        self._writer: Optional[ckpt.AsyncShardWriter] = None
        self._save_step = 0
        # The hvd-ckpt-digest thread: restore's shard verification needs
        # the digest table of the last commit; commit kicks the worker,
        # and restore uses its table when it is ready for the current
        # commit and layout (else waits for a pass in progress, or hashes
        # inline: the same digests either way).
        self._digest_table: Optional[tuple] = None
        self._digest_memo: Dict[tuple, str] = {}
        self._digest_wake = threading.Event()
        self._digest_stop = threading.Event()
        self._digest_done = threading.Condition()
        self._digest_busy: Optional[int] = None
        self._digest_thread: Optional[threading.Thread] = None
        # Seconds of each digest pass (commit id, seconds), and what the
        # last restore did: the measurements a caller reports.
        self.digest_seconds: List[tuple] = []
        self.last_restore: Optional[dict] = None
        ckpt_dir = config_mod.elastic_ckpt_dir()
        if ckpt_dir:
            self.enable_sharded_checkpoint(ckpt_dir)
        self.commit()
        self._install_exchange()

    # ------------------------------------------------------------- storage

    def enable_sharded_checkpoint(self, directory: str,
                                  keep: Optional[int] = None) -> None:
        """Turn on the continuous async disk tier: every ``commit()``
        hands this rank's shard to the ``hvd-ckpt-writer`` thread (rank
        0 adds the manifest). Never blocks the step loop."""
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
        """Release the background workers (digest thread, disk writer)
        and the shard provider, which pins the committed snapshot."""
        self._digest_stop.set()
        self._digest_wake.set()
        if self._digest_thread is not None:
            self._digest_thread.join(timeout=30.0)
        if self._writer is not None:
            self._writer.close()
        shards_mod.exchange().clear_provider(self)

    # -------------------------------------------------------------- commit

    def commit(self) -> None:
        """Snapshot the current values as the restore point. Purely local
        (no collective): call it at a point every rank reaches in the
        same iteration. With the disk tier on, also enqueues this rank's
        shard for the async writer."""
        self._commit_world = max(1, _topology()[1])
        # The new dict is published before the new id, so a lock-free
        # reader that sees the bumped id flattens the bumped snapshot.
        self._committed = {name: _snapshot(getattr(self, name))
                           for name in self._names}
        self._commit_id += 1
        self._flat_cache = None
        if self._writer is not None:
            self._check_leaves()
            try:
                self._submit_shards()
            except Exception as exc:  # storage must never fail the step
                logging.warning(
                    "elastic: sharded checkpoint submit skipped: %s", exc)
        if config_mod.elastic_enabled() \
                and config_mod.elastic_restore_mode() == "p2p":
            # The table only feeds the p2p restore.
            self._kick_digests()

    # -- the async digest pass ----------------------------------------------

    def _kick_digests(self) -> None:
        if self._digest_thread is None:
            self._digest_thread = threading.Thread(
                target=self._digest_loop, name="hvd-ckpt-digest",
                daemon=True)
            self._digest_thread.start()
        self._digest_wake.set()

    def _digest_loop(self) -> None:
        while not self._digest_stop.is_set():
            if not self._digest_wake.wait(timeout=0.5):
                continue
            if self._digest_stop.is_set():
                return
            cid = self._commit_id
            with self._digest_done:
                self._digest_busy = cid  # before the wake clears: waiters
            self._digest_wake.clear()   # see the pass at every moment
            try:
                t0 = time.perf_counter()
                flat, _st, array_ids, _obj = self._flat_commit()
                layout = self._layout(flat, array_ids, self._commit_world)
                digests = self._hash_layout(flat, layout)
                if self._commit_id == cid:
                    self._digest_table = (
                        cid, tuple(tuple(ids) for ids in layout), digests)
                    self.digest_seconds.append(
                        (cid, time.perf_counter() - t0))
            except Exception as exc:
                logging.debug("elastic: digest precompute failed: %s", exc)
            finally:
                with self._digest_done:
                    self._digest_busy = None
                    self._digest_done.notify_all()

    @staticmethod
    def _hash_layout(flat: List[Any], layout: List[List[int]]
                     ) -> List[Optional[str]]:
        """Per-shard digests of this process's committed leaves under a
        layout; None where a shard names leaves this rank cannot hash."""
        out: List[Optional[str]] = []
        for ids in layout:
            if any(i >= len(flat) or not ckpt.is_array(flat[i])
                   for i in ids):
                out.append(None)
                continue
            try:
                out.append(ckpt.shard_digest([flat[i] for i in ids]))
            except Exception:
                out.append(None)
        return out

    def _digests_for(self, layout: List[List[int]]
                     ) -> List[Optional[str]]:
        """The digest table for ``layout`` against the current commit:
        the precomputed one when it matches (waiting for a pass of this
        commit still running), else an inline pass."""
        key = tuple(tuple(ids) for ids in layout)
        cid = self._commit_id
        deadline = time.monotonic() + 300.0

        def landed():
            table = self._digest_table
            return table is not None and table[0] == cid

        with self._digest_done:
            # A pass of this commit is queued or running: wait for it
            # rather than hash the model a second time beside it.
            while (not landed() and self._commit_id == cid
                   and (self._digest_wake.is_set()
                        or self._digest_busy is not None)
                   and time.monotonic() < deadline):
                self._digest_done.wait(timeout=1.0)
        table = self._digest_table
        if table is not None and table[0] == cid and table[1] == key:
            return table[2]
        digests = self._hash_layout(self._flat_commit()[0], layout)
        if self._commit_id == cid:
            # The shard provider's lookups hit it from here on.
            self._digest_table = (cid, key, digests)
        return digests

    def _digest_of(self, leaf_ids) -> Optional[str]:
        """One shard's digest of the current commit from the table or a
        memo (the shard provider's check); None when neither has it."""
        key = tuple(int(i) for i in leaf_ids)
        cid = self._commit_id
        table = self._digest_table
        if table is not None and table[0] == cid and key in table[1]:
            return table[2][table[1].index(key)]
        memo = self._digest_memo.get((cid, key))
        if memo is None:
            flat = self._flat_commit()[0]
            memo = ckpt.shard_digest([flat[i] for i in key])
            self._digest_memo = {(cid, key): memo}
        return memo

    def _flat_commit(self) -> tuple:
        """``(flat, structure, array_ids, objects)`` of the committed dict:
        flat leaves in JAX's order, the indices that shard (tensors and
        arrays), and the object leaves that ride the metadata. Cached per
        commit."""
        cached = self._flat_cache
        if cached is not None and cached[0] == self._commit_id:
            return cached[1]
        cid = self._commit_id
        committed = self._committed
        flat, structure = ckpt.tree_flatten(
            {name: committed[name] for name in self._names})
        array_ids = [i for i, leaf in enumerate(flat) if ckpt.is_array(leaf)]
        objects = {i: leaf for i, leaf in enumerate(flat)
                   if not ckpt.is_array(leaf)}
        out = (flat, structure, array_ids, objects)
        self._flat_cache = (cid, out)
        return out

    def _check_leaves(self) -> None:
        flat, structure, array_ids, _ = self._flat_commit()
        paths = ckpt.leaf_paths(structure)
        for i in array_ids:
            ckpt.check_numpy_dtype(flat[i], paths[i])

    @staticmethod
    def _layout(flat: List[Any], array_ids: List[int],
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
            epoch_now = epoch()

            def manifest(flat=flat, layout=layout, objects=objects,
                         step=step, world=world, epoch_now=epoch_now):
                return {"step": step, "epoch": epoch_now,
                        "world_size": world, "layout": layout,
                        "digests": [ckpt.shard_digest([flat[i] for i in ids])
                                    for ids in layout],
                        "objects_hex": ckpt.pack_objects(objects)}
        self._writer.submit(step, rank, world, mine, manifest=manifest)

    # ------------------------------------------------------------- restore

    def restore(self) -> None:
        """Roll every tracked value back to the last commit, consistent
        with rank 0 on every member of the current epoch, joiners
        included: the p2p path under elastic membership, rank 0's
        re-broadcast otherwise."""
        t0 = time.monotonic()
        rank, size = _topology()
        if size <= 1:
            self._apply(self._committed)
            self.last_restore = {"mode": "local", "fetched_shards": 0,
                                 "fetched_bytes": 0, "local_bytes": 0}
        elif (config_mod.elastic_enabled()
                and config_mod.elastic_restore_mode() == "p2p"
                and self._p2p_capable()):
            self._restore_p2p(rank, size)
        else:
            self._restore_broadcast(rank)
        took = time.monotonic() - t0
        self.last_restore["seconds"] = took
        self.last_restore["epoch"] = epoch()
        if metrics.on():
            _elastic_metrics().restore_seconds.observe(took)

    def _apply(self, committed: Dict[str, Any]) -> None:
        """Load ``committed`` into the live values: modules and optimizers
        in place through ``load_state_dict`` (an optimizer gets a copy,
        since it adopts the tensors it is given), others as fresh
        copies."""
        for name in self._names:
            live, value = getattr(self, name), committed[name]
            if isinstance(live, torch.nn.Module):
                live.load_state_dict(value)
            elif isinstance(live, torch.optim.Optimizer):
                live.load_state_dict(copy.deepcopy(value))
            else:
                setattr(self, name, copy.deepcopy(value))

    def _p2p_capable(self) -> bool:
        """The shard plane rides the Python controller's TCP star; any
        other controller shape keeps the broadcast path."""
        ctl = basics.controller()
        return (ctl is not None and hasattr(ctl, "clear_reshape_fence")
                and (getattr(ctl, "_service", None) is not None
                     or getattr(ctl, "_client", None) is not None))

    def _install_exchange(self) -> None:
        if not basics.is_initialized() or not self._p2p_capable():
            return
        ex = shards_mod.exchange()
        ex.install(basics.controller())
        ex.set_provider(shards_mod.make_memory_provider(
            lambda: self._flat_commit()[0], self._digest_of), owner=self)

    def _specs(self, flat: List[Any], array_ids: List[int]) -> dict:
        """The structure-level half of rank 0's metadata: where each array
        leaf lives, its byte size, the flat structure and the object
        leaves."""
        _, structure, _, objects = self._flat_commit()
        return {
            "nleaves": len(flat),
            "structure_hex": ckpt.pack_objects({0: structure}),
            "kinds": {i: _leaf_kind(flat[i]) for i in array_ids},
            "nbytes": {i: ckpt.leaf_nbytes(flat[i]) for i in array_ids},
            "shapes": {i: (_dtype_name(flat[i]), tuple(flat[i].shape))
                       for i in array_ids},
            "objects_hex": ckpt.pack_objects(objects),
        }

    def _rebuild(self, meta: dict, committed_flat: List[Any]) -> None:
        """Swap in a new committed snapshot (rank 0's structure) and load
        it into the live values."""
        structure = ckpt.unpack_objects(
            {"objects_hex": meta["structure_hex"]})[0]
        for i, obj in ckpt.unpack_objects(meta).items():
            committed_flat[int(i)] = obj
        tree = ckpt.tree_unflatten(structure, committed_flat)
        self._committed = {name: tree[name] for name in self._names}
        self._apply(self._committed)

    def _restore_broadcast(self, rank: int) -> None:
        """Rank 0's whole commit on every rank: its structure and object
        leaves as one object, then each array leaf broadcast in flat
        order (a rank whose structure differs takes rank 0's)."""
        from ..torch import broadcast_, broadcast_object

        flat, _structure, array_ids, _objects = self._flat_commit()
        meta = broadcast_object(
            self._specs(flat, array_ids) if rank == 0 else None,
            root_rank=0, name="elastic.restore.broadcast")
        committed_flat: List[Any] = [None] * meta["nleaves"]
        moved = 0
        dev = basics.device()
        for i in sorted(meta["kinds"]):
            dtype_name, shape = meta["shapes"][i]
            if rank == 0:
                leaf = flat[i]
                buf = (leaf if torch.is_tensor(leaf)
                       else torch.from_numpy(np.ascontiguousarray(leaf)))
                buf = buf.to(dev)
            else:
                buf = torch.empty(shape, dtype=getattr(torch, dtype_name),
                                  device=dev)
            broadcast_(buf, 0, name=f"elastic.restore.{i}")
            kind = meta["kinds"][i]
            if rank == 0:
                committed_flat[i] = flat[i]
                continue
            moved += ckpt.leaf_nbytes(buf)
            if kind == "numpy":
                committed_flat[i] = _as_leaf(buf.cpu().numpy(), kind, shape)
            else:
                committed_flat[i] = buf if kind == "cuda" else buf.cpu()
        self._rebuild(meta, committed_flat)
        self._commit_id += 1
        self._flat_cache = None
        self._digest_table = None
        self.last_restore = {"mode": "broadcast",
                             "fetched_shards": 0, "fetched_bytes": moved,
                             "local_bytes": 0}
        if metrics.on() and moved:
            _elastic_metrics().restore_bytes.labels("peer").inc(moved)

    # -- the p2p path -------------------------------------------------------

    def _authority_meta(self) -> dict:
        """Rank 0's view of its commit, as tiny metadata: layout,
        per-shard digests, where each leaf lives, the structure and the
        object leaves. O(model) hashing (usually done already by the
        digest thread), O(1) bytes on the wire."""
        flat, _structure, array_ids, _objects = self._flat_commit()
        layout = self._layout(flat, array_ids, self._commit_world)
        digests = self._digests_for(layout)
        if any(d is None for d in digests):
            raise RuntimeError(
                "elastic: rank 0's committed state cannot be hashed; the "
                "p2p restore has no authority to serve")
        return {**self._specs(flat, array_ids),
                "commit_id": self._commit_id,
                "world": self._commit_world, "layout": layout,
                "digests": digests, "save_step": self._save_step}

    def _match_bitmap(self, meta: dict) -> List[bool]:
        """Which authority shards this rank's committed copy already holds
        byte-exactly. A rank whose flat structure differs holds none."""
        flat, structure, _, _ = self._flat_commit()
        if len(flat) != meta["nleaves"] or ckpt.pack_objects(
                {0: structure}) != meta["structure_hex"]:
            return [False] * len(meta["layout"])
        mine = self._digests_for(meta["layout"])
        return [m is not None and m == digest
                for m, digest in zip(mine, meta["digests"])]

    def _restore_p2p(self, rank: int, size: int) -> None:
        from ..torch import allgather_object, broadcast_object

        self._install_exchange()
        # 1. Rank 0's metadata (tiny), then every member's match bitmap
        # (tinier); both ride the negotiated collectives, so a reshape
        # tears them with the same retryable RanksChangedError.
        meta = broadcast_object(
            self._authority_meta() if rank == 0 else None,
            root_rank=0, name="elastic.restore.meta")
        bitmap = (self._match_bitmap(meta) if rank != 0
                  else [True] * len(meta["layout"]))
        bitmaps = allgather_object(bitmap, name="elastic.restore.holders")
        holders = [[r for r in range(size)
                    if k < len(bitmaps[r]) and bitmaps[r][k]]
                   for k in range(len(meta["layout"]))]
        # 2. Fetch what is missing, in parts. Owners rotate over each
        # shard's holders, so a joiner's pulls spread across survivors;
        # rank 0 holds every shard, so every chain is non-empty.
        flat = self._flat_commit()[0]
        mon = metrics.on()
        ex = shards_mod.exchange()
        missing = [k for k in range(len(meta["layout"])) if not bitmap[k]]
        fetched: Dict[int, List[np.ndarray]] = {}
        fetched_bytes = 0
        for k in missing:
            chain = [holders[k][(k + j) % len(holders[k])]
                     for j in range(len(holders[k]))]
            chain = [r for i, r in enumerate(chain)
                     if r != rank and r not in chain[:i]]
            ids = meta["layout"][k]
            parts = shards_mod.shard_parts(
                [meta["nbytes"][i] for i in ids])
            arrays, source = shards_mod.fetch_shard(
                ex, k, meta["digests"][k], ids, chain, parts,
                disk_dir=self.checkpoint_dir
                or config_mod.elastic_ckpt_dir())
            fetched[k] = arrays
            nbytes = sum(int(a.nbytes) for a in arrays)
            fetched_bytes += nbytes
            if mon:
                m = _elastic_metrics()
                m.fetches.labels(source).inc()
                m.restore_bytes.labels(source).inc(nbytes)
        # 3. Rebuild: matched shards keep the local committed leaves,
        # fetched shards replace them (as tensors on this rank's card
        # where rank 0's live on a card), objects adopt rank 0's.
        committed_flat: List[Any] = [None] * meta["nleaves"]
        local_bytes = 0
        for k, ids in enumerate(meta["layout"]):
            if bitmap[k]:
                for i in ids:
                    committed_flat[i] = flat[i]
                    local_bytes += ckpt.leaf_nbytes(flat[i])
            else:
                for i, arr in zip(ids, fetched[k]):
                    committed_flat[i] = _as_leaf(
                        arr, meta["kinds"][i], meta["shapes"][i][1])
        self._rebuild(meta, committed_flat)
        # The commit is rank 0's now, layout and all: the digest pass
        # below hashes it under the authority's layout.
        self._commit_world = int(meta["world"])
        if self._writer is not None and int(meta.get("save_step", -1)) >= 0:
            self._save_step = int(meta["save_step"])
        if missing:
            # Fetched content: a new commit for caching purposes. The
            # all-match case (every survivor) keeps its still-valid
            # table, so its recovery path stays hash-free.
            self._commit_id += 1
            self._flat_cache = None
            self._digest_table = None
            self._kick_digests()
        self.last_restore = {"mode": "p2p", "shards": len(meta["layout"]),
                             "fetched_shards": len(missing),
                             "fetched_bytes": fetched_bytes,
                             "local_bytes": local_bytes,
                             "authority": {"layout": meta["layout"],
                                           "digests": meta["digests"]}}
        if mon:
            _elastic_metrics().restore_bytes.labels("local").inc(local_bytes)


def _acknowledge_reshape() -> None:
    """Clear the controller's reshape fence: collectives enqueued from
    here on ride the new epoch (until then they fail with the
    RanksChangedError their drained siblings got)."""
    if not basics.is_initialized():
        return
    ctl = basics.controller()
    if ctl is not None and hasattr(ctl, "clear_reshape_fence"):
        ctl.clear_reshape_fence()


def run(func):
    """Decorate the training loop for elastic execution: acknowledge any
    reshape, restore the last commit (rank 0's values everywhere), run
    ``func(state, *args, **kwargs)``, and on :class:`RanksChangedError`
    (a reshape interrupted the loop) do it all again. Any other exception
    propagates unchanged."""

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        while True:
            try:
                _acknowledge_reshape()
                state.restore()
                return func(state, *args, **kwargs)
            except RanksChangedError as exc:
                logging.warning(
                    "elastic: %s; restoring state and resuming the "
                    "training loop", exc)
                continue

    return wrapper
