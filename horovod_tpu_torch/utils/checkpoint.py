"""Checkpoint and resume — the port's counterpart of
``horovod_tpu/utils/checkpoint.py``.

**The plain checkpoint** keeps the reference's contract: rank 0 saves
(``save_checkpoint``); on resume every rank loads and, in a job of more
than one rank, takes rank 0's values by broadcast (``restore_checkpoint``),
so a rank that read a stale file cannot diverge. Its storage is the
port's own: ``torch.save`` of the tree (nested dicts, lists and tuples of
tensors and Python scalars, e.g. ``{"params": model.state_dict(),
"opt_state": optimizer.state_dict(), "step": 10}``) into
``<path>/checkpoint.pt``, read back with ``torch.load(weights_only=True)``.
The JAX package writes orbax directories; the two plain formats do not
interchange.

**The sharded checkpoint** (``shard_layout`` .. ``AsyncShardWriter``) is
framework-neutral, and the port writes and reads the same bytes as the
JAX package: each rank persists its share of the committed tree's flat
leaves as a pickled list of numpy arrays (``shard.bin`` + ``meta.json``),
and rank 0 adds a JSON manifest (step, membership epoch, world size, the
shard layout, each shard's blake2b digest over dtype, shape and bytes,
and the non-array leaves as a hex pickle). A checkpoint written by either
package restores in the other. Flat leaves follow JAX's order (dict keys
sorted, ``OrderedDict`` in insertion order, lists and tuples in order,
None no leaf), so the layouts and digests agree. A bfloat16 tensor has no
numpy form without ``ml_dtypes``: it is refused with its leaf's name.

Every write, plain or sharded, goes through ``_write_atomically``: a kill
at any rename point leaves the previous complete checkpoint visible.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import pickle
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import fault
from .. import metrics
from ..common import basics
from ..common import hvd_logging as logging

PLAIN_FILE = "checkpoint.pt"


def _write_atomically(path: str, write: Callable[[str], None],
                      force: bool = True) -> None:
    """Write a checkpoint directory torn-proof: materialize under a
    ``<path>.tmp.<pid>`` sibling (same filesystem, so the rename is
    atomic) and swing it into place only once complete.

    Invariant: at every kill point at least one COMPLETE checkpoint is
    visible to the resume path. Overwriting retires the old directory to
    ``<path>.prev`` between the two renames (directories cannot be
    ``os.replace``'d atomically), and an orphaned ``.prev`` without its
    primary counts as that step. Orphans of any earlier attempt (each
    respawn has a fresh pid) are swept first."""
    parent = os.path.dirname(path) or "."
    base = os.path.basename(path) + ".tmp."
    for name in os.listdir(parent) if os.path.isdir(parent) else ():
        if name.startswith(base):
            shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    write(tmp)
    if os.path.exists(path):
        if not force:
            shutil.rmtree(tmp, ignore_errors=True)
            raise FileExistsError(
                f"checkpoint {path} already exists (force=False)")
        old = f"{path}.prev"
        shutil.rmtree(old, ignore_errors=True)  # stale recovery artifact
        os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, path)


def _rank_size() -> Tuple[int, int]:
    """(rank, size) of the job; (0, 1) before ``init()``."""
    if not basics.is_initialized():
        return 0, 1
    return basics.rank(), basics.size()


# ---------------------------------------------------------------------------
# Trees, in JAX's leaf order


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure) of nested dicts, lists and tuples, in the
    order ``jax.tree_util`` flattens them."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, collections.OrderedDict):
            keys = list(node)
            return ("odict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return ("namedtuple", type(node), [walk(v) for v in node])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(v) for v in node])
        leaves.append(node)
        return ("leaf", None, None)

    return leaves, walk(tree)


def tree_unflatten(structure, leaves: Sequence[Any]):
    """The inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kind, meta, children = node
        if kind == "leaf":
            return next(it)
        values = [build(c) for c in children]
        if kind == "odict":
            return collections.OrderedDict(zip(meta, values))
        if kind == "dict":
            return dict(zip(meta, values))
        if kind == "namedtuple":
            return meta(*values)
        return kind(values)

    out = build(structure)
    if next(it, _END) is not _END:
        raise ValueError("tree_unflatten: more leaves than the structure")
    return out


_END = object()


def leaf_paths(structure, prefix: str = "") -> List[str]:
    """``a/b/0``-style names of the leaves, in flat order."""
    if structure is None:
        return []
    kind, meta, children = structure
    if kind == "leaf":
        return [prefix]
    keys = meta if kind in ("dict", "odict") else range(len(children))
    out = []
    for k, c in zip(keys, children):
        out += leaf_paths(c, f"{prefix}/{k}" if prefix else str(k))
    return out


def is_array(leaf: Any) -> bool:
    """Array leaves shard; Python scalars and objects ride the manifest
    (so a ``step`` counter stays an int)."""
    return torch.is_tensor(leaf) or isinstance(leaf, (np.ndarray,
                                                      np.generic))


def leaf_nbytes(leaf: Any) -> int:
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)


def check_numpy_dtype(leaf: Any, name: str = "") -> None:
    """Refuse, with the leaf's name, a tensor whose dtype numpy lacks
    (bfloat16, the float8s)."""
    if torch.is_tensor(leaf) and leaf.dtype.is_floating_point \
            and leaf.dtype not in (torch.float16, torch.float32,
                                   torch.float64):
        raise ValueError(
            f"checkpoint leaf {name or '?'} is {leaf.dtype}, which has no "
            "numpy form in the shared checkpoint format; keep master "
            "weights, moments and statistics float32 (cast a copy to "
            "float32 to save it)")


def to_numpy(leaf: Any, name: str = "") -> np.ndarray:
    """A leaf's numpy form (a host copy of a tensor)."""
    if torch.is_tensor(leaf):
        check_numpy_dtype(leaf, name)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# ---------------------------------------------------------------------------
# The plain checkpoint


def broadcast_tree(tree: Any, root_rank: int = 0) -> Any:
    """``root_rank``'s values of ``tree`` on every rank (a collective):
    tensors and arrays broadcast in flat order through the bound device,
    each coming back on its own device and dtype; the other leaves as
    one pickled object."""
    from ..torch import broadcast_, broadcast_object

    leaves, structure = tree_flatten(tree)
    dev = basics.device()
    out = list(leaves)
    for i, leaf in enumerate(leaves):
        if torch.is_tensor(leaf):
            buf = leaf.detach().to(dev).contiguous()
            broadcast_(buf, root_rank, name=f"checkpoint.{i}")
            out[i] = buf.to(leaf.device)
        elif isinstance(leaf, np.ndarray):
            buf = torch.from_numpy(np.ascontiguousarray(leaf)).to(dev)
            broadcast_(buf, root_rank, name=f"checkpoint.{i}")
            out[i] = buf.cpu().numpy()
    others = {i: leaf for i, leaf in enumerate(leaves)
              if not (torch.is_tensor(leaf) or isinstance(leaf, np.ndarray))}
    for i, value in broadcast_object(others, root_rank).items():
        out[i] = value
    return tree_unflatten(structure, out)


def save_checkpoint(path: str, tree: Any, root_rank: int = 0,
                    force: bool = True) -> None:
    """Write ``tree`` at ``path`` from ``root_rank`` only (the reference's
    rank-0-saves pattern); a no-op on other ranks, all may call it. The
    write is atomic: ``path`` holds the previous complete checkpoint or
    the new one, never a torn mix."""
    if _rank_size()[0] != root_rank:
        return
    path = os.path.abspath(path)

    def write(tmp: str) -> None:
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, PLAIN_FILE))

    _write_atomically(path, write, force=force)
    logging.debug("saved checkpoint at %s", path)


def restore_checkpoint(path: str, like: Optional[Any] = None,
                       root_rank: int = 0, broadcast: bool = True) -> Any:
    """Load the tree at ``path``; each tensor lands on the device of
    ``like``'s leaf at its place (the CPU without ``like``, whose
    structure must match). With ``broadcast`` (default) in a job of more
    than one rank, ``root_rank``'s values are re-broadcast so every rank
    resumes identically.

    A missing path — or a ``.tmp.`` transient of a save killed mid-write
    — raises FileNotFoundError naming the path AND the nearest complete
    checkpoint in its directory."""
    path = os.path.abspath(path)
    if not os.path.exists(path) or ".tmp." in os.path.basename(path):
        near = latest_checkpoint(os.path.dirname(path) or ".")
        state = ("a torn .tmp. transient of an interrupted save"
                 if os.path.exists(path) else "missing")
        raise FileNotFoundError(
            f"checkpoint {path} is {state}; nearest complete checkpoint "
            f"in its directory: {near if near else 'none'}")
    restored = torch.load(os.path.join(path, PLAIN_FILE), map_location="cpu",
                          weights_only=True)
    if like is not None:
        leaves, structure = tree_flatten(restored)
        like_leaves, like_structure = tree_flatten(like)
        if len(leaves) != len(like_leaves):
            raise ValueError(
                f"checkpoint {path} holds {len(leaves)} leaves but `like` "
                f"has {len(like_leaves)}")
        restored = tree_unflatten(structure, [
            leaf.to(ref.device) if torch.is_tensor(leaf)
            and torch.is_tensor(ref) else leaf
            for leaf, ref in zip(leaves, like_leaves)])
    if broadcast and _rank_size()[1] > 1:
        restored = broadcast_tree(restored, root_rank)
    return restored


def restart_epoch() -> int:
    """Supervision attempt number (``HOROVOD_RESTART_EPOCH``, bumped on
    every relaunch; 0 on the first launch and outside a launcher):
    training scripts branch on it to resume instead of reinitializing."""
    from ..common import config

    return config.restart_epoch()


def restore_latest(directory: str, like: Optional[Any] = None,
                   prefix: str = "ckpt_", root_rank: int = 0,
                   broadcast: bool = True):
    """``(path, tree)`` of the newest checkpoint under ``directory``, or
    ``(None, None)`` when there is nothing to resume."""
    path = latest_checkpoint(directory, prefix)
    if path is None:
        return None, None
    tree = restore_checkpoint(path, like=like, root_rank=root_rank,
                              broadcast=broadcast)
    logging.info("resumed from checkpoint %s (restart epoch %d)",
                 path, restart_epoch())
    return path, tree


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """Newest ``<directory>/<prefix><step>`` path, or None. ``.tmp.``
    transients of an interrupted save are never candidates; a
    ``<prefix><step>.prev`` WITHOUT its primary is the complete previous
    save of an overwrite killed between its two renames, and counts as
    that step (the primary, when present, wins)."""
    if not os.path.isdir(directory):
        return None
    names = set(os.listdir(directory))
    best, best_step = None, -1
    for name in sorted(names):
        if name.startswith(prefix):
            if ".tmp." in name:
                continue
            stem = name
            if name.endswith(".prev"):
                stem = name[:-len(".prev")]
                if stem in names:
                    continue
            try:
                step = int(stem[len(prefix):])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(directory, name), step
    return best


# ---------------------------------------------------------------------------
# Sharded checkpoints: each rank persists its 1/world_size share of the
# committed tree's flat leaves; rank 0 adds the manifest.

SHARDED_PREFIX = "sharded_"

_m = None


def _ckpt_metrics():
    """Registered lazily, never at import."""
    global _m
    if _m is None:
        from types import SimpleNamespace

        _m = SimpleNamespace(
            commits=metrics.counter(
                "hvd_ckpt_commits_total",
                "Sharded-checkpoint snapshots handed to the async "
                "hvd-ckpt-writer thread."),
            dropped=metrics.counter(
                "hvd_ckpt_dropped_commits_total",
                "Snapshots superseded in the writer's double buffer "
                "before reaching storage (commit cadence outran the "
                "write; the NEWEST snapshot always persists)."),
            write_seconds=metrics.histogram(
                "hvd_ckpt_write_seconds",
                "Wall time of one async shard (+manifest) persist, on "
                "the writer thread — never on the step loop."),
            written_bytes=metrics.counter(
                "hvd_ckpt_written_bytes_total",
                "Payload bytes persisted by the async shard writer."),
        )
    return _m


def shard_layout(leaf_nbytes: Sequence[int], world_size: int
                 ) -> List[List[int]]:
    """Assign flat-leaf indices to ``world_size`` shards, walking the
    leaves in flat order and placing each on the currently lightest
    shard (ties to the lowest shard id). A pure function of (leaf sizes,
    world size): every rank computes the same map."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    shards: List[List[int]] = [[] for _ in range(world_size)]
    weights = [0] * world_size
    for idx, nbytes in enumerate(leaf_nbytes):
        k = min(range(world_size), key=lambda s: (weights[s], s))
        shards[k].append(idx)
        weights[k] += int(nbytes)
    return shards


def _host_arrays(arrays: Sequence[Any]) -> List[np.ndarray]:
    return [np.ascontiguousarray(to_numpy(a, f"{i} of the shard"))
            for i, a in enumerate(arrays)]


def _digest_parts(leaf: Any) -> Tuple[str, Tuple[int, ...], Any]:
    """(numpy's dtype name, ``np.ascontiguousarray``'s shape, a flat byte
    view) of one leaf, as the JAX package hashes it. A tensor costs one
    host copy (one D2H for a CUDA tensor) and no numpy dtype, so
    bfloat16 hashes as ml_dtypes' ``bfloat16`` does."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        return (str(t.dtype).rpartition(".")[2], tuple(t.shape) or (1,),
                t.reshape(-1).view(torch.uint8).numpy())
    a = np.ascontiguousarray(leaf)
    return str(a.dtype), a.shape, a.reshape(-1).view(np.uint8)


def shard_hasher():
    """A running :func:`shard_digest`: feed it leaves in shard order with
    :func:`digest_update`, read ``hexdigest()``."""
    return hashlib.blake2b(digest_size=16)


def digest_update(h, leaf: Any) -> None:
    dtype, shape, data = _digest_parts(leaf)
    h.update(dtype.encode())
    h.update(str(shape).encode())
    h.update(data)


def shard_digest(arrays: Sequence[Any]) -> str:
    """Content digest of one shard's leaves: dtype + shape + bytes per
    leaf, in shard order, equal to the JAX package's for the same values
    (bfloat16 included). The identity key of the p2p restore plane: a
    peer serves a shard only if its copy hashes to the digest asked
    for."""
    h = shard_hasher()
    for leaf in arrays:
        digest_update(h, leaf)
    return h.hexdigest()


def shard_path(directory: str, step: int, shard_id: int, world_size: int,
               prefix: str = SHARDED_PREFIX) -> str:
    return os.path.join(directory,
                        f"{prefix}{step}.shard{shard_id}of{world_size}")


def manifest_path(directory: str, step: int,
                  prefix: str = SHARDED_PREFIX) -> str:
    return os.path.join(directory, f"{prefix}{step}.manifest")


def pack_shard(arrays: Sequence[Any]) -> bytes:
    """One shard's leaves as self-describing bytes: a pickled list of
    numpy arrays, byte for byte what the JAX package writes."""
    return pickle.dumps(_host_arrays(arrays),
                        protocol=pickle.HIGHEST_PROTOCOL)


def unpack_shard(blob: bytes, expect_digest: Optional[str] = None
                 ) -> List[np.ndarray]:
    arrays = [np.asarray(a) for a in pickle.loads(blob)]
    if expect_digest is not None:
        got = shard_digest(arrays)
        if got != expect_digest:
            raise ValueError(
                f"shard digest mismatch: expected {expect_digest}, "
                f"got {got} (torn or foreign shard)")
    return arrays


def save_shard(directory: str, step: int, shard_id: int, world_size: int,
               arrays: Sequence[Any], prefix: str = SHARDED_PREFIX) -> str:
    """Persist one shard torn-proof (atomic rename swing). Returns the
    final path."""
    path = shard_path(directory, step, shard_id, world_size, prefix)
    host = _host_arrays(arrays)
    blob = pack_shard(host)
    digest = shard_digest(host)

    def write(tmp: str) -> None:
        os.makedirs(tmp)
        with open(os.path.join(tmp, "shard.bin"), "wb") as f:
            f.write(blob)
        with open(os.path.join(tmp, "meta.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"step": step, "shard": shard_id,
                       "world_size": world_size, "digest": digest,
                       "nbytes": len(blob)}, f)

    os.makedirs(directory, exist_ok=True)
    _write_atomically(path, write)
    return path


def load_shard(path: str, expect_digest: Optional[str] = None
               ) -> List[np.ndarray]:
    """Read one shard directory back, digest-validated (against its own
    recorded meta, and against ``expect_digest``, the manifest's, when
    given)."""
    with open(os.path.join(path, "shard.bin"), "rb") as f:
        blob = f.read()
    with open(os.path.join(path, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    arrays = unpack_shard(blob, expect_digest=meta.get("digest"))
    if expect_digest is not None and meta.get("digest") != expect_digest:
        raise ValueError(
            f"shard {path} holds digest {meta.get('digest')}, manifest "
            f"expects {expect_digest}")
    return arrays


def write_manifest(directory: str, step: int, manifest: Dict[str, Any],
                   prefix: str = SHARDED_PREFIX) -> str:
    path = manifest_path(directory, step, prefix)

    def write(tmp: str) -> None:
        os.makedirs(tmp)
        with open(os.path.join(tmp, "manifest.json"), "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, sort_keys=True)

    os.makedirs(directory, exist_ok=True)
    _write_atomically(path, write)
    return path


def read_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "manifest.json"), encoding="utf-8") as f:
        return json.load(f)


def _sharded_steps(directory: str, prefix: str) -> List[int]:
    """Steps with a (renamed-whole) manifest present, descending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in sorted(os.listdir(directory)):
        if (name.startswith(prefix) and name.endswith(".manifest")
                and ".tmp." not in name):
            stem = name[len(prefix):-len(".manifest")]
            try:
                steps.append(int(stem))
            except ValueError:
                continue
    return sorted(set(steps), reverse=True)


def latest_sharded_checkpoint(directory: str, prefix: str = SHARDED_PREFIX
                              ) -> Optional[Tuple[int, Dict[str, Any]]]:
    """Newest COMPLETE sharded step: manifest readable and every shard
    directory it names renamed into place."""
    for step in _sharded_steps(directory, prefix):
        path = manifest_path(directory, step, prefix)
        try:
            manifest = read_manifest(path)
        except (OSError, ValueError):
            continue
        world = int(manifest.get("world_size", 0))
        if world < 1:
            continue
        if all(os.path.isdir(shard_path(directory, step, k, world, prefix))
               for k in range(world)):
            return step, manifest
    return None


def restore_latest_sharded(directory: str, like: Any,
                           prefix: str = SHARDED_PREFIX):
    """``(step, tree)`` of the newest step whose manifest AND every
    digest-validated shard load whole, or ``(None, None)``. ``like``
    gives the structure (the shards hold flat leaves); where its leaf is
    a tensor the restored leaf is one, on that tensor's device, else a
    numpy array (object leaves come back as they were saved)."""
    like_leaves, structure = tree_flatten(like)
    for step in _sharded_steps(directory, prefix):
        path = manifest_path(directory, step, prefix)
        try:
            manifest = read_manifest(path)
            leaves = load_manifest_leaves(directory, manifest, prefix)
        except (OSError, ValueError, KeyError) as exc:
            logging.warning(
                "sharded checkpoint step %s under %s is incomplete or "
                "torn (%s); trying the previous step", step, directory, exc)
            continue
        if len(like_leaves) != len(leaves):
            raise ValueError(
                f"sharded checkpoint {path} holds {len(leaves)} leaves "
                f"but `like` has {len(like_leaves)} — structure changed "
                "between save and resume")
        leaves = [torch.from_numpy(np.array(leaf)).to(ref.device)
                  if torch.is_tensor(ref) and isinstance(leaf, np.ndarray)
                  else leaf for leaf, ref in zip(leaves, like_leaves)]
        return step, tree_unflatten(structure, leaves)
    return None, None


def load_manifest_leaves(directory: str, manifest: Dict[str, Any],
                         prefix: str = SHARDED_PREFIX) -> List[Any]:
    """All flat leaves of one manifest's step, read from its shard
    directories (each digest-validated) with the manifest's object
    leaves spliced back in."""
    step = int(manifest["step"])
    world = int(manifest["world_size"])
    layout = manifest["layout"]
    total = sum(len(ids) for ids in layout)
    objects = unpack_objects(manifest)
    flat: List[Any] = [None] * (total + len(objects))
    for shard_id in range(world):
        arrays = load_shard(
            shard_path(directory, step, shard_id, world, prefix),
            expect_digest=manifest["digests"][shard_id])
        ids = layout[shard_id]
        if len(arrays) != len(ids):
            raise ValueError(
                f"shard {shard_id} of step {step} holds {len(arrays)} "
                f"leaves, layout expects {len(ids)}")
        for idx, arr in zip(ids, arrays):
            flat[idx] = arr
    for idx, obj in objects.items():
        flat[int(idx)] = obj
    if any(v is None for v in flat):
        raise ValueError(f"step {step}: leaves missing from every shard")
    return flat


def pack_objects(objects: Dict[int, Any]) -> str:
    """Non-array leaves (rare, tiny) ride the manifest as a hex blob."""
    return pickle.dumps(objects, protocol=pickle.HIGHEST_PROTOCOL).hex()


def unpack_objects(manifest: Dict[str, Any]) -> Dict[int, Any]:
    blob = manifest.get("objects_hex")
    if not blob:
        return {}
    return pickle.loads(bytes.fromhex(blob))


class AsyncShardWriter:
    """The ``hvd-ckpt-writer`` daemon thread: commits hand it a snapshot
    and return at once; it persists double-buffered — one pending slot,
    latest wins, so a commit cadence faster than storage drops
    intermediate snapshots (counted) and the newest always lands. All
    file IO runs on this thread; a storage error is kept in
    ``last_error`` and logged, never raised into the step."""

    def __init__(self, directory: str, prefix: str = SHARDED_PREFIX,
                 keep: int = 2):
        self.directory = directory
        self.prefix = prefix
        self.keep = max(2, int(keep))
        self.last_error: Optional[BaseException] = None
        self.written_steps = 0
        self.dropped = 0
        self._pending: Optional[dict] = None
        # Held only around plain attribute swaps, never across a call.
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="hvd-ckpt-writer", daemon=True)
        self._thread.start()

    def next_step(self) -> int:
        """First unused step number: past anything already on disk, so a
        restarted process never shadows an earlier one's steps."""
        steps = _sharded_steps(self.directory, self.prefix)
        return (steps[0] + 1) if steps else 1

    def submit(self, step: int, shard_id: int, world_size: int,
               arrays: Sequence[Any], manifest: Optional[Any] = None) -> None:
        """Hand one snapshot to the writer; never blocks on storage.
        ``manifest``: a dict, or a zero-arg callable building one on the
        writer thread (rank 0 defers the whole-commit digest pass
        there). Tensors are copied to the host on the writer thread."""
        snap = {"step": int(step), "shard": int(shard_id),
                "world": int(world_size), "arrays": list(arrays),
                "manifest": manifest}
        self._idle.clear()
        stopped = False
        dropped = False
        with self._lock:
            if self._stop:
                stopped = True
            else:
                dropped = self._pending is not None
                if dropped:
                    self.dropped += 1
                self._pending = snap
        if stopped:
            self._idle.set()
            return
        self._wake.set()
        if metrics.on():
            m = _ckpt_metrics()
            m.commits.inc()
            if dropped:
                m.dropped.inc()

    def _run(self) -> None:
        while True:
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            with self._lock:
                snap = self._pending
                self._pending = None
                stop = self._stop
            if snap is None:
                self._idle.set()
                if stop:
                    return
                continue
            try:
                self._persist(snap)
            except Exception as exc:  # storage must never fail the job
                self.last_error = exc
                logging.error("ckpt-writer: persisting step %s failed: %s",
                              snap["step"], exc)

    def _persist(self, snap: dict) -> None:
        fault.hook("ckpt_save")  # chaos seam: kill/delay/raise mid-write
        t0 = time.monotonic()
        path = save_shard(self.directory, snap["step"], snap["shard"],
                          snap["world"], snap["arrays"], prefix=self.prefix)
        manifest = snap["manifest"]
        if callable(manifest):
            manifest = manifest()
        if manifest is not None:
            write_manifest(self.directory, snap["step"], manifest,
                           prefix=self.prefix)
        self._prune(snap["step"])
        self.written_steps += 1
        if metrics.on():
            m = _ckpt_metrics()
            m.write_seconds.observe(time.monotonic() - t0)
            m.written_bytes.inc(sum(leaf_nbytes(a) for a in snap["arrays"]))
        logging.debug("ckpt-writer: persisted %s", path)

    def _prune(self, current_step: int) -> None:
        """Retention: entries older than the ``keep`` newest steps go,
        but NEVER the newest COMPLETE step or anything after it (the
        latest-wins buffers drop different steps on different ranks).
        Only whole (renamed) entries are touched."""
        cutoff = current_step - self.keep + 1
        latest = latest_sharded_checkpoint(self.directory, self.prefix)
        if latest is None:
            return
        cutoff = min(cutoff, int(latest[0]))
        if not os.path.isdir(self.directory):
            return
        for name in sorted(os.listdir(self.directory)):
            if not name.startswith(self.prefix) or ".tmp." in name:
                continue
            stem = name[len(self.prefix):].split(".", 1)[0]
            try:
                step = int(stem)
            except ValueError:
                continue
            if step < cutoff:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def flush(self, timeout: float = 30.0) -> bool:
        """Wait for the pending snapshot (if any) to reach storage —
        tests and teardown; the step loop never calls this."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._pending is None and self._idle.is_set():
                return True
            time.sleep(0.005)
        return False

    def close(self, timeout: float = 30.0) -> None:
        self._stop = True
        self._wake.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
