"""Peer-to-peer checkpoint-shard exchange — the port's copy of
``horovod_tpu/elastic/shards.py``.

The transfer half of fast elastic restore: after a reshape, survivors
already hold the whole committed state in memory, so the only bytes that
must move are the shards a member is missing (a joiner's everything, a
diverged rank's mismatches). They move over the existing authenticated
wires as SHARD_FETCH / SHARD_DATA frames (``common/wire.py``), routed
through the coordinator star (requester → coordinator → owner →
coordinator → requester), so a restore needs no connectivity the job
does not already have.

Addressing is by content digest (``utils.checkpoint.shard_digest``): a
fetch names the shard id, the digest the authority (rank 0's commit)
declared, and the flat-leaf indices that make it up; an owner serves
only if its own committed copy hashes to that digest. A racing commit, a
stale reply or a foreign epoch's traffic can never splice wrong bytes
into a restore: at worst a fetch comes back ``found=False`` and the
requester walks its fallback chain (the next surviving holder, then the
manifest-validated on-disk shard, then a loud error naming every source
tried).

One departure from the JAX package: every fetch names a ``part`` of its
shard (``[first, stop)`` into the shard's leaf list; ``(0, n)`` when the
whole shard fits). The owner still checks the whole shard's digest
(cached per commit) and packs only the part; the requester requests
every part at once and hashes the parts in order as they arrive,
checking the digest of the reassembled shard. A frame holds at most
``wire.MAX_FRAME`` (2 GiB) and a fetch attempt waits
``FETCH_ATTEMPT_TIMEOUT``: a model-sized shard (Llama-300M with its
AdamW moments is 3.8 GB, one shard in a world of one) fits neither, so
:func:`shard_parts` cuts shards into parts of at most ``PART_BYTES``.
The frames' framing is the JAX wire's; their payload carries the extra
``part`` key.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import hvd_logging as logging
from ..utils.checkpoint import (
    SHARDED_PREFIX,
    _sharded_steps,
    digest_update,
    load_shard,
    manifest_path,
    pack_shard,
    read_manifest,
    shard_digest,
    shard_hasher,
    shard_path,
    unpack_shard,
)

# Per-holder attempt bound: long enough for a part to cross the star
# twice under load, short enough that a dead owner's chain falls through
# to disk well inside the liveness deadline.
FETCH_ATTEMPT_TIMEOUT = 15.0

# Largest part of a shard one fetch moves.
PART_BYTES = 256 << 20


class ShardFetchError(RuntimeError):
    """No source produced the shard: every surviving holder declined or
    timed out and no manifest-validated on-disk copy matched."""


def shard_parts(leaf_nbytes: Sequence[int],
                limit: int = PART_BYTES) -> List[Tuple[int, int]]:
    """Cut a shard's leaves (their byte sizes, in shard order) into
    consecutive ``[first, stop)`` runs of at most ``limit`` bytes (a
    larger leaf is a part of its own). One part, ``(0, n)``, when the
    shard fits."""
    parts: List[Tuple[int, int]] = []
    first, total = 0, 0
    for i, n in enumerate(leaf_nbytes):
        if i > first and total + int(n) > limit:
            parts.append((first, i))
            first, total = i, 0
        total += int(n)
    parts.append((first, len(leaf_nbytes)))
    return parts


class _Fetch:
    __slots__ = ("shard", "digest", "part", "nonce", "event", "found",
                 "data")

    def __init__(self, shard: int, digest: str, part: Tuple[int, int],
                 nonce: int = 0):
        self.shard = shard
        self.digest = digest
        self.part = part
        # Per-attempt id: a late reply of a timed-out earlier attempt
        # must not fulfil a newer attempt's future.
        self.nonce = nonce
        self.event = threading.Event()
        self.found = False
        self.data: Optional[bytes] = None

    @property
    def key(self) -> tuple:
        return (self.shard, self.digest, self.part)


def _key(info: dict) -> tuple:
    return (int(info["shard"]), info["digest"], tuple(info["part"]))


class ShardExchange:
    """One process's half of the shard plane: requester futures, the
    provider serving this rank's committed copy, and on rank 0 the star
    relay. Installed onto a live controller's wires; ``reform()`` keeps
    Wire objects, so an installation survives membership epochs."""

    def __init__(self):
        # Covers the pending-futures table only; never held across a send.
        self._lock = threading.Lock()
        self._pending: Dict[tuple, _Fetch] = {}
        self._provider = None
        self._provider_owner = None
        self._ctl = None
        self._nonce = 0

    # ------------------------------------------------------------- install

    def install(self, controller) -> None:
        """Bind to a controller and hook the shard callback onto its
        wires (both star sides). Idempotent; re-binding to a new
        controller drops stale futures."""
        if controller is self._ctl:
            return
        with self._lock:
            self._pending = {}
        self._ctl = controller
        service = getattr(controller, "_service", None)
        client = getattr(controller, "_client", None)
        if service is not None:
            service.set_shard_callback(self._on_frame)
        if client is not None:
            client.wire.set_shard_callback(self._on_frame)

    def set_provider(self, fn, owner=None) -> None:
        """``fn(shard_id, digest, leaf_ids, part) -> Optional[bytes]``
        serving this rank's committed copy (None: no matching copy here).
        ``owner`` tags who installed it, so its teardown can release the
        closure without clobbering a newer installation."""
        self._provider = fn
        self._provider_owner = owner

    def clear_provider(self, owner) -> None:
        """Drop the provider if ``owner`` still owns it."""
        if self._provider_owner is owner:
            self._provider = None
            self._provider_owner = None

    # ------------------------------------------------------- frame handling

    @staticmethod
    def _answer(info: dict, blob: Optional[bytes]) -> dict:
        return {"shard": int(info["shard"]), "digest": info["digest"],
                "part": list(info["part"]), "req": int(info["req"]),
                "nonce": info.get("nonce"), "found": blob is not None,
                "data": blob}

    def _serve(self, info: dict) -> dict:
        """The reply to a fetch this rank owns."""
        blob = None
        provider = self._provider
        if provider is not None:
            try:
                blob = provider(int(info["shard"]), info["digest"],
                                list(info.get("leaves", ())),
                                tuple(info["part"]))
            except Exception as exc:
                logging.warning("shards: provider failed for shard %s: %s",
                                info.get("shard"), exc)
                blob = None
        return self._answer(info, blob)

    def _fulfill(self, info: dict) -> None:
        key = _key(info)
        with self._lock:
            fetch = self._pending.get(key)
            if fetch is None or fetch.nonce != info.get("nonce"):
                fetch = None  # superseded or stale attempt's reply
            else:
                del self._pending[key]
        if fetch is None:
            return
        fetch.found = bool(info.get("found"))
        fetch.data = info.get("data")
        fetch.event.set()

    def _coordinator_wire(self, rank: int):
        service = getattr(self._ctl, "_service", None)
        if service is None:
            return None
        with service._wires_lock:
            return service.wires.get(rank)

    def _on_frame(self, event: str, info: dict) -> None:
        """Per-wire callback (on whatever thread drained the frame).
        Worker side: serve fetches, consume replies. Coordinator side:
        serve or consume what is addressed to rank 0, relay the rest; a
        relay target that died answers the requester ``found=False`` at
        once, so its fallback chain advances."""
        ctl = self._ctl
        if ctl is None:
            return
        is_coord = getattr(ctl, "_service", None) is not None
        if event == "fetch":
            owner = int(info.get("owner", -1))
            if not is_coord or owner == 0:
                self._reply(self._serve(info))
                return
            wire = self._coordinator_wire(owner)
            if wire is None:
                self._reply(self._answer(info, None))
                return
            try:
                wire.send_shard_fetch(info)
            except Exception as exc:
                logging.debug("shards: relay to owner %d failed (%s)",
                              owner, exc)
                self._reply(self._answer(info, None))
        else:  # "data"
            req = int(info.get("req", -1))
            if is_coord and req != 0:
                wire = self._coordinator_wire(req)
                if wire is None:
                    return  # requester died: nothing to relay to
                try:
                    wire.send_shard_data(info)
                except Exception as exc:
                    logging.debug("shards: relay to requester %d failed "
                                  "(%s)", req, exc)
                return
            self._fulfill(info)

    def _reply(self, info: dict) -> None:
        """Send a SHARD_DATA answer toward the requester: workers hand it
        to the star; rank 0 sends straight to the requester's wire (or
        fulfils its own future for a local serve)."""
        ctl = self._ctl
        if getattr(ctl, "_service", None) is not None:
            if int(info["req"]) == 0:
                self._fulfill(info)
                return
            wire = self._coordinator_wire(int(info["req"]))
            if wire is None:
                return
            try:
                wire.send_shard_data(info)
            except Exception as exc:
                logging.debug("shards: reply to requester %d failed (%s)",
                              info["req"], exc)
            return
        client = getattr(ctl, "_client", None)
        if client is None:
            return
        try:
            client.wire.send_shard_data(info)
        except Exception as exc:
            logging.debug("shards: reply send failed (%s)", exc)

    # ------------------------------------------------------------ requester

    def fetch_async(self, shard: int, digest: str, leaf_ids: Sequence[int],
                    owner: int, part: Tuple[int, int]) -> _Fetch:
        """Issue one fetch of ``part`` of a shard's leaves toward
        ``owner``, a surviving holder's current rank; returns the future
        the SHARD_DATA reply fulfils."""
        fetch = _Fetch(shard, digest, (int(part[0]), int(part[1])))
        with self._lock:
            self._nonce += 1
            fetch.nonce = self._nonce
            self._pending[fetch.key] = fetch
        ctl = self._ctl
        rank = ctl.topo.rank
        info = {"shard": int(shard), "digest": digest,
                "leaves": [int(i) for i in leaf_ids],
                "part": list(fetch.part), "req": int(rank),
                "owner": int(owner), "nonce": fetch.nonce}
        try:
            if rank == 0:
                wire = self._coordinator_wire(owner)
                if wire is None:
                    raise ConnectionError(f"no wire to owner {owner}")
                wire.send_shard_fetch(info)
            else:
                ctl._client.wire.send_shard_fetch(info)
        except Exception as exc:
            logging.debug("shards: fetch send to owner %d failed (%s)",
                          owner, exc)
            fetch.found = False
            fetch.event.set()
        return fetch

    def wait(self, fetch: _Fetch,
             timeout: float = FETCH_ATTEMPT_TIMEOUT) -> bool:
        """Block the (user) restore thread on one fetch, watching for the
        job tearing underneath it: a reshape fence raises the retryable
        RanksChangedError, so ``hvd.elastic.run`` restarts the restore at
        the new epoch."""
        deadline = time.monotonic() + timeout
        while not fetch.event.wait(0.02):
            ctl = self._ctl
            fence = getattr(ctl, "_reshape_fence", None)
            if fence is not None:
                raise fence
            if ctl is None or ctl._closed.is_set():
                raise RuntimeError(
                    "shard fetch aborted: the controller shut down")
            if time.monotonic() > deadline:
                with self._lock:
                    self._pending.pop(fetch.key, None)
                return False
        return fetch.found


def _fetch_from(exchange: ShardExchange, shard: int, digest: str,
                leaf_ids: Sequence[int], owner: int, parts,
                attempt_timeout: float) -> Optional[List[np.ndarray]]:
    """Every part of one shard from ``owner``: all requested at once (the
    owner serves them back to back while this thread unpacks and hashes
    the ones that arrived), checked against ``digest`` whole. None when
    a part does not come."""
    fetches = [exchange.fetch_async(shard, digest, leaf_ids, owner, part)
               for part in parts]
    h = shard_hasher()
    arrays: List[np.ndarray] = []
    for fetch in fetches:
        if not (exchange.wait(fetch, timeout=attempt_timeout)
                and fetch.data):
            return None
        got = unpack_shard(fetch.data)
        fetch.data = None
        for a in got:
            digest_update(h, a)
        arrays.extend(got)
    if h.hexdigest() != digest:
        raise ValueError(f"shard digest mismatch: expected {digest}, got "
                         f"{h.hexdigest()} (torn or foreign shard)")
    return arrays


def fetch_shard(exchange: ShardExchange, shard: int, digest: str,
                leaf_ids: Sequence[int], holders: Sequence[int],
                parts: Sequence[Tuple[int, int]],
                disk_dir: Optional[str] = None,
                prefix: str = SHARDED_PREFIX,
                attempt_timeout: float = FETCH_ATTEMPT_TIMEOUT,
                ) -> Tuple[List[np.ndarray], str]:
    """Fetch one shard through its fallback chain: each surviving holder
    in order (peer memory), then the newest on-disk step whose manifest
    records this digest, then a loud error naming every source tried.
    ``parts`` (from :func:`shard_parts`) are the pieces it moves in. Returns
    ``(arrays, source)`` with source ``"peer"`` or ``"disk"``."""
    tried: List[str] = []
    for owner in holders:
        try:
            arrays = _fetch_from(exchange, shard, digest, leaf_ids, owner,
                                 parts, attempt_timeout)
        except ValueError as exc:
            tried.append(f"rank {owner} (bad payload: {exc})")
            continue
        if arrays is not None:
            return arrays, "peer"
        tried.append(f"rank {owner} (no matching copy or timeout)")
    arrays = _disk_shard(disk_dir, shard, digest, prefix)
    if arrays is not None:
        return arrays, "disk"
    tried.append(f"disk under {disk_dir!r} (no manifest records digest "
                 f"{digest})")
    raise ShardFetchError(
        f"shard {shard} (digest {digest}) unrecoverable; tried: "
        + "; ".join(tried))


def _disk_shard(directory: Optional[str], shard: int, digest: str,
                prefix: str) -> Optional[List[np.ndarray]]:
    """Newest on-disk copy of a shard matching ``digest``, manifest-
    validated: the fallback when every in-memory holder is gone."""
    if not directory:
        return None
    for step in _sharded_steps(directory, prefix):
        try:
            manifest = read_manifest(manifest_path(directory, step, prefix))
            digests = manifest.get("digests", [])
            if shard >= len(digests) or digests[shard] != digest:
                continue
            world = int(manifest["world_size"])
            return load_shard(shard_path(directory, step, shard, world,
                                         prefix), expect_digest=digest)
        except (OSError, ValueError, KeyError):
            continue  # torn or incomplete step: keep scanning older ones
    return None


def make_memory_provider(get_flat, digest_of=None):
    """Provider over an in-memory committed snapshot: ``get_flat()``
    returns the current flat leaf list (or None). Serves a part of a
    shard only if the whole shard's leaves hash to the requested digest;
    ``digest_of(leaf_ids)`` may return that digest from a cache (None:
    hash now)."""

    def provide(shard: int, digest: str, leaf_ids: Sequence[int],
                part: Tuple[int, int]) -> Optional[bytes]:
        flat = get_flat()
        if flat is None:
            return None
        try:
            leaves = [flat[i] for i in leaf_ids]
            have = digest_of(leaf_ids) if digest_of is not None else None
            if have is None:
                have = shard_digest(leaves)
        except Exception:
            # Out-of-range or non-array leaf: no copy to serve.
            return None
        if have != digest:
            return None
        return pack_shard(leaves[part[0]:part[1]])

    return provide


_exchange: Optional[ShardExchange] = None


def exchange() -> ShardExchange:
    """The process-wide exchange (one controller per process)."""
    global _exchange
    if _exchange is None:
        _exchange = ShardExchange()
    return _exchange
