"""One multiplexed logical rank: the worker side of the lockstep protocol
as an explicitly-phased state machine.

A real worker rank is a whole ``Controller`` — a background cycle thread,
a heartbeat thread, handle tables. At 256 ranks that is 500+ threads in
one process, which is exactly the cost this harness exists to avoid.
A :class:`SimWorker` keeps only what the *wire contract* requires: it
dials the coordinator through the real :class:`WorkerClient` (real
socket, real frames, real HMAC, real ``ProtocolMonitor`` role), and
exposes the per-cycle protocol as separate phases — send the tick, recv
the reply, run each response's data exchange — so ONE driving thread can
interleave any number of logical ranks without deadlocking: the lockstep
protocol's global order (all ticks → reply fanout → per-response data
walks) is re-created by the driver calling each phase across all workers
before advancing (``sim/cluster.py``).

Fidelity boundary: everything ON the wire is real —
frame kinds, epochs, reshape acks, abort payloads, conformance
monitoring, and the response-cache bitmask plane: each
logical rank holds its own :class:`ResponseCache` and runs the
controller's exact tick/reply cache contract (``_build_tick`` masks,
``_process_reply`` evictions/bypasses, the reshape reset), so cache-on
jobs simulate with coherent bit masks instead of pinning the cache off.
What is simulated is the process around it: "killing" a logical rank
closes its socket (how a SIGKILLed process looks from the coordinator's
side of the wire), and a delayed tick is the driver sleeping, not a
loaded host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common.message import (Request, RequestList, RequestType, Response,
                              ResponseType)
from ..common.response_cache import ResponseCache
from ..common.wire import RanksChangedError, RemoteAbortError
from ..controller.service import WorkerClient


class SimWorkerDead(ConnectionError):
    """An operation was driven on a logical rank whose wire is gone."""


@dataclasses.dataclass
class SimOp:
    """One collective this logical rank submits on a tick: the sim-side
    mirror of a user calling ``hvd.allreduce_async`` on a real rank."""

    kind: str                       # "allreduce" | "allgather" | "broadcast"
    name: str
    array: np.ndarray
    root_rank: int = -1             # broadcast only

    _TYPES = {"allreduce": RequestType.ALLREDUCE,
              "allgather": RequestType.ALLGATHER,
              "broadcast": RequestType.BROADCAST}

    def request(self, rank: int) -> Request:
        return Request(
            request_rank=rank, request_type=self._TYPES[self.kind],
            tensor_name=self.name, tensor_dtype=str(self.array.dtype),
            tensor_shape=tuple(self.array.shape), root_rank=self.root_rank)


class SimWorker:
    """A logical worker rank multiplexed onto the driver thread."""

    def __init__(self, addr: str, rank: int, size: int,
                 join: bool = False,
                 comm_timeout: Optional[float] = None,
                 cache_capacity: int = 0):
        self.rank = rank
        self.size = size
        self.epoch = 1
        self.alive = True
        self.joined_at_epoch: Optional[int] = None
        # What the driver learns from replies, for assertions: results by
        # tensor name (this step), the last abort/error seen, the last
        # synced autotune push (the JAX package's docs/overlap.md bucket sync).
        self.results: Dict[str, np.ndarray] = {}
        self.executed: set = set()
        self.errors: List[str] = []
        self.abort: Optional[RemoteAbortError] = None
        self.reshapes = 0
        self.last_tune: Optional[tuple] = None
        self.tuned_bucket_bytes: Optional[int] = None
        self._pending: Dict[str, SimOp] = {}
        # The controller's response-cache state, replicated per logical
        # rank so the bit-mask plane stays coherent with rank 0
        # (``capacity=0`` disables it).
        self._cache_capacity = int(cache_capacity)
        self._cache = ResponseCache(self._cache_capacity)
        self._cache_enabled = self._cache_capacity > 0
        self._bit_pending: Dict[int, str] = {}
        self._renegotiate: List[str] = []
        self._bypass: List[Response] = []
        self._client = WorkerClient(addr, rank, join=join,
                                    comm_timeout=comm_timeout)
        if join:
            # A joiner has no identity until the admission assignment;
            # rank/size above are provisional (advisory hello only).
            self.epoch = 0

    # ------------------------------------------------------------ admission

    def await_admission(self) -> None:
        """Joiner half of the elastic handshake: block for the RESHAPE
        assignment, adopt it, and acknowledge — exactly what a real
        joiner's Controller does at init."""
        exc = self._client.await_assignment()
        self._adopt(exc)
        self.joined_at_epoch = exc.epoch
        self._client.wire.send_join({"ack": exc.epoch})

    # ---------------------------------------------------------- tick phase

    def send_tick(self, ops: Optional[List[SimOp]] = None,
                  shutdown: bool = False) -> None:
        """Phase 1 of a cycle: this rank's tick. ``ops`` mirror what the
        coordinator rank enqueued this step (negotiation completes only
        when every rank reports a tensor). Mirrors ``_build_tick``: a
        cached announce parks on its bit instead of sending a request,
        every still-pending bit is re-advertised in ``cache_mask``, and
        a parameter-stale hit raises the bit in ``invalid_mask``."""
        if not self.alive:
            raise SimWorkerDead(f"logical rank {self.rank} is gone")
        ops = ops or []
        # Accumulate, don't replace: the coordinator builds its own tick
        # BEFORE blocking on worker ticks, so a tensor announced on
        # cycle k may only negotiate (and exchange data) on cycle k+1,
        # after an empty follow-up tick.
        self._pending.update({op.name: op for op in ops})
        announce = list(ops)
        if self._renegotiate:
            # Names whose cache bit died under them (invalidation, or
            # the cache categorical flipping off) re-enter as ordinary
            # announces — the controller's _queue requeue path.
            announce.extend(self._pending[n] for n in self._renegotiate
                            if n in self._pending)
            self._renegotiate = []
        cache_mask = 0
        invalid_mask = 0
        requests = []
        for op in announce:
            req = op.request(self.rank)
            bit = self._cache.lookup(req) if self._cache_enabled else None
            if bit is not None:
                self._bit_pending[bit] = op.name
                continue
            if self._cache_enabled:
                stale = self._cache.stale_bit(req)
                if stale is not None:
                    invalid_mask |= 1 << stale
            requests.append(req)
        for bit in self._bit_pending:
            cache_mask |= 1 << bit
        self._client.send({
            "rank": self.rank,
            "cache_mask": cache_mask,
            "invalid_mask": invalid_mask,
            "requests": RequestList(requests=requests, shutdown=shutdown),
        })

    def recv_reply(self) -> Tuple[str, Optional[dict]]:
        """Phase 2: the coordinator's cycle reply. Returns
        ``("reply", reply_dict)`` in the steady case; ``("reshape", None)``
        after adopting + acking a membership change mid-stream (the
        step's collectives are torn — the driver retries them at the new
        epoch, like ``hvd.elastic.run``); ``("abort", None)`` after a
        coordinated abort (this rank records the diagnosis and is done)."""
        if not self.alive:
            raise SimWorkerDead(f"logical rank {self.rank} is gone")
        try:
            reply = self._client.recv()
        except RanksChangedError as exc:
            self.apply_reshape(exc)
            return "reshape", None
        except RemoteAbortError as exc:
            self.abort = exc
            self.close()
            return "abort", None
        tune = reply.get("tune")
        cache_turned_off = False
        if tune is not None:
            # Mirror Controller._apply_tune: the synced knobs every rank
            # adopts from the cycle reply — including the bucket-size
            # element, which the sync test pins here,
            # and the cache categorical (every rank flips on the same
            # cycle so the bit masks stay aligned).
            self.last_tune = tune
            if len(tune) > 2:
                new_cache = bool(tune[2].get("cache_enabled",
                                             self._cache_enabled))
                cache_turned_off = self._cache_enabled and not new_cache
                self._cache_enabled = new_cache
            if len(tune) > 3 and tune[3].get("bucket_bytes"):
                self.tuned_bucket_bytes = int(tune[3]["bucket_bytes"])
        # _process_reply's cache walk, in its exact order: invalidations
        # evict (a pending hit renegotiates), bypass bits pop into the
        # cached fast path, and a cache turn-off renegotiates whatever
        # is still parked on a bit (sorted by bit — rank-agnostic).
        for bit in ResponseCache.mask_to_bits(reply["invalid_mask"]):
            self._cache.evict_bit(bit)
            name = self._bit_pending.pop(bit, None)
            if name is not None:
                self._renegotiate.append(name)
        self._bypass = []
        for bit in reply["bypass_bits"]:
            _, cached = self._cache.get(bit)
            self._cache.touch(bit)
            name = self._bit_pending.pop(bit)
            self._bypass.append(Response(
                response_type=cached.response_type,
                tensor_names=[name],
                tensor_sizes=list(cached.tensor_sizes)))
        if cache_turned_off:
            self._renegotiate.extend(
                name for _, name in sorted(self._bit_pending.items()))
            self._bit_pending.clear()
        return "reply", reply

    def take_bypass(self, reply: dict) -> List[Response]:
        """The cache-bypass responses this rank popped while processing
        ``reply`` (already removed from the bit-pending table). The
        driver walks these data exchanges BEFORE ``reply["responses"]``
        — the identical global order ``_process_reply`` executes them
        in on rank 0. ``reply`` is accepted for symmetry with the other
        phase methods; the pops happened in :meth:`recv_reply`."""
        del reply
        bypass, self._bypass = self._bypass, []
        return bypass

    # ----------------------------------------------------------- data phase

    def data_send(self, response) -> None:
        """Per-response send half, in the identical order every rank
        walks (the lockstep contract). Fused allreduces concatenate in
        ``tensor_names`` order, exactly like ``_execute_allreduce``."""
        if not self.alive:
            raise SimWorkerDead(f"logical rank {self.rank} is gone")
        rtype = response.response_type
        self.executed.update(response.tensor_names)
        if rtype == ResponseType.ERROR:
            self.errors.append(response.error_message)
            for name in response.tensor_names:
                self._pending.pop(name, None)
            return
        if rtype == ResponseType.ALLREDUCE:
            arrays = [self._pending[n].array.ravel()
                      for n in response.tensor_names]
            buf = arrays[0] if len(arrays) == 1 else np.concatenate(arrays)
            self._client.send_bytes(buf.tobytes())
        elif rtype == ResponseType.ALLGATHER:
            op = self._pending[response.tensor_names[0]]
            self._client.send_bytes(op.array.tobytes())
        elif rtype == ResponseType.BROADCAST:
            op = self._pending[response.tensor_names[0]]
            if self.rank == op.root_rank:
                self._client.send_bytes(op.array.tobytes())

    def data_recv(self, response, cache_put: bool = True) -> None:
        """Per-response receive half; stores results by tensor name.
        ``cache_put=False`` marks a cache-bypass exchange (the driver's
        walk of :meth:`take_bypass` responses) — mirroring ``_execute``,
        only freshly-negotiated responses are inserted into the cache."""
        if not self.alive:
            raise SimWorkerDead(f"logical rank {self.rank} is gone")
        rtype = response.response_type
        if rtype == ResponseType.ERROR:
            return
        if rtype == ResponseType.ALLREDUCE:
            entries = [self._pending.pop(n) for n in response.tensor_names]
            dtype = entries[0].array.dtype
            flat = np.frombuffer(self._client.recv_bytes(), dtype=dtype)
            offset = 0
            for op in entries:
                n = op.array.size
                self.results[op.name] = np.array(
                    flat[offset:offset + n]).reshape(op.array.shape)
                offset += n
        elif rtype == ResponseType.ALLGATHER:
            entries = [self._pending.pop(response.tensor_names[0])]
            op = entries[0]
            rest = op.array.shape[1:]
            raw = np.frombuffer(self._client.recv_bytes(),
                                dtype=op.array.dtype)
            self.results[op.name] = raw.reshape(
                (sum(response.tensor_sizes),) + rest)
        elif rtype == ResponseType.BROADCAST:
            entries = [self._pending.pop(response.tensor_names[0])]
            op = entries[0]
            if self.rank == op.root_rank:
                self.results[op.name] = op.array
            else:
                raw = np.frombuffer(self._client.recv_bytes(),
                                    dtype=op.array.dtype)
                self.results[op.name] = raw.reshape(op.array.shape)
        if cache_put and self._cache_enabled:
            # _execute's put, per fused entry, in tensor_names order.
            for op in entries:
                self._cache.put(op.request(self.rank), Response(
                    response_type=rtype, tensor_names=[op.name],
                    tensor_sizes=list(response.tensor_sizes)))

    # ------------------------------------------------------- shard plane

    def enable_shards(self, store: Optional[Dict[str, bytes]] = None
                      ) -> Dict[str, bytes]:
        """Arm this logical rank's half of the p2p checkpoint-shard
        plane: ``store`` maps content
        digest -> packed shard bytes; relayed SHARD_FETCH frames are
        served from it (missing digest = ``found: False``) and
        SHARD_DATA replies land in :attr:`shard_replies` — all
        transparently, from whatever recv the driver runs next."""
        self.shard_store: Dict[str, bytes] = store if store is not None \
            else {}
        self.shard_replies: Dict[Tuple[int, str], dict] = {}

        def cb(event: str, info: dict) -> None:
            if event == "fetch":
                blob = self.shard_store.get(info["digest"])
                self._client.wire.send_shard_data({
                    "shard": int(info["shard"]), "digest": info["digest"],
                    "part": list(info["part"]), "req": int(info["req"]),
                    "nonce": info.get("nonce"),
                    "found": blob is not None, "data": blob})
            else:
                self.shard_replies[(int(info["shard"]),
                                    info["digest"])] = info

        self._client.wire.set_shard_callback(cb)
        return self.shard_store

    def send_shard_fetch(self, shard: int, digest: str,
                         owner: int) -> None:
        """Issue one fetch toward ``owner`` through the coordinator
        star; the reply shows up in :attr:`shard_replies` once the
        driver has run enough recv phases for the relay round trip.
        The port's frames name a ``part`` of the shard; a simulated
        store serves whole shards, so the fetch asks for part
        ``(0, 0)``, which every store here answers with the whole
        blob."""
        self._client.wire.send_shard_fetch({
            "shard": int(shard), "digest": digest, "leaves": [],
            "part": [0, 0], "req": int(self.rank), "owner": int(owner)})

    # ------------------------------------------------------------ membership

    def apply_reshape(self, exc: RanksChangedError) -> None:
        """Adopt a membership assignment and acknowledge it — the worker
        half of ``reform()``'s ack handshake. Pending collectives from
        the dead epoch are discarded, mirroring ``_drain_epoch``; the
        response cache resets like the controller's reshape path does
        (joiners arrive cold, so every member must restart coherent)."""
        self._adopt(exc)
        self._pending.clear()
        self._bit_pending.clear()
        self._renegotiate = []
        self._bypass = []
        self._cache = ResponseCache(self._cache_capacity)
        self.reshapes += 1
        self._client.wire.send_join({"ack": exc.epoch})

    def _adopt(self, exc: RanksChangedError) -> None:
        self.rank = int(exc.rank)
        self.size = int(exc.size)
        self.epoch = int(exc.epoch)

    # ------------------------------------------------------------- lifetime

    def kill(self) -> None:
        """A crash, as the coordinator sees one: the socket closes with
        no farewell. (A graceful FaultPlan "leave" looks identical on
        the wire — the exit-code difference is a process-tier concept
        with no wire-level footprint.)"""
        self.close()

    def close(self) -> None:
        if self.alive:
            self.alive = False
            try:
                self._client.close()
            except OSError:
                pass
