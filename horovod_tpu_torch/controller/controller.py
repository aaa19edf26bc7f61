"""Background controller: the eager tier's negotiation + execution engine —
the port's copy of ``horovod_tpu/controller/controller.py`` over the TCP
star, on torch tensors (CPU or CUDA).

Reference: ``horovod/common/operations.cc`` — a background thread per
process ticks every ``cycle_time_ms`` (``RunLoopOnce``), drains the
request queue, negotiates globally-ready tensors (the coordinator gathers
RequestLists and broadcasts the fused ResponseList), packs Tensor Fusion
groups (``FuseResponses``), executes, and fires completion callbacks. A
bit-indexed response cache short-circuits negotiation for repeat tensors
(``RunBypass``), and the coordinator warns/aborts on stalled ranks.

Protocol per cycle (lockstep), the JAX package's:
  worker → coordinator   {"rank", "cache_mask", "invalid_mask",
                          "requests": RequestList}
  coordinator → workers  {"bypass_bits", "invalid_mask",
                          "responses": ResponseList}
  then, for each bypass bit and each response, in identical order on every
  rank: one raw-buffer data exchange (send shard / recv result).

Data planes, chosen identically on every rank from the launcher's
environment, as the JAX package's controller chooses them:

* the native ring (``core/src/ring.cc`` through ``core/bindings.py``):
  reduce-scatter + allgather allreduce, allgatherv and broadcast over
  authenticated TCP connections, when ``horovodrun`` exported
  ``HOROVOD_RING_ADDRS``; ``HOROVOD_RING_WIRE_DTYPE=bf16|fp16`` puts
  float32 payloads on the wire in half width (int8 needs the native
  engine's error-feedback residuals and falls back, loudly, to the
  uncompressed stream);
* the two-level plane (``HOROVOD_HIERARCHICAL_ALLREDUCE`` /
  ``_ALLGATHER`` with the exported group rings): a ring inside each host,
  a ring of the hosts' first ranks, and a broadcast back;
* the TCP star through the coordinator, for ``HOROVOD_CPU_OPS=star`` and
  for dtypes the ring cannot carry (uint32, uint64).

Every plane meets on host bytes, whatever the device: a CUDA tensor on
one rank and a CPU tensor on another exchange the same bytes, so no data
phase branches on the device. A CUDA entry is read after the event its
caller recorded at enqueue (the caller's stream may still be writing it,
as autograd's is when a gradient hook fires); a fused response of CUDA
entries is packed on the card into one persistent buffer of the fusion
threshold's size, copied to pinned host memory once, sent, and the result
copied back once and split, all on a side stream whose event the
handle's ``wait()`` hands to the caller's stream. The coordinator sums in
the tensors' dtype and in rank order (``acc = acc + peer``), so every add
rounds as the JAX package's numpy sum does; the ring sums in its own
order, the JAX ring's.

Elastic membership (``HOROVOD_ELASTIC=1``), as in the JAX package: the
coordinator keeps a join listener open, a dead worker re-forms the world
at a bumped membership epoch instead of failing it, parked joiners are
admitted at the next epoch boundary (up to ``HOROVOD_ELASTIC_MAX_RANKS``),
and every in-flight collective of the dead epoch fails with the
retryable ``RanksChangedError``. Ops enqueued after the drain fail the
same way until ``hvd.elastic.run`` acknowledges the reshape (the fence).
The rings are fixed-membership, so an elastic job stays on the star. A
process keeps the card ``init`` bound whatever rank it becomes.

The tuning and tracing loop, as in the JAX package: with
``HOROVOD_AUTOTUNE`` rank 0 scores every cycle's bytes/second, blended
with the coordinator's measured tick lateness (the negotiation slack) and
the bucket scheduler's overlap, and its next configuration rides the
following cycle reply as ``reply["tune"]``, applied on every rank at that
cycle boundary (``_apply_tune``): fusion threshold and cycle time, the
hierarchical and cache switches, and the gradient-bucket size. With
``HOROVOD_TRACE_DIR`` the reply also carries ``trace_seq``, the base of
the coordinator's collective sequence ids; every rank writes
``enqueue → negotiate → fuse → execute → done`` spans tagged with them,
rank 0 pings the workers' clocks on the heartbeat frames, and at shutdown
the workers ship their span files to rank 0, which merges them and
writes the straggler report.

Not ported: the cluster doctor.
"""

from __future__ import annotations

import math
import threading
import time
import os
from typing import Any, Dict, List, Optional

import torch

from ..common import config as config_mod
from ..common import hvd_logging as logging
from ..common import timeline as tl
from ..common.config import Config
from ..common.handles import Handle, HandleManager
from ..common.message import (
    Request,
    RequestList,
    RequestType,
    Response,
    ResponseList,
    ResponseType,
    construct_response,
)
from ..common.reduction import average
from ..common.response_cache import ResponseCache
from ..common.topology import Topology
from ..common.wire import RanksChangedError, RemoteAbortError, job_secret
from ..core import bindings
from .. import fault
from .. import metrics
from .service import CoordinatorService, PeerFailureError, WorkerClient

_OP_NAMES = {
    RequestType.ALLREDUCE: "ALLREDUCE",
    RequestType.ALLGATHER: "ALLGATHER",
    RequestType.BROADCAST: "BROADCAST",
}

# Unsigned widths torch cannot add on the host: summed in a signed type
# of the same or twice the width, then narrowed (the wrap-around numpy's
# unsigned sums have).
_WIDENED_SUM = {torch.uint16: torch.int32, torch.uint32: torch.int64}

_m = None


def _ctl_metrics():
    """Lazy-registered controller series (no import-time registration)."""
    global _m
    if _m is None:
        from types import SimpleNamespace

        _m = SimpleNamespace(
            cycle=metrics.histogram(
                "hvd_controller_cycle_seconds",
                "Controller cycle duration (tick build + negotiation + "
                "data phases)."),
            tensors=metrics.counter(
                "hvd_controller_tensors_total",
                "Tensors executed by the eager controller."),
            fused_bytes=metrics.counter(
                "hvd_controller_fused_bytes_total",
                "Payload bytes executed via (possibly fused) responses."),
            cache_hits=metrics.counter(
                "hvd_controller_cache_hits_total",
                "Response-cache hits at tick build."),
            cache_misses=metrics.counter(
                "hvd_controller_cache_misses_total",
                "Requests that missed the response cache and negotiated."),
            stalls=metrics.counter(
                "hvd_controller_stall_warnings_total",
                "Stall warnings issued by the coordinator."),
            aborts=metrics.counter(
                "hvd_controller_aborts_total",
                "Times _fail_all failed pending work on a transport "
                "failure."),
            ops=metrics.counter(
                "hvd_collective_ops_total",
                "Eager collectives enqueued, by op and dtype.",
                ("op", "dtype")),
            op_bytes=metrics.counter(
                "hvd_collective_bytes_total",
                "Eager collective payload bytes enqueued, by op and dtype.",
                ("op", "dtype")),
            tick_lateness=metrics.histogram(
                "hvd_controller_tick_lateness_seconds",
                "Per-rank tick lateness observed by the coordinator: time "
                "it sat blocked on a rank's tick beyond the cycle-time "
                "pacing allowance. The live straggler signal the doctor "
                "and the autotune objective consume.", ("rank",)),
        )
    return _m


_em = None


def _elastic_metrics():
    """Membership series, registered lazily under the JAX package's
    names. The epoch and size gauges are published by every
    metrics-enabled multi-rank job; the transition, reshape and
    departure series move only on elastic ones."""
    global _em
    if _em is None:
        from types import SimpleNamespace

        _em = SimpleNamespace(
            epoch=metrics.gauge(
                "hvd_membership_epoch",
                "Current membership epoch (1 at rendezvous; bumped by "
                "every elastic reshape)."),
            size=metrics.gauge(
                "hvd_membership_size",
                "Current world size as adopted by this rank."),
            transitions=metrics.counter(
                "hvd_membership_transitions_total",
                "Elastic membership transitions, by direction.", ("kind",)),
            reshape_seconds=metrics.histogram(
                "hvd_elastic_reshape_seconds",
                "Wall time of one elastic reshape: failure detection to "
                "re-formed lockstep (assignment broadcast + ack drain + "
                "epoch drain)."),
            departures=metrics.counter(
                "hvd_membership_rank_departures_total",
                "Ranks lost to elastic reshapes, by the departing rank's "
                "old global rank.", ("rank",)),
        )
    return _em


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype (``"float32"``, ``"bfloat16"``,
    ``"bool"``): what ``Request.tensor_dtype`` carries, so fusion groups
    and mismatch errors read as the JAX package's."""
    return str(dtype).rpartition(".")[2]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 tensor (shares
    memory)."""
    return t.reshape(-1).view(torch.uint8)


def _from_bytes(buf, dtype: torch.dtype) -> torch.Tensor:
    """A flat CPU tensor over a received (writable) buffer."""
    if len(buf) == 0:
        return torch.empty(0, dtype=dtype)
    return torch.frombuffer(buf, dtype=dtype)


def _host_sum(acc: torch.Tensor, peer: torch.Tensor) -> torch.Tensor:
    """``acc + peer`` in the operands' dtype (bool: logical OR)."""
    wide = _WIDENED_SUM.get(acc.dtype)
    if wide is not None:
        return (acc.to(wide) + peer.to(wide)).to(acc.dtype)
    if acc.dtype == torch.uint64:
        return (acc.view(torch.int64) + peer.view(torch.int64)).view(
            torch.uint64)
    return acc + peer


class _Pending:
    """Tensor-table entry (reference ``TensorTableEntry``)."""

    __slots__ = ("name", "tensor", "request", "handle", "average",
                 "target", "ready", "stream", "enqueued_at", "sent_at")

    def __init__(self, name: str, tensor: torch.Tensor, request: Request,
                 handle: Handle, average: bool,
                 target: Optional[torch.Tensor]):
        self.name = name
        # Contiguous, detached input. ``target``: the caller's tensor that
        # receives the result (in-place ops), else None.
        self.tensor = tensor
        self.request = request
        self.handle = handle
        self.average = average
        self.target = target
        self.ready = None
        self.stream = None
        if tensor.is_cuda:
            # The caller's stream may still be producing the tensor.
            self.stream = torch.cuda.current_stream(tensor.device)
            self.ready = torch.cuda.Event()
            self.ready.record(self.stream)
        self.enqueued_at = time.monotonic()
        # When this rank's request left for the coordinator (a traced
        # job's negotiate-span start); None for a cache bypass.
        self.sent_at: Optional[float] = None

    @property
    def nbytes(self) -> int:
        return _nbytes(self.tensor)


def _python_engine_wire(wire: str, which: str) -> str:
    """The wire dtype the Python controller can honour: bf16/fp16 are
    stateless casts; int8 needs the per-tensor error-feedback residuals
    of the native engine, so it keeps the uncompressed stream — with a
    warning only when the environment asked for int8 explicitly (the
    link-class defaults may pick it for a hop nobody configured)."""
    if wire != "int8":
        return wire
    if (config_mod.env_str(which) or "").strip().lower() == "int8":
        logging.warning(
            "%s=int8 requires the native engine (error-feedback residuals "
            "live in controller/native.py); the Python engine keeps the "
            "uncompressed wire — unset HOROVOD_ENGINE=python, or use "
            "bf16/fp16 here", which)
    return "none"


class ShutdownError(RuntimeError):
    """Delivered to pending callbacks at teardown (reference
    ``operations.cc:1107-1122`` "Horovod has been shut down")."""


# Keys of Controller.counters(): responses executed (a fused group counts
# once), tensors executed, cache hits at tick build, and the seconds this
# rank spent in each phase — the tick exchange of cycles that carried
# work, packing (with the card-to-host copy), the star exchange, and the
# host-to-card copy with the unpack.
COUNTERS = ("responses", "tensors", "cache_hits", "negotiate_s", "pack_s",
            "exchange_s", "unpack_s")


class Controller:
    def __init__(self, config: Config, topology: Topology,
                 timeline: Optional[tl.Timeline] = None):
        self.cfg = config
        self.topo = topology
        self.timeline = timeline
        self.handles = HandleManager()
        # Guards the queue/table/cache state; reached from user threads
        # (enqueue), the controller thread, and teardown.
        self._lock = threading.Lock()
        self._queue: List[str] = []           # names awaiting negotiation
        self._table: Dict[str, _Pending] = {}  # name -> entry
        self._bit_pending: Dict[int, str] = {}  # cache bit -> name (hits)
        self._cache = ResponseCache(config.cache_capacity)
        self._cache_enabled = config.cache_capacity > 0
        self._autoname_counter: Dict[str, int] = {}
        self._shutdown_requested = False
        self._closed = threading.Event()
        # The diagnosed transport failure, if any: ops enqueued after the
        # job died resolve with the same descriptive error.
        self._failure: Optional[BaseException] = None
        self._stall_warned: Dict[str, float] = {}
        self._fusion_threshold = config.fusion_threshold_bytes
        self._cycle_time_ms = config.cycle_time_ms
        # The data-plane switches the autotuner may flip, on every rank at
        # one cycle boundary (_apply_tune).
        self._hier_allreduce = config.hierarchical_allreduce
        self._hier_allgather = config.hierarchical_allgather
        self._counters = dict.fromkeys(COUNTERS, 0)
        # The card side of the data plane, made on first use by the
        # controller thread: a side stream per device, the persistent
        # device fusion buffer, and the pinned host staging buffer.
        self._streams: Dict[torch.device, Any] = {}
        self._device_buffers: Dict[torch.device, torch.Tensor] = {}
        self._host_buffer: Optional[torch.Tensor] = None
        self._resolved: list = []
        # The coordinator's record of each reshape (epoch, size, lost
        # ranks, admitted joiners, seconds), oldest first.
        self.reshapes: List[dict] = []
        # Elastic membership: the versioned epoch, and the fence that
        # fails ops enqueued between a reshape's drain and the user's
        # acknowledgement (hvd.elastic.run clears it before the restore):
        # a lone post-drain enqueue would negotiate a tensor no peer
        # knows about and hang the new epoch.
        self._elastic = config_mod.elastic_enabled()
        self._elastic_max = (config_mod.elastic_max_ranks()
                             if self._elastic else 0)
        self._epoch = 1
        self._reshape_fence: Optional[RanksChangedError] = None
        self._ring = self._local_ring = self._cross_ring = None
        self._wire_code = self._wire_local_code = self._wire_cross_code = 0
        if self._elastic and topology.size > 1 and (
                config_mod.ring_data_plane_enabled()
                or config.hierarchical_allreduce
                or config.hierarchical_allgather):
            # Every ring member binds a pre-assigned address: the rings
            # are fixed-membership, and an elastic job stays on the star,
            # whose endpoints survive a reshape.
            logging.warning(
                "elastic: ring/hierarchical data planes are static-"
                "membership; using the TCP star data plane")
        elif topology.size > 1:
            self._start_rings(config, topology)
        # The coordinator's straggler observations for the cycle just
        # coordinated: the worst rank's tick lateness and the summed
        # excess wait (seconds), read by the autotuner.
        self._cycle_slack = 0.0
        self._cycle_excess_wait = 0.0
        self._param_manager = None
        self._pending_tune = None
        self._autotune_steps_pub: Optional[int] = None
        if config.autotune and topology.rank == 0:
            from .autotune_glue import make_parameter_manager

            # The gradient-bucket size joins the search: its value rides
            # the synced reply, so every rank's BucketScheduler moves
            # together.
            self._param_manager = make_parameter_manager(
                config, tune_hierarchical=self._local_ring is not None,
                tune_cache=True, tune_bucket=True,
                world_size=topology.size)

        addr = config_mod.controller_addr()
        if addr is None:
            raise RuntimeError(
                "HOROVOD_CONTROLLER_ADDR is not set; the Python controller "
                "requires the horovodrun-exported TCP star endpoint")
        if topology.rank == 0:
            self._service = CoordinatorService(
                addr, topology.size,
                comm_timeout=config.comm_timeout_seconds)
            self._client = None
            # Coordinator's MessageTable: name -> {rank: Request}; plus
            # first-seen stamps for the stall check.
            self._message_table: Dict[str, Dict[int, Request]] = {}
            self._first_seen: Dict[str, float] = {}
            if self._elastic:
                self._service.start_join_listener()
            self._service.start_heartbeats(config.heartbeat_interval_seconds)
        else:
            self._service = None
            joining = self._elastic and config_mod.elastic_join()
            self._client = WorkerClient(
                addr, topology.rank,
                comm_timeout=config.comm_timeout_seconds, join=joining)
            if joining:
                # Late joiner: the assignment (the first frame) is this
                # process's identity; the launcher's provisional topology
                # is discarded.
                assignment = self._client.await_assignment()
                self._epoch = assignment.epoch
                self._set_topology(assignment.rank, assignment.size)
                self._client.wire.send_join({"ack": assignment.epoch})
                logging.info(
                    "elastic: joined the job at membership epoch %d as "
                    "rank %d of %d", assignment.epoch, assignment.rank,
                    assignment.size)
            self._client.start_heartbeats(config.heartbeat_interval_seconds)
        if metrics.on():
            em = _elastic_metrics()
            em.epoch.set(self._epoch)
            em.size.set(self.topo.size)

        # Cluster tracing: a clock-anchored span writer per rank, the
        # coordinator's sequence id per fused op on the reply, and (rank
        # 0) the clock-offset table fed by the heartbeat ping-pongs.
        self._trace_enabled = bool(config.trace_dir)
        self._tracer = None
        self._clock = None
        self._cycle_index = 0
        self._trace_seq = 0
        if self._trace_enabled:
            from ..trace import ClockSync, TraceWriter, rank_trace_path

            self._clock_sync_cycles = config_mod.clock_sync_cycles()
            os.makedirs(config.trace_dir, exist_ok=True)
            self._tracer = TraceWriter(
                rank_trace_path(config.trace_dir, self.topo.rank),
                self.topo.rank)
            if self.topo.rank == 0:
                self._clock = ClockSync(self.topo.size)
                self._service.set_clock_sync(self._clock)

        self._thread = threading.Thread(
            target=self._run_loop, name="hvd-controller", daemon=True)
        self._thread.start()

    def _start_rings(self, config: Config, topology: Topology) -> None:
        """The native rings, before the star (the JAX order). A ring that
        fails to start raises: the path choice must be the same on every
        rank or the lockstep data phases deadlock."""
        if config_mod.ring_data_plane_enabled():
            self._ring = bindings.RingBackend(
                topology.rank, topology.size, config_mod.ring_addrs(),
                job_secret())
            self._wire_code = bindings.WIRE_DTYPE_CODES[_python_engine_wire(
                config_mod.ring_wire_dtype(), "HOROVOD_RING_WIRE_DTYPE")]
        local_addrs = config_mod.local_ring_addrs()
        cross_addrs = config_mod.cross_ring_addrs()
        # Both or neither of the group rings, and only for a real two-level
        # layout; HOROVOD_CPU_OPS=star turns them off with the flat ring.
        if ((config.hierarchical_allreduce or config.hierarchical_allgather)
                and topology.local_size > 1 and topology.cross_size > 1
                and config_mod.cpu_ops() != "star"
                and local_addrs and cross_addrs):
            self._local_ring = bindings.RingBackend(
                topology.local_rank, topology.local_size, local_addrs,
                job_secret())
            self._local_ring.set_link("local")
            if topology.local_rank == 0:
                self._cross_ring = bindings.RingBackend(
                    topology.cross_rank, topology.cross_size, cross_addrs,
                    job_secret())
                self._cross_ring.set_link("cross")
            self._wire_local_code = bindings.WIRE_DTYPE_CODES[
                _python_engine_wire(config_mod.ring_wire_dtype_local(),
                                    "HOROVOD_RING_WIRE_DTYPE_LOCAL")]
            self._wire_cross_code = bindings.WIRE_DTYPE_CODES[
                _python_engine_wire(config_mod.ring_wire_dtype_cross(),
                                    "HOROVOD_RING_WIRE_DTYPE_CROSS")]
        if self._ring is not None or self._local_ring is not None:
            # Process-wide in the core: every ring pipelines on it.
            bindings.set_chunk_bytes(config_mod.resolved_ring_chunk_bytes())

    def _close_rings(self) -> None:
        for ring in (self._ring, self._local_ring, self._cross_ring):
            if ring is not None:
                ring.shutdown()
        self._ring = self._local_ring = self._cross_ring = None

    def _use_ring(self, dtype: torch.dtype) -> bool:
        """Whether the flat ring carries ``dtype``: global ring
        availability and the negotiated dtype, the same on every rank."""
        return (self._ring is not None
                and bindings.dtype_code(dtype) is not None)

    def _use_hierarchical(self, dtype: torch.dtype, enabled: bool) -> bool:
        return (enabled and self._local_ring is not None
                and bindings.dtype_code(dtype) is not None)

    # ------------------------------------------------------------------ API

    def counters(self) -> Dict[str, float]:
        """This rank's running totals (see ``COUNTERS``); callers diff two
        reads around the work they measure."""
        with self._lock:
            return dict(self._counters)

    def _count(self, key: str, amount: float) -> None:
        with self._lock:
            self._counters[key] += amount

    def _autoname(self, kind: str, name: Optional[str]) -> str:
        if name is not None:
            return name
        # Deterministic per-type counters: identical call order across
        # ranks yields identical names.
        with self._lock:
            n = self._autoname_counter.get(kind, 0)
            self._autoname_counter[kind] = n + 1
        return f"{kind}.noname.{n}"

    def _enqueue(self, kind: str, name: Optional[str], tensor: torch.Tensor,
                 request_type: RequestType, average: bool = False,
                 root_rank: int = -1, inplace: bool = False,
                 priority: int = 0) -> Handle:
        name = self._autoname(kind, name)
        target = tensor if inplace else None
        tensor = tensor.detach()
        if not tensor.is_contiguous():
            tensor = tensor.contiguous()
        dtype = dtype_name(tensor.dtype)
        req = Request(
            request_rank=self.topo.rank, request_type=request_type,
            tensor_name=name, tensor_dtype=dtype,
            tensor_shape=tuple(tensor.shape), root_rank=root_rank,
            priority=int(priority))
        if metrics.on():
            m = _ctl_metrics()
            m.ops.labels(kind, dtype).inc()
            m.op_bytes.labels(kind, dtype).inc(_nbytes(tensor))
        handle = self.handles.allocate()
        entry = _Pending(name, tensor, req, handle, average, target)
        with self._lock:
            # _failure is part of the closed predicate: _fail_all runs
            # (and clears the table) before _run_loop's finally sets
            # _closed.
            if (self._closed.is_set() or self._shutdown_requested
                    or self._failure is not None):
                handle.set_error(self._failure or ShutdownError(
                    "Horovod has been shut down"))
                return handle
            if self._reshape_fence is not None:
                # Membership changed under this caller: fail the op with
                # the retryable error its in-flight siblings got, until
                # hvd.elastic.run acknowledges the reshape.
                handle.set_error(self._reshape_fence)
                return handle
            if name in self._table:
                # Reference IncrementTensorCount duplicate-name error.
                handle.set_error(RuntimeError(
                    f"Duplicate tensor name {name!r}: a collective with this "
                    "name is already pending; names must be unique until the "
                    "operation completes."))
                return handle
            self._table[name] = entry
            self._queue.append(name)
        return handle

    def allreduce_async(self, tensor: torch.Tensor, average: bool = True,
                        name: Optional[str] = None, inplace: bool = False,
                        priority: int = 0) -> Handle:
        """Sum (or mean) of ``tensor`` over the ranks. ``inplace``: the
        result is written into ``tensor``, which the handle returns.
        ``priority``: launch priority — nonzero moves this cycle's
        highest-priority fused group to the front on every rank; never
        changes results."""
        return self._enqueue("allreduce", name, tensor,
                             RequestType.ALLREDUCE, average=average,
                             inplace=inplace, priority=priority)

    def allgather_async(self, tensor: torch.Tensor,
                        name: Optional[str] = None) -> Handle:
        return self._enqueue("allgather", name, tensor,
                             RequestType.ALLGATHER)

    def broadcast_async(self, tensor: torch.Tensor, root_rank: int,
                        name: Optional[str] = None,
                        inplace: bool = False) -> Handle:
        if not 0 <= root_rank < self.topo.size:
            # Fail fast: an out-of-range root would pass validation on
            # every rank (they all agree) and hang the data phase.
            h = self.handles.allocate()
            h.set_error(ValueError(
                f"root_rank {root_rank} out of range for size "
                f"{self.topo.size}"))
            return h
        return self._enqueue("broadcast", name, tensor,
                             RequestType.BROADCAST, root_rank=root_rank,
                             inplace=inplace)

    def allreduce(self, tensor, average: bool = True,
                  name: Optional[str] = None):
        return self.allreduce_async(tensor, average, name).wait()

    def allgather(self, tensor, name: Optional[str] = None):
        return self.allgather_async(tensor, name).wait()

    def broadcast(self, tensor, root_rank: int, name: Optional[str] = None):
        return self.broadcast_async(tensor, root_rank, name).wait()

    def shutdown(self) -> None:
        """Cooperative teardown: the flag travels with the next tick and
        the coordinator echoes it to everyone."""
        with self._lock:
            self._shutdown_requested = True
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            logging.warning("controller thread did not exit within 30s")

    # ------------------------------------------------------------ cycle loop

    def _run_loop(self) -> None:
        try:
            while not self._closed.is_set():
                started = time.monotonic()
                if self.timeline:
                    self.timeline.mark_cycle_start()
                try:
                    if (self._elastic and self._service is not None
                            and self._service.parked_joiner_count()
                            and (self._elastic_max == 0
                                 or self.topo.size < self._elastic_max)):
                        # Epoch boundary: absorb parked joiners before the
                        # next tick exchange. At max-ranks a parked joiner
                        # waits: a reshape here would admit nobody yet
                        # bump the epoch and drain in-flight work every
                        # cycle (a livelock).
                        self._elastic_reshape(set())
                    self._cycle()
                except PeerFailureError as exc:
                    if self._shutdown_requested:
                        # Teardown race: a worker whose own shutdown was
                        # requested may close its wire before this
                        # coordinator's next recv. The job is ending
                        # either way; never re-form a dying world.
                        logging.debug(
                            "shutdown: rank %d closed its wire before "
                            "the final echo (%s)", exc.rank, exc.cause)
                        self._closed.set()
                        self._fail_all(ShutdownError(
                            "Horovod has been shut down"))
                        continue
                    # With elastic on, a dead worker re-forms the world
                    # (re-raising below min-ranks); without it, the
                    # static abort path.
                    if not self._elastic or self._service is None:
                        raise
                    self._elastic_reshape({exc.rank}, cause=exc)
                    continue
                except RanksChangedError as exc:
                    # Worker side: the coordinator re-formed the world and
                    # a RESHAPE frame tore this rank out of the dead epoch.
                    if not self._elastic or self._client is None:
                        raise
                    self._apply_reshape(exc)
                    continue
                if self.topo.rank != 0 or self.topo.size == 1:
                    # Workers pace the lockstep; the coordinator is paced
                    # by their arrivals, or, alone after an elastic
                    # shrink, by the cycle time too (else it would spin).
                    delay = (self._cycle_time_ms / 1e3
                             - (time.monotonic() - started))
                    if delay > 0 and not self._shutdown_requested:
                        time.sleep(delay)
        except Exception as exc:  # transport failure: fail all pending work
            logging.error("controller loop failed: %s", exc)
            self._fail_all(self._diagnose_failure(exc))
        finally:
            self._closed.set()
            if self._trace_enabled:
                # After a failure, a valid local trace and offset table
                # for an offline merge (both calls are idempotent after a
                # clean shutdown's _finalize_trace).
                try:
                    self._tracer.close()
                    if self._clock is not None:
                        from ..trace import OFFSETS_FILE

                        self._clock.write(os.path.join(
                            self.cfg.trace_dir, OFFSETS_FILE))
                except OSError as exc:
                    logging.error("trace: salvage failed: %s", exc)
            self._close_rings()
            if self._service:
                self._service.close()
            if self._client:
                self._client.close()

    def _inflight_summary(self) -> str:
        """Which ops were pending when the job died."""
        with self._lock:
            names = sorted(self._table)
        if not names:
            return "none"
        shown = ", ".join(repr(n) for n in names[:8])
        if len(names) > 8:
            shown += f", ... ({len(names)} total)"
        return shown

    def _diagnose_failure(self, exc: BaseException) -> RuntimeError:
        """Turn a raw transport failure into one descriptive engine error,
        and — on the coordinator — broadcast the diagnosis as a
        coordinated abort so every surviving rank fails the same way
        immediately."""
        inflight = self._inflight_summary()
        if isinstance(exc, PeerFailureError):
            msg = (f"Horovod controller failed: rank {exc.rank} died or "
                   f"became unreachable ({exc.cause}); in-flight ops: "
                   f"{inflight}")
            if self._service is not None:
                self._service.send_abort_all(
                    msg, dead_rank=exc.rank,
                    op=None if inflight == "none" else inflight)
            return RuntimeError(msg)
        if isinstance(exc, RemoteAbortError):
            return RuntimeError(f"Horovod controller failed: job aborted by "
                                f"coordinator: {exc}")
        if self._client is not None and isinstance(exc, (ConnectionError,
                                                         OSError)):
            return RuntimeError(
                f"Horovod controller failed: lost contact with the "
                f"coordinator (rank 0): {exc}; in-flight ops: {inflight}")
        if not isinstance(exc, RuntimeError):
            return RuntimeError(f"Horovod controller failed: {exc} "
                                "(a peer process likely died)")
        return exc

    def _build_tick(self) -> dict:
        hits = 0
        with self._lock:
            names = self._queue
            self._queue = []
            cache_mask = 0
            invalid_mask = 0
            uncached: List[Request] = []
            for name in names:
                entry = self._table[name]
                bit = (self._cache.lookup(entry.request)
                       if self._cache_enabled else None)
                if bit is not None:
                    self._bit_pending[bit] = name
                    hits += 1
                    continue
                if self._cache_enabled:
                    stale = self._cache.stale_bit(entry.request)
                    if stale is not None:
                        invalid_mask |= 1 << stale
                uncached.append(entry.request)
            for bit in self._bit_pending:
                cache_mask |= 1 << bit
            shutdown = self._shutdown_requested
            self._counters["cache_hits"] += hits
        if metrics.on() and self._cache_enabled and (hits or uncached):
            m = _ctl_metrics()
            if hits:
                m.cache_hits.inc(hits)
            if uncached:
                m.cache_misses.inc(len(uncached))
        return {
            "rank": self.topo.rank,
            "cache_mask": cache_mask,
            "invalid_mask": invalid_mask,
            "requests": RequestList(requests=uncached, shutdown=shutdown),
        }

    def _stamp_sent(self, tick: dict) -> None:
        """Mark the tick's requests as departed (the negotiate-span start,
        the straggler attribution's arrival). Called after the send, so a
        stalled send is charged to this rank."""
        if self._tracer is None:
            return
        now = time.monotonic()
        with self._lock:
            for req in tick["requests"].requests:
                entry = self._table.get(req.tensor_name)
                if entry is not None:
                    entry.sent_at = now

    def _cycle(self) -> None:
        fault.hook("cycle")  # chaos seam: kill/delay/raise at cycle N
        mon = metrics.on()
        t_start = time.monotonic()
        tick = self._build_tick()
        if self.topo.rank == 0:
            self._cycle_index += 1
            if self._clock is not None and (
                    self._cycle_index <= 8
                    or self._cycle_index % self._clock_sync_cycles == 0):
                # Offset refresh: a dense burst while the job warms up,
                # then periodic; pongs are consumed whenever the
                # coordinator next drains frames.
                self._service.send_clock_pings()
            self._stamp_sent(tick)  # rank 0's "send" is the local build
            t_coord = time.monotonic()
            reply = self._coordinate(tick)
        else:
            self._client.send(tick)
            self._stamp_sent(tick)
            reply = self._client.recv()
        t_reply = time.monotonic()
        if (tick["requests"].requests or tick["cache_mask"]
                or reply["bypass_bits"] or reply["responses"].responses):
            self._count("negotiate_s", t_reply - t_start)
        # Both sides of the rank conditional run _process_reply on the
        # same negotiated response list, so every rank executes identical
        # collectives.
        nbytes = self._process_reply(reply)
        if self._param_manager is not None:
            self._tune(nbytes, time.monotonic() - t_coord, mon)
        if mon:
            _ctl_metrics().cycle.observe(time.monotonic() - t_start)

    def _tune(self, nbytes: int, seconds: float, mon: bool) -> None:
        """Rank 0: score the cycle just executed; a new configuration
        rides the next reply. The continuous knobs apply here at once
        (they only shape the coordinator's fusion and pacing); the
        hierarchical and cache switches and the bucket size wait for the
        synced reply, which every rank applies at the same boundary."""
        from .bucket_scheduler import last_overlap_efficiency

        pm = self._param_manager
        tuned = pm.record(nbytes, seconds,
                          slack_seconds=self._cycle_slack,
                          recv_wait_seconds=self._cycle_excess_wait,
                          overlap=last_overlap_efficiency())
        if tuned is not None:
            self._fusion_threshold, self._cycle_time_ms = tuned[:2]
            extras = {}
            if pm.bucket_bytes:
                extras["bucket_bytes"] = int(pm.bucket_bytes)
            self._pending_tune = tuned + (extras,)
        if mon and pm.steps_scored != self._autotune_steps_pub:
            # The first pass publishes the initial state; afterwards only
            # a newly scored configuration re-publishes.
            from .autotune_glue import publish_tuner_gauges

            self._autotune_steps_pub = pm.steps_scored
            publish_tuner_gauges(pm)

    # ------------------------------------------------------- coordinator side

    def _coordinate(self, my_tick: dict) -> dict:
        size = self.topo.size
        ticks = {0: my_tick}
        # Per-rank tick waits: a cumulative allowance of one cycle time is
        # free; anything beyond it is lateness charged to the rank being
        # waited on, the live analogue of the trace plane's negotiation
        # slack.
        measure = metrics.on() or self._param_manager is not None
        waits: Dict[int, float] = {}
        for rank in range(1, size):
            t_r = time.monotonic() if measure else 0.0
            ticks[rank] = self._service.recv_from(rank)
            if measure:
                waits[rank] = time.monotonic() - t_r
        if measure:
            allowance = self._cycle_time_ms / 1e3
            slack = excess = 0.0
            mon = metrics.on()
            for rank in sorted(waits):
                lateness = max(0.0, waits[rank] - allowance)
                allowance = max(0.0, allowance - waits[rank])
                slack = max(slack, lateness)
                excess += lateness
                if mon:
                    _ctl_metrics().tick_lateness.labels(
                        str(rank)).observe(lateness)
            self._cycle_slack = slack
            self._cycle_excess_wait = excess

        rank_order_ticks = [t for _, t in sorted(ticks.items())]
        shutdown = any(t["requests"].shutdown for t in rank_order_ticks)
        invalid_mask = 0
        for t in rank_order_ticks:
            invalid_mask |= t["invalid_mask"]
        and_mask = ticks[0]["cache_mask"]
        for t in rank_order_ticks:
            and_mask &= t["cache_mask"]
        and_mask &= ~invalid_mask
        bypass_bits = ResponseCache.mask_to_bits(and_mask)

        # Negotiation: accumulate per-tensor requests; a tensor is ready
        # when every rank reported it.
        now = time.monotonic()
        ready: List[Response] = []
        for rank in sorted(ticks):
            for req in ticks[rank]["requests"].requests:
                entry = self._message_table.setdefault(req.tensor_name, {})
                if not entry:
                    self._first_seen[req.tensor_name] = now
                    if self.timeline:
                        self.timeline.negotiate_start(
                            req.tensor_name, _OP_NAMES[req.request_type])
                if self.timeline:
                    self.timeline.negotiate_rank_ready(req.tensor_name, rank)
                entry[rank] = req
        for name in list(self._message_table):
            entry = self._message_table[name]
            if len(entry) == size:
                requests = [entry[r] for r in range(size)]
                response = construct_response(requests, size)
                ready.append(response)
                del self._message_table[name]
                self._first_seen.pop(name, None)
                self._stall_warned.pop(name, None)
                if self.timeline:
                    self.timeline.negotiate_end(
                        name, _OP_NAMES[requests[0].request_type])

        self._check_stalls(now)
        responses = self._prioritize_responses(self._fuse_responses(ready))
        reply = {
            "bypass_bits": bypass_bits,
            "invalid_mask": invalid_mask,
            "responses": ResponseList(responses=responses, shutdown=shutdown),
        }
        if self._trace_enabled:
            # One base id a cycle: every rank derives the per-op ids by
            # walking the identical bypass-bits + responses order.
            reply["trace_seq"] = self._trace_seq
            self._trace_seq += len(bypass_bits) + len(responses)
        if self._pending_tune is not None:
            reply["tune"] = self._pending_tune
            self._pending_tune = None
        self._service.send_all(reply)
        return reply

    def _fuse_responses(self, responses: List[Response]) -> List[Response]:
        """Tensor Fusion packing (reference ``FuseResponses``): join
        ALLREDUCE responses of equal dtype while the fused byte count stays
        under the threshold, looking ahead past mismatched dtypes. Only
        allreduce fuses; byte sizes come from the negotiated shapes,
        identical on all ranks."""
        out: List[Response] = []
        pending = list(responses)
        while pending:
            first = pending.pop(0)
            if first.response_type != ResponseType.ALLREDUCE:
                out.append(first)
                continue
            fused = first
            dtype = self._response_dtype(first)
            total = self._response_bytes(first)
            i = 0
            while i < len(pending):
                cand = pending[i]
                if (cand.response_type == ResponseType.ALLREDUCE
                        and self._response_dtype(cand) == dtype):
                    nbytes = self._response_bytes(cand)
                    if total + nbytes <= self._fusion_threshold:
                        fused.tensor_names.extend(cand.tensor_names)
                        total += nbytes
                        pending.pop(i)
                        continue
                i += 1  # look-ahead (reference operations.cc:483-499)
            out.append(fused)
        return out

    def _prioritize_responses(
            self, responses: List[Response]) -> List[Response]:
        """Stable-sort the cycle's responses by each one's highest member
        priority, descending; the sorted order rides the reply, so every
        rank launches in the same order. A no-op when no tensor this
        cycle carries a priority."""
        if len(responses) <= 1:
            return responses
        prios = []
        for r in responses:
            p = 0
            for n in r.tensor_names:
                entry = self._table.get(n)
                if entry is not None:
                    p = max(p, entry.request.priority)
            prios.append(p)
        if not any(p > 0 for p in prios):
            return responses
        order = sorted(range(len(responses)), key=lambda i: -prios[i])
        if order == list(range(len(responses))):
            return responses
        if metrics.on():
            from .bucket_scheduler import _overlap_metrics

            _overlap_metrics().priority_jumps.inc()
        return [responses[i] for i in order]

    def _response_dtype(self, response: Response) -> str:
        return self._table[response.tensor_names[0]].request.tensor_dtype

    def _response_bytes(self, response: Response) -> int:
        return sum(self._table[n].nbytes for n in response.tensor_names)

    def _check_stalls(self, now: float) -> None:
        """Reference ``CheckForStalledTensors`` (operations.cc:688-769)."""
        if self.cfg.stall_check_disable:
            return
        for name, first in sorted(self._first_seen.items()):
            age = now - first
            if age > self.cfg.stall_check_seconds:
                last = self._stall_warned.get(name, 0.0)
                if now - last > self.cfg.stall_check_seconds:
                    seen = sorted(self._message_table.get(name, {}))
                    missing = [r for r in range(self.topo.size)
                               if r not in seen]
                    logging.warning(
                        "One or more tensors were submitted to be reduced, "
                        "gathered or broadcasted by subset of ranks and are "
                        "waiting for remainder of ranks for more than %ds. "
                        "Stalled op: %s [missing ranks: %s]",
                        int(self.cfg.stall_check_seconds), name,
                        ", ".join(map(str, missing)))
                    self._stall_warned[name] = now
                    if metrics.on():
                        _ctl_metrics().stalls.inc()
                if (self.cfg.stall_shutdown_seconds > 0
                        and age > self.cfg.stall_shutdown_seconds):
                    logging.error(
                        "Stall duration exceeded "
                        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS: aborting job "
                        "(stalled op: %s)", name)
                    with self._lock:
                        self._shutdown_requested = True

    # ----------------------------------------------------------- both sides

    def _apply_tune(self, tune: tuple) -> bool:
        """Apply a configuration the coordinator pushed on the reply:
        ``(fusion_threshold, cycle_ms, categoricals, extras)``, the
        extras carrying the tuned gradient-bucket size. Returns whether
        the response cache was turned off (the caller renegotiates the
        tensors parked on cache bits)."""
        self._fusion_threshold, self._cycle_time_ms = tune[:2]
        cache_turned_off = False
        if len(tune) > 2:
            cats = tune[2]
            self._hier_allreduce = bool(cats.get(
                "hierarchical_allreduce", self._hier_allreduce))
            self._hier_allgather = bool(cats.get(
                "hierarchical_allgather", self._hier_allgather))
            new_cache = bool(cats.get("cache_enabled", self._cache_enabled))
            cache_turned_off = self._cache_enabled and not new_cache
            self._cache_enabled = new_cache
        if len(tune) > 3 and tune[3].get("bucket_bytes"):
            from .bucket_scheduler import set_autotuned_bucket_bytes

            set_autotuned_bucket_bytes(int(tune[3]["bucket_bytes"]))
        return cache_turned_off

    def _process_reply(self, reply: dict) -> int:
        """Execute the reply's collectives; returns the bytes executed
        (the autotuner's throughput numerator)."""
        # One stamp for the whole reply: negotiate spans end when it
        # arrived, not when each response's turn came.
        reply_at = time.monotonic()
        tune = reply.get("tune")
        cache_turned_off = tune is not None and self._apply_tune(tune)
        executed = 0
        for bit in ResponseCache.mask_to_bits(reply["invalid_mask"]):
            with self._lock:
                self._cache.evict_bit(bit)
                name = self._bit_pending.pop(bit, None)
                if name is not None:
                    # Cache entry died under a pending hit: renegotiate.
                    self._queue.append(name)

        # Collective sequence ids: the reply's base plus the identical
        # bypass + responses walk on every rank.
        seq_cursor = reply.get("trace_seq")

        def _next_seq():
            nonlocal seq_cursor
            if seq_cursor is None:
                return None
            seq, seq_cursor = seq_cursor, seq_cursor + 1
            return seq

        for bit in reply["bypass_bits"]:
            # Cached fast path (reference RunBypass).
            _, response = self._cache.get(bit)
            with self._lock:
                self._cache.touch(bit)
                name = self._bit_pending.pop(bit)
            executed += self._execute(Response(
                response_type=response.response_type,
                tensor_names=[name],
                tensor_sizes=list(response.tensor_sizes)), cache_put=False,
                seq=_next_seq(), reply_at=reply_at)

        if cache_turned_off:
            # Hits parked on a bit would strand now that ticks stop
            # advertising bits: renegotiate them, in bit order.
            with self._lock:
                self._queue.extend(
                    name for _, name in sorted(self._bit_pending.items()))
                self._bit_pending.clear()

        rlist: ResponseList = reply["responses"]
        for response in rlist.responses:
            executed += self._execute(
                response, cache_put=self._cache_enabled, seq=_next_seq(),
                reply_at=reply_at)

        # A traced job keeps cycling until the shutdown flag came back
        # echoed: the trace exchange needs every rank in lockstep on the
        # same cycle, wires still up.
        if rlist.shutdown or (self._shutdown_requested
                              and not self._trace_enabled):
            if rlist.shutdown and self._trace_enabled:
                self._finalize_trace()
            # Close before failing: once _fail_all empties the table, a
            # concurrently-enqueued op must take the closed branch.
            self._closed.set()
            self._fail_all(ShutdownError("Horovod has been shut down"))
        return executed

    def _finalize_trace(self) -> None:
        """Shutdown trace collection, in lockstep off the shutdown reply:
        workers close their span file and push its bytes to rank 0; rank
        0 writes them out, dumps the clock-offset table, merges
        everything into ``merged_trace.json`` and writes
        ``straggler_report.json``. A worker lost here fails like any
        transport failure; a failed write or merge is logged and leaves
        the per-rank files for the launcher's merge."""
        from .. import trace as trace_mod

        trace_dir = self.cfg.trace_dir
        if self.topo.rank != 0:
            self._tracer.close()
            # Always push: rank 0 waits for one blob a worker.
            self._client.send_bytes(self._tracer.read_bytes())
            return
        blobs: Dict[int, bytes] = {}
        for worker_rank in range(1, self.topo.size):
            blobs[worker_rank] = self._service.recv_bytes_from(worker_rank)
        self._tracer.close()
        try:
            for worker_rank, blob in sorted(blobs.items()):
                if blob:
                    with open(trace_mod.rank_trace_path(
                            trace_dir, worker_rank), "wb") as f:
                        f.write(blob)
            self._clock.write(os.path.join(trace_dir, trace_mod.OFFSETS_FILE))
            merged = trace_mod.merge_trace_dir(trace_dir)
            report = trace_mod.write_report(trace_dir)
            logging.info("trace: merged trace at %s; straggler report at %s",
                         merged, report)
        except (OSError, ValueError) as exc:
            logging.error("trace: finalize failed: %s (the per-rank trace "
                          "files stay for trace.merge_trace_dir)", exc)

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            if self._failure is None and not isinstance(exc, ShutdownError):
                self._failure = exc
            # Sorted by tensor name so failure callbacks fire in the same
            # order on every rank.
            entries = [self._table[n] for n in sorted(self._table)]
            self._table.clear()
            self._queue.clear()
            self._bit_pending.clear()
        for entry in entries:
            if not entry.handle.done():
                entry.handle.set_error(exc)
        if not isinstance(exc, ShutdownError) and metrics.on():
            _ctl_metrics().aborts.inc()

    # ------------------------------------------------------ elastic reshape

    @property
    def membership_epoch(self) -> int:
        """Current membership epoch (1 at rendezvous; bumped per reshape)."""
        return self._epoch

    def clear_reshape_fence(self) -> None:
        """User-level acknowledgement of a reshape (``hvd.elastic.run``
        calls it before restoring state): new enqueues ride the new
        epoch."""
        with self._lock:
            self._reshape_fence = None

    def _set_topology(self, new_rank: int, new_size: int) -> None:
        """Swap in the re-formed world. Elastic jobs are one process per
        member (the launcher respawns workers one by one), so local and
        cross collapse to the subset shape. The card stays the one
        ``init`` bound: a process keeps its device."""
        old = self.topo
        topo = Topology(
            rank=new_rank, size=new_size, local_rank=0, local_size=1,
            cross_rank=new_rank, cross_size=new_size,
            num_devices=old.num_devices,
            local_num_devices=old.local_num_devices,
            launched=old.launched, device_index=old.device_index)
        self.topo = topo
        from ..common import basics

        basics.replace_topology(topo)

    def _drain_epoch(self, exc: RanksChangedError) -> None:
        """Discard every trace of the dead epoch: pending entries fail
        with the retryable ``exc`` (not recorded as a job failure: new
        enqueues stay allowed behind the fence), and the negotiation
        state, the response cache and the autonaming counters reset, so
        every member of the new epoch starts from the same blank slate,
        joiners included."""
        with self._lock:
            self._reshape_fence = exc
            entries = [self._table[n] for n in sorted(self._table)]
            self._table.clear()
            self._queue.clear()
            self._bit_pending.clear()
            self._cache = ResponseCache(self.cfg.cache_capacity)
            self._autoname_counter.clear()
        if self._service is not None:
            self._message_table.clear()
            self._first_seen.clear()
            self._stall_warned.clear()
        for entry in entries:
            if not entry.handle.done():
                entry.handle.set_error(exc)

    @staticmethod
    def _reshape_error(epoch: int, rank: int,
                       size: int) -> RanksChangedError:
        return RanksChangedError(
            f"cluster membership changed at epoch {epoch} (this process is "
            f"now rank {rank} of {size}); in-flight collectives were "
            "discarded — wrap the training loop in hvd.elastic.run to "
            "restore state from rank 0 and resume", rank=rank, size=size,
            epoch=epoch)

    def _elastic_reshape(self, dead: set,
                         cause: Optional[PeerFailureError] = None) -> None:
        """Coordinator: re-form the world without ``dead`` and with any
        parked joiners, then resume ticking at the new epoch. Raises the
        original failure when the survivors fall below min-ranks; the
        loop's outer handler then aborts like a static job."""
        t0 = time.monotonic()
        old_size = self.topo.size
        res = self._service.reform(
            dead, min_ranks=config_mod.elastic_min_ranks(),
            max_ranks=config_mod.elastic_max_ranks())
        if res is None:
            if cause is not None:
                raise cause
            raise RuntimeError(
                "elastic: survivors fell below HOROVOD_ELASTIC_MIN_RANKS "
                f"({config_mod.elastic_min_ranks()}); aborting")
        self._epoch = res.epoch
        # The topology first: a waiter the drain wakes must already see
        # the new world (the JAX package swaps it after the drain, so a
        # restore racing the swap reads the old size).
        self._set_topology(0, res.size)
        self._drain_epoch(self._reshape_error(res.epoch, 0, res.size))
        took = time.monotonic() - t0
        logging.warning(
            "elastic: re-formed at membership epoch %d: size %d -> %d "
            "(lost ranks %s, admitted %d joiner(s)) in %.3fs",
            res.epoch, old_size, res.size,
            list(res.lost) or "none", res.joined, took)
        self.reshapes.append({"epoch": res.epoch, "size": res.size,
                              "lost": list(res.lost), "joined": res.joined,
                              "seconds": took})
        if metrics.on():
            em = _elastic_metrics()
            em.epoch.set(res.epoch)
            em.size.set(res.size)
            if res.lost:
                em.transitions.labels("shrink").inc()
                for rank in res.lost:
                    em.departures.labels(str(rank)).inc()
            if res.joined:
                em.transitions.labels("grow").inc()
            em.reshape_seconds.observe(took)

    def _apply_reshape(self, exc: RanksChangedError) -> None:
        """Worker: adopt the RESHAPE assignment, drain the dead epoch, and
        acknowledge so the coordinator knows this wire's stream is
        clean."""
        self._epoch = exc.epoch
        self._set_topology(exc.rank, exc.size)
        self._drain_epoch(self._reshape_error(exc.epoch, exc.rank, exc.size))
        self._client.wire.send_join({"ack": exc.epoch})
        logging.warning(
            "elastic: membership epoch %d: this process is now rank %d "
            "of %d", exc.epoch, exc.rank, exc.size)
        if metrics.on():
            em = _elastic_metrics()
            em.epoch.set(exc.epoch)
            em.size.set(exc.size)

    # ------------------------------------------------------------ data plane

    def _execute(self, response: Response, cache_put: bool,
                 seq: Optional[int] = None,
                 reply_at: Optional[float] = None) -> int:
        """Run one negotiated response; returns its payload bytes."""
        names = response.tensor_names
        if response.response_type == ResponseType.ERROR:
            with self._lock:
                entries = [self._table.pop(n) for n in names]
            for entry in entries:
                entry.handle.set_error(RuntimeError(response.error_message))
            return 0

        with self._lock:
            entries = [self._table[n] for n in names]
        tname = names[0] if len(names) == 1 else f"fused[{len(names)}]"
        if self._tracer is not None:
            # Per-tensor spans, now that the op's seq is known: enqueue =
            # the user call to the request's departure; negotiate = the
            # departure to this reply (a cache bypass never departed, so
            # it has no negotiate span).
            if reply_at is None:
                reply_at = time.monotonic()
            for entry in entries:
                self._tracer.span(
                    "enqueue", entry.enqueued_at,
                    entry.sent_at if entry.sent_at is not None else reply_at,
                    seq=seq, op=entry.name)
                if entry.sent_at is not None:
                    self._tracer.span("negotiate", entry.sent_at, reply_at,
                                      seq=seq, op=entry.name)
        self._seq = seq
        # (entry, result, CUDA event) of this response, resolved only once
        # the entries left the table: a caller woken by its handle may
        # enqueue the same name again at once.
        self._resolved = []
        if self.timeline:
            self.timeline.start(tname, response.response_type.name)

        if response.response_type == ResponseType.ALLREDUCE:
            self._execute_allreduce(entries, tname)
        elif response.response_type == ResponseType.ALLGATHER:
            self._execute_allgather(entries[0], response)
        else:
            self._execute_broadcast(entries[0])

        with self._lock:
            for entry in entries:
                self._table.pop(entry.name, None)
                if cache_put:
                    self._cache.put(
                        entry.request,
                        Response(response_type=response.response_type,
                                 tensor_names=[entry.name],
                                 tensor_sizes=list(response.tensor_sizes)))
            self._counters["responses"] += 1
            self._counters["tensors"] += len(entries)
        for entry, value, ready in self._resolved:
            entry.handle.set_result(value, ready=ready)
        self._resolved = []
        if self.timeline:
            self.timeline.end(tname)
        nbytes = sum(e.nbytes for e in entries)
        if metrics.on():
            m = _ctl_metrics()
            m.tensors.inc(len(entries))
            m.fused_bytes.inc(nbytes)
        return nbytes

    def _spans(self, op: str, t_fuse: Optional[float], t_exec: float,
               t_done: float, tensors: int = 1) -> None:
        """The data phases of the op executing now: fuse (packing, for an
        allreduce), execute (the exchange), done (delivering results)."""
        if self._tracer is None:
            return
        t_end = time.monotonic()
        if t_fuse is not None:
            self._tracer.span("fuse", t_fuse, t_exec, seq=self._seq, op=op,
                              tensors=tensors)
        self._tracer.span("execute", t_exec, t_done, seq=self._seq, op=op)
        self._tracer.span("done", t_done, t_end, seq=self._seq, op=op)

    # -- the card side ------------------------------------------------------

    def _stream(self, device: torch.device):
        """This controller's side stream on ``device``."""
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return stream

    def _device_buffer(self, device: torch.device,
                       nbytes: int) -> torch.Tensor:
        """The persistent device fusion buffer (the reference's
        ``PersistentBuffer``), sized to the fusion threshold."""
        buf = self._device_buffers.get(device)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, self._fusion_threshold),
                              dtype=torch.uint8, device=device)
            self._device_buffers[device] = buf
        return buf[:nbytes]

    def _staging(self, nbytes: int) -> torch.Tensor:
        """The pinned host buffer a fused CUDA response leaves the card
        through; grows to the largest response."""
        buf = self._host_buffer
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, self._fusion_threshold),
                              dtype=torch.uint8, pin_memory=True)
            self._host_buffer = buf
        return buf[:nbytes]

    def _activity(self, tname: str, name: str):
        if self.timeline:
            self.timeline.activity_start(tname, name)

    def _activity_end(self, tname: str):
        if self.timeline:
            self.timeline.activity_end(tname)

    @staticmethod
    def _card_of(entries: List[_Pending]) -> Optional[torch.device]:
        """The one CUDA device every entry lives on, else None (then each
        entry takes the host path)."""
        devices = {e.tensor.device for e in entries}
        if len(devices) == 1:
            (device,) = devices
            if device.type == "cuda":
                return device
        return None

    def _host_bytes(self, entry: _Pending) -> torch.Tensor:
        """An entry's bytes on the host (a view for a CPU tensor)."""
        if entry.ready is None:
            return _byte_view(entry.tensor)
        device = entry.tensor.device
        stream = self._stream(device)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            stream.wait_event(entry.ready)
            return _byte_view(entry.tensor).to("cpu")

    def _pack(self, entries: List[_Pending], tname: str) -> torch.Tensor:
        """The response's input as one flat uint8 host tensor (reference
        ``MemcpyInFusionBuffer``)."""
        device = self._card_of(entries)
        if device is None:
            parts = [self._host_bytes(e) for e in entries]
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        stream = self._stream(device)
        total = sum(e.nbytes for e in entries)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            for e in entries:
                stream.wait_event(e.ready)
            if len(entries) == 1:
                src = _byte_view(entries[0].tensor)
            else:
                src = self._device_buffer(device, total)
                offset = 0
                for e in entries:
                    src[offset:offset + e.nbytes].copy_(_byte_view(e.tensor))
                    offset += e.nbytes
            host = self._staging(total)
            self._activity(tname, tl.MEMCPY_D2H)
            host.copy_(src, non_blocking=True)
            stream.synchronize()
            self._activity_end(tname)
        return host

    def _finalize(self, entry: _Pending,
                  value: torch.Tensor) -> torch.Tensor:
        """``entry``'s result from ``value`` (already on its device):
        averaged, and written into the caller's tensor when in-place."""
        if entry.average:
            value = average(value, self.topo.size)
        if entry.target is not None:
            if entry.target.data_ptr() != value.data_ptr():
                entry.target.copy_(value)
            return entry.target
        if entry.stream is not None:
            # Made on the side stream, used on the caller's.
            value.record_stream(entry.stream)
        return value

    def _resolve_on_card(self, entries: List[_Pending],
                         values: List[torch.Tensor]) -> None:
        """Finish CUDA entries on the current (side) stream: one event
        after the last kernel, which each handle's ``wait()`` hands to
        its caller's stream."""
        outs = [self._finalize(e, v) for e, v in zip(entries, values)]
        done = torch.cuda.Event()
        done.record()
        self._resolved.extend(
            (e, out, done) for e, out in zip(entries, outs))

    def _to_card(self, entry: _Pending, value: torch.Tensor) -> None:
        """Deliver a host result to a CUDA entry, on the side stream."""
        device = entry.tensor.device
        stream = self._stream(device)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            self._resolve_on_card([entry], [value.to(device)])

    def _unpack(self, entries: List[_Pending], result: torch.Tensor,
                tname: str) -> None:
        """Split the flat host result into the entries' results (reference
        ``MemcpyOutFusionBuffer``)."""
        device = self._card_of(entries)
        if device is None:
            offset = 0
            for e in entries:
                n = e.tensor.numel()
                value = result[offset:offset + n].view(e.tensor.shape)
                offset += n
                if e.ready is not None:
                    self._to_card(e, value)
                else:
                    self._resolved.append(
                        (e, self._finalize(e, value.clone()), None))
            return
        stream = self._stream(device)
        raw = _byte_view(result)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            if len(entries) == 1:
                e = entries[0]
                out = (e.target if e.target is not None
                       and e.target.is_contiguous() else
                       torch.empty_like(e.tensor))
                self._activity(tname, tl.MEMCPY_H2D)
                _byte_view(out).copy_(raw)
                self._activity_end(tname)
                self._resolve_on_card(entries, [out])
                return
            buf = self._device_buffer(device, raw.numel())
            self._activity(tname, tl.MEMCPY_H2D)
            buf.copy_(raw)
            self._activity_end(tname)
            values, offset = [], 0
            for e in entries:
                values.append(buf[offset:offset + e.nbytes].view(
                    e.tensor.dtype).view(e.tensor.shape).clone())
                offset += e.nbytes
            self._resolve_on_card(entries, values)

    def _execute_allreduce(self, entries: List[_Pending], tname: str) -> None:
        t0 = time.monotonic()
        self._activity(tname, tl.MEMCPY_IN_FUSION_BUFFER)
        host = self._pack(entries, tname)
        self._activity_end(tname)
        t1 = time.monotonic()
        dtype = entries[0].tensor.dtype
        self._activity(tname, tl.TCP_COLLECTIVE)
        hier = self._use_hierarchical(dtype, self._hier_allreduce)
        if hier or self._use_ring(dtype):
            if len(entries) == 1 and entries[0].ready is None:
                # A view of the caller's CPU tensor: reduce a copy.
                host = host.clone()
            result = host.view(dtype)
            if hier:
                # Sum inside the host, exchange the host sums over the
                # local roots' ring, fan the result back out.
                self._local_ring.allreduce_(
                    result, wire_dtype=self._wire_local_code)
                if self.topo.local_rank == 0:
                    self._cross_ring.allreduce_(
                        result, wire_dtype=self._wire_cross_code)
                self._local_ring.broadcast_(result, 0)
            else:
                self._ring.allreduce_(result, wire_dtype=self._wire_code)
        elif self.topo.rank == 0:
            acc = host.view(dtype)
            for rank in range(1, self.topo.size):
                peer = _from_bytes(self._service.recv_bytes_from(rank), dtype)
                acc = _host_sum(acc, peer)
            payload = _byte_view(acc).numpy()
            for rank in range(1, self.topo.size):
                self._service.send_bytes_to(rank, payload)
            result = acc
        else:
            self._client.send_bytes(host.numpy())
            result = _from_bytes(self._client.recv_bytes(), dtype)
        self._activity_end(tname)
        t2 = time.monotonic()
        self._activity(tname, tl.MEMCPY_OUT_FUSION_BUFFER)
        self._unpack(entries, result, tname)
        self._activity_end(tname)
        self._spans(tname, t0, t1, t2, len(entries))
        t3 = time.monotonic()
        with self._lock:
            self._counters["pack_s"] += t1 - t0
            self._counters["exchange_s"] += t2 - t1
            self._counters["unpack_s"] += t3 - t2

    def _execute_allgather(self, entry: _Pending, response: Response) -> None:
        t0 = time.monotonic()
        dtype = entry.tensor.dtype
        rest = tuple(entry.tensor.shape[1:])
        # The negotiated per-rank first dims on the handle: autograd's
        # backward locates its slice without a second sizes-allgather.
        entry.handle.tensor_sizes = [int(s) for s in response.tensor_sizes]
        mine = self._host_bytes(entry)
        t1 = time.monotonic()
        sizes = [int(s) for s in response.tensor_sizes]
        rest_elems = math.prod(rest)
        if self._use_hierarchical(dtype, self._hier_allgather):
            # Gather inside the host, the local roots exchange the host
            # blobs, then fan the whole back out (contiguous rank groups:
            # host order is rank order).
            ls, cr = self.topo.local_size, self.topo.cross_rank
            local = self._local_ring.allgather(
                mine.view(dtype),
                [s * rest_elems for s in sizes[cr * ls:(cr + 1) * ls]])
            if self.topo.local_rank == 0:
                flat = self._cross_ring.allgather(local, [
                    sum(sizes[g * ls:(g + 1) * ls]) * rest_elems
                    for g in range(self.topo.cross_size)])
            else:
                flat = torch.empty(sum(sizes) * rest_elems, dtype=dtype)
            full = _byte_view(self._local_ring.broadcast_(flat, 0))
        elif self._use_ring(dtype):
            full = _byte_view(self._ring.allgather(
                mine.view(dtype), [s * rest_elems for s in sizes]))
        elif self.topo.rank == 0:
            parts = [mine]
            for rank in range(1, self.topo.size):
                parts.append(_from_bytes(
                    self._service.recv_bytes_from(rank), torch.uint8))
            full = torch.cat(parts)
            payload = full.numpy()
            for rank in range(1, self.topo.size):
                self._service.send_bytes_to(rank, payload)
        else:
            self._client.send_bytes(mine.numpy())
            full = _from_bytes(self._client.recv_bytes(), torch.uint8)
        t2 = time.monotonic()
        value = full.view(dtype).view((sum(response.tensor_sizes),) + rest)
        if entry.ready is not None:
            self._to_card(entry, value)
        else:
            self._resolved.append(
                (entry, self._finalize(entry, value.clone()), None))
        self._spans(entry.name, None, t1, t2)
        with self._lock:
            self._counters["pack_s"] += t1 - t0
            self._counters["exchange_s"] += t2 - t1
            self._counters["unpack_s"] += time.monotonic() - t2

    def _execute_broadcast(self, entry: _Pending) -> None:
        t0 = time.monotonic()
        root = entry.request.root_rank
        rank = self.topo.rank
        mine = self._host_bytes(entry) if rank == root else None
        t1 = time.monotonic()
        if self._use_ring(entry.tensor.dtype):
            if mine is None:
                data = torch.empty(entry.nbytes, dtype=torch.uint8)
            else:
                data = mine.clone() if entry.ready is None else mine
            self._ring.broadcast_(data.view(entry.tensor.dtype), root)
        elif rank == 0:
            data = mine if root == 0 else _from_bytes(
                self._service.recv_bytes_from(root), torch.uint8)
            payload = data.numpy()
            for peer in range(1, self.topo.size):
                if peer != root:
                    self._service.send_bytes_to(peer, payload)
        elif rank == root:
            self._client.send_bytes(mine.numpy())
            data = mine
        else:
            data = _from_bytes(self._client.recv_bytes(), torch.uint8)
        t2 = time.monotonic()
        value = data.view(entry.tensor.dtype).view(entry.tensor.shape)
        if entry.ready is not None:
            if rank == root:
                # The root's result is its own input, already on the card.
                value = entry.tensor.clone() if entry.target is None \
                    else entry.tensor
                stream = self._stream(entry.tensor.device)
                with torch.cuda.device(entry.tensor.device), \
                        torch.cuda.stream(stream):
                    stream.wait_event(entry.ready)
                    self._resolve_on_card([entry], [value])
            else:
                self._to_card(entry, value)
        else:
            self._resolved.append(
                (entry, self._finalize(entry, value.clone()), None))
        self._spans(entry.name, None, t1, t2)
        with self._lock:
            self._counters["pack_s"] += t1 - t0
            self._counters["exchange_s"] += t2 - t1
            self._counters["unpack_s"] += time.monotonic() - t2


# ---------------------------------------------------------------------------
# The composed eager alltoall (the JAX package's): correctness first — it
# gathers the full payload. (The eager reduce-scatter is a block of an
# allreduce, ``torch/mpi_ops.reducescatter``.) Bandwidth-optimal forms run
# on the process group (``group=``).


def alltoall_dims(ctl: Controller, tensor: torch.Tensor,
                  name: Optional[str] = None) -> List[int]:
    """Every rank's first dim, agreed through an allgather, so that an
    indivisible one raises the same error on every rank instead of
    hanging the data phase."""
    size = ctl.topo.size
    dims = [int(d) for d in ctl.allgather(
        torch.tensor([tensor.shape[0]], dtype=torch.int64),
        name=None if name is None else f"{name}.dims")]
    for r, d in enumerate(dims):
        if d % size != 0:
            raise ValueError(
                f"alltoall requires every rank's first dimension to be "
                f"divisible by size {size}; rank {r} has dim 0 = {d}")
    return dims


def composed_alltoall(ctl: Controller, tensor: torch.Tensor,
                      name: Optional[str] = None,
                      dims: Optional[List[int]] = None) -> torch.Tensor:
    """Exchange dim-0 splits: rank r's output is the concatenation of
    every rank's r-th block. Each rank's own first dim must be divisible
    by the world size (block sizes may differ between ranks)."""
    if tensor.ndim == 0:
        raise ValueError(
            "alltoall requires at least one dimension (got a scalar)")
    size, rank = ctl.topo.size, ctl.topo.rank
    if dims is None:
        dims = alltoall_dims(ctl, tensor, name)
    gathered = ctl.allgather(tensor, name=name)
    parts, start = [], 0
    for j in range(size):
        seg = dims[j] // size
        parts.append(gathered[start + rank * seg:start + (rank + 1) * seg])
        start += dims[j]
    return torch.cat(parts, dim=0)
