"""Native controller: the eager tier run by the C++ engine — the port's
counterpart of ``horovod_tpu/controller/native.py`` on torch tensors.

The engine (``core/src/engine.cc``, built by ``core/bindings.py``) runs
negotiation, Tensor Fusion, the response cache, stall checks and the
timeline on a background thread of its own, over the authenticated TCP
ring (the control token and the data phases share its connections),
and reduces in place in host memory that this module hands it by
pointer. Python keeps what belongs to the API layer, as in the JAX
package: averaging as a post-divide, the int8 wire's error-feedback
residuals (per tensor name), and the result surface (handles).

CPU tensors go to the engine zero-copy: an in-place op hands over the
caller's contiguous tensor, a value op one defensive copy. A CUDA
tensor cannot be read by the engine's thread, so a staging thread of
this controller waits for the event the caller's stream recorded at
enqueue, copies the tensor on a side stream into pinned host memory that
lives until the handle resolves, and only then enqueues it: the caller's
thread (autograd's hook thread, for ``DistributedOptimizer``) never
waits for a card-to-host copy. ``wait()`` copies the result back to the
card on a second side stream, averages it there (a division by a
tensor, integers truncated, as the Python controller does) and makes the
caller's stream wait on an event recorded after the last of it.

The tuning and tracing loop, as in the JAX package: with
``HOROVOD_AUTOTUNE`` a rank-0 thread samples the engine's cumulative
bytes and busy seconds (``hvd_eng_get_stats``), scores them with the GP
tuner, and pushes the next fusion threshold and cycle time into the
engine (``hvd_eng_set_params``), the ring chunk into this process, and
the gradient-bucket size into the engine's cycle-reply slot
(``hvd_eng_set_tuned_bucket``), from which every rank's telemetry thread
adopts it at the same cycle. With ``HOROVOD_TRACE_DIR`` the engine stamps
its ``enqueue → negotiate → fuse → execute → done`` spans, tagged with
the coordinator's sequence ids, into a C ring that the telemetry thread
drains into the rank's ``TraceWriter``.

One difference from the JAX package's engine, which writes no clock table
and merges only the files of a shared directory: a traced job also opens
the launcher's TCP star (``HOROVOD_CONTROLLER_ADDR``) beside the ring.
Its heartbeats carry rank 0's clock pings, as on the Python controller,
so ``clock_offsets.json`` is measured on this engine too, and at shutdown
the workers ship their span files over it to rank 0, which merges them.

Selected by ``init()`` whenever the launcher exported ring addresses,
unless ``HOROVOD_ENGINE=python`` or ``HOROVOD_CPU_OPS=star``.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
import time
from typing import Dict, Optional

import torch

from ..common import config as config_mod
from ..common import hvd_logging as logging
from ..common.config import Config
from ..common.reduction import average_
from ..common.topology import Topology
from ..common.wire import job_secret
from ..core import bindings
from .. import metrics
from .controller import ShutdownError

_OP_CODES = {"allreduce": 0, "allgather": 1, "broadcast": 2}

_SHUTDOWN_MSG = "Horovod has been shut down"

# Seconds this side of the ABI spends on CUDA tensors: staging inputs to
# the host (the staging thread) and issuing results back (``wait()``).
STAGING_COUNTERS = ("stage_s", "unstage_s")


class _Op:
    """One collective on its way through the engine."""

    __slots__ = ("kind", "name", "named", "tensor", "target", "average",
                 "root", "priority", "host", "residual", "ready",
                 "engine_id", "staged", "error")

    def __init__(self, kind: str, name: str, named: bool,
                 tensor: torch.Tensor, target: Optional[torch.Tensor],
                 average: bool, root: int, priority: int):
        self.kind = kind
        self.name = name
        self.named = named
        # Detached, contiguous input; ``target`` is the caller's tensor
        # that receives the result (in-place ops), else None.
        self.tensor = tensor
        self.target = target
        self.average = average
        self.root = root
        self.priority = priority
        # The host buffer the engine reads (and, for allreduce and
        # broadcast, writes the result into), and the int8 residual.
        self.host: Optional[torch.Tensor] = None
        self.residual: Optional[torch.Tensor] = None
        self.ready = None
        self.engine_id = -1
        self.error: Optional[BaseException] = None
        # Set once the op reached the engine (or failed to).
        self.staged = threading.Event()


class NativeHandle:
    """Handle over an engine operation, API-compatible with
    ``common.handles.Handle`` (``wait``/``done``/``tensor_sizes``)."""

    __slots__ = ("_ctl", "_op", "_result", "_error", "_taken",
                 "tensor_sizes")

    def __init__(self, ctl: Optional["NativeController"], op: _Op):
        self._ctl = ctl
        self._op = op
        self._result = None
        self._error: Optional[BaseException] = None
        self._taken = False
        # Allgather: every rank's negotiated first dim, filled at wait().
        self.tensor_sizes = None

    @classmethod
    def failed(cls, exc: BaseException) -> "NativeHandle":
        h = cls(None, None)
        h._error = exc
        h._taken = True
        return h

    def done(self) -> bool:
        if self._taken:
            return True
        op = self._op
        if not op.staged.is_set():
            return False
        return op.error is not None or \
            self._ctl._lib.hvd_eng_poll(op.engine_id) != 0

    def wait(self, timeout: Optional[float] = None):
        if not self._taken:
            self._take(timeout)
        if self._error is not None:
            raise self._error
        return self._result

    def _take(self, timeout: Optional[float]) -> None:
        op, lib = self._op, self._ctl._lib
        start = time.monotonic()
        if not op.staged.wait(timeout):
            raise TimeoutError(f"{op.name} not staged after {timeout}s")
        if op.error is not None:
            self._error, self._taken = op.error, True
            return
        # ctypes releases the GIL while these block.
        if timeout is None:
            rc = lib.hvd_eng_wait(op.engine_id)
        else:
            left = max(0.0, timeout - (time.monotonic() - start))
            rc = lib.hvd_eng_wait_for(op.engine_id, left)
            if rc == -2:
                raise TimeoutError(
                    f"{op.name} not complete after {timeout}s")
        try:
            if rc == 0:
                self._result = self._ctl._finish(op, self)
            else:
                msg = lib.hvd_eng_handle_error(op.engine_id).decode(
                    errors="replace")
                self._error = (ShutdownError(msg) if _SHUTDOWN_MSG in msg
                               else RuntimeError(msg))
        finally:
            lib.hvd_eng_release(op.engine_id)
            self._taken = True
            self._ctl._unpin(op)


class NativeController:
    """The Python controller's public surface, backed by the C++
    engine."""

    def __init__(self, config: Config, topology: Topology):
        ring_addrs = config_mod.ring_addrs() or ""
        if topology.size > 1 and not ring_addrs:
            raise RuntimeError(
                "native engine requires HOROVOD_RING_ADDRS (exported by "
                "horovodrun); set HOROVOD_ENGINE=python to use the TCP star")
        if config_mod.elastic_enabled():
            raise RuntimeError(
                "HOROVOD_ELASTIC=1: the native engine's ring is fixed-"
                "membership; elastic membership runs on the Python "
                "controller, which hvd.init selects under HOROVOD_ELASTIC")
        self._lib = lib = bindings.load()
        self.cfg = config
        self.topo = topology
        self._lock = threading.Lock()
        self._autoname_counter: Dict[str, int] = {}
        # Ops whose host memory the engine holds a pointer into, by engine
        # id, until their handle resolves (a dropped handle keeps its op
        # pinned for the controller's life, as in the JAX package); and
        # the names in flight, for the error-feedback bookkeeping.
        self._pinned: Dict[int, _Op] = {}
        self._inflight: Dict[str, int] = {}
        self._residuals: Dict[str, torch.Tensor] = {}
        self._warned_unnamed_int8 = False
        self._shut = False
        self._extra = dict.fromkeys(STAGING_COUNTERS, 0.0)
        self._streams: Dict[tuple, object] = {}

        wire = config_mod.ring_wire_dtype()
        wire_local = config_mod.ring_wire_dtype_local()
        wire_cross = config_mod.ring_wire_dtype_cross()
        codes = bindings.WIRE_DTYPE_CODES
        secret = job_secret()
        key = (ctypes.c_uint8 * len(secret)).from_buffer_copy(secret)
        timeline = (config.timeline_filename or "") \
            if topology.rank == 0 else ""
        rc = lib.hvd_eng_init(
            topology.rank, topology.size, ring_addrs.encode(), key,
            len(secret), config.cycle_time_ms, config.fusion_threshold_bytes,
            config.cache_capacity, 1 if config.stall_check_disable else 0,
            config.stall_check_seconds, config.stall_shutdown_seconds,
            timeline.encode(), 1 if config.timeline_mark_cycles else 0,
            codes[wire], codes[wire_local], codes[wire_cross],
            1 if config_mod.pipeline_enabled() else 0)
        if rc != 0:
            raise RuntimeError(
                "native engine init failed: "
                + lib.hvd_eng_last_error().decode(errors="replace"))
        # Error feedback is live when int8 rides the plane this job's
        # allreduces take: the hierarchical hops when the two-level plane
        # routes allreduces, else the flat ring.
        if lib.hvd_eng_hier_active() and config.hierarchical_allreduce:
            self._ef_enabled = codes["int8"] in (codes[wire_local],
                                                 codes[wire_cross])
        else:
            self._ef_enabled = wire == "int8"
        bindings.set_chunk_bytes(config_mod.resolved_ring_chunk_bytes())
        # The double-buffered data plane: the BucketScheduler launches
        # each gradient eagerly when it is on.
        self.pipeline_enabled = config_mod.pipeline_enabled()
        self._stage_q: "queue.Queue[Optional[_Op]]" = queue.Queue()
        self._stager = threading.Thread(
            target=self._stage_loop, name="hvd-native-stage", daemon=True)
        self._stager.start()

        self._tracer = None
        self._clock = None
        self._service = self._client = None
        self._blobs: Dict[int, bytes] = {}
        self._star_threads = []
        if config.trace_dir:
            self._start_trace(config, topology)

        # Telemetry thread (every rank): adopts the synced tuned-bucket
        # value from the cycle reply, drains the span ring, and (rank 0,
        # traced) pings the workers' clocks.
        self._applied_bucket = 0
        self._jumps_seen = 0
        self._telemetry_stop = threading.Event()
        self._telemetry = threading.Thread(
            target=self._telemetry_loop, name="hvd-native-telemetry",
            daemon=True)
        self._telemetry.start()

        # Rank 0's autotuner: the ring chunk and the bucket size join the
        # search (the hierarchical and cache knobs have no runtime switch
        # in the engine and stay pinned).
        self._param_manager = None
        self._tuner_stop = threading.Event()
        self._tuner = None
        if config.autotune and topology.rank == 0:
            from .autotune_glue import make_parameter_manager

            self._param_manager = make_parameter_manager(
                config, tune_ring_chunk=topology.size > 1,
                tune_bucket=True, world_size=topology.size)
            self._tuner = threading.Thread(
                target=self._tune_loop, name="hvd-native-autotune",
                daemon=True)
            self._tuner.start()

    # ------------------------------------------------------ tune and trace

    def _start_trace(self, config: Config, topology: Topology) -> None:
        """Arm the engine's span ring, open this rank's span file and,
        in a multi-rank job, the clock star (see the module docstring).
        Raises when the star cannot start: a traced job never runs
        untraced."""
        from ..common.config import _env_int
        from ..trace import ClockSync, TraceWriter, rank_trace_path
        from .service import CoordinatorService, WorkerClient

        os.makedirs(config.trace_dir, exist_ok=True)
        self._tracer = TraceWriter(
            rank_trace_path(config.trace_dir, topology.rank), topology.rank)
        # Ring capacity: the span cap knob, clamped by the C side to
        # [256, 2^20]; 0 keeps the engine's default.
        self._lib.hvd_eng_trace_set(
            1, _env_int("HOROVOD_TRACE_MAX_EVENTS", 0))
        self._clock_sync_cycles = config_mod.clock_sync_cycles()
        if topology.size == 1:
            return
        addr = config_mod.controller_addr()
        if addr is None:
            raise RuntimeError(
                "HOROVOD_TRACE_DIR on the native engine needs "
                "HOROVOD_CONTROLLER_ADDR (exported by horovodrun) for its "
                "clock sync and the shutdown trace exchange")
        if topology.rank == 0:
            self._service = CoordinatorService(
                addr, topology.size, comm_timeout=config.comm_timeout_seconds)
            self._clock = ClockSync(topology.size)
            self._service.set_clock_sync(self._clock)
            self._service.start_heartbeats(config.heartbeat_interval_seconds)
            # One reader a worker: drains the pongs until the worker's
            # span file arrives at shutdown.
            for worker_rank in range(1, topology.size):
                self._star_threads.append(threading.Thread(
                    target=self._collect_blob, args=(worker_rank,),
                    name=f"hvd-native-trace-{worker_rank}", daemon=True))
        else:
            self._client = WorkerClient(
                addr, topology.rank, comm_timeout=config.comm_timeout_seconds)
            self._client.start_heartbeats(config.heartbeat_interval_seconds)
            # Answers the pings until rank 0's end-of-trace frame.
            self._star_threads.append(threading.Thread(
                target=self._await_trace_end,
                name="hvd-native-trace-pongs", daemon=True))
        for t in self._star_threads:
            t.start()

    def _await_trace_end(self) -> None:
        try:
            self._client.recv_bytes()
        except Exception as exc:
            logging.error("trace: lost the clock star to rank 0: %s", exc)

    def _collect_blob(self, worker_rank: int) -> None:
        try:
            self._blobs[worker_rank] = bytes(
                self._service.recv_bytes_from(worker_rank))
        except Exception as exc:
            logging.error("trace: rank %d sent no span file: %s",
                          worker_rank, exc)

    def _tune_loop(self) -> None:
        """Rank 0: score the engine's bytes per busy second since the
        last sample and push a new configuration when the tuner moves."""
        from .autotune_glue import publish_tuner_gauges
        from .bucket_scheduler import last_overlap_efficiency

        pm = self._param_manager
        last_bytes, last_busy = 0, 0.0
        published = None
        # Sample fast enough that a short burst of traffic still yields
        # the warm-up and scoring samples.
        while not self._tuner_stop.wait(0.01):
            _, nbytes, busy = bindings.engine_stats()
            delta_bytes, delta_busy = nbytes - last_bytes, busy - last_busy
            last_bytes, last_busy = nbytes, busy
            if delta_bytes <= 0 or delta_busy <= 0:
                continue
            tuned = pm.record(delta_bytes, delta_busy,
                              overlap=last_overlap_efficiency())
            if tuned is not None:
                threshold, cycle_ms = tuned[:2]
                self._lib.hvd_eng_set_params(int(threshold), float(cycle_ms))
                if pm.ring_chunk_bytes:
                    # Per-rank pipelining granularity: no cross-rank
                    # agreement needed.
                    bindings.set_chunk_bytes(int(pm.ring_chunk_bytes))
                if pm.bucket_bytes:
                    # Rides the next cycle reply's slot, so every rank
                    # (this one through its telemetry thread) adopts it
                    # together.
                    self._lib.hvd_eng_set_tuned_bucket(int(pm.bucket_bytes))
                logging.debug("native autotune: threshold=%d cycle=%.2fms "
                              "chunk=%s bucket=%s", int(threshold),
                              float(cycle_ms), pm.ring_chunk_bytes,
                              pm.bucket_bytes)
            if metrics.on() and pm.steps_scored != published:
                published = pm.steps_scored
                publish_tuner_gauges(pm)

    def _telemetry_loop(self) -> None:
        # Traced jobs drain the span ring every 20 ms; untraced ones only
        # adopt the synced bucket, which moves at the tuner's pace.
        interval = 0.02 if self._tracer is not None else 0.5
        passes, last_sync = 0, 0
        while not self._telemetry_stop.wait(interval):
            self._drain_telemetry()
            if self._service is not None:
                # Clock pings: a dense burst while the job warms up, then
                # every HOROVOD_CLOCK_SYNC_CYCLES engine cycles.
                passes += 1
                cycles = bindings.engine_stats()[0]
                if passes <= 8 or \
                        cycles - last_sync >= self._clock_sync_cycles:
                    last_sync = cycles
                    self._service.send_clock_pings()
        self._drain_telemetry()

    def _drain_telemetry(self) -> None:
        """Adopt the synced tuned-bucket value, mirror the engine's
        priority jumps, and move the stamped spans into the TraceWriter."""
        counters = bindings.native_counters()
        if counters is not None:
            bucket = counters["bucket_bytes"]
            if bucket and bucket != self._applied_bucket:
                from .bucket_scheduler import set_autotuned_bucket_bytes

                # Arrived on the cycle reply: every rank lands here with
                # the same value.
                set_autotuned_bucket_bytes(int(bucket))
                self._applied_bucket = bucket
            jumps = counters["priority_jumps"]
            if metrics.on() and jumps > self._jumps_seen:
                from .bucket_scheduler import _overlap_metrics

                _overlap_metrics().priority_jumps.inc(
                    jumps - self._jumps_seen)
            self._jumps_seen = jumps
        if self._tracer is None:
            return
        from ..trace.tracer import PHASES

        for phase, seq, t0, t1, tensors, op in bindings.drain_engine_spans():
            if not 0 <= phase < len(PHASES):
                continue  # an unknown code: drop it
            kwargs = {"tensors": tensors} if tensors else {}
            self._tracer.span(PHASES[phase], t0, t1,
                              seq=seq if seq >= 0 else None,
                              op=op or None, **kwargs)

    def _finish_trace(self) -> None:
        """After the engine stopped: workers ship their span file to rank
        0 over the star; rank 0 writes them, the clock table, the merged
        trace and the straggler report, then releases the workers."""
        from .. import trace as trace_mod

        self._tracer.close()
        trace_dir = self.cfg.trace_dir
        if self._client is not None:
            self._client.send_bytes(self._tracer.read_bytes())
            for t in self._star_threads:
                t.join(timeout=self.cfg.comm_timeout_seconds or None)
            self._client.close()
            return
        if self._service is not None:
            for t in self._star_threads:
                t.join(timeout=self.cfg.comm_timeout_seconds or None)
            for worker_rank, blob in sorted(self._blobs.items()):
                if blob:
                    with open(trace_mod.rank_trace_path(
                            trace_dir, worker_rank), "wb") as f:
                        f.write(blob)
            self._clock.write(os.path.join(trace_dir, trace_mod.OFFSETS_FILE))
        try:
            merged = trace_mod.merge_trace_dir(trace_dir)
            report = trace_mod.write_report(trace_dir)
            logging.info("trace: merged trace at %s; straggler report at %s",
                         merged, report)
        except (OSError, ValueError) as exc:
            logging.error("trace: merge failed: %s (the per-rank trace "
                          "files stay for trace.merge_trace_dir)", exc)
        finally:
            if self._service is not None:
                from .service import PeerFailureError

                for worker_rank in sorted(self._service.wires):
                    try:
                        self._service.send_bytes_to(worker_rank, b"")
                    except PeerFailureError:
                        pass  # that worker already left
                self._service.close()

    # ------------------------------------------------------------- counters

    def counters(self) -> Dict[str, float]:
        """This rank's running totals: the engine's counters
        (``bindings.native_counters()``: its scalar slots and the responses
        executed, a fused group counting once), its busy seconds
        (``busy_s``) and ``STAGING_COUNTERS``; callers diff two reads
        around the work they measure."""
        out = bindings.native_counters() or dict.fromkeys(
            bindings.NATIVE_COUNTER_SCALARS + ("responses",), 0)
        out["busy_s"] = bindings.engine_stats()[2]
        with self._lock:
            out.update(self._extra)
        return out

    def residual(self, name: str) -> Optional[torch.Tensor]:
        """The int8 wire's error-feedback residual of tensor ``name`` (a
        copy), or None."""
        with self._lock:
            res = self._residuals.get(name)
            return None if res is None else res.clone()

    # ------------------------------------------------------------ enqueue

    def _autoname(self, kind: str, name: Optional[str]) -> str:
        if name is not None:
            return name
        with self._lock:
            n = self._autoname_counter.get(kind, 0)
            self._autoname_counter[kind] = n + 1
        return f"{kind}.noname.{n}"

    def _enqueue(self, kind: str, name: Optional[str], tensor: torch.Tensor,
                 average: bool = False, root: int = -1,
                 inplace: bool = False, priority: int = 0) -> NativeHandle:
        t = tensor.detach()
        if bindings.dtype_code(t.dtype) is None:
            return NativeHandle.failed(RuntimeError(
                f"dtype {t.dtype} is not supported by the native engine "
                "(supported: float32/float64/float16/bfloat16/int8/int16/"
                "int32/int64/uint8/uint16/bool); set HOROVOD_ENGINE=python "
                "for other dtypes"))
        op = _Op(kind, self._autoname(kind, name), name is not None,
                 t.contiguous(), tensor if inplace else None, average, root,
                 priority)
        with self._lock:
            if self._shut:
                return NativeHandle.failed(ShutdownError(_SHUTDOWN_MSG))
        handle = NativeHandle(self, op)
        if t.is_cuda:
            # The caller's stream may still be producing the tensor.
            op.ready = torch.cuda.Event()
            op.ready.record(torch.cuda.current_stream(t.device))
            self._stage_q.put(op)
            return handle
        # The engine only reads an allgather's input, an in-place op on a
        # contiguous tensor reduces in the caller's memory, and a
        # non-contiguous input is already a private copy; anything else
        # takes one defensive copy.
        op.host = op.tensor if (kind == "allgather" or inplace
                                or op.tensor is not t) else op.tensor.clone()
        self._submit(op)
        return handle

    def _stream(self, device: torch.device, role: str):
        """This controller's side stream on ``device`` for ``role``
        (card-to-host staging, or results back to the card)."""
        stream = self._streams.get((device, role))
        if stream is None:
            stream = self._streams[(device, role)] = torch.cuda.Stream(device)
        return stream

    def _stage_loop(self) -> None:
        while True:
            op = self._stage_q.get()
            if op is None:
                return
            try:
                self._stage(op)
            except Exception as exc:  # delivered through the handle
                op.error = exc
                op.staged.set()

    def _stage(self, op: _Op) -> None:
        """A CUDA input to pinned host memory, then to the engine."""
        t0 = time.monotonic()
        t = op.tensor
        stream = self._stream(t.device, "d2h")
        with torch.cuda.device(t.device), torch.cuda.stream(stream):
            op.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if op.kind != "broadcast" or op.root == self.topo.rank:
                stream.wait_event(op.ready)
                op.host.copy_(t, non_blocking=True)
                stream.synchronize()
        with self._lock:
            self._extra["stage_s"] += time.monotonic() - t0
        self._submit(op)

    def _compensate(self, op: _Op) -> None:
        """int8 wire error feedback: add this tensor's previous residual to
        its contribution and hand the ring a buffer for this round's.
        Keyed by name, so only named tensors take part; a same-name op
        still in flight will be refused by the engine, so it touches no
        buffer."""
        if not (self._ef_enabled and op.kind == "allreduce"
                and op.host.dtype == torch.float32):
            return
        if not op.named:
            if not self._warned_unnamed_int8:
                self._warned_unnamed_int8 = True
                logging.warning(
                    "int8 wire compression without a tensor name: no error "
                    "feedback is applied (residuals are keyed by name); "
                    "pass name= to allreduce")
            return
        if self._name_still_pending(op.name):
            return
        with self._lock:
            residual = self._residuals.get(op.name)
        if residual is None or residual.numel() != op.host.numel():
            residual = torch.zeros(op.host.numel(), dtype=torch.float32)
        op.host.view(-1).add_(residual)
        op.residual = residual

    def _name_still_pending(self, name: str) -> bool:
        with self._lock:
            hid = self._inflight.get(name)
            if hid is None:
                return False
            if self._lib.hvd_eng_poll(hid) == 0:
                return True
            # Finished, though never waited: the engine freed the name.
            self._inflight.pop(name, None)
            self._pinned.pop(hid, None)
            return False

    def _submit(self, op: _Op) -> None:
        """Hand ``op.host`` to the engine; the outcome lands on ``op``."""
        try:
            self._compensate(op)
            host = op.host
            shape = (ctypes.c_longlong * max(host.dim(), 1))(*host.shape)
            h = self._lib.hvd_eng_enqueue(
                _OP_CODES[op.kind], op.name.encode(),
                host.data_ptr() or None, shape, host.dim(),
                bindings.dtype_code(host.dtype), op.root,
                None if op.residual is None else op.residual.data_ptr(),
                int(op.priority))
            if h >= 0:
                op.engine_id = h
                with self._lock:
                    self._pinned[h] = op
                    self._inflight[op.name] = h
                    if op.residual is not None:
                        self._residuals[op.name] = op.residual
                return
            if op.residual is not None:
                # Refused after the compensation: take it back out.
                host.view(-1).sub_(op.residual)
            if h == -2:
                op.error = RuntimeError(
                    f"Duplicate tensor name {op.name!r}: a collective with "
                    "this name is already pending; names must be unique "
                    "until the operation completes.")
            else:
                op.error = ShutdownError(_SHUTDOWN_MSG)
        finally:
            op.staged.set()

    def _unpin(self, op: _Op) -> None:
        with self._lock:
            self._pinned.pop(op.engine_id, None)
            if self._inflight.get(op.name) == op.engine_id:
                del self._inflight[op.name]

    # ------------------------------------------------------------- results

    def _finish(self, op: _Op, handle: NativeHandle) -> torch.Tensor:
        """The op's result from the engine's slot: averaged, written into
        the caller's tensor for in-place ops, on the caller's device."""
        lib, hid = self._lib, op.engine_id
        if lib.hvd_eng_result_in_place(hid):
            host = op.host
        else:
            ndim = lib.hvd_eng_result_ndim(hid)
            dims = (ctypes.c_longlong * max(ndim, 1))()
            lib.hvd_eng_result_shape(hid, dims)
            host = torch.empty(
                tuple(dims[k] for k in range(ndim)),
                dtype=bindings.DTYPES[lib.hvd_eng_result_dtype(hid)],
                pin_memory=op.ready is not None)
            if host.numel():
                lib.hvd_eng_result_copy(hid, host.data_ptr())
            nsz = lib.hvd_eng_result_sizes_count(hid)
            if nsz > 0:
                sizes = (ctypes.c_longlong * nsz)()
                lib.hvd_eng_result_sizes(hid, sizes)
                handle.tensor_sizes = [int(sizes[k]) for k in range(nsz)]
        if op.ready is None:
            value = host
            if op.average:
                value = average_(value, self.topo.size)
            if op.target is None:
                return value
            if op.target.data_ptr() != value.data_ptr():
                with torch.no_grad():
                    op.target.copy_(value)
            return op.target
        t0 = time.monotonic()
        device = op.tensor.device
        caller = torch.cuda.current_stream(device)
        stream = self._stream(device, "h2d")
        with torch.cuda.device(device), torch.cuda.stream(stream), \
                torch.no_grad():
            target = op.target
            if target is not None and target.is_contiguous():
                out = target
            else:
                out = torch.empty(host.shape, dtype=host.dtype,
                                  device=device)
            out.copy_(host, non_blocking=True)
            if op.average:
                average_(out, self.topo.size)
            if target is not None and out is not target:
                target.copy_(out)
                out = target
            done = torch.cuda.Event()
            done.record(stream)
        if out is not op.target:
            # Made on the side stream, used on the caller's.
            out.record_stream(caller)
        caller.wait_event(done)
        with self._lock:
            self._extra["unstage_s"] += time.monotonic() - t0
        return out

    # ---------------------------------------------------------------- API

    def allreduce_async(self, tensor: torch.Tensor, average: bool = True,
                        name: Optional[str] = None, inplace: bool = False,
                        priority: int = 0) -> NativeHandle:
        """Sum (or mean) over the ranks; ``inplace``: into ``tensor``.
        ``priority``: launch priority of the fused group (never changes
        results)."""
        return self._enqueue("allreduce", name, tensor, average=average,
                             inplace=inplace, priority=priority)

    def allgather_async(self, tensor: torch.Tensor,
                        name: Optional[str] = None) -> NativeHandle:
        return self._enqueue("allgather", name, tensor)

    def broadcast_async(self, tensor: torch.Tensor, root_rank: int,
                        name: Optional[str] = None,
                        inplace: bool = False) -> NativeHandle:
        if not 0 <= root_rank < self.topo.size:
            # Fail fast: every rank agrees on a bad root, so it would pass
            # negotiation and hang the data phase.
            return NativeHandle.failed(ValueError(
                f"root_rank {root_rank} out of range for size "
                f"{self.topo.size}"))
        return self._enqueue("broadcast", name, tensor, root=root_rank,
                             inplace=inplace)

    def allreduce(self, tensor, average: bool = True,
                  name: Optional[str] = None):
        return self.allreduce_async(tensor, average, name).wait()

    def allgather(self, tensor, name: Optional[str] = None):
        return self.allgather_async(tensor, name).wait()

    def broadcast(self, tensor, root_rank: int, name: Optional[str] = None):
        return self.broadcast_async(tensor, root_rank, name).wait()

    @property
    def hierarchical_active(self) -> bool:
        """Whether the engine's two-level data plane is live."""
        return bool(self._lib.hvd_eng_hier_active())

    def shutdown(self) -> None:
        with self._lock:
            if self._shut:
                return
            self._shut = True
        self._stage_q.put(None)
        self._stager.join(timeout=30.0)
        self._tuner_stop.set()
        if self._tuner is not None:
            self._tuner.join(timeout=2.0)
        self._lib.hvd_eng_shutdown()
        # The engine loop has exited: the final drain sees the ring's
        # tail spans.
        self._telemetry_stop.set()
        self._telemetry.join(timeout=10.0)
        if self._tracer is not None:
            self._finish_trace()
