"""The port's runtime telemetry plane, the JAX package's ``metrics``
over the port's own copies: metrics registry, Prometheus endpoint,
crash flight recorder and telemetry windows.

1. A process-wide default :class:`~.registry.MetricsRegistry` that
   instrumentation registers into lazily, never at import time
   (``counter()``/``gauge()``/``histogram()`` below); ``snapshot()`` as
   a plain dict and ``render_all()`` as Prometheus text.
2. A per-rank scrape endpoint (``HOROVOD_METRICS_PORT``, port + rank;
   ``exporter.py``) serving ``/metrics`` and the cluster doctor's
   ``/doctor``. Under the Python controller rank 0 also renders every
   worker's snapshot (piggybacked on the controller ticks every
   ``HOROVOD_METRICS_PUSH_CYCLES`` cycles) with a ``rank`` label.
3. A crash flight recorder (``HOROVOD_FLIGHT_RECORDER=<path>``,
   ``recorder.py``): a bounded ring of structured events dumped as JSONL
   when the job fails.
4. The rank-0 window roller (``HOROVOD_METRICS_WINDOW_SECONDS``):
   delta windows of the cluster view, read by the doctor's windowed
   rules and the live calibration, and by ``/metrics?window=recent``.

**Zero overhead by default**: every instrumentation site reduces to
``if metrics.on():``, a cached module-global boolean resolved once from
``HOROVOD_METRICS`` / ``HOROVOD_METRICS_PORT`` /
``HOROVOD_FLIGHT_RECORDER`` (re-read after a fork); ``enable()`` turns
it on programmatically (tests, the load generator).

The eager tier's tuning and tracing series keep the JAX package's
names and help strings, each registered by the module that owns it:
``hvd_overlap_buckets_total``, ``hvd_overlap_efficiency`` and
``hvd_overlap_priority_jumps_total`` (``controller/bucket_scheduler.py``;
the native engine's priority jumps mirrored into the last by its
telemetry thread), the ``hvd_autotune_*`` gauges
(``controller/autotune_glue.py``), the coordinator's
``hvd_controller_tick_lateness_seconds{rank}``, and
``hvd_negotiation_slack_seconds`` and
``hvd_straggler_cycles_total{rank}`` (``trace/straggler.py``).

``snapshot()`` first mirrors the native core's cumulative counters into
the registry, as the JAX package's does: the ring's wire counters
(``refresh_ring_wire_metrics``: ``hvd_ring_wire_bytes_total{dtype,link}``,
``hvd_ring_compress_seconds``, ``hvd_ring_chunk_bytes``) and the native
engine's (``refresh_native_engine_metrics``: the ``hvd_native_*``
series, and its priority jumps into the bucket scheduler's series). A
scrape never builds the core: a process that has not loaded it mirrors
nothing. The engine's telemetry thread (``controller/native.py``) runs
the same refresh, on the same seen-bookkeeping, so nothing counts twice.
"""

from __future__ import annotations

import os
import sys
import threading
from types import SimpleNamespace
from typing import Dict, Optional

from ..analysis.lockorder import make_lock
from ..common.config import _env_int, env_rank, env_size, metrics_enabled
from ..common.config import flight_recorder_path as _flight_recorder_path
from .exporter import MetricsExporter, start_exporter  # noqa: F401
from .recorder import FlightRecorder, expand_rank_path
from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    log_buckets,
    quantile,
    render_prometheus,
    subtract_snapshots,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "on", "enable",
    "counter", "gauge", "histogram", "default_registry", "snapshot",
    "render_all", "quantile", "render_prometheus", "log_buckets",
    "reset_for_tests", "subtract_snapshots", "refresh_ring_wire_metrics",
    "refresh_native_engine_metrics", "MetricsExporter", "FlightRecorder",
    "ingest_remote", "remote_snapshots", "maybe_start_exporter",
    "record_event", "record_sampled_event", "dump_flight_recorder",
    "flight_recorder_path", "controller_health", "push_cycles",
    "start_exporter", "expand_rank_path", "WindowRoller", "windows",
    "window_roller", "start_window_roller", "stop_window_roller",
    "set_mark", "snapshot_delta",
]

# Tri-state enabled cache; a forked child re-resolves its own.
_on: Optional[bool] = None
# Tracked under HOROVOD_LOCKCHECK: guards the enabled cache, the
# remote-snapshot table, recorder creation and the native mirror's
# seen-marks, reached from the controller, heartbeat, exporter and
# telemetry threads.
_lock = make_lock("metrics.state")
_registry = MetricsRegistry()
_remote: Dict[int, Dict[str, dict]] = {}
_recorder: Optional[FlightRecorder] = None


def _invalidate_in_child() -> None:
    global _on, _recorder
    _on = None
    _recorder = None  # the child re-reads its own HOROVOD_RANK


os.register_at_fork(after_in_child=_invalidate_in_child)


def on() -> bool:
    """Whether telemetry is active: THE hot-path guard (one global read
    once resolved)."""
    if _on is not None:
        return _on
    return _resolve_on()


def _resolve_on() -> bool:
    global _on
    with _lock:
        if _on is None:
            _on = metrics_enabled()
    return _on


def enable() -> None:
    """Turn telemetry on programmatically (no env needed)."""
    global _on
    with _lock:
        _on = True


def reset_for_tests() -> None:
    """Forget the enabled cache, every registered metric, the remote
    snapshots, the recorder and the window roller, and drop the
    instrumented modules' cached metric namespaces (a module-global
    ``_m`` SimpleNamespace, the package convention; the controller's and
    the elastic module's ``_em`` too), which would otherwise point at
    orphaned metrics after the registry clear."""
    global _on, _recorder
    stop_window_roller()
    with _lock:
        _on = None
        _recorder = None
        _remote.clear()
    _registry.clear()
    # The live calibration's samples come off the roller; a cleared
    # registry makes them orphans too. Only a module already imported is
    # touched: a reset must not grow the import graph.
    live_cal = sys.modules.get("horovod_tpu_torch.utils.live_calibration")
    if live_cal is not None:
        live_cal.reset_for_tests()
    for name, mod in list(sys.modules.items()):
        if not name.startswith("horovod_tpu_torch") or mod is None:
            continue
        for cache_attr in ("_m", "_em"):
            if isinstance(getattr(mod, cache_attr, None), SimpleNamespace):
                setattr(mod, cache_attr, None)
    # The native mirror's baseline: a cleared registry must not re-ingest
    # the process's earlier native history on its next refresh (an
    # engine of an earlier test keeps its cumulative counters). Mark the
    # current totals as seen; an engine created later bumps the
    # generation slot, which the refresh reads as a fresh zero.
    from ..core import bindings as _bindings

    current = (_bindings.native_counters()
               if _bindings.loaded() is not None else None)
    wire = _bindings.wire_stats()
    with _lock:
        _native_seen.clear()
        _ring_wire_seen.clear()
        if current is not None:
            _native_seen["_gen"] = current["engine_gen"]
            for key in _bindings.NATIVE_COUNTER_SCALARS:
                _native_seen[key] = float(current[key])
            _native_seen["cycle_seconds"] = current["cycle_seconds"]
            _native_seen["execute_seconds"] = current["execute_seconds"]
        for link, row in sorted(wire["by_link"].items()):
            for name, val in sorted(row["tx_bytes"].items()):
                _ring_wire_seen[f"tx.{link}.{name}"] = float(val)
        _ring_wire_seen["compress_s"] = wire["compress_seconds"]


def default_registry() -> MetricsRegistry:
    return _registry


def counter(name: str, help: str = "", labelnames=()) -> Counter:
    return _registry.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()) -> Gauge:
    return _registry.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames=(),
              buckets=None) -> Histogram:
    return _registry.histogram(name, help, labelnames, buckets=buckets)


def snapshot() -> Dict[str, dict]:
    """This process's registry as a plain dict (JSON/pickle-clean).
    Mirrors the native ring's wire counters and the native engine's
    counters first, so a snapshot always carries the current
    ``hvd_ring_*`` / ``hvd_native_*`` series."""
    refresh_ring_wire_metrics()
    refresh_native_engine_metrics()
    return _registry.snapshot()


# Last-mirrored native ring wire counters (under _lock): the C side keeps
# cumulative totals, the registry wants monotone increments.
_ring_wire_seen: Dict[str, float] = {}


def refresh_ring_wire_metrics() -> None:
    """Mirror the native ring's wire counters (``bindings.wire_stats()``)
    into the registry: ``hvd_ring_wire_bytes_total{dtype,link}`` (bytes
    the allreduce data phases put on the wire, by wire dtype and link
    class — flat/local/cross, so the two-level plane's hops read
    separately), ``hvd_ring_compress_seconds`` (cumulative compress and
    decompress time) and ``hvd_ring_chunk_bytes`` (the live transfer
    chunk). Never builds the core: a process that has not loaded it
    observes nothing and registers nothing."""
    if not on():
        return
    from ..core import bindings

    if bindings.loaded() is None:
        return
    stats = bindings.wire_stats()
    with _lock:
        wire_c = counter(
            "hvd_ring_wire_bytes_total",
            "Bytes the native ring's allreduce data phases put on the "
            "wire, by wire dtype and link class (flat/local/cross)",
            labelnames=("dtype", "link"))
        comp_c = counter(
            "hvd_ring_compress_seconds",
            "Cumulative time in the ring's wire compress/decompress "
            "kernels")
        for link, row in sorted(stats["by_link"].items()):
            for name, val in sorted(row["tx_bytes"].items()):
                key = f"tx.{link}.{name}"
                prev = _ring_wire_seen.get(key, 0.0)
                if val > prev:
                    wire_c.labels(dtype=name, link=link).inc(val - prev)
                    _ring_wire_seen[key] = float(val)
        comp = stats["compress_seconds"]
        prev = _ring_wire_seen.get("compress_s", 0.0)
        if comp > prev:
            comp_c.inc(comp - prev)
            _ring_wire_seen["compress_s"] = comp
        gauge("hvd_ring_chunk_bytes",
              "Live ring transfer-chunk size (pipelining granularity)"
              ).set(stats["chunk_bytes"])


# Last-mirrored native engine counters (under _lock): cumulative C totals
# -> monotone registry increments, the _ring_wire_seen pattern. Histogram
# keys hold the last {counts, count, sum_seconds} snapshots.
_native_seen: Dict[str, object] = {}

# Lazy hvd_native_* namespace (the package-wide ``_m`` convention:
# reset_for_tests drops it with every other module's metric cache).
_m = None


def _native_metrics():
    global _m
    if _m is None:
        from .registry import DEFAULT_TIME_BUCKETS

        _m = SimpleNamespace(
            cycles=counter(
                "hvd_native_cycles_total",
                "Native engine control-token cycles completed"),
            tensors=counter(
                "hvd_native_tensors_total",
                "Tensors the native engine executed collectives for"),
            fused_tensors=counter(
                "hvd_native_fused_tensors_total",
                "Tensors that rode a multi-tensor fusion buffer"),
            fused_bytes=counter(
                "hvd_native_fused_bytes_total",
                "Bytes the native engine's data phases processed"),
            spans=counter(
                "hvd_native_spans_total",
                "Trace spans the native engine stamped into its ring"),
            spans_dropped=counter(
                "hvd_native_spans_dropped_total",
                "Trace spans overwritten (oldest-first) before a drain "
                "emptied the fixed-capacity span ring"),
            cache_hits=counter(
                "hvd_native_cache_hits_total",
                "Response-cache bypass executions in the native engine"),
            cache_misses=counter(
                "hvd_native_cache_misses_total",
                "Negotiated (uncached) responses the native engine "
                "executed"),
            fusion_capacity=gauge(
                "hvd_native_fusion_buffer_capacity_bytes",
                "Native fusion buffer reserved capacity"),
            fusion_fill=gauge(
                "hvd_native_fusion_buffer_fill_bytes",
                "Native fusion buffer occupancy at the last fused op"),
            bucket=gauge(
                "hvd_native_bucket_bytes",
                "Autotuned gradient-bucket size synced over the native "
                "cycle reply (0 = none pushed yet)"),
            pipeline_depth=gauge(
                "hvd_native_pipeline_depth",
                "High-water count of fused groups simultaneously in "
                "flight through the engine's double-buffered data plane "
                "(1 = no overlap, 2 = pack/wire/copy-out pipelined)"),
            pipeline_stall=counter(
                "hvd_native_pipeline_stall_seconds",
                "Cumulative time the engine thread spent blocked on the "
                "wire thread (slot-acquire and reap stalls)"),
            cycle_seconds=histogram(
                "hvd_native_cycle_seconds",
                "Native engine cycle duration (token round + data "
                "phases)", buckets=DEFAULT_TIME_BUCKETS),
            execute_seconds=histogram(
                "hvd_native_execute_seconds",
                "Native engine per-op data-plane execute time",
                buckets=DEFAULT_TIME_BUCKETS),
        )
    return _m


def refresh_native_engine_metrics() -> None:
    """Mirror the native engine's counters (``hvd_eng_get_counters``,
    ``core/src/engine.cc``) into the registry as ``hvd_native_*``
    series: cycle / tensor / fused-byte / span counters, fusion-buffer
    gauges, the synced tuned-bucket gauge, and the cycle/execute time
    histograms (ingested bucket for bucket: the C side bins on the
    registry's ``DEFAULT_TIME_BUCKETS`` edges). Never builds the core,
    and a process without an engine (the Python controller merely riding
    the ring) registers nothing."""
    if not on():
        return
    from ..core import bindings

    if bindings.loaded() is None:
        return
    c = bindings.native_counters()
    if c is None:
        return
    with _lock:
        if _native_seen.get("_gen") != c["engine_gen"]:
            # A new engine restarted the C counters at zero (one engine
            # an init; the old one's totals are history): drop the
            # baseline so the fresh engine's activity mirrors from zero.
            _native_seen.clear()
            _native_seen["_gen"] = c["engine_gen"]
        m = _native_metrics()

        def _ctr(metric, key):
            val = float(c[key])
            prev = _native_seen.get(key, 0.0)
            if val > prev:
                metric.inc(val - prev)
                _native_seen[key] = val

        _ctr(m.cycles, "cycles")
        _ctr(m.tensors, "tensors")
        _ctr(m.fused_tensors, "fused_tensors")
        _ctr(m.fused_bytes, "processed_bytes")
        _ctr(m.spans, "spans")
        _ctr(m.spans_dropped, "spans_dropped")
        _ctr(m.cache_hits, "cache_hits")
        _ctr(m.cache_misses, "cache_misses")
        m.fusion_capacity.set(c["fusion_capacity"])
        m.fusion_fill.set(c["fusion_fill"])
        m.bucket.set(c["bucket_bytes"])
        m.pipeline_depth.set(c["pipeline_depth"])
        # The C side counts stall time in integer microseconds; mirrored
        # as seconds, the registry's unit. The baseline lives under the
        # raw scalar key, so reset_for_tests re-baselines it too.
        stall_us = float(c["pipeline_stall_us"])
        prev_stall = _native_seen.get("pipeline_stall_us", 0.0)
        if stall_us > prev_stall:
            m.pipeline_stall.inc((stall_us - prev_stall) / 1e6)
            _native_seen["pipeline_stall_us"] = stall_us
        # hvd_overlap_priority_jumps_total is owned by the bucket
        # scheduler (one owner a metric); the native coordinator's jumps
        # ride the same series through the owner's accessor.
        jumps = float(c["priority_jumps"])
        prev_jumps = _native_seen.get("priority_jumps", 0.0)
        if jumps > prev_jumps:
            from ..controller.bucket_scheduler import _overlap_metrics

            _overlap_metrics().priority_jumps.inc(jumps - prev_jumps)
            _native_seen["priority_jumps"] = jumps

        def _hist(hist, key):
            cur = c[key]
            prev = _native_seen.get(key) or {
                "counts": [0] * len(cur["counts"]), "count": 0,
                "sum_seconds": 0.0}
            dcount = cur["count"] - prev["count"]
            if dcount <= 0:
                return
            # Bulk bucket ingest under the metric's own lock: the C side
            # already binned on the registry's bucket edges, and
            # observe() cannot land a count in a chosen bin.
            child = hist._default()
            with hist._lock:
                for i, (a, b) in enumerate(zip(cur["counts"],
                                               prev["counts"])):
                    if a > b:
                        child.counts[i] += a - b
                child.count += dcount
                child.sum += max(0.0,
                                 cur["sum_seconds"] - prev["sum_seconds"])
            _native_seen[key] = cur

        _hist(m.cycle_seconds, "cycle_seconds")
        _hist(m.execute_seconds, "execute_seconds")


def _local_rank() -> Optional[int]:
    return env_rank()


def ingest_remote(rank: int, snap: Dict[str, dict]) -> None:
    """Store a worker's piggybacked snapshot for the rank-0 cluster view.
    Snapshots are cumulative, so a lost push is healed by the next one."""
    with _lock:
        _remote[int(rank)] = snap


def remote_snapshots() -> Dict[int, Dict[str, dict]]:
    with _lock:
        return dict(_remote)


def render_all(query: str = "") -> str:
    """Prometheus exposition of the local registry plus every ingested
    remote snapshot — what the scrape endpoint serves. Goes through
    snapshot() so a scrape always carries the freshly mirrored
    hvd_ring_* / hvd_native_* native counters (under the native engine
    nothing else calls snapshot() periodically).

    ``?window=recent`` on the scrape URL renders the most recent
    completed telemetry window's DELTAS instead of the lifetime totals
   : counters and histogram buckets show only what
    happened inside the window, gauges their current level."""
    if query:
        from urllib.parse import parse_qs

        if parse_qs(query).get("window") == ["recent"]:
            recent = windows()
            if not recent:
                return ("# no completed telemetry window yet "
                        "(HOROVOD_METRICS_WINDOW_SECONDS rolls them; "
                        "lifetime totals at /metrics)\n")
            snaps = dict(recent[-1]["snapshots"])
            rank = _local_rank() or 0
            local = snaps.pop(rank, {})
            return render_prometheus(local, _local_rank(), snaps)
    return render_prometheus(snapshot(), _local_rank(),
                             remote_snapshots())


def set_mark(mark: str) -> Dict[str, dict]:
    """(Re)set a named watermark on the default registry at the current
    totals (native mirrors refreshed first, like :func:`snapshot`)."""
    refresh_ring_wire_metrics()
    refresh_native_engine_metrics()
    return _registry.set_mark(mark)


def snapshot_delta(mark: str) -> Dict[str, dict]:
    """Per-metric deltas since :func:`set_mark`'s watermark — counters
    and histogram buckets subtract, gauges pass through. A mark never
    set reads as a mark at process start (full snapshot)."""
    refresh_ring_wire_metrics()
    refresh_native_engine_metrics()
    return _registry.snapshot_delta(mark)


class WindowRoller:
    """Rank-0 background thread (``hvd-metrics-window``) that rolls the
    cluster's telemetry into fixed-duration delta windows: every
    ``interval_s`` it snapshots the local registry plus every
    piggybacked worker snapshot, subtracts the previous roll's totals
    (:func:`subtract_snapshots`), and appends one window record —
    ``{"index", "start", "end", "duration_seconds", "snapshots":
    {rank: delta}}`` — to a bounded ring of the last ``capacity``
    windows. The doctor's windowed rules and the live-calibration
    re-fit consume the ring via
    :func:`windows`; observers run synchronously after each roll.

    Locking: the ring/baseline lock guards only
    call-free dict/deque swaps; snapshot gathering and delta math run
    outside it, serialized by a dedicated roll lock so a manual
    :meth:`roll_now` never interleaves with the timer thread."""

    def __init__(self, interval_s: float = 30.0, capacity: int = 32):
        import collections

        self.interval_s = max(0.05, float(interval_s))
        self._lock = make_lock("metrics.window")
        self._roll_lock = make_lock("metrics.window.roll")
        self._ring = collections.deque(maxlen=max(1, int(capacity)))
        self._prev: Dict[int, Dict[str, dict]] = {}
        self._prev_time = 0.0
        self._index = 0
        self._observers: list = []
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Prime the baseline at now and launch the timer thread
        (idempotent)."""
        import time

        with self._roll_lock:
            baseline = self._gather()
            with self._lock:
                if not self._prev:
                    self._prev = baseline
                    # Window boundaries are wall stamps (read next to
                    # logs/dashboards). hvdlint: disable=HVD004
                    self._prev_time = time.time()
        if self._thread is None or not self._thread.is_alive():
            self._stop_event.clear()
            self._thread = threading.Thread(
                target=self._loop, name="hvd-metrics-window", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop_event.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)
        self._thread = None

    def add_observer(self, fn) -> None:
        """``fn(window_record)`` after every roll (same thread as the
        roll; exceptions are swallowed to a debug line — telemetry must
        never kill the job it observes). Idempotent by identity, so a
        restarted controller re-registering the live-calibration feed
        never double-ingests a window."""
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)

    def windows(self) -> list:
        """Completed windows, oldest first (up to ``capacity``)."""
        with self._lock:
            return list(self._ring)

    @staticmethod
    def _gather() -> Dict[int, Dict[str, dict]]:
        rank = _local_rank() or 0
        current = {rank: snapshot()}
        for r, snap in remote_snapshots().items():
            if int(r) != rank:
                current[int(r)] = snap
        return current

    def roll_now(self) -> dict:
        """Close the current window synchronously and return its record
        (tests roll deterministically instead of waiting out the
        interval)."""
        import time

        with self._roll_lock:
            current = self._gather()
            now = time.time()  # hvdlint: disable=HVD004 (wall stamp)
            with self._lock:
                prev = self._prev
                prev_time = self._prev_time
                self._prev = current
                self._prev_time = now
                index = self._index
                self._index += 1
            deltas = {r: subtract_snapshots(snap, prev.get(r, {}))
                      for r, snap in sorted(current.items())}
            window = {
                "index": index,
                "start": prev_time,
                "end": now,
                "duration_seconds": max(0.0, now - prev_time),
                "snapshots": deltas,
            }
            with self._lock:
                self._ring.append(window)
                observers = list(self._observers)
        if on():
            counter("hvd_metrics_windows_total",
                    "Telemetry windows the rank-0 roller has completed "
                    "(each one delta-snapshots the whole cluster view)"
                    ).inc()
        for fn in observers:
            try:
                fn(window)
            except Exception as exc:
                from ..common import hvd_logging as logging

                logging.debug("window observer failed: %r", exc)
        return window

    def _loop(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            try:
                self.roll_now()
            except Exception as exc:
                from ..common import hvd_logging as logging

                logging.debug("window roll failed: %r", exc)


_roller: Optional[WindowRoller] = None


def window_roller() -> Optional[WindowRoller]:
    """The process's roller, if one was started (rank 0 only)."""
    with _lock:
        return _roller


def start_window_roller(interval_s: Optional[float] = None,
                        capacity: int = 32) -> WindowRoller:
    """Start (or return) the process-wide window roller. Interval
    defaults to ``HOROVOD_METRICS_WINDOW_SECONDS`` (30s)."""
    global _roller
    from ..common.config import metrics_window_seconds

    if interval_s is None:
        interval_s = metrics_window_seconds()
    with _lock:
        roller = _roller
        if roller is None:
            roller = WindowRoller(interval_s, capacity=capacity)
            _roller = roller
    roller.start()
    return roller


def stop_window_roller() -> None:
    global _roller
    with _lock:
        roller = _roller
        _roller = None
    if roller is not None:
        roller.stop()


def windows() -> list:
    """Completed telemetry windows (oldest first); empty when no roller
    ran — callers fall back to lifetime snapshots."""
    roller = window_roller()
    return roller.windows() if roller is not None else []


def push_cycles() -> int:
    """Worker piggyback period, in controller cycles."""
    return max(1, _env_int("HOROVOD_METRICS_PUSH_CYCLES", 50))


def _doctor_route():
    """Lazy: the doctor package imports metrics, so the import must live
    inside the request path, not at module scope."""
    from .. import doctor

    return doctor.http_body()


def maybe_start_exporter(rank: int) -> Optional[MetricsExporter]:
    """Start this rank's endpoint at HOROVOD_METRICS_PORT + rank (None
    when unset/garbage — snapshot() keeps working without it). Every
    rank's endpoint also serves ``GET /doctor`` (the cluster doctor's
    JSON report) — most useful on rank 0, where the piggybacked worker
    snapshots give the doctor the whole job."""
    base = _env_int("HOROVOD_METRICS_PORT", 0)
    if base <= 0:
        return None
    # On a bind collision, walk in steps of the job size so this rank's
    # fallback never lands on (and displaces) a sibling rank's slot.
    return start_exporter(base + rank, render_all,
                          routes={"/doctor": _doctor_route},
                          stride=max(1, env_size() or 1))


# ---------------------------------------------------------------------------
# Flight recorder facade


def _get_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record_event(kind: str, **fields) -> None:
    """Append one structured event to the ring. No-op when telemetry is
    off — callers may skip their own ``on()`` check for rare events."""
    if not on():
        return
    _get_recorder().record(kind, **fields)


def record_sampled_event(kind: str, **fields) -> None:
    """Sampled variant for high-rate sites (1st + every Nth occurrence,
    N = HOROVOD_FLIGHT_RECORDER_SAMPLE)."""
    if not on():
        return
    _get_recorder().record_sampled(kind, **fields)


def flight_recorder_path() -> Optional[str]:
    return _flight_recorder_path()


def dump_flight_recorder(reason: str,
                         path: Optional[str] = None) -> Optional[str]:
    """Dump the ring as JSONL; returns the written path or None when no
    path is configured. Called from ``Controller._fail_all``, abort
    handling, and unclean shutdown — and safe to call repeatedly (each
    dump rewrites the file with the full current ring)."""
    path = path or flight_recorder_path()
    if not path or not on():
        return None
    return _get_recorder().dump(path, reason)


# ---------------------------------------------------------------------------
# Derived views


def _counter_total(snap: Dict[str, dict], name: str) -> Optional[float]:
    entry = snap.get(name)
    if not entry:
        return None
    return sum(v for _, v in entry.get("values", []))


def controller_health(snap: Optional[Dict[str, dict]] = None) -> dict:
    """Compact controller-health summary (dashboards, examples):
    cycle-time p50/p99, fused bytes, response-cache hit rate. On a fresh
    registry — before the first controller cycle, or with any series
    missing (e.g. SPMD-only runs with no eager controller) — every key
    is still present with a 0 value: a well-formed all-zeros dict that
    downstream consumers can index and chart without None-guards."""
    snap = snap if snap is not None else snapshot()
    # Engine-agnostic: the python controller's series plus the native
    # engine's hvd_native_* mirror — only one engine runs per process, so
    # summing is exact, and a native job's health rows stop reading zero.
    hits = ((_counter_total(snap, "hvd_controller_cache_hits_total") or 0.0)
            + (_counter_total(snap, "hvd_native_cache_hits_total") or 0.0))
    misses = ((_counter_total(snap, "hvd_controller_cache_misses_total")
               or 0.0)
              + (_counter_total(snap, "hvd_native_cache_misses_total")
                 or 0.0))
    total = hits + misses
    hit_rate = round(hits / total, 4) if total else 0.0
    cycle = snap.get("hvd_controller_cycle_seconds")
    if quantile(cycle, 0.5) is None:
        cycle = snap.get("hvd_native_cycle_seconds")
    p50 = quantile(cycle, 0.5) or 0.0
    p99 = quantile(cycle, 0.99) or 0.0
    # Wire-compression savings straight from the native ring's counters
    # (zeros when the core isn't loaded or the ring never moved bytes):
    # logical = the f32-equivalent bytes the compressed dtypes carried,
    # savings = the fraction of those bytes compression kept off the wire.
    try:
        from ..core import bindings

        wire = bindings.wire_stats()
    except ImportError:  # stripped install; health must stay well-formed
        wire = {"tx_bytes": {}, "logical_bytes": {}, "by_link": {},
                "compress_seconds": 0.0, "chunk_bytes": 0}
    tx = wire["tx_bytes"]
    logical = wire["logical_bytes"]

    def _savings(tx_row, logical_row):
        # Fraction of the compressed dtypes' f32-equivalent bytes that
        # compression kept off this link's wire.
        comp_logical = sum(v for k, v in logical_row.items() if k != "none")
        comp_tx = sum(v for k, v in tx_row.items() if k != "none")
        return (round(1.0 - comp_tx / comp_logical, 4)
                if comp_logical else 0.0)

    # Per-link savings (flat/local/cross): the two-level plane's proof
    # that the slow cross hop is the compressed one. Always well-formed —
    # every link key present, zeros before any traffic.
    by_link = {link: _savings(row.get("tx_bytes", {}),
                              row.get("logical_bytes", {}))
               for link, row in wire.get("by_link", {}).items()}
    for link in ("flat", "local", "cross"):
        by_link.setdefault(link, 0.0)
    return {
        "cycle_seconds_p50": round(p50, 6),
        "cycle_seconds_p99": round(p99, 6),
        "fused_bytes_total": (_counter_total(
            snap, "hvd_controller_fused_bytes_total") or 0)
        + (_counter_total(snap, "hvd_native_fused_bytes_total") or 0),
        "cache_hit_rate": hit_rate,
        "wire_bytes_total": sum(tx.values()),
        "wire_savings_frac": _savings(tx, logical),
        "wire_savings_by_link": by_link,
        "wire_compress_seconds": round(wire["compress_seconds"], 6),
    }
