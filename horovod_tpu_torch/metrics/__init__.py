"""The port's metrics plane: the surface of ``horovod_tpu/metrics`` that
the serving tier uses, over the port's own registry copy
(``metrics/registry.py``).

A process-wide default :class:`~.registry.MetricsRegistry` that
instrumentation registers into lazily, never at import time
(``counter()``/``gauge()``/``histogram()`` below); ``snapshot()`` as a
plain dict and ``render_all()`` as Prometheus text.

**Zero overhead by default**: every instrumentation site reduces to
``if metrics.on():``, a cached module-global boolean resolved once from
``HOROVOD_METRICS`` / ``HOROVOD_METRICS_PORT`` (re-read after a fork);
``enable()`` turns it on programmatically (tests, the load generator).

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

Not ported yet (later slices): the per-rank HTTP exporter, the flight
recorder (so ``HOROVOD_FLIGHT_RECORDER`` does not turn metrics on here)
and the windowed roller.
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace
from typing import Dict, Optional

from ..analysis.lockorder import make_lock
from ..common.config import env_rank, metrics_enabled
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
    "refresh_native_engine_metrics",
]

# Tri-state enabled cache; a forked child re-resolves its own.
_on: Optional[bool] = None
# Tracked under HOROVOD_LOCKCHECK: guards the enabled cache and the
# native mirror's seen-marks, reached from the controller, heartbeat and
# telemetry threads.
_lock = make_lock("metrics.state")
_registry = MetricsRegistry()


def _invalidate_in_child() -> None:
    global _on
    _on = None


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
    """Forget the enabled cache and every registered metric, and drop the
    instrumented modules' cached metric namespaces (a module-global
    ``_m`` SimpleNamespace, the package convention), which would
    otherwise point at orphaned metrics after the registry clear."""
    global _on
    with _lock:
        _on = None
    _registry.clear()
    for name, mod in list(sys.modules.items()):
        if not name.startswith("horovod_tpu_torch") or mod is None:
            continue
        if isinstance(getattr(mod, "_m", None), SimpleNamespace):
            mod._m = None
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


def render_all() -> str:
    """Prometheus exposition of the registry, the series labelled with
    ``HOROVOD_RANK`` when it is set."""
    return render_prometheus(snapshot(), env_rank())
