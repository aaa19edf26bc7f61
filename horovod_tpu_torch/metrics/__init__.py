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

Not ported yet (later slices): the per-rank HTTP exporter, the flight
recorder (so ``HOROVOD_FLIGHT_RECORDER`` does not turn metrics on here),
the windowed roller, and the native-engine and ring-wire mirrors, which
have no counterpart in the port until its controller and wire exist.
"""

from __future__ import annotations

import os
import sys
import threading
from types import SimpleNamespace
from typing import Dict, Optional

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
    "reset_for_tests", "subtract_snapshots",
]

# Tri-state enabled cache; a forked child re-resolves its own.
_on: Optional[bool] = None
_lock = threading.Lock()
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
    """This process's registry as a plain dict (JSON/pickle-clean)."""
    return _registry.snapshot()


def render_all() -> str:
    """Prometheus exposition of the registry, the series labelled with
    ``HOROVOD_RANK`` when it is set."""
    return render_prometheus(snapshot(), env_rank())
