"""Thread-safe metrics primitives and Prometheus rendering: the port's
own copy of ``horovod_tpu/metrics/registry.py`` (same classes, same
snapshot dicts, byte-identical exposition text), whose locks come from
``make_lock`` (``metrics.metric``, ``metrics.registry``) and are tracked
under ``HOROVOD_LOCKCHECK``.

``Counter``/``Gauge``/``Histogram`` with label support; a registry with
get-or-create semantics (each metric registered lazily at its one call
site, never at import time); a plain-dict ``snapshot()`` that travels
through pickle and JSON; ``subtract_snapshots`` for deltas between two
snapshots; the
Prometheus text exposition format (version 0.0.4); and ``quantile`` over
a histogram snapshot.

Design constraints, in order:

* **Exactness** — N writer threads must produce exact final counts, so
  every mutation takes the metric's lock.
* **Hot-path cost** — ``labels(...)`` returns a cached child whose
  ``inc``/``observe`` is a lock + float add.
* **Determinism** — rendering sorts metric names and label sets, so the
  exposition is byte-stable.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis.lockorder import make_lock



def log_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` log-spaced bucket upper bounds: start, start*factor, ..."""
    return tuple(start * (factor ** i) for i in range(count))


# Spans 100us .. ~210s in x2 steps: covers controller cycles (ms) through
# recv waits bounded by HOROVOD_COMM_TIMEOUT_SECONDS (120s default).
DEFAULT_TIME_BUCKETS = log_buckets(1e-4, 2.0, 22)


class _Child:
    """One labeled series. All mutation under the parent metric's lock."""

    __slots__ = ("_metric", "_value")

    def __init__(self, metric: "_Metric"):
        self._metric = metric
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._metric._lock:
            return self._value

    def inc(self, amount: float = 1.0) -> None:
        with self._metric._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._metric._lock:
            self._value = value


class _HistChild:
    __slots__ = ("_metric", "counts", "sum", "count")

    def __init__(self, metric: "Histogram"):
        self._metric = metric
        # one slot per bucket bound, plus the +Inf overflow slot
        self.counts = [0] * (len(metric.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        m = self._metric
        idx = bisect_left(m.buckets, value)
        with m._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1


class _Metric:
    kind = "untyped"
    _child_cls = _Child

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = make_lock("metrics.metric")
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            # Unlabeled metric: one implicit child so inc()/observe() on
            # the metric itself works without a labels() call.
            self._children[()] = self._child_cls(self)

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by name")
            unknown = set(kw) - set(self.labelnames)
            if unknown:
                # A typo'd kwarg must not silently produce a wrong series.
                raise ValueError(
                    f"{self.name}: unknown label(s) {sorted(unknown)} "
                    f"(labels: {self.labelnames})")
            try:
                values = tuple(kw[n] for n in self.labelnames)
            except KeyError as exc:
                raise ValueError(
                    f"{self.name}: unknown label {exc} "
                    f"(labels: {self.labelnames})") from exc
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label "
                f"value(s) {self.labelnames}, got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._child_cls(self)
                self._children[values] = child
            return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()")
        return self._children[()]

    def _snapshot_values(self) -> List[list]:
        with self._lock:
            return [[list(k), self._child_value(c)]
                    for k, c in sorted(self._children.items())]

    @staticmethod
    def _child_value(child):
        return child._value

    def snapshot(self) -> dict:
        return {"type": self.kind, "help": self.help,
                "labels": list(self.labelnames),
                "values": self._snapshot_values()}


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().inc(-amount)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Metric):
    kind = "histogram"
    _child_cls = _HistChild

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.buckets = tuple(sorted(buckets if buckets is not None
                                    else DEFAULT_TIME_BUCKETS))
        super().__init__(name, help, labelnames)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    @staticmethod
    def _child_value(child):
        return {"counts": list(child.counts), "sum": child.sum,
                "count": child.count}

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["buckets"] = list(self.buckets)
        return snap


def subtract_snapshots(current: Dict[str, dict],
                       baseline: Dict[str, dict]) -> Dict[str, dict]:
    """Pure delta algebra over two :meth:`MetricsRegistry.snapshot`
    dicts: counters subtract per label set (a label set absent from the
    baseline subtracts an implicit zero — it was born inside the
    window), histogram ``counts``/``sum``/``count`` subtract
    element-wise, and gauges pass the CURRENT value through (a gauge is
    a level, not a flow — "delta of membership size" is not a thing an
    operator wants). Metrics absent from the baseline appear whole.
    Inputs are never mutated; the result is a fresh snapshot-shaped
    dict, so windowed and lifetime views travel the same pipelines
    (quantile(), render_prometheus(), the doctor rules)."""
    out: Dict[str, dict] = {}
    for name, entry in current.items():
        kind = entry.get("type")
        base = baseline.get(name)
        if (kind == "gauge" or base is None or base.get("type") != kind):
            out[name] = {**entry,
                         "values": [[list(k), _copy_value(v)]
                                    for k, v in entry.get("values", [])]}
            continue
        base_by_labels = {tuple(k): v for k, v in base.get("values", [])}
        values = []
        for labelvalues, value in entry.get("values", []):
            prev = base_by_labels.get(tuple(labelvalues))
            if kind == "histogram":
                prev = prev or {"counts": [], "sum": 0.0, "count": 0}
                prev_counts = list(prev.get("counts", []))
                cur_counts = value["counts"]
                prev_counts += [0] * (len(cur_counts) - len(prev_counts))
                delta = {
                    "counts": [c - p for c, p
                               in zip(cur_counts, prev_counts)],
                    "sum": value["sum"] - prev.get("sum", 0.0),
                    "count": value["count"] - prev.get("count", 0),
                }
            else:
                delta = value - (prev or 0.0)
            values.append([list(labelvalues), delta])
        out[name] = {**entry, "values": values}
    return out


def _copy_value(value):
    if isinstance(value, dict):  # histogram child value
        return {"counts": list(value.get("counts", [])),
                "sum": value.get("sum", 0.0),
                "count": value.get("count", 0)}
    return value


class MetricsRegistry:
    """Name -> metric, with get-or-create registration. A name re-registered
    with a different kind or label set is a programming error and raises —
    each metric has exactly one owning call site (the lint test walks the
    package asserting this statically too)."""

    def __init__(self):
        self._lock = make_lock("metrics.registry")
        self._metrics: Dict[str, _Metric] = {}
        # Named watermarks for windowed delta snapshots: mark name ->
        # the full snapshot taken when the mark was (re)set. Marks are
        # independent — two callers rolling their own marks never see
        # each other's baselines.
        self._marks: Dict[str, Dict[str, dict]] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames}, conflicting "
                        f"re-registration as {cls.kind}{tuple(labelnames)}")
                buckets = kw.get("buckets")
                if (buckets is not None
                        and tuple(sorted(buckets)) != existing.buckets):
                    # Silently reusing the first bucket layout would park
                    # the second site's observations in the wrong bins —
                    # wrong dashboards with no error.
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {existing.buckets}, conflicting "
                        f"re-registration with {tuple(sorted(buckets))}")
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """``buckets=None`` means "no opinion": a fresh registration gets
        DEFAULT_TIME_BUCKETS, a re-fetch accepts whatever the owning call
        site registered. EXPLICIT buckets that differ from the registered
        layout raise — the observations would silently land in the wrong
        bins otherwise."""
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def clear(self) -> None:
        """Drop every registered metric and every watermark (tests
        only): a stale mark over a fresh registry would subtract a dead
        process's totals."""
        with self._lock:
            self._metrics.clear()
            self._marks.clear()

    def snapshot(self) -> Dict[str, dict]:
        """Plain-dict view of every series; JSON/pickle-clean."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}

    def set_mark(self, mark: str) -> Dict[str, dict]:
        """(Re)set a named watermark at the current totals and return
        the snapshot it captured. The next :meth:`snapshot_delta` with
        this mark reports only what happened after this moment."""
        snap = self.snapshot()
        with self._lock:
            self._marks[mark] = snap
        return snap

    def drop_mark(self, mark: str) -> None:
        with self._lock:
            self._marks.pop(mark, None)

    def snapshot_delta(self, mark: str) -> Dict[str, dict]:
        """Per-metric deltas since the named watermark
        (:func:`subtract_snapshots`: counters/histograms subtract,
        gauges pass through). A mark never set behaves as a mark set at
        process start — the delta since an all-zero baseline is the
        full snapshot."""
        current = self.snapshot()
        with self._lock:
            baseline = self._marks.get(mark)
        if baseline is None:
            return subtract_snapshots(current, {})
        return subtract_snapshots(current, baseline)


# ---------------------------------------------------------------------------
# Prometheus text exposition (format version 0.0.4)


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(text: str) -> str:
    return (text.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(value: float) -> str:
    if isinstance(value, bool):
        return str(int(value))
    try:
        if float(value).is_integer():
            return str(int(value))
    except (OverflowError, ValueError):
        pass
    return repr(float(value))


def _labels_str(pairs: Sequence[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in pairs)
    return "{" + inner + "}"


def _render_series(lines: List[str], name: str, entry: dict,
                   rank: Optional[int]) -> None:
    labelnames = entry.get("labels", [])
    for labelvalues, value in entry.get("values", []):
        pairs = list(zip(labelnames, labelvalues))
        if rank is not None:
            pairs.append(("rank", str(rank)))
        if entry["type"] == "histogram":
            buckets = entry.get("buckets", [])
            cumulative = 0
            for bound, count in zip(list(buckets) + ["+Inf"],
                                    value["counts"]):
                cumulative += count
                le = "+Inf" if bound == "+Inf" else _fmt(bound)
                lines.append(f"{name}_bucket"
                             + _labels_str(pairs + [("le", le)])
                             + f" {cumulative}")
            lines.append(f"{name}_sum{_labels_str(pairs)} "
                         f"{_fmt(value['sum'])}")
            lines.append(f"{name}_count{_labels_str(pairs)} "
                         f"{value['count']}")
        else:
            lines.append(f"{name}{_labels_str(pairs)} {_fmt(value)}")


def render_prometheus(local: Dict[str, dict],
                      local_rank: Optional[int] = None,
                      remote: Optional[Dict[int, Dict[str, dict]]] = None
                      ) -> str:
    """Render snapshots as Prometheus text. ``remote`` maps rank ->
    snapshot (the piggybacked worker registries); every series gets a
    ``rank`` label so one scrape of rank 0 shows the whole job."""
    remote = remote or {}
    names: List[str] = sorted(
        set(local) | {n for snap in remote.values() for n in snap})
    lines: List[str] = []
    for name in names:
        entry = local.get(name)
        if entry is None:
            entry = next(snap[name] for snap in
                         (remote[r] for r in sorted(remote))
                         if name in snap)
        if entry.get("help"):
            lines.append(f"# HELP {name} {_escape_help(entry['help'])}")
        lines.append(f"# TYPE {name} {entry['type']}")
        if name in local:
            _render_series(lines, name, local[name], local_rank)
        for r in sorted(remote):
            if name in remote[r]:
                _render_series(lines, name, remote[r][name], r)
    return "\n".join(lines) + ("\n" if lines else "")


def quantile(entry: Optional[dict], q: float) -> Optional[float]:
    """Estimate a quantile from one histogram snapshot entry (linear
    interpolation inside the winning bucket, the PromQL
    ``histogram_quantile`` convention). None when empty/absent."""
    if not entry or entry.get("type") != "histogram":
        return None
    buckets = entry.get("buckets", [])
    total_counts = [0] * (len(buckets) + 1)
    for _, value in entry.get("values", []):
        for i, c in enumerate(value["counts"]):
            total_counts[i] += c
    total = sum(total_counts)
    if total == 0:
        return None
    target = q * total
    cumulative = 0
    for i, count in enumerate(total_counts):
        if cumulative + count >= target and count > 0:
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i] if i < len(buckets) else buckets[-1]
            frac = (target - cumulative) / count
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        cumulative += count
    return buckets[-1] if buckets else None
