"""Straggler attribution: who arrived last at negotiation, and by how much.

Input is a merged, clock-corrected event list (``trace/merge.py``). For
every collective sequence id, each rank's ``negotiate`` span begins when
that rank's request left for the coordinator (stamped after the send
completed, so an injected or real network stall shows up here); with all
ranks on one timebase:

    arrival(seq, rank) = start of rank's negotiate span for seq
    slack(seq)         = max_rank(arrival) - min_rank(arrival)
    straggler(seq)     = argmax_rank(arrival)
    lateness(seq, r)   = arrival(seq, r) - min_rank(arrival)

The report aggregates per rank (straggler cycles, lateness p50/p99/max)
and overall (slack distribution, worst offending collectives by name),
and — when telemetry is on — feeds two series into the metrics
registry so dashboards see stragglers without parsing traces:

* ``hvd_negotiation_slack_seconds`` — histogram of per-collective slack;
* ``hvd_straggler_cycles_total{rank=…}`` — collectives a rank arrived
  last at (with positive slack).

Produced automatically as ``straggler_report.json`` when a traced job
shuts down cleanly. The port's copy of ``horovod_tpu/trace/straggler.py``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

from .. import metrics
from .tracer import REPORT_FILE

# Slack below this is clock-sync noise, not a straggler: typical offset
# uncertainty on a healthy local network is tens of microseconds.
DEFAULT_SLACK_EPSILON_SECONDS = 1e-4

_m = None


def _straggler_metrics():
    """Lazy registration (never at import time)."""
    global _m
    if _m is None:
        from types import SimpleNamespace

        _m = SimpleNamespace(
            slack=metrics.histogram(
                "hvd_negotiation_slack_seconds",
                "Per-collective negotiation slack: last rank's arrival "
                "minus first rank's, clock-corrected."),
            cycles=metrics.counter(
                "hvd_straggler_cycles_total",
                "Collectives this rank arrived last at negotiation for "
                "(slack above the epsilon).", ("rank",)))
    return _m


def _pctl(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1,
                     int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[idx]


def attribute(events: List[dict],
              epsilon: float = DEFAULT_SLACK_EPSILON_SECONDS,
              feed: bool = True) -> dict:
    """Build the straggler report from merged (already clock-corrected)
    events. ``feed=True`` additionally populates the metrics registry
    (no-op with telemetry off)."""
    arrivals: Dict[int, Dict[int, float]] = {}  # seq -> {rank: seconds}
    ops: Dict[int, str] = {}
    clock: Dict[str, dict] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "clock_sync":
            args = ev.get("args", {})
            clock[str(args.get("rank", ev.get("pid")))] = {
                "applied_offset_seconds": args.get(
                    "applied_offset_seconds"),
                "uncertainty_seconds": args.get("uncertainty_seconds"),
                "synced": args.get("synced"),
            }
            continue
        if ev.get("name") != "negotiate" or ev.get("ph") != "X":
            continue
        args = ev.get("args", {})
        seq = args.get("seq")
        if seq is None:
            continue
        arrivals.setdefault(int(seq), {})[int(ev["pid"])] = \
            ev["ts"] / 1e6
        if "op" in args:
            ops[int(seq)] = args["op"]

    ranks = sorted({r for per in arrivals.values() for r in per})
    slacks: List[float] = []
    lateness: Dict[int, List[float]] = {r: [] for r in ranks}
    straggler_cycles: Dict[int, int] = {r: 0 for r in ranks}
    worst: List[dict] = []
    for seq in sorted(arrivals):
        per = arrivals[seq]
        if len(per) < 2:
            continue  # a collective not seen by >=2 ranks attributes nothing
        first = min(per.values())
        last_rank = max(per, key=lambda r: (per[r], r))
        slack = per[last_rank] - first
        slacks.append(slack)
        for r, t in per.items():
            lateness[r].append(t - first)
        if slack > epsilon:
            straggler_cycles[last_rank] += 1
            worst.append({"seq": seq, "op": ops.get(seq),
                          "slack_seconds": round(slack, 6),
                          "straggler": last_rank})

    worst.sort(key=lambda w: -w["slack_seconds"])
    slacks_sorted = sorted(slacks)
    per_rank = {}
    for r in ranks:
        vals = sorted(lateness[r])
        per_rank[str(r)] = {
            "straggler_cycles": straggler_cycles[r],
            "lateness_p50_seconds": _round(_pctl(vals, 0.5)),
            "lateness_p99_seconds": _round(_pctl(vals, 0.99)),
            "lateness_max_seconds": _round(vals[-1] if vals else None),
        }
    worst_rank = None
    if ranks and slacks:
        # Worst = most straggler cycles, ties broken by max lateness:
        # "who should you go look at" in one field.
        worst_rank = max(
            ranks, key=lambda r: (straggler_cycles[r],
                                  lateness[r] and max(lateness[r]) or 0.0))
    report = {
        "collectives": len(slacks),
        "ranks": ranks,
        "slack_epsilon_seconds": epsilon,
        "slack_p50_seconds": _round(_pctl(slacks_sorted, 0.5)),
        "slack_p99_seconds": _round(_pctl(slacks_sorted, 0.99)),
        "slack_max_seconds": _round(slacks_sorted[-1]
                                    if slacks_sorted else None),
        "per_rank": per_rank,
        "worst_rank": worst_rank,
        "worst_collectives": worst[:10],
        "clock": clock,
    }
    if feed and metrics.on() and slacks:
        m = _straggler_metrics()
        for s in slacks:
            m.slack.observe(s)
        for r, c in straggler_cycles.items():
            if c:
                m.cycles.labels(str(r)).inc(c)
    return report


def _round(v: Optional[float]) -> Optional[float]:
    return round(v, 6) if v is not None else None


def write_report(trace_dir: str, events: Optional[List[dict]] = None,
                 out_path: Optional[str] = None, feed: bool = True) -> str:
    """Attribute and write ``straggler_report.json`` next to the merged
    trace. With ``events`` omitted, reads ``merged_trace.json`` from
    ``trace_dir``."""
    if events is None:
        from .tracer import MERGED_TRACE_FILE

        with open(os.path.join(trace_dir, MERGED_TRACE_FILE)) as f:
            events = json.load(f)
    report = attribute(events, feed=feed)
    path = out_path or os.path.join(trace_dir, REPORT_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def summary(snap: Optional[Dict[str, dict]] = None) -> dict:
    """Compact straggler summary off the metrics registry (bench.py
    rows): negotiation-slack p99 and the rank with the most straggler
    cycles. Fields are None when no traced attribution ran."""
    snap = snap if snap is not None else metrics.snapshot()
    p99 = metrics.quantile(snap.get("hvd_negotiation_slack_seconds"), 0.99)
    worst_rank = None
    cycles = snap.get("hvd_straggler_cycles_total")
    if cycles and cycles.get("values"):
        (labels, count) = max(cycles["values"], key=lambda kv: kv[1])
        if count > 0:
            worst_rank = int(labels[0])
    return {
        "slack_p99_seconds": round(p99, 6) if p99 is not None else None,
        "worst_rank": worst_rank,
    }
