"""The cluster doctor's rule catalog (the JAX package's, rule for rule;
thresholds, slugs and evidence fields are the same).

Each rule is a pure function ``Evidence -> Iterator[Diagnosis]`` — no
clocks, no env, no I/O — so every rule is unit-testable from synthetic
evidence and behaves identically live (the ``/doctor`` endpoint, the
coordinator's periodic sweep) and offline (``tools.doctor`` over an
artifact directory). A rule that cannot see its minimum evidence yields
nothing: absence of data is not health, and the report records which
sources were present.

Thresholds are module constants, deliberately conservative: a doctor
that cries wolf gets ignored, and every ``Diagnosis`` carries the raw
evidence series so the operator can re-judge the verdict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

from ..metrics import quantile
from .evidence import Evidence

SEVERITIES = ("critical", "warning", "info")

# -- persistent straggler ----------------------------------------------------
# A rank must be late this often / this much before it is named.
STRAGGLER_MIN_COLLECTIVES = 10     # report: attributed collectives needed
STRAGGLER_CYCLE_SHARE = 0.3        # report: fraction a rank arrived last
STRAGGLER_MIN_LATENESS = 0.010     # seconds, p99 floor (live + report)
STRAGGLER_CRITICAL_LATENESS = 0.100
STRAGGLER_MIN_SAMPLES = 20         # live: tick-lateness observations needed
STRAGGLER_SKEW_FACTOR = 3.0        # live: p99 vs other ranks' median p99
# -- clock sync --------------------------------------------------------------
CLOCK_MAX_UNCERTAINTY = 0.005      # seconds
# -- recv-wait skew ----------------------------------------------------------
RECV_WAIT_MIN_P99 = 0.020          # seconds
RECV_WAIT_SKEW_FACTOR = 3.0
# -- heartbeat flapping ------------------------------------------------------
FLAPPING_MIN_TRIPS = 2
FLAPPING_CRITICAL_TRIPS = 10
# -- cache collapse ----------------------------------------------------------
CACHE_MIN_TRAFFIC = 200            # hits + misses before judging
CACHE_COLLAPSE_RATE = 0.2
# -- restart churn -----------------------------------------------------------
RESTART_CHURN_MIN = 2
RESTART_CHURN_CRITICAL = 5

MEMBERSHIP_CHURN_MIN = 3           # elastic transitions before warning
MEMBERSHIP_CHURN_CRITICAL = 10
# -- autotune search ---------------------------------------------------------
AUTOTUNE_STALLED_MIN_CYCLES = 500  # controller cycles before "stalled"
AUTOTUNE_WANDER_MIN_STEPS = 10     # steps before "wandering" is judged
AUTOTUNE_WANDER_RATIO = 0.5        # last score vs best score
# -- serving tier ------------------------------------------------------------
SERVING_QUEUE_SATURATION_SHARE = 0.9   # waiting depth vs admission bound
SERVING_CRITICAL_REJECTS = 10          # shed requests before "critical"
SERVING_MIN_PREEMPTIONS = 3            # pool-dry recomputes before warning
SERVING_CRITICAL_PREEMPTIONS = 20
# -- serving fleet -----------------------------------------------------------
ROUTER_FLAPPING_MIN = 2                # replica departures before warning
ROUTER_FLAPPING_CRITICAL = 5
PREFIX_CACHE_MIN_TRAFFIC = 200         # whole pages judged before verdict
PREFIX_CACHE_COLLAPSE_RATE = 0.2
# -- capacity headroom -------------------------------------------------------
CAPACITY_HEADROOM_FACTOR = 2.0     # measured p99 vs the modeled curve
CAPACITY_MIN_CYCLES = 20           # cycle observations before judging
CAPACITY_MIN_RESHAPES = 3          # reshape observations before judging
# Below this modeled cost the controller's cycle pacer, not the control
# plane, sets the floor — small worlds would otherwise trip on pacing.
CAPACITY_MODELED_FLOOR = 0.005     # seconds
# How many of the newest completed telemetry windows the windowed rules
# (capacity_headroom, recv_wait_skew) judge when windows exist: two, so
# one window boundary never hides a fault that straddles it, and a
# transient heals within two rolls.
RECENT_WINDOWS = 2
# -- calibration drift -------------------------------------------------------
# A plane needs this many windows carrying data inside the live horizon
# before its slope is trusted; per-plane observation floors reuse the
# headroom rule's minimums.
DRIFT_MIN_WINDOWS = 2


@dataclasses.dataclass
class Diagnosis:
    """One structured verdict: what is wrong, where, how bad, what to do.
    ``evidence`` holds the raw numbers the verdict was derived from so an
    operator can re-judge it without re-running the rules."""

    rule: str
    severity: str          # "critical" | "warning" | "info"
    summary: str
    hint: str
    rank: Optional[int] = None
    evidence: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "rank": self.rank, "summary": self.summary,
                "hint": self.hint, "evidence": self.evidence}

    def one_line(self) -> str:
        where = f"rank {self.rank} " if self.rank is not None else ""
        return f"[{self.severity}] {where}{self.rule}: {self.summary}"


def _series_totals(snapshots: Dict[int, dict], name: str
                   ) -> Dict[int, float]:
    """rank -> summed counter value for ``name`` across its label sets."""
    out: Dict[int, float] = {}
    for rank in sorted(snapshots):
        entry = snapshots[rank].get(name)
        if entry and entry.get("type") != "histogram":
            out[rank] = sum(v for _, v in entry.get("values", []))
    return out


def _counter_by_first_label(snap: dict, name: str) -> Dict[str, float]:
    entry = snap.get(name)
    if not entry:
        return {}
    return {labels[0]: value for labels, value in entry.get("values", [])
            if labels}


def _gauge(snapshots: Dict[int, dict], name: str) -> Optional[float]:
    """First rank's unlabeled gauge value, or None when absent anywhere."""
    for rank in sorted(snapshots):
        entry = snapshots[rank].get(name)
        if entry and entry.get("values"):
            return float(entry["values"][0][1])
    return None


def _per_label_quantiles(entry: Optional[dict], q: float
                         ) -> Dict[str, Tuple[float, int]]:
    """label-value -> (quantile, sample count) for a single-label
    histogram entry (e.g. hvd_controller_tick_lateness_seconds{rank})."""
    if not entry or entry.get("type") != "histogram":
        return {}
    out: Dict[str, Tuple[float, int]] = {}
    for labels, value in entry.get("values", []):
        if not labels:
            continue
        single = {"type": "histogram", "buckets": entry.get("buckets", []),
                  "values": [[[], value]]}
        est = quantile(single, q)
        if est is not None:
            out[labels[0]] = (est, int(value.get("count", 0)))
    return out


def _hist_quantile_and_count(snap: dict, name: str, q: float
                             ) -> Tuple[Optional[float], int]:
    entry = snap.get(name)
    est = quantile(entry, q)
    count = 0
    if entry and entry.get("type") == "histogram":
        count = sum(int(v.get("count", 0))
                    for _, v in entry.get("values", []))
    return est, count


def _ms(seconds: float) -> str:
    return f"{seconds * 1e3:.0f}ms"


def _sum_snaps(older: dict, newer: dict) -> dict:
    """Merge two delta snapshots of ONE rank: counters and histogram
    buckets add, gauges keep the newer level. Pure dict math — inputs
    are never mutated (they alias the window ring's records)."""
    out = dict(older)
    for name, entry in newer.items():
        prev = out.get(name)
        if (prev is None or entry.get("type") == "gauge"
                or prev.get("type") != entry.get("type")):
            out[name] = entry
            continue
        by_labels = {tuple(k): v for k, v in prev.get("values", [])}
        values = []
        seen = set()
        for labelvalues, value in entry.get("values", []):
            key = tuple(labelvalues)
            seen.add(key)
            prev_value = by_labels.get(key)
            if prev_value is None:
                values.append([list(labelvalues), value])
            elif entry.get("type") == "histogram":
                values.append([list(labelvalues), {
                    "counts": [a + b for a, b in
                               zip(value["counts"], prev_value["counts"])],
                    "sum": value["sum"] + prev_value["sum"],
                    "count": value["count"] + prev_value["count"]}])
            else:
                values.append([list(labelvalues), value + prev_value])
        for labelvalues, value in prev.get("values", []):
            if tuple(labelvalues) not in seen:
                values.append([list(labelvalues), value])
        out[name] = {**entry, "values": values}
    return out


def _recent_snapshots(ev: Evidence) -> Dict[int, dict]:
    """The windowed rules' input: per-rank telemetry merged over the
    last RECENT_WINDOWS completed windows when any exist, else the
    lifetime snapshots (jobs without a window roller keep the exact
    pre-window behavior). Judging the recent window is the point of the
    windowed plane: a slow warm-up heals once healthy windows roll past
    it, and fresh degradation is not diluted into hours of healthy
    history."""
    if not ev.windows:
        return ev.snapshots
    merged: Dict[int, dict] = {}
    for window in ev.windows[-RECENT_WINDOWS:]:
        for rank, snap in sorted(window.get("snapshots", {}).items()):
            rank = int(rank)
            cur = merged.get(rank)
            merged[rank] = snap if cur is None else _sum_snaps(cur, snap)
    return merged


# ---------------------------------------------------------------------------
# Rules


def check_persistent_straggler(ev: Evidence) -> Iterator[Diagnosis]:
    """One rank keeps arriving last at negotiation. Offline evidence is
    the r9 straggler report; live evidence is the coordinator's per-rank
    tick-lateness histogram — both express "late at negotiation"."""
    report = ev.straggler_report
    if report and report.get("collectives", 0) >= STRAGGLER_MIN_COLLECTIVES:
        total = report["collectives"]
        for rank_str in sorted(report.get("per_rank", {})):
            stats = report["per_rank"][rank_str]
            cycles = stats.get("straggler_cycles", 0)
            p99 = stats.get("lateness_p99_seconds") or 0.0
            if (cycles >= max(5, STRAGGLER_CYCLE_SHARE * total)
                    and p99 >= STRAGGLER_MIN_LATENESS):
                sev = ("critical" if p99 >= STRAGGLER_CRITICAL_LATENESS
                       else "warning")
                yield Diagnosis(
                    rule="persistent_straggler", severity=sev,
                    rank=int(rank_str),
                    summary=(f"arrived last at negotiation in {cycles} of "
                             f"{total} collectives (lateness p99 "
                             f"{_ms(p99)})"),
                    hint=(f"rank {rank_str} is persistently ≥"
                          f"{_ms(p99)} late at negotiation across {total} "
                          "collectives; suspect its NIC, a co-tenant "
                          "process, or its input pipeline"),
                    evidence={"straggler_cycles": cycles,
                              "collectives": total,
                              "lateness_p99_seconds": p99,
                              "source": "straggler_report"})
    # Live: the coordinator's tick-lateness histogram (rank label).
    for rank in sorted(ev.snapshots):
        per = _per_label_quantiles(
            ev.snapshots[rank].get("hvd_controller_tick_lateness_seconds"),
            0.99)
        if len(per) < 2:
            # One observed worker means no cluster to compare against:
            # the documented contract is "≥3x the cluster median", and
            # without peers the floor would degenerate to an absolute
            # threshold that names a merely compute-bound lone worker.
            continue
        for label in sorted(per):
            p99, count = per[label]
            others = [p for lbl, (p, _) in per.items() if lbl != label]
            floor = max(sorted(others)[len(others) // 2] if others else 0.0,
                        1e-3)
            if (count >= STRAGGLER_MIN_SAMPLES
                    and p99 >= STRAGGLER_MIN_LATENESS
                    and p99 >= STRAGGLER_SKEW_FACTOR * floor):
                sev = ("critical" if p99 >= STRAGGLER_CRITICAL_LATENESS
                       else "warning")
                yield Diagnosis(
                    rule="persistent_straggler", severity=sev,
                    rank=int(label),
                    summary=(f"coordinator waited ≥{_ms(p99)} (p99) for "
                             f"this rank's tick over {count} cycles"),
                    hint=(f"rank {label} is persistently ≥{_ms(p99)} late "
                          f"at negotiation across {count} collectives; "
                          "suspect its NIC, a co-tenant process, or its "
                          "input pipeline"),
                    evidence={"tick_lateness_p99_seconds": p99,
                              "cycles": count,
                              "cluster_median_p99_seconds": floor,
                              "source": "tick_lateness"})


def check_clock_sync(ev: Evidence) -> Iterator[Diagnosis]:
    """Clock-offset table quality: an unsynced or high-uncertainty rank
    silently degrades every downstream straggler attribution."""
    clock: Dict[int, dict] = {}
    if ev.clock:
        clock = {int(r): e for r, e in sorted(ev.clock.items())}
    elif ev.straggler_report and ev.straggler_report.get("clock"):
        clock = {int(r): e for r, e in
                 sorted(ev.straggler_report["clock"].items())}
    if len(clock) < 2:
        return
    workers = [r for r in sorted(clock) if r != 0]
    # "No ping plane ran at all" vs "the ping plane is broken": a python
    # engine job ALWAYS writes a clock_offsets.json (table entries carry
    # offset_seconds/samples), even when every pong was lost — only the
    # native engine leaves no table, and the clock evidence then comes
    # from the merged-trace metadata (applied_offset_seconds-shaped).
    from_table = any("offset_seconds" in clock[r] or "samples" in clock[r]
                     for r in workers)
    if (workers and not from_table
            and not any(clock[r].get("synced", False) for r in workers)):
        # No ping-pong plane ran AT ALL — a native-engine traced job:
        # spans come from the C++ engine's ring, and clock offsets ride
        # python-side heartbeats only (docs/tracing.md "Native engine").
        # That is a property of the job, not a broken heartbeat path, so
        # say so once at info instead of warning per rank.
        yield Diagnosis(
            rule="clock_sync_degraded", severity="info", rank=None,
            summary="no clock-offset table: every worker rank rebases "
                    "with offset 0 (native-engine jobs run no "
                    "python-side ping plane)",
            hint="same-host ranks share one monotonic clock, so the "
                 "merged timebase and straggler attribution stand; "
                 "across hosts treat sub-millisecond slacks as clock "
                 "noise, or run the python engine once to record a "
                 "clock_offsets.json",
            evidence={"clock": {str(r): clock[r] for r in workers}})
        return
    for rank in sorted(clock):
        entry = clock[rank]
        if rank == 0:
            continue  # rank 0 IS the reference clock
        if not entry.get("synced", False):
            yield Diagnosis(
                rule="clock_sync_degraded", severity="warning", rank=rank,
                summary="never completed a clock ping-pong; merged traces "
                        "rebase it with offset 0",
                hint=(f"rank {rank}'s heartbeat path never returned a "
                      "pong — straggler attribution involving it is "
                      "unreliable; check that heartbeats flow "
                      "(HOROVOD_HEARTBEAT_INTERVAL_SECONDS > 0) and that "
                      "nothing drops frames between it and rank 0"),
                evidence={"clock": entry})
            continue
        unc = entry.get("uncertainty_seconds")
        if unc is not None and unc >= CLOCK_MAX_UNCERTAINTY:
            yield Diagnosis(
                rule="clock_sync_degraded", severity="warning", rank=rank,
                summary=(f"clock offset uncertainty grew to {_ms(unc)} "
                         "(min-RTT window polluted)"),
                hint=(f"attribution finer than {_ms(unc)} against rank "
                      f"{rank} is noise; the RTT floor rose — look for "
                      "congestion or queueing between it and rank 0"),
                evidence={"clock": entry})


def check_recv_wait_skew(ev: Evidence) -> Iterator[Diagnosis]:
    """One worker's control-plane recvs wait far longer than the cluster
    median: its link (or the peer feeding it) is slow. Needs the rank-0
    cluster view with ≥2 WORKER snapshots — the coordinator's own
    recv-wait histogram is excluded on both sides of the comparison,
    because in the star topology rank 0's recvs block waiting for the
    slowest worker's tick: a sick worker inflates rank 0's profile, and
    judging it would blame exactly the wrong rank (the tick-lateness
    straggler rule owns that case). When telemetry windows exist the
    comparison runs over the recent windows' deltas, so one slow warm-up
    recv never brands a now-healthy link."""
    snapshots = _recent_snapshots(ev)
    per_rank: Dict[int, Tuple[float, int]] = {}
    for rank in sorted(snapshots):
        if rank == 0:
            continue
        p99, count = _hist_quantile_and_count(
            snapshots[rank], "hvd_wire_recv_wait_seconds", 0.99)
        if p99 is not None and count >= 20:
            per_rank[rank] = (p99, count)
    if len(per_rank) < 2:
        return
    for rank in sorted(per_rank):
        p99, count = per_rank[rank]
        # Median of the OTHER ranks' p99s (as in the live straggler
        # rule): a whole-cluster median would include the outlier's own
        # value and, at the documented 2-snapshot minimum, BE it —
        # making the rule unable to ever fire on a 2-rank job.
        others = sorted(p for r, (p, _) in per_rank.items() if r != rank)
        median = others[len(others) // 2]
        if (p99 >= RECV_WAIT_MIN_P99
                and p99 >= RECV_WAIT_SKEW_FACTOR * max(median, 1e-3)):
            yield Diagnosis(
                rule="recv_wait_skew", severity="warning", rank=rank,
                summary=(f"recv-wait p99 {_ms(p99)} vs cluster median "
                         f"{_ms(median)} over {count} recvs"),
                hint=(f"rank {rank} waits {p99 / max(median, 1e-9):.1f}x "
                      "the cluster median for control frames; its NIC, "
                      "its host, or the path to the coordinator is slow"),
                evidence={"recv_wait_p99_seconds": p99,
                          "cluster_median_p99_seconds": median,
                          "recvs": count})


def check_heartbeat_flapping(ev: Evidence) -> Iterator[Diagnosis]:
    """Repeated liveness-deadline trips on a rank that is still alive:
    heartbeats arrive in bursts with gaps — a flapping link or a starved
    process, and the precursor of a spurious abort."""
    trips_by_rank: Dict[int, float] = _series_totals(
        ev.snapshots, "hvd_wire_deadline_trips_total")
    for events in ev.postmortems:
        for event in events:
            if event.get("kind") == "deadline_trip" and "rank" in event:
                rank = int(event["rank"])
                trips_by_rank[rank] = trips_by_rank.get(rank, 0) + 1
    for rank in sorted(trips_by_rank):
        trips = int(trips_by_rank[rank])
        if trips >= FLAPPING_MIN_TRIPS:
            sev = ("critical" if trips >= FLAPPING_CRITICAL_TRIPS
                   else "warning")
            yield Diagnosis(
                rule="heartbeat_flapping", severity=sev, rank=rank,
                summary=(f"tripped its liveness deadline {trips} times "
                         "without the job dying"),
                hint=(f"rank {rank} sees heartbeat gaps longer than "
                      "HOROVOD_COMM_TIMEOUT_SECONDS in bursts; look for "
                      "GC/GIL pauses, CPU starvation by a co-tenant, or a "
                      "flapping NIC — each trip is one missed frame away "
                      "from a job abort"),
                evidence={"deadline_trips": trips})


def check_cache_hit_collapse(ev: Evidence) -> Iterator[Diagnosis]:
    """Response-cache hit rate collapsed under real traffic. Expected
    briefly after membership-relevant events (restart, abort, autotune
    flipping the cache categorical); persistent collapse means the
    negotiation fast path is off for the steady state."""
    for rank in sorted(ev.snapshots):
        snap = ev.snapshots[rank]
        entry_h = snap.get("hvd_controller_cache_hits_total")
        entry_m = snap.get("hvd_controller_cache_misses_total")
        if entry_h is None and entry_m is None:
            continue
        hits = sum(v for _, v in (entry_h or {}).get("values", []))
        misses = sum(v for _, v in (entry_m or {}).get("values", []))
        total = hits + misses
        if total < CACHE_MIN_TRAFFIC:
            continue
        rate = hits / total
        if rate < CACHE_COLLAPSE_RATE:
            membership = {}
            if ev.restart_epoch:
                membership["restart_epoch"] = ev.restart_epoch
            aborts = _series_totals(
                {rank: snap}, "hvd_controller_aborts_total").get(rank)
            if aborts:
                membership["aborts"] = aborts
            yield Diagnosis(
                rule="cache_hit_collapse", severity="warning", rank=rank,
                summary=(f"response-cache hit rate {rate:.0%} over "
                         f"{int(total)} requests"),
                hint=("a re-warm after a restart/abort recovers on its "
                      "own; a persistent collapse means tensor names do "
                      "not repeat (dynamic graph or unnamed collectives) "
                      "or HOROVOD_CACHE_CAPACITY is too small for the "
                      "working set"
                      + (" — this job shows membership churn: "
                         f"{membership}" if membership else "")),
                evidence={"hit_rate": round(rate, 4), "hits": hits,
                          "misses": misses, **membership})
    # Serving prefix cache: same rule slug, its own hint branches — a
    # warm-prefix rate this low under real page traffic means the fleet
    # is re-prefilling prompts it should be admitting near-free.
    for rank in sorted(ev.snapshots):
        snap = ev.snapshots[rank]
        entry_h = snap.get("hvd_serving_prefix_hits_total")
        entry_m = snap.get("hvd_serving_prefix_misses_total")
        if entry_h is None and entry_m is None:
            continue
        hits = sum(v for _, v in (entry_h or {}).get("values", []))
        misses = sum(v for _, v in (entry_m or {}).get("values", []))
        total = hits + misses
        if total < PREFIX_CACHE_MIN_TRAFFIC:
            continue
        rate = hits / total
        if rate >= PREFIX_CACHE_COLLAPSE_RATE:
            continue
        restarts = int(ev.restart_epoch) or int(max(_series_totals(
            ev.snapshots, "hvd_launcher_restarts_total").values(),
            default=0))
        if restarts:
            # Post-restart re-warm: the index died with the old
            # process's pools — distinct from a cold cache that never
            # warmed, which points at the traffic, not the lifecycle.
            hint = (f"post-restart re-warm (restart epoch {restarts}): "
                    "the prefix index lives in the engine's pools and "
                    "died with the previous process; the hit rate "
                    "recovers as shared prompts repopulate it — no "
                    "action here unless the restarts themselves recur "
                    "(see restart_churn)")
        else:
            hint = ("prefix-cache cold start, or traffic that shares no "
                    "page-aligned prefixes: if the rate stays this low "
                    "under steady load, check that system prompts are "
                    "byte-identical across requests (one drifted token "
                    "unshares every page after it) and that prompts "
                    "span at least one whole HOROVOD_SERVING_BLOCK_SIZE "
                    "page; raise HOROVOD_SERVING_PREFIX_CAPACITY if "
                    "evictions churn the index")
        yield Diagnosis(
            rule="cache_hit_collapse", severity="warning", rank=rank,
            summary=(f"serving prefix-cache hit rate {rate:.0%} over "
                     f"{int(total)} whole pages"),
            hint=hint,
            evidence={"prefix_hit_rate": round(rate, 4), "hits": hits,
                      "misses": misses, "restart_epoch": restarts,
                      "source": "serving_prefix"})


def check_restart_churn(ev: Evidence) -> Iterator[Diagnosis]:
    """The supervisor keeps relaunching the job: each restart replays
    init + cache warmup, and a crash loop converges on zero useful
    work."""
    restarts = ev.restart_epoch
    launcher = max(_series_totals(
        ev.snapshots, "hvd_launcher_restarts_total").values(), default=0)
    restarts = max(int(restarts), int(launcher))
    if restarts >= RESTART_CHURN_MIN:
        sev = ("critical" if restarts >= RESTART_CHURN_CRITICAL
               else "warning")
        yield Diagnosis(
            rule="restart_churn", severity=sev,
            summary=f"job is on restart epoch {restarts}",
            hint=("the job is crash-looping under --max-restarts; read "
                  "the flight-recorder postmortems (the dump tail names "
                  "the dead rank and in-flight ops) and fix the "
                  "recurring failure instead of raising the restart "
                  "budget"),
            evidence={"restart_epoch": restarts})


def check_membership_churn(ev: Evidence) -> Iterator[Diagnosis]:
    """An elastic job that keeps re-forming is paying the reshape tax —
    every transition discards in-flight collectives and re-broadcasts
    state from rank 0 — and usually has ONE sick host behind it. A
    couple of transitions is elastic working as designed; a stream of
    them is a flapping rank."""
    transitions = max(_series_totals(
        ev.snapshots, "hvd_membership_transitions_total").values(),
        default=0)
    if transitions < MEMBERSHIP_CHURN_MIN:
        return
    # Name the flapper: the old global rank most often lost to reshapes.
    # Counters are cumulative, so take each label's max across snapshots
    # (the coordinator owns the series; workers may echo stale copies).
    departures: Dict[str, float] = {}
    for rank in sorted(ev.snapshots):
        for label, value in _counter_by_first_label(
                ev.snapshots[rank],
                "hvd_membership_rank_departures_total").items():
            departures[label] = max(departures.get(label, 0.0), value)
    flapper: Optional[int] = None
    if departures:
        flapper = int(max(sorted(departures),
                          key=lambda label: departures[label]))
    sev = ("critical" if transitions >= MEMBERSHIP_CHURN_CRITICAL
           else "warning")
    epoch = _gauge(ev.snapshots, "hvd_membership_epoch")
    hint = ("each reshape discards in-flight work and re-syncs parameters "
            "from rank 0, so a flapping member costs far more than its "
            "own capacity")
    if flapper is not None:
        hint = (f"rank {flapper} keeps leaving the job "
                f"({int(departures[str(flapper)])} departure(s)); suspect "
                "its host (preemption, OOM kills, flaky NIC) before "
                "raising --elastic-respawns — " + hint)
    yield Diagnosis(
        rule="membership_churn", severity=sev, rank=flapper,
        summary=(f"{int(transitions)} elastic membership transitions "
                 f"(grow+shrink) this job"
                 + (f", now at epoch {int(epoch)}"
                    if epoch is not None else "")),
        hint=hint,
        evidence={"transitions": int(transitions),
                  "departures_by_rank": {k: int(v) for k, v in
                                         sorted(departures.items())},
                  "membership_epoch": epoch})


def check_autotune_search(ev: Evidence) -> Iterator[Diagnosis]:
    """The GP search itself can be the patient: a tuner that never
    scores is stalled; one whose current configuration scores far below
    its own best late in the search is wandering on noise."""
    active = _gauge(ev.snapshots, "hvd_autotune_active")
    if active is None or active < 1.0:
        return
    steps = _gauge(ev.snapshots, "hvd_autotune_steps_completed") or 0.0
    if steps == 0:
        # Zero steps is NORMAL early on (the tuner needs warmup + a full
        # sample window of payload cycles before its first score); only
        # a search still scoreless after a meaningful number of cycles
        # is stalled — without this guard every autotuned job reports
        # unhealthy from its very first /doctor scrape.
        cycles = 0
        for rank in sorted(ev.snapshots):
            _, count = _hist_quantile_and_count(
                ev.snapshots[rank], "hvd_controller_cycle_seconds", 0.5)
            cycles = max(cycles, count)
        if cycles >= AUTOTUNE_STALLED_MIN_CYCLES:
            yield Diagnosis(
                rule="autotune_stalled", severity="info",
                summary=(f"autotune has scored no configuration after "
                         f"{cycles} controller cycles"),
                hint=("the tuner only scores cycles that execute payload "
                      "bytes; if eager traffic is flowing and this "
                      "persists, the controller is seeing empty cycles "
                      "only"),
                evidence={"steps_completed": 0,
                          "cycles_observed": cycles})
        return
    last = None
    best = _gauge(ev.snapshots, "hvd_autotune_best_objective")
    for rank in sorted(ev.snapshots):
        by_label = _counter_by_first_label(
            ev.snapshots[rank], "hvd_autotune_objective")
        if by_label:
            last = by_label.get("score")
            break
    if (last is not None and best is not None and best > 0
            and steps >= AUTOTUNE_WANDER_MIN_STEPS
            and last < AUTOTUNE_WANDER_RATIO * best):
        yield Diagnosis(
            rule="autotune_wandering", severity="warning",
            summary=(f"search moved to a configuration scoring "
                     f"{last / best:.0%} of its own best after "
                     f"{int(steps)} steps"),
            hint=("the objective surface is noisy (timeshared host or "
                  "stragglers distorting cycle timing); consider "
                  "HOROVOD_AUTOTUNE_STRAGGLER_WEIGHT to discount "
                  "straggler noise, or pin the knobs you already trust "
                  "via their HOROVOD_* env vars"),
            evidence={"last_score": last, "best_score": best,
                      "steps_completed": int(steps)})


def check_serving_pressure(ev: Evidence) -> Iterator[Diagnosis]:
    """The serving tier is saturated: admission control is shedding
    load (queue at its bound / rejects counted), or the paged KV pool
    keeps running dry (preemption-by-recompute replaying whole
    prefixes). Both are capacity verdicts with direct knobs —
    docs/serving.md. Evidence: the ``hvd_serving_*`` series in any
    rank's snapshot; ``rank`` is attached only when more than one rank
    serves (a lone serving process needs no rank attribution)."""
    many = len(ev.snapshots) > 1
    for rank in sorted(ev.snapshots):
        snap = ev.snapshots[rank]
        subject = rank if many else None
        limit = _gauge({rank: snap}, "hvd_serving_queue_limit")
        depth = _gauge({rank: snap}, "hvd_serving_queue_depth") or 0.0
        rejects = _counter_by_first_label(
            snap, "hvd_serving_requests_total").get("rejected", 0.0)
        if limit and (rejects > 0
                      or depth >= SERVING_QUEUE_SATURATION_SHARE * limit):
            sev = ("critical" if rejects >= SERVING_CRITICAL_REJECTS
                   else "warning")
            yield Diagnosis(
                rule="serving_queue_saturation", severity=sev, rank=subject,
                summary=(f"serving queue at {int(depth)}/{int(limit)} "
                         f"with {int(rejects)} rejected request(s)"),
                hint=("admission control is shedding load — arrivals "
                      "outpace the decode loop; add serving capacity "
                      "(another replica, or a larger "
                      "HOROVOD_SERVING_MAX_BATCH if the chip has "
                      "headroom) or slow the client, and check "
                      "hvd_serving_ttft_seconds for how far the backlog "
                      "already pushed first-token latency"),
                evidence={"queue_depth": int(depth),
                          "queue_limit": int(limit),
                          "rejected": int(rejects)})
        total_preempts = sum(
            v for _, v in (snap.get("hvd_serving_preemptions_total")
                           or {}).get("values", []))
        if total_preempts >= SERVING_MIN_PREEMPTIONS:
            sev = ("critical"
                   if total_preempts >= SERVING_CRITICAL_PREEMPTIONS
                   else "warning")
            blocks = _gauge({rank: snap}, "hvd_serving_blocks_total")
            yield Diagnosis(
                rule="serving_block_exhaustion", severity=sev, rank=subject,
                summary=(f"paged KV pool ran dry {int(total_preempts)} "
                         "time(s) (preemption-by-recompute)"),
                hint=("each preemption drops a sequence's KV blocks and "
                      "re-prefills its whole prefix later — correct but "
                      "pure overhead; raise HOROVOD_SERVING_NUM_BLOCKS "
                      "(more HBM for the pool) or lower "
                      "HOROVOD_SERVING_MAX_BATCH so fewer sequences "
                      "share it"),
                evidence={"preemptions": int(total_preempts),
                          "blocks_total": (int(blocks)
                                           if blocks is not None else None)})


def check_router_replica_flapping(ev: Evidence) -> Iterator[Diagnosis]:
    """Serving replicas keep leaving the fleet: every departure is a
    reshape (requests re-route, in-flight work replays, and the dead
    replica's whole prefix cache is lost), so a flapping replica taxes
    the survivors far beyond its own capacity — the serving twin of
    ``membership_churn``. Counters are cumulative; take each replica
    label's max across snapshots."""
    departures: Dict[str, float] = {}
    for rank in sorted(ev.snapshots):
        for label, value in _counter_by_first_label(
                ev.snapshots[rank],
                "hvd_router_replica_departures_total").items():
            departures[label] = max(departures.get(label, 0.0), value)
    total = int(sum(departures.values()))
    if total < ROUTER_FLAPPING_MIN:
        return
    flapper = max(sorted(departures), key=lambda label: departures[label])
    sev = ("critical" if total >= ROUTER_FLAPPING_CRITICAL else "warning")
    replicas = _gauge(ev.snapshots, "hvd_router_replicas")
    epoch = _gauge(ev.snapshots, "hvd_router_epoch")
    yield Diagnosis(
        rule="router_replica_flapping", severity=sev,
        summary=(f"{total} serving replica departure(s) this fleet"
                 + (f", {int(replicas)} replica(s) still live"
                    if replicas is not None else "")),
        hint=(f"replica {flapper} left the fleet "
              f"{int(departures[flapper])} time(s); every departure "
              "re-routes its queue, replays its in-flight requests on "
              "the survivors, and cold-starts its prefix cache on "
              "rejoin — suspect that replica's host (OOM kills, "
              "preemption, device resets) before adding capacity"),
        evidence={"departures_total": total,
                  "departures_by_replica": {k: int(v) for k, v in
                                            sorted(departures.items())},
                  "live_replicas": (int(replicas)
                                    if replicas is not None else None),
                  "router_epoch": (int(epoch)
                                   if epoch is not None else None)})


def check_capacity_headroom(ev: Evidence) -> Iterator[Diagnosis]:
    """The job's live control-plane latencies have left the calibrated
    capacity envelope: negotiation or reshape p99 for the CURRENT world
    size runs ≥2x what the committed scaling curves predict
    (docs/capacity.md). That gap means the planner's forward
    extrapolations understate this job — re-plan before trusting a
    scale-up. Needs a calibration artifact
    (HOROVOD_CAPACITY_CALIBRATION live, or a capacity/simcluster
    artifact beside the traces offline) and the ``hvd_membership_size``
    abscissa. When telemetry windows exist, the p99 is judged over the
    recent windows' deltas — a slow warm-up heals within two rolls, and
    degradation after hours of health is not diluted into lifetime
    aggregates."""
    data = ev.capacity_calibration
    if not data or not data.get("control_plane"):
        return
    snapshots = _recent_snapshots(ev)
    world = _gauge(snapshots, "hvd_membership_size")
    if world is None or world < 1:
        return
    from ..utils.scaling_model import control_plane_from_artifact
    try:
        cal = control_plane_from_artifact(data)
    except (KeyError, TypeError, ValueError):
        return
    world = int(world)
    planes = (
        ("negotiation", "hvd_controller_cycle_seconds",
         CAPACITY_MIN_CYCLES, cal.negotiation_seconds(world)),
        ("reshape", "hvd_elastic_reshape_seconds",
         CAPACITY_MIN_RESHAPES, cal.reshape_seconds(world)),
    )
    for plane, series, min_samples, modeled in planes:
        # The coordinator owns both series; take the worst qualifying
        # rank in case a worker echoes a stale (smaller) copy.
        worst: Optional[Tuple[float, int]] = None
        for rank in sorted(snapshots):
            p99, count = _hist_quantile_and_count(
                snapshots[rank], series, 0.99)
            if p99 is not None and count >= min_samples:
                if worst is None or p99 > worst[0]:
                    worst = (p99, count)
        if worst is None:
            continue
        p99, count = worst
        floor = max(modeled, CAPACITY_MODELED_FLOOR)
        if p99 >= CAPACITY_HEADROOM_FACTOR * floor:
            yield Diagnosis(
                rule="capacity_headroom", severity="warning",
                summary=(f"{plane} p99 {_ms(p99)} at world size {world} "
                         f"vs modeled {_ms(modeled)} "
                         f"({p99 / max(modeled, 1e-9):.1f}x the "
                         "calibrated curve)"),
                hint=(f"the {plane} plane runs "
                      f"{p99 / max(modeled, 1e-9):.1f}x its calibrated "
                      "cost for this world size, so capacity-planner "
                      "extrapolations understate this job; find what "
                      "changed since calibration (slower hosts, a "
                      "straggler, congested control path — see the other "
                      "findings), or re-run examples/capacity_probe.py "
                      "on this substrate and point "
                      "HOROVOD_CAPACITY_CALIBRATION at the fresh "
                      "artifact"),
                evidence={"plane": plane,
                          "measured_p99_seconds": p99,
                          "modeled_seconds": modeled,
                          "world_size": world,
                          "factor": round(p99 / max(modeled, 1e-9), 2),
                          "samples": count,
                          "windows_judged": (
                              min(len(ev.windows), RECENT_WINDOWS)
                              if ev.windows else 0),
                          "calibration_source": data.get(
                              "substrate", "artifact")})


def check_calibration_drift(ev: Evidence) -> Iterator[Diagnosis]:
    """The LIVE re-fit of a control-plane curve has drifted ≥2x past
    the committed calibration's per-rank slope (docs/capacity.md "Live
    recalibration"): the committed capacity curves now understate this
    job's control plane structurally — not one slow percentile
    (capacity_headroom's case) but the fitted cost-per-rank itself.
    Residual-aware: the committed artifact's own ``fit_residual``
    widens the threshold, so ±20% box-pace swing between calibration
    and today never fires it. Needs both a committed calibration
    artifact and a live summary (the rank-0 window roller feeding
    ``utils/live_calibration.py`` live, or a persisted
    ``capacity_live.json`` beside the traces offline)."""
    live = ev.live_calibration
    data = ev.capacity_calibration
    if not live or not data or not data.get("control_plane"):
        return
    from ..utils.live_calibration import drift_report

    min_observations = {"negotiation": CAPACITY_MIN_CYCLES,
                        "reshape": CAPACITY_MIN_RESHAPES}
    for plane, row in sorted(drift_report(live, data).items()):
        if (row["observations"] < min_observations.get(
                plane, CAPACITY_MIN_RESHAPES)
                or row["windows"] < DRIFT_MIN_WINDOWS):
            continue
        if row["ratio"] < row["threshold"]:
            continue
        live_slope = row["live_per_rank_s"]
        committed_slope = row["committed_per_rank_s"]
        yield Diagnosis(
            rule="calibration_drift", severity="warning",
            summary=(f"{plane} per-rank cost re-fit live at "
                     f"{live_slope * 1e6:.0f}us/rank vs committed "
                     f"{committed_slope * 1e6:.0f}us/rank "
                     f"({row['ratio']:.1f}x, threshold "
                     f"{row['threshold']:.1f}x)"),
            hint=(f"the {plane} plane's live slope drifted "
                  f"{row['ratio']:.1f}x past the committed calibration "
                  "(residual-aware threshold "
                  f"{row['threshold']:.1f}x) — the capacity planner's "
                  "forward extrapolations are stale for this job; "
                  "re-plan from the live curves (python -m "
                  "horovod_tpu_torch.tools.capacity --live "
                  "$HOROVOD_CAPACITY_LIVE_DIR), and if the drift "
                  "persists re-run examples/capacity_probe.py and "
                  "re-point HOROVOD_CAPACITY_CALIBRATION; with "
                  "HOROVOD_AUTOTUNE_PRIORS=capacity the tuner re-seeds "
                  "from the live curves automatically"),
            evidence={"plane": plane,
                      "live_per_rank_seconds": live_slope,
                      "committed_per_rank_seconds": committed_slope,
                      "ratio": row["ratio"],
                      "threshold": row["threshold"],
                      "fit_residual": row["fit_residual"],
                      "observations": row["observations"],
                      "windows": row["windows"],
                      "world_size": live.get("world_size"),
                      "calibration_source": data.get(
                          "substrate", "artifact")})


ALL_RULES = (
    check_persistent_straggler,
    check_clock_sync,
    check_recv_wait_skew,
    check_heartbeat_flapping,
    check_cache_hit_collapse,
    check_restart_churn,
    check_membership_churn,
    check_autotune_search,
    check_serving_pressure,
    check_router_replica_flapping,
    check_capacity_headroom,
    check_calibration_drift,
)

# Every rule slug the catalog can emit — the hvd_doctor_findings gauge
# zeroes the full set each sweep so a healed finding visibly drops to 0.
RULE_SLUGS = (
    "persistent_straggler",
    "clock_sync_degraded",
    "recv_wait_skew",
    "heartbeat_flapping",
    "cache_hit_collapse",
    "restart_churn",
    "membership_churn",
    "autotune_stalled",
    "autotune_wandering",
    "serving_queue_saturation",
    "serving_block_exhaustion",
    "router_replica_flapping",
    "capacity_headroom",
    "calibration_drift",
)


def diagnose(ev: Evidence) -> List[Diagnosis]:
    """Run every rule, dedupe (rule, rank) keeping the worse severity,
    and return findings ordered most-severe first."""
    best: Dict[Tuple[str, Optional[int]], Diagnosis] = {}
    order = {s: i for i, s in enumerate(SEVERITIES)}
    for rule in ALL_RULES:
        for finding in rule(ev):
            key = (finding.rule, finding.rank)
            kept = best.get(key)
            if kept is None or order[finding.severity] < order[kept.severity]:
                best[key] = finding
    return sorted(
        best.values(),
        key=lambda d: (order[d.severity], d.rule,
                       -1 if d.rank is None else d.rank))
