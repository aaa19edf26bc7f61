"""Measured-inputs scaling-efficiency projection for data parallelism,
the bucket scheduler's overlap accounting, and the control-plane capacity
model: the port's copy of ``horovod_tpu/utils/scaling_model.py`` (numpy
free, pure Python; the port imports nothing of ``horovod_tpu``).

Pipelined-reduction event model (:func:`dp_step_time`): compute runs for
``step_time_s``; gradient group *g* becomes available at
``(1 - compute_after_frac_g) * step_time_s``; a single serial comm engine
starts each group when both the group is available and the engine is
free. The step ends when both compute and the last reduction finish.
Ring-allreduce wire bytes are ``2 (n-1)/n * B`` per device.

Every function takes its bandwidths and times as arguments. The tables
``ICI_BW_BYTES_PER_S``, ``CONSERVATIVE_LINK_FRACTION`` and
``DCN_BW_BYTES_PER_S_PER_CHIP`` are the JAX package's published TPU link
figures, kept so both packages' functions agree on the same inputs; they
are not measurements of any GPU link. The port's groups come from
``controller.bucket_scheduler.plan_from_compiled`` (a recorded backward,
not a compiled schedule) or from :func:`groups_from_overlap_report` on a
report dict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple



def ring_wire_bytes(n: int, payload: int) -> float:
    """Ring-allreduce send bytes per device: ``2 (n-1)/n * payload``."""
    return 2 * (n - 1) / n * payload


# Published per-chip aggregate ICI bandwidths (one-way, bytes/s). Sources:
# cloud.google.com/tpu/docs system architecture pages — v5e: 1,600 Gbps
# per chip (2D torus, 4 links); v5p: 4,800 Gbps per chip (3D torus,
# 6 links). The optimistic figure assumes XLA's multi-dimension ring
# decomposition drives every link (what its combined all-reduce does on
# a full torus axis); the conservative band assumes a single torus
# dimension's links only.
ICI_BW_BYTES_PER_S = {
    "v5e": 200e9,
    "v5p": 600e9,
}
CONSERVATIVE_LINK_FRACTION = {
    "v5e": 0.5,   # 1 of 2 torus dims
    "v5p": 1 / 3,  # 1 of 3 torus dims
}
# Per-chip DCN share for multi-slice jobs: ~200 Gbps NICs per v5e host
# of 8 chips => ~3 GB/s/chip sustained. Carried as a parameter.
DCN_BW_BYTES_PER_S_PER_CHIP = 3e9


@dataclasses.dataclass
class GradGroup:
    payload_bytes: int
    compute_after_frac: float  # schedule fraction of compute still queued


def dp_step_time(step_time_s: float, groups: Sequence[GradGroup],
                 n: int, bw_bytes_per_s: float,
                 overlap: bool = True) -> float:
    """Projected per-step wall time at ``n`` chips (event model above)."""
    if n <= 1:
        return step_time_s
    engine_free = 0.0
    for g in sorted(groups, key=lambda g: g.compute_after_frac,
                    reverse=True):
        avail = ((1.0 - g.compute_after_frac) * step_time_s
                 if overlap else step_time_s)
        t_comm = ring_wire_bytes(n, g.payload_bytes) / bw_bytes_per_s
        engine_free = max(engine_free, avail) + t_comm
    return max(step_time_s, engine_free)


def dp_efficiency(step_time_s: float, groups: Sequence[GradGroup], n: int,
                  bw_bytes_per_s: float, overlap: bool = True) -> float:
    """step_time(1) / step_time(n): weak-scaling efficiency (fixed
    per-chip batch, the definition of Horovod's published benchmarks)."""
    return step_time_s / dp_step_time(step_time_s, groups, n,
                                      bw_bytes_per_s, overlap)


def hierarchical_exposed_bytes(total_payload: int, ici_size: int) -> float:
    """DCN bytes per chip for a two-level reduction (psum_scatter on ICI,
    cross-slice psum of the 1/ici shard, all_gather back —
    ``parallel/hierarchical.py``): each chip owns 1/ici_size of the
    payload on the slow axis."""
    return 2.0 * total_payload / ici_size


def multislice_efficiency(step_time_s: float, groups: Sequence[GradGroup],
                          n_slices: int, ici_size: int,
                          ici_bw: float, dcn_bw_per_chip: float,
                          overlap: bool = True) -> float:
    """Two-slice+ jobs: ICI phase as in :func:`dp_efficiency` within the
    slice, plus the serialized DCN phase on each chip's 1/ici shard
    (conservative: DCN phase modeled unoverlapped beyond the ICI
    pipeline, which is how ``hierarchical_allreduce`` sequences it)."""
    t_ici = dp_step_time(step_time_s, groups, ici_size, ici_bw, overlap)
    total = sum(g.payload_bytes for g in groups)
    scale = (n_slices - 1) / n_slices
    t_dcn = scale * hierarchical_exposed_bytes(
        total, ici_size) / dcn_bw_per_chip
    return step_time_s / (t_ici + t_dcn)


# The named_scope marker hvd's collective wrappers plant
# (ops/collective_ops.py); it survives compilation as HLO op_name
# metadata, so a compiled schedule says which all-reduces are OURS.
GRADIENT_MARKER = "hvd.allreduce"


def groups_from_overlap_report(report: dict,
                               min_bytes: int = 1 << 16) -> List[GradGroup]:
    """The sync-collective placements of a compiled DP step, as model
    inputs. An all-reduce whose op_name carries hvd's own scope marker is
    gradient traffic by construction, whatever its size — jax versions
    that emit one all-reduce per PARAMETER would otherwise lose every
    small leaf (a 128-byte bias) to the size filter. Unmarked collectives
    (older artifacts predate the op_name field; synthetic schedules have
    no metadata) fall back to the size heuristic: small control
    collectives (loss psum, counters) are not gradient traffic."""
    out = []
    for s in report["sync_collectives"]:
        if s["opcode"] != "all-reduce":
            continue
        marked = GRADIENT_MARKER in s.get("op_name", "")
        if not marked and s["payload_bytes"] < min_bytes:
            continue
        out.append(GradGroup(s["payload_bytes"], s["compute_after_frac"]))
    return out


def efficiency_curve(step_time_s: float, groups: Sequence[GradGroup],
                     sizes: Sequence[int], bw_bytes_per_s: float,
                     overlap: bool = True) -> Dict[int, float]:
    return {n: dp_efficiency(step_time_s, groups, n, bw_bytes_per_s,
                             overlap) for n in sizes}


# --------------------------------------------------------------------------
# Overlap-efficiency validation: the bucket scheduler
# (controller/bucket_scheduler.py) measures per-bucket launch/complete
# times on the live controller; feeding them back through the SAME union
# computation the model's event timeline uses validates the model's
# overlap assumption against reality instead of assuming it.


@dataclasses.dataclass
class BucketEvent:
    """One reduction's measured (or modeled) life on the comm engine."""

    launch_s: float
    complete_s: float


def overlap_efficiency_from_events(
        events: Sequence[BucketEvent],
        compute_start_s: float, compute_end_s: float) -> float:
    """Fraction of the backward-compute window during which at least one
    reduction was in flight: the union of the [launch, complete]
    intervals, clipped to [compute_start, compute_end], over the window
    length. THE definition of ``overlap_efficiency`` — the scheduler's
    measured value and the model's predicted value both come from this
    function, so comparing them compares assumptions, not formulas.
    Returns 0.0 for an empty/degenerate window (no compute to hide
    behind)."""
    window = compute_end_s - compute_start_s
    if window <= 0 or not events:
        return 0.0
    spans = sorted(
        (max(e.launch_s, compute_start_s), min(e.complete_s, compute_end_s))
        for e in events)
    covered = 0.0
    cur_a, cur_b = None, None
    for a, b in spans:
        if b <= a:
            continue
        if cur_a is None:
            cur_a, cur_b = a, b
        elif a <= cur_b:
            cur_b = max(cur_b, b)
        else:
            covered += cur_b - cur_a
            cur_a, cur_b = a, b
    if cur_a is not None:
        covered += cur_b - cur_a
    return min(1.0, covered / window)


def predicted_bucket_events(step_time_s: float,
                            groups: Sequence[GradGroup], n: int,
                            bw_bytes_per_s: float) -> List[BucketEvent]:
    """The :func:`dp_step_time` event model, returning the per-group
    (launch, complete) timeline instead of only the final clock: group
    *g* becomes available at ``(1 - compute_after_frac_g) * step_time``;
    the single serial comm engine starts it when both it and the engine
    are free. Feeding this through
    :func:`overlap_efficiency_from_events` gives the model's PREDICTED
    overlap efficiency for the same schedule the bucket scheduler runs —
    tests/test_bucket_scheduler.py pins model-vs-measured within a
    documented tolerance."""
    if n <= 1:
        return []
    events: List[BucketEvent] = []
    engine_free = 0.0
    for g in sorted(groups, key=lambda g: g.compute_after_frac,
                    reverse=True):
        avail = (1.0 - g.compute_after_frac) * step_time_s
        t_comm = ring_wire_bytes(n, g.payload_bytes) / bw_bytes_per_s
        launch = max(engine_free, avail)
        engine_free = launch + t_comm
        events.append(BucketEvent(launch, engine_free))
    return events


def modeled_events_from_measured(
        events: Sequence[BucketEvent],
        window_s: float) -> List[BucketEvent]:
    """Rebuild the model's serial-engine timeline FROM a measured bucket
    timeline: buckets become available at uniform spacing across the
    backward window, and each occupies the engine for the measured
    MEDIAN bucket duration. Feeding the result through
    :func:`overlap_efficiency_from_events` gives the model's predicted
    overlap for the schedule that was actually run — THE model-vs-
    measured validation recipe (examples/overlap_probe.py and
    tests/test_bucket_scheduler.py both call this; the comparison is
    meaningless unless both use the same reconstruction)."""
    if not events or window_s <= 0:
        return []
    durations = sorted(e.complete_s - e.launch_s for e in events)
    t_comm = durations[len(durations) // 2]
    out: List[BucketEvent] = []
    engine_free = 0.0
    for i in range(len(events)):
        avail = window_s * (i + 1) / len(events)
        launch = max(engine_free, avail)
        engine_free = launch + t_comm
        out.append(BucketEvent(launch, engine_free))
    return out


# --------------------------------------------------------------------------
# Control-plane cost calibration: until the sim harness
# (horovod_tpu/sim, docs/simcluster.md) existed, everything this module
# said about hundred-rank behavior was extrapolated from <= 4-rank
# measurements. The simcluster measurement rig records per-world-size
# negotiation step latency, elastic reshape time, and heartbeat fanout
# cost (artifacts/simcluster_r13.json); the functions below fit the
# model's control-plane curves FROM that data — linear in world size,
# which is what the coordinator's O(N) tick gather / assignment fanout
# predicts — and the artifact gate (tests/test_simcluster.py) asserts
# model-vs-measured agreement at multiple world sizes, so the curve is
# validated, not assumed.


@dataclasses.dataclass
class ControlPlaneCalibration:
    """Fitted linear cost curves for the coordinator's O(N) loops:
    ``cost(n) = base + per_rank * n`` seconds."""

    negotiation_base_s: float
    negotiation_per_rank_s: float
    reshape_base_s: float
    reshape_per_rank_s: float
    heartbeat_base_s: float
    heartbeat_per_rank_s: float
    source: str = "assumed"

    def negotiation_seconds(self, n: int) -> float:
        return self.negotiation_base_s + self.negotiation_per_rank_s * n

    def reshape_seconds(self, n: int) -> float:
        return self.reshape_base_s + self.reshape_per_rank_s * n

    def heartbeat_fanout_seconds(self, n: int) -> float:
        return self.heartbeat_base_s + self.heartbeat_per_rank_s * n


def fit_linear(points: Dict[int, float]) -> Tuple[float, float]:
    """Least-squares ``base + per_rank * n`` over ``{n: seconds}``,
    clamped to non-negative coefficients (a negative marginal cost per
    rank is measurement noise, not physics). One point degenerates to a
    pure per-rank rate — the conservative reading at larger n."""
    items = sorted(points.items())
    if not items:
        raise ValueError("fit_linear needs at least one (n, seconds) point")
    if len(items) == 1:
        n, secs = items[0]
        return 0.0, max(0.0, secs / max(1, n))
    ns = [float(n) for n, _ in items]
    ys = [float(y) for _, y in items]
    n_mean = sum(ns) / len(ns)
    y_mean = sum(ys) / len(ys)
    var = sum((n - n_mean) ** 2 for n in ns)
    cov = sum((n - n_mean) * (y - y_mean) for n, y in zip(ns, ys))
    slope = cov / var if var else 0.0
    slope = max(0.0, slope)
    base = max(0.0, y_mean - slope * n_mean)
    return base, slope


def fit_linear_relative(points: Dict[int, float]) -> Tuple[float, float]:
    """Relative-error-weighted least squares (weights ``1/y**2``),
    same non-negative clamps as :func:`fit_linear`. Plain least squares
    is dominated by the largest world size's absolute cost, so a fit
    over sizes spanning two orders of magnitude leaves the small sizes'
    RELATIVE residuals unbounded; this variant spreads relative error
    evenly — the right objective when the gate is a rel_err bound at
    every recorded size. New calibration artifacts stamp ``"fit":
    "relative"`` so :func:`control_plane_from_artifact` refits them the
    same way (older artifacts carry no stamp and keep the absolute
    fit, bit-for-bit)."""
    items = sorted(points.items())
    if not items:
        raise ValueError(
            "fit_linear_relative needs at least one (n, seconds) point")
    if len(items) == 1:
        n, secs = items[0]
        return 0.0, max(0.0, secs / max(1, n))
    rows = [(float(n), float(y)) for n, y in items if float(y) > 0]
    if len(rows) < 2:
        return fit_linear(points)
    # Weighted normal equations for y ~ b + m*n with w = 1/y^2.
    sw = sn = sy = snn = sny = 0.0
    for n, y in rows:
        w = 1.0 / (y * y)
        sw += w
        sn += w * n
        sy += w * y
        snn += w * n * n
        sny += w * n * y
    det = sw * snn - sn * sn
    if not det:
        return fit_linear(points)
    base = (snn * sy - sn * sny) / det
    slope = (sw * sny - sn * sy) / det
    slope = max(0.0, slope)
    if base < 0.0:
        # Re-solve the slope with the base pinned at its clamp, instead
        # of keeping a slope optimized for the unclamped intercept.
        base = 0.0
        slope = max(0.0, sny / snn if snn else 0.0)
    return base, slope


def fit_control_plane(measured: Dict[int, dict],
                      source: str = "measured",
                      relative: bool = False) -> ControlPlaneCalibration:
    """Fit the three control-plane curves from per-world-size sim
    measurements: ``{n: {"negotiate_step_seconds": s,
    "reshape_seconds": s, "heartbeat_fanout_seconds": s}}`` (absent
    fields are skipped per curve). ``relative`` switches to the
    rel-err-weighted fit (:func:`fit_linear_relative`)."""
    fit = fit_linear_relative if relative else fit_linear

    def curve(key: str) -> Tuple[float, float]:
        pts = {n: row[key] for n, row in sorted(measured.items())
               if row.get(key) is not None}
        if not pts:
            return 0.0, 0.0
        return fit(pts)

    neg = curve("negotiate_step_seconds")
    resh = curve("reshape_seconds")
    hb = curve("heartbeat_fanout_seconds")
    return ControlPlaneCalibration(
        negotiation_base_s=neg[0], negotiation_per_rank_s=neg[1],
        reshape_base_s=resh[0], reshape_per_rank_s=resh[1],
        heartbeat_base_s=hb[0], heartbeat_per_rank_s=hb[1],
        source=source)


def control_plane_report(measured: Dict[int, dict],
                         relative: bool = False) -> dict:
    """Fit + per-size model-vs-measured residuals, JSON-ready — the
    shape ``artifacts/simcluster_r13.json`` embeds and the artifact gate
    asserts on. Residuals are relative to the measured value. The
    ``fit`` key records which fit produced the calibration so
    :func:`control_plane_from_artifact` reproduces it exactly."""
    cal = fit_control_plane(measured, relative=relative)
    rows = {}
    for n in sorted(measured):
        row = measured[n]
        entry = {}
        for key, predict in (
                ("negotiate_step_seconds", cal.negotiation_seconds),
                ("reshape_seconds", cal.reshape_seconds),
                ("heartbeat_fanout_seconds", cal.heartbeat_fanout_seconds)):
            got = row.get(key)
            if got is None:
                continue
            pred = predict(n)
            entry[key] = {
                "measured": round(float(got), 6),
                "predicted": round(float(pred), 6),
                "rel_err": (round(abs(pred - got) / got, 4)
                            if got else None),
            }
        rows[str(n)] = entry
    return {
        "calibration": dataclasses.asdict(cal),
        "model_vs_measured": rows,
        "fit": "relative" if relative else "absolute",
    }


def control_plane_from_artifact(data: dict) -> ControlPlaneCalibration:
    """Rebuild the calibration from a loaded simcluster artifact (the
    ``control_plane`` section keyed by world size), honoring the
    artifact's recorded ``fit`` flavor (absent on older artifacts —
    those keep the absolute fit they were committed with)."""
    measured = {int(n): row
                for n, row in sorted(data["control_plane"].items())}
    return fit_control_plane(
        measured, source=data.get("substrate", "artifact"),
        relative=data.get("fit") == "relative")


def pipelined_modeled_events(event_dicts: Sequence[dict],
                             window_s: float) -> List[BucketEvent]:
    """Pipelined-engine analogue of :func:`modeled_events_from_measured`
    (docs/overlap.md): with the double-buffered wire thread,
    a bucket's launch is no longer serialized behind the previous
    bucket's copy-out — the model assumes bucket *i* of *nb* enters the
    engine as its members are produced (uniformly across the backward
    window) and drains one median post-ready tail later, concurrent
    with its successors' packing. Takes the measured report's event
    dicts (``launch_s``/``ready_s``/``complete_s`` offsets — ``ready_s``
    is when the bucket's last member was produced) so the tail excludes
    the bucket's own production time."""
    if not event_dicts or window_s <= 0:
        return []
    nb = len(event_dicts)
    tails = sorted(
        max(0.0, e["complete_s"] - e.get("ready_s", e["launch_s"]))
        for e in event_dicts)
    t_tail = tails[nb // 2]
    return [BucketEvent(window_s * i / nb, window_s * (i + 1) / nb + t_tail)
            for i in range(nb)]


def stall_split_report(event_dicts: Sequence[dict],
                       calibration: ControlPlaneCalibration,
                       n: int) -> dict:
    """Split each bucket's post-ready stall (``complete_s - ready_s`` —
    time the finished gradients sat waiting on comms) into negotiation
    vs wire using the calibrated control-plane model (
    ``artifacts/simcluster_r13.json``): up to one calibrated negotiation
    round per bucket is control-plane cost, the remainder is wire
    occupancy. JSON-ready — the overlap probe embeds this so the
    remaining gap names its owner (docs/overlap.md reading guide)."""
    neg_budget = max(0.0, calibration.negotiation_seconds(n))
    neg_total = 0.0
    wire_total = 0.0
    for e in event_dicts:
        stall = max(0.0, e["complete_s"] - e.get("ready_s", e["launch_s"]))
        neg = min(stall, neg_budget)
        neg_total += neg
        wire_total += stall - neg
    total = neg_total + wire_total
    return {
        "buckets": len(event_dicts),
        "negotiation_stall_s": round(neg_total, 6),
        "wire_stall_s": round(wire_total, 6),
        "negotiation_frac": (round(neg_total / total, 4) if total else 0.0),
        "negotiation_budget_per_bucket_s": round(neg_budget, 6),
        "calibration_source": calibration.source,
    }


def measured_overlap_report(events: Sequence[BucketEvent],
                            compute_start_s: float,
                            compute_end_s: float) -> dict:
    """JSON-ready summary of a measured bucket timeline — what the bench
    row and the ``hvd_overlap_*`` gauges carry."""
    eff = overlap_efficiency_from_events(events, compute_start_s,
                                         compute_end_s)
    return {
        "buckets": len(events),
        "overlap_efficiency": round(eff, 4),
        "compute_window_s": round(max(0.0, compute_end_s - compute_start_s),
                                  6),
        "comm_busy_s": round(sum(max(0.0, e.complete_s - e.launch_s)
                                 for e in events), 6),
    }


# --------------------------------------------------------------------------
# Capacity planner: invert the calibrated curves. The calibrations
# answer "what does the control plane cost at the sizes we ran"; the
# planner answers the operator's forward question — "what saturates
# FIRST if I scale this job to N ranks" — from the committed calibration
# artifacts (control plane, restore, stall split), each
# prediction carried with its fit residual as an explicit uncertainty.
# Substrate honesty: the calibrations are loopback+GIL coordinator walk
# costs, not NIC latency — every report stamps its calibration source
# (docs/capacity.md).

# Fixed evaluation order; ties in saturation rank deterministically.
CAPACITY_PLANES = ("negotiation", "reshape", "heartbeat_fanout",
                   "restore", "overlap_stall")

_MIB = 1024 * 1024

# Operator hints, per plane — what to turn when the plane binds.
CAPACITY_HINTS = {
    "negotiation": (
        "negotiation is a per-rank coordinator walk: keep the response "
        "cache on (HOROVOD_CACHE_CAPACITY) so repeated tensors bypass "
        "it, raise HOROVOD_CYCLE_TIME to amortize the walk, or grow "
        "buckets so fewer rounds run per step"),
    "reshape": (
        "reform fanout is O(ranks); batch membership changes so one "
        "reshape absorbs many joiners, and keep "
        "HOROVOD_COMM_TIMEOUT_SECONDS above the modeled reshape time"),
    "heartbeat_fanout": (
        "the liveness sweep walks every wire from rank 0; raise "
        "HOROVOD_HEARTBEAT_INTERVAL_SECONDS so sweeps stay a small "
        "fraction of the interval"),
    "restore": (
        "use p2p sharded restore (HOROVOD_ELASTIC_RESTORE=p2p) — the "
        "per-rank shard shrinks as the world grows, unlike the "
        "broadcast path"),
    "overlap_stall": (
        "per-bucket negotiation stall outgrows the backward window: "
        "raise HOROVOD_BUCKET_BYTES (fewer rounds per step) or set "
        "HOROVOD_AUTOTUNE_PRIORS=capacity to seed the tuner at the "
        "modeled point"),
}


def fit_restore_curve(restore_data: dict) -> Tuple[float, float]:
    """``base + per_mib * shard_mib`` from the restore artifact's
    measured p2p leaf timings (``leaf_kinds.jax.p2p``: per-size
    ``median_s`` rows). The p2p plane is the one whose per-rank cost
    stays flat as the world grows (each joiner fetches only its shard),
    which is why it is the restore curve worth extrapolating."""
    rows = restore_data["leaf_kinds"]["jax"]["p2p"]
    points = {}
    for size_mib, entry in sorted(rows.items()):
        try:
            points[float(size_mib)] = float(entry["median_s"])
        except (TypeError, ValueError):
            continue  # the "ratio" summary key rides beside the sizes
    if not points:
        raise ValueError("restore artifact has no p2p size rows")
    return fit_linear(points)


def _curve_residual(control_plane_report_data: dict, key: str):
    """Max relative fit error for one measured curve across the
    artifact's model-vs-measured rows — the honesty number every
    extrapolation carries (predicted ± predicted * residual)."""
    worst = None
    rows = control_plane_report_data.get("model_vs_measured", {})
    for _, entry in sorted(rows.items()):
        rel = entry.get(key, {}).get("rel_err")
        if rel is not None:
            worst = rel if worst is None else max(worst, rel)
    return worst


def saturation_ranks(base_s: float, per_rank_s: float,
                     budget_s: float) -> Optional[int]:
    """Smallest world size at which ``base + per_rank * n`` meets the
    budget; None when the curve never reaches it (zero slope)."""
    if budget_s <= base_s:
        return 1
    if per_rank_s <= 0:
        return None
    n = (budget_s - base_s) / per_rank_s
    return max(1, int(n) + 1)


def capacity_plan(ranks: int, model_bytes: int = 0,
                  control_plane_data: Optional[dict] = None,
                  restore_data: Optional[dict] = None,
                  overlap_data: Optional[dict] = None,
                  step_window_s: Optional[float] = None,
                  comm_timeout_s: Optional[float] = None,
                  heartbeat_interval_s: Optional[float] = None) -> dict:
    """Per-plane predicted cost at ``ranks`` + the first bottleneck.

    ``control_plane_data`` is a simcluster measurement artifact (the
    ``control_plane`` + ``model_vs_measured`` shape) — required; the
    calibration is re-fit from its measured rows, never trusted as
    stored coefficients. ``restore_data``/``overlap_data`` arm the
    restore and overlap-stall planes (the restore and overlap artifact shapes);
    ``step_window_s`` overrides the overlap artifact's measured backward
    window. Budgets default to the config defaults a fresh job runs
    with. Returns a JSON-ready dict: ``planes`` (one entry per
    CAPACITY_PLANES member, fixed order), ``first_bottleneck``,
    ``calibration`` and sources."""
    if ranks < 1:
        raise ValueError("capacity_plan needs ranks >= 1")
    if control_plane_data is None:
        raise ValueError("capacity_plan needs a control-plane artifact")
    from ..common.config import DEFAULT_COMM_TIMEOUT_SECONDS

    cal = control_plane_from_artifact(control_plane_data)
    if comm_timeout_s is None:
        comm_timeout_s = DEFAULT_COMM_TIMEOUT_SECONDS
    if heartbeat_interval_s is None:
        heartbeat_interval_s = min(10.0, comm_timeout_s / 4.0)

    window_s = step_window_s
    buckets = None
    if overlap_data is not None:
        # Overlap probe artifacts nest the measured step under
        # median_step_report; the raw measured_overlap_report shape is
        # flat. Accept both.
        report = overlap_data.get("median_step_report") or overlap_data
        if window_s is None:
            window_s = report.get("compute_window_s")
        buckets = report.get("buckets", overlap_data.get("buckets"))
    if buckets is None:
        buckets = 4  # the probe default; overridden by real artifacts

    planes = {}

    def _plane(name, predicted, budget, budget_desc, sat, residual,
               note=None):
        entry = {
            "predicted_seconds": round(float(predicted), 6),
            "budget_seconds": (round(float(budget), 6)
                               if budget is not None else None),
            "budget": budget_desc,
            "saturation_ranks": sat,
            "fit_residual": residual,
            "uncertainty_seconds": (
                round(float(predicted) * residual, 6)
                if residual is not None else None),
            "hint": CAPACITY_HINTS[name],
        }
        if note:
            entry["note"] = note
        planes[name] = entry

    _plane("negotiation", cal.negotiation_seconds(ranks), window_s,
           "backward compute window per step",
           (saturation_ranks(cal.negotiation_base_s,
                             cal.negotiation_per_rank_s, window_s)
            if window_s else None),
           _curve_residual(control_plane_data, "negotiate_step_seconds"))

    _plane("reshape", cal.reshape_seconds(ranks), comm_timeout_s,
           "comm deadline (HOROVOD_COMM_TIMEOUT_SECONDS)",
           saturation_ranks(cal.reshape_base_s, cal.reshape_per_rank_s,
                            comm_timeout_s),
           _curve_residual(control_plane_data, "reshape_seconds"))

    _plane("heartbeat_fanout", cal.heartbeat_fanout_seconds(ranks),
           heartbeat_interval_s,
           "heartbeat interval (sweep must fit inside it)",
           saturation_ranks(cal.heartbeat_base_s, cal.heartbeat_per_rank_s,
                            heartbeat_interval_s),
           _curve_residual(control_plane_data, "heartbeat_fanout_seconds"))

    if restore_data is not None:
        base, per_mib = fit_restore_curve(restore_data)
        shard_mib = (model_bytes / max(1, ranks)) / _MIB
        pts = {float(s): float(e["median_s"])
               for s, e in sorted(
                   restore_data["leaf_kinds"]["jax"]["p2p"].items())
               if isinstance(e, dict) and "median_s" in e}
        residual = max((abs((base + per_mib * s) - y) / y
                        for s, y in pts.items() if y), default=None)
        _plane("restore", base + per_mib * shard_mib, comm_timeout_s,
               "comm deadline (HOROVOD_COMM_TIMEOUT_SECONDS)",
               None,  # per-rank shard SHRINKS with n: never saturates
               round(residual, 4) if residual is not None else None,
               note=("p2p restore cost falls with world size (shard = "
                     "model_bytes / ranks); not a scaling bottleneck"))

    # Overlap stall: the per-step negotiation tax the stall split
    # measured, extrapolated — `buckets` negotiation rounds per step
    # must fit inside the backward window or gradients wait on the
    # control plane instead of the wire.
    stall = buckets * cal.negotiation_seconds(ranks)
    _plane("overlap_stall", stall, window_s,
           "backward compute window per step "
           f"({buckets} negotiation rounds)",
           (saturation_ranks(buckets * cal.negotiation_base_s,
                             buckets * cal.negotiation_per_rank_s,
                             window_s)
            if window_s else None),
           _curve_residual(control_plane_data, "negotiate_step_seconds"),
           note=None if window_s else (
               "no overlap artifact/step window given: stall reported "
               "without a saturation point"))

    first = None
    for name in CAPACITY_PLANES:
        entry = planes.get(name)
        if entry is None or entry["saturation_ranks"] is None:
            continue
        if first is None or (entry["saturation_ranks"]
                             < planes[first]["saturation_ranks"]):
            first = name
    bottleneck = None
    if first is not None:
        e = planes[first]
        bottleneck = {
            "plane": first,
            "saturation_ranks": e["saturation_ranks"],
            "summary": (
                f"{first} saturates its budget "
                f"({e['budget_seconds']}s — {e['budget']}) at "
                f"~{e['saturation_ranks']} ranks; at {ranks} ranks the "
                f"modeled cost is {e['predicted_seconds']}s"
                + (f" (±{e['uncertainty_seconds']}s fit uncertainty)"
                   if e["uncertainty_seconds"] is not None else "")),
            "hint": e["hint"],
        }
    return {
        "ranks": ranks,
        "model_bytes": int(model_bytes),
        "planes": {name: planes[name] for name in CAPACITY_PLANES
                   if name in planes},
        "first_bottleneck": bottleneck,
        "calibration": dataclasses.asdict(cal),
        "calibration_source": cal.source,
    }


def recommend_autotune_seeds(cal: ControlPlaneCalibration, ranks: int,
                             reference_ranks: int = 64) -> Dict[str, int]:
    """Planner-predicted warm-start seeds for the GP autotuner
    (``HOROVOD_AUTOTUNE_PRIORS=capacity``, docs/autotune.md): as the
    calibrated negotiation round gets costlier with world size, the
    right starting bucket grows proportionally (fewer rounds per step)
    and the ring chunk with its square root (pipelining still wants
    depth). A deterministic heuristic snapped to the tuner's own
    power-of-two grid — a SEED the search refines, not a pin."""
    import math

    from ..common.config import DEFAULT_BUCKET_BYTES

    ref = max(1e-9, cal.negotiation_seconds(reference_ranks))
    ratio = max(1e-9, cal.negotiation_seconds(max(1, ranks))) / ref
    bucket_log2 = round(math.log2(DEFAULT_BUCKET_BYTES) + math.log2(ratio))
    bucket_log2 = min(26, max(21, bucket_log2))
    chunk_log2 = round(18 + math.log2(ratio) / 2.0)
    chunk_log2 = min(21, max(16, chunk_log2))
    return {"bucket_bytes": 1 << bucket_log2,
            "ring_chunk_bytes": 1 << chunk_log2}
