"""Controller-side autotuner construction, the port's copy of
``horovod_tpu/controller/autotune_glue.py``: every knob the user's
environment sets explicitly is pinned (``fixed=``); only the rest are
tuned. Both of the port's controllers build their rank-0
:class:`ParameterManager` here.

Also the tuner's telemetry surface: :func:`publish_tuner_gauges` mirrors
the live :meth:`ParameterManager.state` into the ``hvd_autotune_*``
gauges, so the search can be watched without parsing the autotune CSV.

Not ported yet: ``reseed_from_live``, the one-time re-seed from the
doctor's live capacity re-fit, which comes with the cluster doctor.
"""

from __future__ import annotations

import os

from .. import metrics
from ..common.autotune import ParameterManager
from ..common.config import (Config, autotune_overlap_weight,
                             autotune_straggler_weight)

# knob name -> env var whose presence fixes it (reference env surface).
_FIXING_ENV = {
    "fusion_threshold": "HOROVOD_FUSION_THRESHOLD",
    "cycle_time": "HOROVOD_CYCLE_TIME",
    "ring_chunk": "HOROVOD_RING_CHUNK_BYTES",
    "bucket_bytes": "HOROVOD_BUCKET_BYTES",
    "hierarchical_allreduce": "HOROVOD_HIERARCHICAL_ALLREDUCE",
    "hierarchical_allgather": "HOROVOD_HIERARCHICAL_ALLGATHER",
    "cache_enabled": "HOROVOD_CACHE_CAPACITY",
}


def _capacity_priors(world_size) -> "dict | None":
    """Planner-predicted warm-start seeds (HOROVOD_AUTOTUNE_PRIORS=capacity,
    docs/capacity.md): re-fit the calibration artifact named by
    HOROVOD_CAPACITY_CALIBRATION and scale the default bucket/ring-chunk
    knobs by the predicted negotiation-cost ratio at this world size.
    None (no priors) whenever the mode is off, the artifact is missing or
    unreadable, or it carries no measured points — the search then starts
    from the resolved defaults exactly as before."""
    from ..common.config import autotune_priors, capacity_calibration_path

    if autotune_priors() != "capacity":
        return None
    path = capacity_calibration_path()
    if not path:
        return None
    import json

    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if not data.get("control_plane"):
        return None
    from ..utils.scaling_model import (control_plane_from_artifact,
                                       recommend_autotune_seeds)

    try:
        cal = control_plane_from_artifact(data)
    except (KeyError, TypeError, ValueError):
        return None
    return recommend_autotune_seeds(cal, max(1, int(world_size or 1)))


def make_parameter_manager(config: Config,
                           tune_hierarchical: bool = False,
                           tune_cache: bool = False,
                           tune_ring_chunk: bool = False,
                           tune_bucket: bool = False,
                           world_size: int = 0) -> ParameterManager:
    fixed = {knob for knob, env in sorted(_FIXING_ENV.items())
             if env in os.environ}
    if not tune_hierarchical:
        # No two-level rings in this job: the hierarchical knobs have no
        # data plane to switch to — pin them at their config values (the
        # data-plane gate re-checks ring availability independently).
        fixed |= {"hierarchical_allreduce", "hierarchical_allgather"}
    if not tune_cache:
        # The native C++ engine owns its own response cache and exposes no
        # runtime toggle — exploring a knob the engine ignores would only
        # pollute the scores.
        fixed |= {"cache_enabled"}
    ring_chunk = None
    if tune_ring_chunk:
        # Only a job with the native ring data plane has a transfer chunk
        # to tune; seed the knob at the resolved (env or link-class
        # default) value so search starts from today's behavior.
        from ..common.config import resolved_ring_chunk_bytes, \
            ring_chunk_bytes

        ring_chunk = resolved_ring_chunk_bytes()
        if ring_chunk_bytes() == 0:
            # The env var may be PRESENT but say "auto" (0/empty/garbage
            # all parse to 0, the documented join-the-search sentinel) —
            # only an explicit positive value pins the knob.
            fixed.discard("ring_chunk")
    bucket = None
    if tune_bucket:
        # The gradient-bucket size (docs/overlap.md) joins on the ring
        # chunk's exact terms: seeded at the resolved value, pinned only
        # by an explicit positive HOROVOD_BUCKET_BYTES.
        from ..common.config import bucket_bytes as bucket_bytes_env
        from ..common.config import resolved_bucket_bytes

        bucket = resolved_bucket_bytes()
        if bucket_bytes_env() == 0:
            fixed.discard("bucket_bytes")
    # Capacity priors re-seed only knobs that are actually searchable —
    # an explicit env pin (membership in ``fixed``) always wins, exactly
    # as it does against the resolved defaults.
    priors = _capacity_priors(world_size)
    if priors:
        if tune_bucket and "bucket_bytes" not in fixed:
            bucket = priors["bucket_bytes"]
        if tune_ring_chunk and "ring_chunk" not in fixed:
            ring_chunk = priors["ring_chunk_bytes"]
    return ParameterManager(
        fusion_threshold=config.fusion_threshold_bytes,
        cycle_time_ms=config.cycle_time_ms,
        log_path=config.autotune_log,
        categoricals={
            "hierarchical_allreduce": config.hierarchical_allreduce,
            "hierarchical_allgather": config.hierarchical_allgather,
            "cache_enabled": config.cache_capacity > 0,
        },
        fixed=fixed,
        straggler_weight=autotune_straggler_weight(),
        overlap_weight=autotune_overlap_weight(),
        ring_chunk_bytes=ring_chunk,
        bucket_bytes=bucket,
    )


def reseed_from_live(pm: ParameterManager, world_size) -> "dict | None":
    """One-time GP re-seed from the LIVE capacity curves: when the
    doctor's ``calibration_drift`` rule confirms the committed
    calibration no longer describes this job, the in-job re-fit's curves
    replace it as the warm-start — the next scored
    configuration samples the re-seeded bucket/ring-chunk point, feeding
    the Gaussian process a fresh anchor where the LIVE cost model says
    the optimum moved.

    Returns the knobs actually moved (``{knob: bytes}``) or None when
    nothing applied: search already pinned/complete, no live re-fit yet,
    or every candidate knob env-fixed. Same precedence as the committed
    priors: an explicit env pin always wins."""
    if pm is None or not pm.tunable:
        return None
    from ..utils import live_calibration
    from ..utils.scaling_model import (control_plane_from_artifact,
                                       recommend_autotune_seeds)

    live = live_calibration.get()
    if live is None:
        return None
    artifact = live.refit()
    if not artifact or not artifact.get("control_plane"):
        return None
    try:
        cal = control_plane_from_artifact(artifact)
    except (KeyError, TypeError, ValueError):
        return None
    seeds = recommend_autotune_seeds(cal, max(1, int(world_size or 1)))
    state = pm.state()
    applied = {}
    if (state.get("bucket_bytes") is not None
            and "bucket_bytes" not in pm.fixed):
        pm.bucket_bytes = int(seeds["bucket_bytes"])
        applied["bucket_bytes"] = pm.bucket_bytes
    if (state.get("ring_chunk_bytes") is not None
            and "ring_chunk" not in pm.fixed):
        pm.ring_chunk_bytes = int(seeds["ring_chunk_bytes"])
        applied["ring_chunk_bytes"] = pm.ring_chunk_bytes
    return applied or None


_m = None


def _autotune_metrics():
    """Lazy registration (never at import time). One gauge per scalar of
    tuner state plus a component-labeled objective gauge; all live on
    the coordinator only (the tuner runs on rank 0)."""
    global _m
    if _m is None:
        from types import SimpleNamespace

        _m = SimpleNamespace(
            active=metrics.gauge(
                "hvd_autotune_active",
                "1 while the parameter search is still exploring, 0 once "
                "every knob is pinned or the search completed."),
            steps=metrics.gauge(
                "hvd_autotune_steps_completed",
                "Scored Bayesian-optimization configurations so far."),
            remaining=metrics.gauge(
                "hvd_autotune_steps_remaining",
                "BO configurations left before the search pins the best "
                "and stops."),
            threshold=metrics.gauge(
                "hvd_autotune_fusion_threshold_bytes",
                "Fusion threshold currently being explored."),
            cycle_ms=metrics.gauge(
                "hvd_autotune_cycle_time_ms",
                "Cycle time (ms) currently being explored."),
            best_threshold=metrics.gauge(
                "hvd_autotune_best_fusion_threshold_bytes",
                "Fusion threshold of the best-scoring configuration seen."),
            best_cycle_ms=metrics.gauge(
                "hvd_autotune_best_cycle_time_ms",
                "Cycle time (ms) of the best-scoring configuration seen."),
            objective=metrics.gauge(
                "hvd_autotune_objective",
                "Blended-objective components of the most recently scored "
                "configuration (docs/autotune.md): throughput_bytes_per_sec,"
                " slack_penalty, recv_wait_penalty, overlap_bonus, score.",
                ("component",)),
            best_objective=metrics.gauge(
                "hvd_autotune_best_objective",
                "Blended score of the best-seen configuration."),
        )
    return _m


def publish_tuner_gauges(pm: ParameterManager) -> None:
    """Mirror ``pm.state()`` into the ``hvd_autotune_*`` gauges. Cheap
    (a dozen locked float sets) and called only when a configuration was
    actually scored, so it never rides the per-cycle hot path."""
    if not metrics.on():
        return
    state = pm.state()
    m = _autotune_metrics()
    m.active.set(1.0 if state["active"] else 0.0)
    m.steps.set(state["steps_completed"])
    m.remaining.set(state["steps_remaining"])
    m.threshold.set(state["fusion_threshold"])
    m.cycle_ms.set(state["cycle_time_ms"])
    m.best_threshold.set(state["best_fusion_threshold"])
    m.best_cycle_ms.set(state["best_cycle_time_ms"])
    last = state["last_objective"]
    if last is not None:
        for component in ("throughput_bytes_per_sec", "slack_penalty",
                          "recv_wait_penalty", "overlap_bonus", "score"):
            m.objective.labels(component).set(last.get(component, 0.0))
    best = state["best_objective"]
    if best is not None:
        m.best_objective.set(best["score"])
