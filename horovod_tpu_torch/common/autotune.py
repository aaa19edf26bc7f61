"""Autotuning: Bayesian optimization of fusion threshold + cycle time —
the port's copy of ``horovod_tpu/common/autotune.py`` (numpy only).

Reference: ``horovod/common/parameter_manager.{h,cc}`` (tunable-parameter
stack scored by observed bytes/sec) driven by
``common/optim/bayesian_optimization.cc`` + ``common/optim/gaussian_process.cc``
(GP surrogate + expected-improvement acquisition, Eigen + L-BFGS). Same
architecture here in numpy: a GP with RBF kernel models score(params); each
tuning step scores the current configuration over a sample window, then
moves to the acquisition argmax (random-candidate search instead of L-BFGS —
two smooth dimensions need no quasi-Newton machinery).

Tuned knobs (the reference's full set, ``parameter_manager.h:35-85``):
  * fusion threshold, log2-bytes in [20, 28]  (1 MiB .. 256 MiB)
  * cycle time, ms in [1, 25]
  * hierarchical allreduce / hierarchical allgather / cache enabled —
    categorical, coordinate-descent (CategoricalParameter analogue)
Each knob honors a ``fixed=`` override when the user's env supplies an
explicit value (reference ``operations.cc:1005-1049``).

Enabled by ``HOROVOD_AUTOTUNE``; per-step CSV via ``HOROVOD_AUTOTUNE_LOG``
(reference ``operations.cc:1074-1078``). The coordinator tunes and the new
values ride the cycle reply to all ranks (reference ``SyncParams``,
``parameter_manager.cc:223``).

Straggler-aware scoring (no reference counterpart; it reads the
observability planes): when ``straggler_weight`` > 0,
each cycle may carry the coordinator's observed negotiation slack (how
late the slowest rank's tick arrived beyond the pacing bound) and its
total excess recv-wait; a configuration's score becomes

    score = median(bytes/sec) / (1 + w*slack_frac + w*wait_frac)

with both penalty terms medians of the per-cycle fractions
``slack/seconds`` — a scale-free "fraction of the cycle spent waiting
on stragglers". Two configurations with identical throughput therefore
rank strictly by their slack, and the per-step log records every
component so the blend is auditable after the fact.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np


class GaussianProcess:
    """GP regression, RBF kernel + noise (reference
    ``optim/gaussian_process.{h,cc}``)."""

    def __init__(self, length_scale: float = 1.0, signal_var: float = 1.0,
                 noise_var: float = 1e-4):
        self.length_scale = length_scale
        self.signal_var = signal_var
        self.noise_var = noise_var
        self._x: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._chol: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.signal_var * np.exp(-0.5 * d2 / self.length_scale ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        k = self._kernel(self._x, self._x)
        k[np.diag_indices_from(k)] += self.noise_var
        self._chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, y))

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        x = np.asarray(x, dtype=np.float64)
        ks = self._kernel(x, self._x)
        mu = ks @ self._alpha
        v = np.linalg.solve(self._chol, ks.T)
        var = np.maximum(
            self.signal_var - (v ** 2).sum(0), 1e-12)
        return mu, np.sqrt(var)


def _norm_pdf(z):
    return np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)


def _norm_cdf(z):
    from math import erf

    return 0.5 * (1.0 + np.vectorize(erf)(z / np.sqrt(2.0)))


class BayesianOptimizer:
    """Expected-improvement Bayesian optimization over a box (reference
    ``optim/bayesian_optimization.{h,cc}``: EI acquisition, xi=0.01)."""

    def __init__(self, bounds: List[Tuple[float, float]], xi: float = 0.01,
                 seed: int = 0):
        self.bounds = np.asarray(bounds, dtype=np.float64)
        self.xi = xi
        self._rng = np.random.RandomState(seed)
        self._x: List[np.ndarray] = []
        self._y: List[float] = []
        self.gp = GaussianProcess(length_scale=0.25)

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (x - lo) / (hi - lo)

    def add_sample(self, x, y: float) -> None:
        self._x.append(self._normalize(np.asarray(x, dtype=np.float64)))
        self._y.append(float(y))

    def suggest(self, n_candidates: int = 512) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        if len(self._x) < 2:
            return lo + self._rng.rand(len(self.bounds)) * (hi - lo)
        x = np.stack(self._x)
        y = np.asarray(self._y)
        # Normalize scores for GP conditioning.
        y_mean, y_std = y.mean(), max(y.std(), 1e-9)
        self.gp.fit(x, (y - y_mean) / y_std)
        cand = self._rng.rand(n_candidates, len(self.bounds))
        mu, sigma = self.gp.predict(cand)
        best = ((y - y_mean) / y_std).max()
        imp = mu - best - self.xi
        z = imp / sigma
        ei = imp * _norm_cdf(z) + sigma * _norm_pdf(z)
        pick = cand[int(np.argmax(ei))]
        return lo + pick * (hi - lo)


# The reference's full categorical knob set (parameter_manager.h:66-85):
# hierarchical allreduce, hierarchical allgather, response-cache enable.
CATEGORICAL_KNOBS = ("hierarchical_allreduce", "hierarchical_allgather",
                     "cache_enabled")
# Continuous knobs, for ``fixed=`` spelling. ``ring_chunk`` is
# the native ring's transfer-chunk size — per-rank pipelining granularity
# for the reduce-while-receive sink and the compress-ahead cursor
# (docs/wire-compression.md); it only joins the search when the caller
# provides an initial value (a job without the native ring has no chunk
# to tune).
CONTINUOUS_KNOBS = ("fusion_threshold", "cycle_time", "ring_chunk",
                    "bucket_bytes")
# log2-bytes box for the ring chunk: 64 KiB .. 2 MiB, bracketing the
# per-link-class defaults (config.RING_CHUNK_BYTES_BY_LINK).
RING_CHUNK_LOG2_BOUNDS = (16.0, 21.0)
# log2-bytes box for the backward-order gradient bucket
# (docs/overlap.md): 2 MiB .. 64 MiB, bracketing the 8 MiB default —
# small buckets launch reductions earlier (more overlap), big buckets
# amortize negotiation; the sweet spot is workload-dependent, which is
# why it joins the search.
BUCKET_BYTES_LOG2_BOUNDS = (21.0, 26.0)


class ParameterManager:
    """Scores the live configuration by observed throughput and proposes the
    next one (reference ``parameter_manager.cc:155-222`` Update/Tune).

    Joint parameter set at reference parity (``parameter_manager.h:35-85``):
    the continuous (fusion threshold, cycle time) pair under Bayesian
    optimization, plus the categorical knobs {hierarchical allreduce,
    hierarchical allgather, cache enabled} explored by coordinate descent —
    each unfixed knob is visited in turn, both values held for a few BO
    steps, the better locked in, over ``CATEGORY_SWEEPS`` passes.

    ``fixed`` mirrors the reference's per-knob ``fixed=`` override
    (``SetTensorFusionThresholdBytes(v, true)`` etc., set when the user's
    env provides an explicit value, ``operations.cc:1005-1049``): a fixed
    knob keeps its initial value and is excluded from the search.
    """

    WARMUP_SAMPLES = 3      # discarded after every parameter change
    SAMPLES_PER_STEP = 10   # scored cycles per configuration
    CATEGORY_STEPS = 3      # BO steps per categorical value visit
    CATEGORY_SWEEPS = 2     # full passes over the categorical knobs
    # Tuning FINISHES: after this many scored BO configurations (and the
    # categorical sweeps are done) the manager pins the best-seen
    # configuration and stops — the reference's BAYES_OPT_MAX_SAMPLES=20 +
    # SetAutoTuning(false) + BestValue() contract
    # (parameter_manager.cc:30,210,473-475). Without termination the
    # search pays exploration cost for the whole job; with noisy scores
    # (timeshared CPUs) it can wander indefinitely.
    BO_MAX_STEPS = 20

    def __init__(self, fusion_threshold: int, cycle_time_ms: float,
                 log_path: Optional[str] = None, seed: int = 0,
                 categoricals: Optional[dict] = None,
                 fixed=frozenset(),
                 tune_hierarchical: bool = False,
                 hierarchical: bool = False,
                 straggler_weight: float = 0.0,
                 ring_chunk_bytes: Optional[int] = None,
                 bucket_bytes: Optional[int] = None,
                 overlap_weight: float = 0.0):
        # Legacy spelling (older callers and tests): hierarchical allreduce
        # only, tuned iff tune_hierarchical.
        if categoricals is None:
            categoricals = {"hierarchical_allreduce": hierarchical}
            if not tune_hierarchical:
                fixed = set(fixed) | {"hierarchical_allreduce"}
        self.fixed = frozenset(fixed)
        # Ring transfer chunk joins the BO box as a third dimension only
        # when the caller supplies an initial value AND the knob isn't
        # pinned — jobs without the native ring keep the original 2-D
        # search (and its exact behavior) bit for bit.
        self._tune_chunk = (ring_chunk_bytes is not None
                            and "ring_chunk" not in self.fixed)
        # Gradient-bucket size joins on the same terms: only
        # when the caller supplies an initial value and the env didn't
        # pin it — jobs without the bucket scheduler keep their exact
        # search box.
        self._tune_bucket = (bucket_bytes is not None
                             and "bucket_bytes" not in self.fixed)
        bounds = [(20.0, 28.0), (1.0, 25.0)]  # (log2 fusion bytes, cycle ms)
        if self._tune_chunk:
            bounds.append(RING_CHUNK_LOG2_BOUNDS)  # log2 chunk bytes
        if self._tune_bucket:
            bounds.append(BUCKET_BYTES_LOG2_BOUNDS)  # log2 bucket bytes
        self._bo = BayesianOptimizer(bounds, seed=seed)
        # Exact pinned values for fixed knobs: a log2/2** round trip would
        # drift a non-power-of-two user threshold.
        self._initial_threshold = int(fusion_threshold)
        self._initial_cycle_ms = float(cycle_time_ms)
        self.fusion_threshold = int(fusion_threshold)
        self.cycle_time_ms = float(cycle_time_ms)
        self.ring_chunk_bytes = (int(ring_chunk_bytes)
                                 if ring_chunk_bytes is not None else None)
        self.best_ring_chunk_bytes = self.ring_chunk_bytes
        self.bucket_bytes = (int(bucket_bytes)
                             if bucket_bytes is not None else None)
        self.best_bucket_bytes = self.bucket_bytes
        self.categoricals = {k: bool(v) for k, v in categoricals.items()}
        self._warmup_left = self.WARMUP_SAMPLES
        self._scores: List[float] = []
        # Per-cycle straggler cost as a fraction of the cycle: slack
        # (worst rank's lateness) and excess recv-wait, both reset with
        # the score window on every parameter change.
        self.straggler_weight = max(0.0, float(straggler_weight))
        self._slack_fracs: List[float] = []
        self._wait_fracs: List[float] = []
        # Overlap-aware scoring (docs/overlap.md): when the
        # bucket scheduler publishes a measured backward/comm overlap
        # efficiency, the blend rewards it — the tuner then optimizes
        # step time, not just wire bandwidth. 0 (the default, and every
        # earlier caller) keeps the objective bit-identical.
        self.overlap_weight = max(0.0, float(overlap_weight))
        self._overlaps: List[float] = []
        self._bo_steps = 0
        self._completed = False
        self._log_path = log_path
        self._log_header_due = log_path is not None
        self._best_score = -np.inf
        # Components of the most recently scored configuration (and of
        # the best-seen one) — the hvd_autotune_* gauges and the doctor's
        # wandering-search rule read these.
        self.last_objective: Optional[dict] = None
        self.best_objective: Optional[dict] = None
        self.best_fusion_threshold = self.fusion_threshold
        self.best_cycle_time_ms = self.cycle_time_ms
        self.best_categoricals = dict(self.categoricals)
        # Coordinate-descent plan over the unfixed categoricals: per knob,
        # hold the initial value CATEGORY_STEPS BO steps, then the flipped
        # value, lock the better, move on; CATEGORY_SWEEPS full passes.
        self._cat_order = [k for k in self.categoricals
                           if k not in self.fixed]
        self._cat_pos = 0            # knob index within the sweep
        self._cat_sweep = 0
        self._cat_phase = 0          # 0 = initial value, 1 = flipped
        self._cat_steps = 0
        self._cat_phase_scores = [-np.inf, -np.inf]
        self._cats_converged = not self._cat_order

    @property
    def tunable(self) -> bool:
        """False when every knob is pinned or settled — record()
        short-circuits, so a fully-pinned (or fully-converged) job never
        pays the per-step GP Cholesky for values it would discard."""
        if self._completed:
            return False
        cats_active = bool(self._cat_order) and not self._cats_converged
        continuous_active = self._tune_chunk or self._tune_bucket or not (
            {"fusion_threshold", "cycle_time"} <= self.fixed)
        return cats_active or continuous_active

    @property
    def hierarchical(self) -> bool:  # legacy accessor
        return self.categoricals.get("hierarchical_allreduce", False)

    def _advance_categoricals(self, score: float) -> None:
        if self._cats_converged:
            return
        knob = self._cat_order[self._cat_pos]
        self._cat_phase_scores[self._cat_phase] = max(
            self._cat_phase_scores[self._cat_phase], score)
        self._cat_steps += 1
        if self._cat_steps < self.CATEGORY_STEPS:
            return
        self._cat_steps = 0
        if self._cat_phase == 0:
            self._cat_phase = 1
            self.categoricals[knob] = not self.categoricals[knob]
            return
        # Both values visited: lock the better and move to the next knob.
        keep_flipped = self._cat_phase_scores[1] > self._cat_phase_scores[0]
        if not keep_flipped:
            self.categoricals[knob] = not self.categoricals[knob]
        self._cat_phase = 0
        self._cat_phase_scores = [-np.inf, -np.inf]
        self._cat_pos += 1
        if self._cat_pos >= len(self._cat_order):
            self._cat_pos = 0
            self._cat_sweep += 1
            if self._cat_sweep >= self.CATEGORY_SWEEPS:
                self._cats_converged = True

    @staticmethod
    def blend(throughput: float, slack_frac: float, wait_frac: float,
              weight: float, overlap: Optional[float] = None,
              overlap_weight: float = 0.0) -> float:
        """The straggler-aware objective: throughput discounted by the
        fraction of each cycle spent waiting on stragglers. Strictly
        decreasing in both penalty fractions at fixed throughput, so two
        configurations with identical bytes/sec rank by their slack.
        When an ``overlap`` sample exists (the bucket scheduler's measured
        overlap efficiency in [0, 1]), the score is additionally
        multiplied by ``1 + overlap_weight * overlap`` — strictly
        increasing in overlap, and a no-op (bit-identical) when no sample
        arrived."""
        score = throughput / (1.0 + weight * max(0.0, slack_frac)
                              + weight * max(0.0, wait_frac))
        if overlap is not None:
            score *= 1.0 + overlap_weight * max(0.0, min(1.0, overlap))
        return score

    def record(self, nbytes: int, seconds: float,
               slack_seconds: float = 0.0,
               recv_wait_seconds: float = 0.0,
               overlap: Optional[float] = None
               ) -> Optional[Tuple[int, float, dict]]:
        """Feed one cycle's totals; returns new (fusion_threshold, cycle_ms,
        categoricals) when the manager moves to a new configuration, else
        None. ``slack_seconds``/``recv_wait_seconds`` are the coordinator's
        per-cycle straggler observations (worst rank's tick lateness /
        total excess tick wait); both default to 0, which reduces the
        objective to the reference's pure bytes/sec. ``overlap`` is the
        bucket scheduler's most recent measured overlap efficiency, when
        one exists — sampled per window alongside the throughput."""
        if nbytes <= 0 or seconds <= 0 or not self.tunable:
            return None
        if self._warmup_left > 0:
            self._warmup_left -= 1
            return None
        self._scores.append(nbytes / seconds)
        if self.straggler_weight > 0:
            self._slack_fracs.append(max(0.0, slack_seconds) / seconds)
            self._wait_fracs.append(max(0.0, recv_wait_seconds) / seconds)
        if self.overlap_weight > 0 and overlap is not None:
            self._overlaps.append(max(0.0, min(1.0, float(overlap))))
        if len(self._scores) < self.SAMPLES_PER_STEP:
            return None

        # MEDIAN of the per-cycle rates (reference sorts scores_ and takes
        # scores_[SAMPLES/2], parameter_manager.cc:176-180): a mean lets
        # one contended cycle on a timeshared host poison the whole
        # configuration's score. The straggler penalties get the same
        # median treatment — one contended cycle must not smear an
        # otherwise clean configuration.
        throughput = float(np.median(self._scores))  # bytes/sec
        w = self.straggler_weight
        slack_frac = (float(np.median(self._slack_fracs))
                      if self._slack_fracs else 0.0)
        wait_frac = (float(np.median(self._wait_fracs))
                     if self._wait_fracs else 0.0)
        overlap_med = (float(np.median(self._overlaps))
                       if self._overlaps else None)
        score = self.blend(throughput, slack_frac, wait_frac, w,
                           overlap=overlap_med,
                           overlap_weight=self.overlap_weight)
        self.last_objective = {
            "throughput_bytes_per_sec": throughput,
            "slack_penalty": w * slack_frac,
            "recv_wait_penalty": w * wait_frac,
            "overlap_bonus": (self.overlap_weight * overlap_med
                              if overlap_med is not None else 0.0),
            "score": score,
        }
        params = [np.log2(self.fusion_threshold), self.cycle_time_ms]
        if self._tune_chunk:
            params.append(np.log2(self.ring_chunk_bytes))
        if self._tune_bucket:
            params.append(np.log2(self.bucket_bytes))
        self._bo.add_sample(tuple(params), score)
        if score > self._best_score:
            self._best_score = score
            self.best_fusion_threshold = self.fusion_threshold
            self.best_cycle_time_ms = self.cycle_time_ms
            self.best_ring_chunk_bytes = self.ring_chunk_bytes
            self.best_bucket_bytes = self.bucket_bytes
            self.best_categoricals = dict(self.categoricals)
            self.best_objective = dict(self.last_objective)
        if self._log_path:
            cat_items = sorted(self.categoricals.items())
            chunk_col = f",{self.ring_chunk_bytes}" if self._tune_chunk \
                else ""
            bucket_col = f",{self.bucket_bytes}" if self._tune_bucket \
                else ""
            # The overlap column joins only when the term is live; it
            # sits BEFORE the throughput/penalty/score tail so the
            # score-is-last-column contract survives.
            ob = self.last_objective["overlap_bonus"]
            overlap_col = f",{ob:.6f}" if self.overlap_weight > 0 else ""
            with open(self._log_path, "a") as f:
                if self._log_header_due:
                    # Self-describing: the column set varies with the
                    # categorical knobs (and the ring-chunk knob), so
                    # name them — but only at the top of a fresh file
                    # (restarts append data rows).
                    if f.tell() == 0:
                        chunk_hdr = (",ring_chunk_bytes"
                                     if self._tune_chunk else "")
                        chunk_hdr += (",bucket_bytes"
                                      if self._tune_bucket else "")
                        overlap_hdr = (",overlap_bonus"
                                       if self.overlap_weight > 0 else "")
                        f.write("time,fusion_threshold,cycle_time_ms"
                                + chunk_hdr + ","
                                + ",".join(k for k, _ in cat_items)
                                + overlap_hdr
                                + ",throughput_bytes_per_sec,"
                                "slack_penalty,recv_wait_penalty,"
                                "score_bytes_per_sec\n")
                    self._log_header_due = False
                cats = ",".join(str(int(v)) for _, v in cat_items)
                # Log-row wall stamp, read next to other logs — not
                # duration math. hvdlint: disable=HVD004
                f.write(f"{time.time():.3f},{self.fusion_threshold},"
                        f"{self.cycle_time_ms:.3f}{chunk_col}{bucket_col},"
                        f"{cats}{overlap_col},"
                        f"{throughput:.1f},{w * slack_frac:.6f},"
                        f"{w * wait_frac:.6f},{score:.1f}\n")

        self._advance_categoricals(score)

        self._bo_steps += 1
        if self._cats_converged and self._bo_steps >= self.BO_MAX_STEPS:
            # Tuning complete: pin the best-seen configuration and stop
            # (reference SetAutoTuning(false) + BestValue(),
            # parameter_manager.cc:210,113-129). The returned tuple is
            # the final config the caller pushes down.
            self._completed = True
            self.fusion_threshold = self.best_fusion_threshold
            self.cycle_time_ms = self.best_cycle_time_ms
            self.ring_chunk_bytes = self.best_ring_chunk_bytes
            self.bucket_bytes = self.best_bucket_bytes
            self.categoricals = dict(self.best_categoricals)
            if self._log_path:
                with open(self._log_path, "a") as f:
                    f.write(f"# tuning complete: pinned "
                            f"{self.fusion_threshold},"
                            f"{self.cycle_time_ms:.3f} "
                            f"(best score {self._best_score:.1f})\n")
            return (self.fusion_threshold, self.cycle_time_ms,
                    dict(self.categoricals))

        nxt = self._bo.suggest()
        # fixed= continuous knobs keep their EXACT initial value (reference
        # TunableParameter::SetValue(value, fixed=true) semantics).
        self.fusion_threshold = (
            self._initial_threshold if "fusion_threshold" in self.fixed
            else int(2 ** nxt[0]))
        self.cycle_time_ms = (
            self._initial_cycle_ms if "cycle_time" in self.fixed
            else float(nxt[1]))
        idx = 2
        if self._tune_chunk:
            self.ring_chunk_bytes = int(2 ** nxt[idx])
            idx += 1
        if self._tune_bucket:
            self.bucket_bytes = int(2 ** nxt[idx])
        self._scores = []
        self._slack_fracs = []
        self._wait_fracs = []
        self._overlaps = []
        self._warmup_left = self.WARMUP_SAMPLES
        return (self.fusion_threshold, self.cycle_time_ms,
                dict(self.categoricals))

    @property
    def steps_scored(self) -> int:
        """Scored BO configurations so far (the gauge publisher keys its
        "something changed" check on this)."""
        return self._bo_steps

    def state(self) -> dict:
        """JSON-clean tuner state for the ``hvd_autotune_*`` gauges and
        the doctor's wandering/stalled-search rules."""
        return {
            "active": bool(self.tunable),
            "steps_completed": self._bo_steps,
            "steps_remaining": max(0, self.BO_MAX_STEPS - self._bo_steps),
            "fusion_threshold": int(self.fusion_threshold),
            "cycle_time_ms": float(self.cycle_time_ms),
            "best_fusion_threshold": int(self.best_fusion_threshold),
            "best_cycle_time_ms": float(self.best_cycle_time_ms),
            "ring_chunk_bytes": (int(self.ring_chunk_bytes)
                                 if self.ring_chunk_bytes is not None
                                 else None),
            "best_ring_chunk_bytes": (int(self.best_ring_chunk_bytes)
                                      if self.best_ring_chunk_bytes
                                      is not None else None),
            "bucket_bytes": (int(self.bucket_bytes)
                             if self.bucket_bytes is not None else None),
            "best_bucket_bytes": (int(self.best_bucket_bytes)
                                  if self.best_bucket_bytes is not None
                                  else None),
            "straggler_weight": self.straggler_weight,
            "overlap_weight": self.overlap_weight,
            "last_objective": self.last_objective,
            "best_objective": self.best_objective,
        }
