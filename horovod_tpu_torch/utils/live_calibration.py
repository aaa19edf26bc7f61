"""Live calibration plane: the port's own copy of the JAX package's
``utils/live_calibration.py``.

The capacity planner extrapolates from *committed* artifacts; this
module drives it from a running job's own telemetry. The rank-0 window
roller (``horovod_tpu_torch.metrics.WindowRoller``) hands each completed delta
window to :func:`on_window`, which feeds the window's control-plane
histogram deltas (negotiation cycles, reshapes, restores) at the
current ``hvd_membership_size`` into a bounded-horizon online re-fit
built on the same ``fit_linear_relative`` the committed artifacts use.
The result is consumed three ways:

* ``capacity_live.json`` — the exact ``capacity_r17.json`` schema,
  stamped ``"source": "live"``, persisted under
  ``HOROVOD_CAPACITY_LIVE_DIR`` every
  ``HOROVOD_CAPACITY_REFIT_WINDOWS`` windows and at shutdown, so
  ``tools/capacity.py --live DIR`` and
  ``control_plane_from_artifact`` work unchanged on live output.
* the ``calibration_drift`` doctor rule (``doctor/rules.py``), which
  compares the live per-rank slopes against the committed
  calibration's with the artifact's own ``fit_residual`` as the noise
  floor.
* the ``hvd_capacity_drift_ratio{plane}`` gauges and
  ``hvd_capacity_refits_total`` counter, so dashboards see the drift
  the moment it opens.

The horizon is a deque of the last N per-window samples (default 8),
so a transient slowdown HEALS as healthy windows displace it — the
lifetime-cumulative dilution problem the windowed telemetry exists to
fix. Everything here is observer-driven and inert unless a roller
runs; nothing registers metrics at import time.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Optional

from ..analysis.lockorder import make_lock

# Live slope must exceed committed slope by this factor (scaled up by
# the committed fit's own residual) before calibration_drift fires.
CALIBRATION_DRIFT_FACTOR = 2.0

# How many per-window samples the online re-fit remembers. Small enough
# that a healed job's drift ratio decays within one horizon, large
# enough that one noisy window cannot swing the fit.
DEFAULT_HORIZON_WINDOWS = 8

# plane -> (histogram series in the window deltas, control-plane row key)
PLANE_SERIES = {
    "negotiation": ("hvd_controller_cycle_seconds",
                    "negotiate_step_seconds"),
    "reshape": ("hvd_elastic_reshape_seconds", "reshape_seconds"),
    "restore": ("hvd_elastic_restore_seconds", "restore_seconds"),
}

LIVE_ARTIFACT_NAME = "capacity_live.json"


def _plane_delta(window: dict, series: str) -> "tuple[float, int]":
    """(sum_seconds, observations) for one histogram series across every
    rank's delta in the window."""
    total_sum = 0.0
    total_count = 0
    for snap in window.get("snapshots", {}).values():
        entry = snap.get(series)
        if not entry or entry.get("type") != "histogram":
            continue
        for _, value in entry.get("values", []):
            total_sum += float(value.get("sum", 0.0))
            total_count += int(value.get("count", 0))
    return total_sum, total_count


def _window_world_size(window: dict) -> int:
    """Membership size during the window — the gauge passes through the
    delta algebra, so this is the CURRENT size, falling back to the
    number of ranks the window observed."""
    best = 0
    for snap in window.get("snapshots", {}).values():
        entry = snap.get("hvd_membership_size")
        if not entry:
            continue
        for _, value in entry.get("values", []):
            try:
                best = max(best, int(value))
            except (TypeError, ValueError):
                continue
    return best or max(1, len(window.get("snapshots", {})))


class LiveCalibration:
    """Online control-plane re-fit over a bounded horizon of telemetry
    windows. ``ingest_window`` extracts one per-plane (mean seconds,
    observations) sample per window; ``refit`` groups the horizon's
    samples by world size into the measured-rows shape
    ``control_plane_report`` fits, producing a ``capacity_r17.json``-
    schema artifact stamped ``"source": "live"``."""

    def __init__(self, horizon_windows: int = DEFAULT_HORIZON_WINDOWS):
        self.horizon_windows = max(1, int(horizon_windows))
        self._lock = make_lock("livecal.samples")
        self._samples: "collections.deque" = collections.deque(
            maxlen=self.horizon_windows)
        self._ingested = 0
        self._world = 1

    @property
    def windows_ingested(self) -> int:
        with self._lock:
            return self._ingested

    def ingest_window(self, window: dict) -> dict:
        """Fold one completed window into the horizon; returns the
        extracted sample (tests assert on it)."""
        planes = {}
        for plane, (series, _) in PLANE_SERIES.items():
            total, count = _plane_delta(window, series)
            planes[plane] = {"sum": total, "count": count}
        sample = {"world": _window_world_size(window), "planes": planes}
        with self._lock:
            self._samples.append(sample)
            self._ingested += 1
            self._world = sample["world"]
        return sample

    def _rows(self) -> Dict[int, dict]:
        """Horizon samples grouped by world size into measured rows:
        per-plane observation-weighted mean seconds."""
        with self._lock:
            samples = list(self._samples)
        acc: Dict[int, Dict[str, List[float]]] = {}
        for sample in samples:
            by_plane = acc.setdefault(sample["world"], {})
            for plane, cell in sample["planes"].items():
                if cell["count"] <= 0:
                    continue
                slot = by_plane.setdefault(plane, [0.0, 0])
                slot[0] += cell["sum"]
                slot[1] += cell["count"]
        rows: Dict[int, dict] = {}
        for world, by_plane in sorted(acc.items()):
            row = {}
            for plane, (series, row_key) in PLANE_SERIES.items():
                slot = by_plane.get(plane)
                if slot and slot[1] > 0:
                    row[row_key] = slot[0] / slot[1]
            if row:
                rows[world] = row
        return rows

    def observations(self, plane: str) -> int:
        """Total horizon observations for one plane (rule gates)."""
        with self._lock:
            samples = list(self._samples)
        return sum(s["planes"].get(plane, {}).get("count", 0)
                   for s in samples)

    def refit(self) -> Optional[dict]:
        """Re-fit the curves from the horizon; None while no plane has
        a single observation yet. The returned dict is byte-compatible
        with the committed ``capacity_r17.json`` control-plane schema
        (``control_plane_from_artifact`` loads it unchanged) and is
        stamped ``substrate``/``source`` = ``"live"``."""
        from .scaling_model import control_plane_report

        rows = self._rows()
        if not rows:
            return None
        report = control_plane_report(rows, relative=True)
        report["calibration"]["source"] = "live"
        artifact = {
            "world_sizes": sorted(rows),
            "control_plane": {str(n): dict(row)
                              for n, row in sorted(rows.items())},
            **report,
            "substrate": "live",
            "source": "live",
            "windows": self.windows_ingested,
            "horizon_windows": self.horizon_windows,
            "observations": {plane: self.observations(plane)
                             for plane in sorted(PLANE_SERIES)},
        }
        return artifact

    def summary(self) -> Optional[dict]:
        """Compact live view for the doctor's evidence bundle: per-plane
        live base/slope plus the observation counts the drift rule
        gates on. None while nothing was observed."""
        artifact = self.refit()
        if artifact is None:
            return None
        cal = artifact["calibration"]
        from .scaling_model import fit_linear_relative

        rows = self._rows()
        restore_pts = {n: row["restore_seconds"]
                       for n, row in rows.items()
                       if row.get("restore_seconds") is not None}
        restore_base, restore_slope = (
            fit_linear_relative(restore_pts) if restore_pts
            else (0.0, 0.0))
        with self._lock:
            world = self._world
            windows_with = {
                plane: sum(1 for s in self._samples
                           if s["planes"].get(plane, {}).get("count", 0)
                           > 0)
                for plane in PLANE_SERIES}
        planes = {
            "negotiation": {
                "live_base_s": cal["negotiation_base_s"],
                "live_per_rank_s": cal["negotiation_per_rank_s"],
            },
            "reshape": {
                "live_base_s": cal["reshape_base_s"],
                "live_per_rank_s": cal["reshape_per_rank_s"],
            },
            "restore": {
                "live_base_s": restore_base,
                "live_per_rank_s": restore_slope,
            },
        }
        for plane in planes:
            planes[plane]["observations"] = self.observations(plane)
            planes[plane]["windows"] = windows_with[plane]
        return {
            "source": "live",
            "windows_ingested": self.windows_ingested,
            "horizon_windows": self.horizon_windows,
            "world_size": world,
            "planes": planes,
        }


def summary_from_artifact(data: dict) -> Optional[dict]:
    """Rebuild a :meth:`LiveCalibration.summary`-shaped dict from a
    persisted ``capacity_live.json`` so the ``calibration_drift`` rule
    can run OFFLINE over what a dead job left on disk. None when the
    dict is not a live artifact (wrong schema, or a committed
    calibration — those must never masquerade as live evidence)."""
    if not isinstance(data, dict) or data.get("source") != "live":
        return None
    cal = data.get("calibration")
    if not isinstance(cal, dict) or not cal:
        return None
    from .scaling_model import fit_linear_relative

    restore_pts = {}
    for n, row in (data.get("control_plane") or {}).items():
        try:
            val = row.get("restore_seconds")
        except AttributeError:
            return None
        if val is not None:
            restore_pts[int(n)] = float(val)
    restore_base, restore_slope = (
        fit_linear_relative(restore_pts) if restore_pts else (0.0, 0.0))
    observations = data.get("observations") or {}
    planes = {
        "negotiation": {
            "live_base_s": cal.get("negotiation_base_s", 0.0),
            "live_per_rank_s": cal.get("negotiation_per_rank_s", 0.0),
        },
        "reshape": {
            "live_base_s": cal.get("reshape_base_s", 0.0),
            "live_per_rank_s": cal.get("reshape_per_rank_s", 0.0),
        },
        "restore": {
            "live_base_s": restore_base,
            "live_per_rank_s": restore_slope,
        },
    }
    windows = int(data.get("windows", 0))
    for plane in planes:
        planes[plane]["observations"] = int(observations.get(plane, 0))
        # The artifact doesn't record per-plane window counts; the
        # fitted horizon is the honest upper bound.
        planes[plane]["windows"] = windows
    worlds = data.get("world_sizes") or [1]
    return {
        "source": "live",
        "windows_ingested": windows,
        "horizon_windows": int(data.get("horizon_windows", 0)),
        "world_size": int(max(worlds)),
        "planes": planes,
    }


def drift_report(live_summary: dict, committed: dict) -> Dict[str, dict]:
    """Pure comparison of a live summary against a committed
    control-plane artifact: per-plane ``ratio`` (live per-rank slope /
    committed per-rank slope) and the residual-aware ``threshold``
    (``CALIBRATION_DRIFT_FACTOR * (1 + fit_residual)``) the
    ``calibration_drift`` rule fires on. Planes without an honest
    committed slope (fit clamped to zero) or without live data are
    omitted — absence of data is not drift."""
    from .scaling_model import _curve_residual, control_plane_from_artifact

    try:
        cal = control_plane_from_artifact(committed)
    except (KeyError, TypeError, ValueError):
        return {}
    committed_slopes = {
        "negotiation": ("negotiate_step_seconds",
                        cal.negotiation_per_rank_s),
        "reshape": ("reshape_seconds", cal.reshape_per_rank_s),
    }
    out: Dict[str, dict] = {}
    for plane, (key, committed_slope) in sorted(committed_slopes.items()):
        entry = (live_summary.get("planes") or {}).get(plane)
        if not entry or committed_slope <= 0.0:
            continue
        live_slope = float(entry.get("live_per_rank_s", 0.0))
        residual = _curve_residual(committed, key) or 0.0
        out[plane] = {
            "live_per_rank_s": round(live_slope, 9),
            "committed_per_rank_s": round(committed_slope, 9),
            "ratio": round(live_slope / committed_slope, 4),
            "fit_residual": residual,
            "threshold": round(
                CALIBRATION_DRIFT_FACTOR * (1.0 + residual), 4),
            "observations": int(entry.get("observations", 0)),
            "windows": int(entry.get("windows", 0)),
        }
    return out


# ---------------------------------------------------------------------------
# Process-wide live instance + roller observer (rank 0 wiring)

_state_lock = make_lock("livecal.state")
_live: Optional[LiveCalibration] = None
_committed_cache: "tuple[Optional[str], Optional[dict]] | None" = None
_m = None


def _live_metrics():
    """Lazy registration (tests/test_metrics_lint.py: never at import
    time); this module owns the live-calibration series."""
    global _m
    if _m is None:
        from types import SimpleNamespace

        from .. import metrics

        _m = SimpleNamespace(
            refits=metrics.counter(
                "hvd_capacity_refits_total",
                "Live control-plane re-fits committed (every "
                "HOROVOD_CAPACITY_REFIT_WINDOWS telemetry windows)"),
            drift=metrics.gauge(
                "hvd_capacity_drift_ratio",
                "Live per-rank control-plane slope over the committed "
                "calibration's, per plane — the calibration_drift rule "
                "fires past 2x(1+fit_residual) (docs/capacity.md)",
                ("plane",)))
    return _m


def get() -> Optional[LiveCalibration]:
    with _state_lock:
        return _live


def ensure() -> LiveCalibration:
    global _live
    with _state_lock:
        if _live is None:
            _live = LiveCalibration()
        return _live


def live_summary() -> Optional[dict]:
    """The live instance's summary, or None when no window was ever
    ingested (Evidence.live() feeds this to the drift rule)."""
    live = get()
    return live.summary() if live is not None else None


def _load_committed() -> Optional[dict]:
    """The committed calibration artifact named by
    ``HOROVOD_CAPACITY_CALIBRATION``, cached per path (the observer
    runs every window; re-reading a static artifact each roll would be
    pure waste)."""
    global _committed_cache
    from ..common.config import capacity_calibration_path

    path = capacity_calibration_path()
    if not path:
        return None
    with _state_lock:
        if _committed_cache is not None and _committed_cache[0] == path:
            return _committed_cache[1]
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = None
    if data is not None and not data.get("control_plane"):
        data = None
    with _state_lock:
        _committed_cache = (path, data)
    return data


def on_window(window: dict) -> None:
    """The window roller's observer: ingest the window, mirror the
    drift gauges against the committed calibration, and re-fit/persist
    every ``HOROVOD_CAPACITY_REFIT_WINDOWS`` windows. Never raises —
    the roller swallows observer errors, but a telemetry consumer
    should not even get that far."""
    from .. import metrics

    if not metrics.on():
        return
    from ..common.config import capacity_live_dir, capacity_refit_windows

    live = ensure()
    live.ingest_window(window)
    summary = live.summary()
    if summary is None:
        return
    committed = _load_committed()
    if committed is not None:
        m = _live_metrics()
        for plane, row in sorted(drift_report(summary, committed).items()):
            m.drift.labels(plane).set(row["ratio"])
    if live.windows_ingested % capacity_refit_windows() == 0:
        _live_metrics().refits.inc()
        out_dir = capacity_live_dir()
        if out_dir:
            persist(out_dir)


def persist(out_dir: str) -> Optional[str]:
    """Atomically write ``capacity_live.json`` under ``out_dir``;
    returns the path, or None when there is nothing fitted yet."""
    live = get()
    artifact = live.refit() if live is not None else None
    if artifact is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, LIVE_ARTIFACT_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def persist_on_shutdown() -> Optional[str]:
    """Rank 0's shutdown hook: one final ``capacity_live.json`` so a
    job's whole life of telemetry survives it (no-op without
    ``HOROVOD_CAPACITY_LIVE_DIR`` or without data)."""
    from ..common.config import capacity_live_dir

    out_dir = capacity_live_dir()
    if not out_dir:
        return None
    return persist(out_dir)


def reset_for_tests() -> None:
    """Forget the live instance and the committed-artifact cache
    (called from ``metrics.reset_for_tests``)."""
    global _live, _committed_cache, _m
    with _state_lock:
        _live = None
        _committed_cache = None
        _m = None
