"""Evidence collection for the cluster doctor.

The doctor's rules (``doctor/rules.py``) are pure functions over ONE
bundle of observations; this module builds that bundle from either of
the two worlds the observability stack lives in:

* **Live** (:meth:`Evidence.live`) — the metrics plane: this rank's
  registry snapshot plus every worker snapshot piggybacked on controller
  ticks (the rank-0 cluster view), and the current restart epoch. Used
  by the ``/doctor`` endpoint and the coordinator's periodic sweep.
* **Artifacts** (:meth:`Evidence.from_artifacts`) — the trace plane
  left behind on disk: ``straggler_report.json`` (attributed in memory
  from the per-rank traces when missing), ``clock_offsets.json``, and
  any flight-recorder JSONL postmortems. Used by
  ``python -m horovod_tpu_torch.tools.doctor`` long after the job is gone.

Collection is read-only and best-effort: a missing or malformed
artifact yields an absent field (rules skip what they cannot see), never
an exception — the doctor must keep diagnosing a half-dead job.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional


@dataclasses.dataclass
class Evidence:
    """Everything one doctor pass may consult. All fields optional —
    each rule states its own minimum and silently stands down below it."""

    # rank -> metrics registry snapshot (hvd.metrics.snapshot() shape).
    snapshots: Dict[int, dict] = dataclasses.field(default_factory=dict)
    # straggler_report.json contents (trace/straggler.py attribute()).
    straggler_report: Optional[dict] = None
    # rank -> clock_offsets.json entry (trace/clock.py table()).
    clock: Optional[Dict[int, dict]] = None
    # Flight-recorder postmortems: one event list (parsed JSONL) per file.
    postmortems: List[List[dict]] = dataclasses.field(default_factory=list)
    # HOROVOD_RESTART_EPOCH (live) / launcher_restart count (artifacts).
    restart_epoch: int = 0
    # Control-plane calibration artifact (scaling_model shape: a
    # "control_plane" dict of measured sizes) for the capacity_headroom
    # rule. Live jobs opt in via HOROVOD_CAPACITY_CALIBRATION; offline
    # runs pick up a committed capacity/simcluster artifact beside the
    # traces when one exists.
    capacity_calibration: Optional[dict] = None
    # Completed telemetry windows (metrics.windows() shape, oldest
    # first): the windowed rules judge the RECENT windows instead of
    # lifetime-cumulative snapshots whenever any exist.
    windows: List[dict] = dataclasses.field(default_factory=list)
    # Live-calibration summary (utils/live_calibration.py
    # LiveCalibration.summary() shape) for the calibration_drift rule.
    # Live jobs carry the in-process re-fit; offline runs rebuild an
    # equivalent summary from a persisted capacity_live.json.
    live_calibration: Optional[dict] = None
    # "live" or "artifacts:<dir>" — recorded in the report for operators.
    source: str = "live"

    @classmethod
    def live(cls) -> "Evidence":
        """This process's registry + the piggybacked worker snapshots.
        On rank 0 that is the whole job; on a worker it is one rank."""
        from .. import metrics
        from ..common.config import (
            capacity_calibration_path,
            env_rank,
            restart_epoch,
        )

        from ..utils import live_calibration

        local = env_rank() or 0
        snapshots = {local: metrics.snapshot()}
        for rank, snap in sorted(metrics.remote_snapshots().items()):
            snapshots.setdefault(int(rank), snap)
        calibration = None
        cal_path = capacity_calibration_path()
        if cal_path:
            calibration = _load_json(cal_path)
        return cls(snapshots=snapshots, restart_epoch=restart_epoch(),
                   capacity_calibration=calibration,
                   windows=metrics.windows(),
                   live_calibration=live_calibration.live_summary(),
                   source="live")

    @classmethod
    def from_artifacts(cls, path: str) -> "Evidence":
        """Everything diagnosable in an artifact directory (a traced
        job's ``HOROVOD_TRACE_DIR``, possibly also holding flight-recorder
        dumps). Read-only: a missing straggler report is attributed in
        memory from the per-rank traces, never written back."""
        from ..trace import (
            MERGED_TRACE_FILE,
            OFFSETS_FILE,
            REPORT_FILE,
            load_offsets,
            merge_events,
            rank_trace_files,
        )
        from ..trace.straggler import attribute

        report = _load_json(os.path.join(path, REPORT_FILE))
        clock = load_offsets(os.path.join(path, OFFSETS_FILE)) or None
        if report is None:
            events = _load_json(os.path.join(path, MERGED_TRACE_FILE))
            if events is None:
                files = rank_trace_files(path)
                if files:
                    per_rank = {}
                    for rank, file_path in sorted(files.items()):
                        loaded = _load_json(file_path)
                        if isinstance(loaded, list):
                            per_rank[rank] = loaded
                    if per_rank:
                        try:
                            events = merge_events(per_rank, clock or {})
                        except ValueError:
                            events = None
            if isinstance(events, list):
                # feed=False: an offline diagnosis must not mutate (or
                # require) a live metrics registry.
                report = attribute(events, feed=False)
        if report is not None and clock is None and report.get("clock"):
            clock = {int(r): entry
                     for r, entry in sorted(report["clock"].items())}
        postmortems = _load_postmortems(path)
        restarts = sum(
            1 for events in postmortems for ev in events
            if ev.get("kind") == "launcher_restart")
        calibration = None
        for name in ("capacity_r17.json", "simcluster_r13.json"):
            loaded = _load_json(os.path.join(path, name))
            if loaded and loaded.get("control_plane"):
                calibration = loaded
                break
        # A dead job's persisted live re-fit (capacity_live.json) lets
        # the drift rule run offline against the committed calibration
        # found beside it.
        live_summary = None
        live_artifact = _load_json(os.path.join(path, "capacity_live.json"))
        if live_artifact is not None:
            from ..utils.live_calibration import summary_from_artifact

            live_summary = summary_from_artifact(live_artifact)
        return cls(straggler_report=report, clock=clock,
                   postmortems=postmortems, restart_epoch=restarts,
                   capacity_calibration=calibration,
                   live_calibration=live_summary,
                   source=f"artifacts:{path}")

    def ranks_observed(self) -> List[int]:
        ranks = set(self.snapshots)
        if self.straggler_report:
            ranks.update(int(r) for r in
                         self.straggler_report.get("ranks", []))
        if self.clock:
            ranks.update(int(r) for r in self.clock)
        for events in self.postmortems:
            for ev in events:
                if "rank" in ev:
                    ranks.add(int(ev["rank"]))
        return sorted(ranks)


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _load_postmortems(path: str) -> List[List[dict]]:
    """Parse every flight-recorder dump under ``path``: any ``*.jsonl*``
    file whose first line is a ``flight_recorder_dump`` header (the
    recorder's ``{rank}``/``.rankN`` expansion makes names vary)."""
    out: List[List[dict]] = []
    for file_path in sorted(glob.glob(os.path.join(path, "*.jsonl*"))):
        if ".tmp." in os.path.basename(file_path):
            # A dump killed between temp-write and os.replace leaves its
            # private temp file behind; counting it would double every
            # event the completed dump also carries.
            continue
        events: List[dict] = []
        try:
            with open(file_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        events.append(json.loads(line))
        except (OSError, ValueError):
            continue
        if events and events[0].get("kind") == "flight_recorder_dump":
            out.append(events)
    return out
