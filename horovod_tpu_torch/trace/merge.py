"""Merge per-rank trace files into one clock-corrected cluster trace.

Input: a trace directory holding ``trace.rank<N>.json`` files written by
:class:`~.tracer.TraceWriter` (each with a
``clock_sync`` wall anchor) and, optionally, ``clock_offsets.json``
written by the coordinator's :class:`~.clock.ClockSync`.

Output: ``merged_trace.json`` — one Chrome/Perfetto JSON array with one
process-row per rank, every timestamp rebased onto the coordinator's
clock:

    corrected_wall(rank, ts) = wall_anchor_rank - offset_rank + ts
    merged_ts                = corrected_wall - min_rank(corrected_wall(0))

so the earliest rank's trace start is t=0 and a span at the same merged
timestamp on two rows really happened at the same moment (within the
recorded offset uncertainty). Ranks missing from the offset table are
rebased with offset 0 and show up as ``synced: false`` in the metadata —
visible, not silently wrong.

The merge is a pure function of its input files (no clocks, no env), so
it is safe to run offline long after the job died. The port's copy of
``horovod_tpu/trace/merge.py``.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Optional

from .clock import load_offsets
from .tracer import MERGED_TRACE_FILE, OFFSETS_FILE

_RANK_FILE = re.compile(r"trace\.rank(\d+)\.json$")


def rank_trace_files(trace_dir: str) -> Dict[int, str]:
    """{rank: path} for every per-rank trace present in ``trace_dir``."""
    out: Dict[int, str] = {}
    for path in glob.glob(os.path.join(trace_dir, "trace.rank*.json")):
        m = _RANK_FILE.search(os.path.basename(path))
        if m:
            out[int(m.group(1))] = path
    return out


def _load_events(path: str) -> List[dict]:
    with open(path) as f:
        events = json.load(f)
    if not isinstance(events, list):
        raise ValueError(f"{path}: expected a JSON array of trace events")
    return events


def _wall_anchor(events: List[dict], path: str) -> float:
    for ev in events:
        if ev.get("name") == "clock_sync" and ev.get("ph") == "M":
            return float(ev["args"]["wall_anchor"])
    raise ValueError(
        f"{path}: no clock_sync metadata — not a mergeable rank trace")


def merge_events(per_rank: Dict[int, List[dict]],
                 offsets: Optional[Dict[int, dict]] = None) -> List[dict]:
    """Merge already-loaded per-rank event lists; returns the merged
    event list (metadata first, then spans sorted by corrected time)."""
    offsets = offsets or {}
    anchors: Dict[int, float] = {}
    corrected0: Dict[int, float] = {}
    for rank, events in per_rank.items():
        anchors[rank] = _wall_anchor(events, f"rank {rank}")
        entry = offsets.get(rank, {})
        off = float(entry.get("offset_seconds") or 0.0)
        corrected0[rank] = anchors[rank] - off
    base = min(corrected0.values())

    meta: List[dict] = []
    spans: List[dict] = []
    counts: Dict[str, int] = {}
    for rank in sorted(per_rank):
        shift_us = (corrected0[rank] - base) * 1e6
        entry = offsets.get(rank, {})
        for ev in per_rank[rank]:
            ev = dict(ev)
            ev["pid"] = rank  # one process-row per rank, whatever was stored
            if ev.get("ph") == "M":
                name = ev.get("name")
                if name == "trace_end":
                    continue  # replaced by one merged trailer
                if name == "clock_sync":
                    ev = {"name": "clock_sync", "ph": "M", "pid": rank,
                          "args": {
                              "rank": rank,
                              "wall_anchor": anchors[rank],
                              "applied_offset_seconds": float(
                                  entry.get("offset_seconds") or 0.0),
                              "uncertainty_seconds": entry.get(
                                  "uncertainty_seconds"),
                              "synced": bool(entry.get("synced", False))
                              or rank == 0,
                          }}
                meta.append(ev)
                continue
            if "ts" in ev:
                ev["ts"] = int(round(ev["ts"] + shift_us))
            spans.append(ev)
            counts[str(rank)] = counts.get(str(rank), 0) + 1
    spans.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0),
                              e.get("tid", 0), e.get("name", "")))
    trailer = {"name": "trace_end", "ph": "M", "pid": 0,
               "args": {"ranks": sorted(per_rank),
                        "events_per_rank": counts}}
    return meta + spans + [trailer]


def write_trace(events: List[dict], path: str) -> str:
    """One event per line, sorted keys: byte-stable for the golden test
    and diffable by humans. Written tmp+rename so a merge killed mid-write
    (e.g. the shutdown join timing out) can never leave a truncated file
    that downstream existence checks mistake for a complete merge."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for i, ev in enumerate(events):
            f.write(("[\n" if i == 0 else ",\n")
                    + json.dumps(ev, sort_keys=True))
        f.write("\n]\n")
    os.replace(tmp, path)
    return path


def merge_trace_dir(trace_dir: str, out_path: Optional[str] = None,
                    offsets: Optional[Dict[int, dict]] = None) -> str:
    """Merge every ``trace.rank*.json`` under ``trace_dir`` and write
    ``merged_trace.json`` (or ``out_path``). Raises if no rank traces
    exist — an empty merge would look like a successful one."""
    files = rank_trace_files(trace_dir)
    if not files:
        raise FileNotFoundError(
            f"no trace.rank*.json files under {trace_dir!r}")
    if offsets is None:
        offsets = load_offsets(os.path.join(trace_dir, OFFSETS_FILE))
    per_rank = {rank: _load_events(path) for rank, path in files.items()}
    merged = merge_events(per_rank, offsets)
    return write_trace(merged,
                       out_path or os.path.join(trace_dir,
                                                MERGED_TRACE_FILE))
