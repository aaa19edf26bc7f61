"""Buffered span writer: the port's own copy of ``TraceWriter`` and
``rank_trace_path`` from ``horovod_tpu/trace/tracer.py`` (same event
format, same fixed phase vocabulary, same file layout); its lock comes
from ``make_lock("trace.writer")``, tracked under ``HOROVOD_LOCKCHECK``.

Every file carries a ``clock_sync`` metadata event recording the
wall-clock anchor of its (monotonic) timebase, so files of several
processes can be rebased onto one clock. The phase vocabulary is FIXED:
``PHASES`` is the collective pipeline (both eager-tier controllers emit
it into ``trace.rank<N>.json``, tagged with the coordinator's collective
sequence id), ``SERVING_PHASES`` the
serving engine's iteration loop (schedule / prefill / decode, written to
``trace.serving.rank<N>.json``). Spans are buffered in memory and
written as one JSON array at ``close()``; beyond
``HOROVOD_TRACE_MAX_EVENTS`` they are dropped and counted.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from ..analysis.lockorder import make_lock
from ..common.config import trace_max_events

# The fixed phase vocabulary: one chrome "thread" per phase per rank. New
# entries append (tids are positional).
PHASES = ("enqueue", "negotiate", "fuse", "execute", "done")
SERVING_PHASES = ("schedule", "prefill", "decode")
ALL_PHASES = PHASES + SERVING_PHASES

TRACE_FILE_FMT = "trace.rank{rank}.json"
SERVING_TRACE_FILE_FMT = "trace.serving.rank{rank}.json"
MERGED_TRACE_FILE = "merged_trace.json"
OFFSETS_FILE = "clock_offsets.json"
REPORT_FILE = "straggler_report.json"


def rank_trace_path(trace_dir: str, rank: int) -> str:
    return os.path.join(trace_dir, TRACE_FILE_FMT.format(rank=rank))


class TraceWriter:
    """Buffered span writer for one rank. Thread-safe; close() is
    idempotent."""

    def __init__(self, path: str, rank: int,
                 max_events: Optional[int] = None):
        self._path = path
        self.rank = int(rank)
        self._mono0 = time.monotonic()
        self._wall0 = time.time()  # hvdlint: disable=HVD004 (anchor)
        self._max = (max_events if max_events is not None
                     else trace_max_events())
        self._lock = make_lock("trace.writer")
        self._events: list = []
        self._dropped = 0
        self._closed = False

    # -- emit ---------------------------------------------------------------

    def span(self, phase: str, t0: float, t1: float, seq: Optional[int] = None,
             op: Optional[str] = None, **args) -> None:
        """One complete ("X") event. ``t0``/``t1`` are ``time.monotonic()``
        stamps from this process; they are stored relative to the file's
        monotonic origin, which the ``clock_sync`` anchor ties to wall
        time."""
        if phase not in ALL_PHASES:
            raise ValueError(
                f"unknown trace phase {phase!r}; the vocabulary is fixed: "
                f"{ALL_PHASES}")
        a = dict(args)
        if seq is not None:
            a["seq"] = int(seq)
        if op is not None:
            a["op"] = op
        event = {
            "name": phase,
            "ph": "X",
            "pid": self.rank,
            # One chrome thread per phase: overlapping spans of DIFFERENT
            # phases (enqueue of op B during execute of op A) land on
            # separate tracks instead of mis-nesting.
            "tid": ALL_PHASES.index(phase) + 1,
            "ts": int(round((t0 - self._mono0) * 1e6)),
            "dur": max(0, int(round((t1 - t0) * 1e6))),
            "args": a,
        }
        with self._lock:
            if self._closed:
                return
            if len(self._events) >= self._max:
                self._dropped += 1
                return
            self._events.append(event)

    # -- lifecycle ----------------------------------------------------------

    def _metadata(self) -> list:
        meta = [{
            # The anchor that makes this file mergeable: absolute wall
            # clock at the monotonic origin (ts == 0), plus the rank.
            "name": "clock_sync", "ph": "M", "pid": self.rank,
            "args": {"wall_anchor": self._wall0,
                     "monotonic_origin": self._mono0,
                     "rank": self.rank},
        }, {
            "name": "process_name", "ph": "M", "pid": self.rank,
            "args": {"name": f"rank {self.rank}"},
        }, {
            "name": "process_sort_index", "ph": "M", "pid": self.rank,
            "args": {"sort_index": self.rank},
        }]
        for i, phase in enumerate(ALL_PHASES):
            meta.append({"name": "thread_name", "ph": "M", "pid": self.rank,
                         "tid": i + 1, "args": {"name": phase}})
        return meta

    def close(self) -> Optional[str]:
        """Write the file (metadata + spans + trailer); returns the path,
        or None if a prior close already wrote it."""
        with self._lock:
            if self._closed:
                return None
            self._closed = True
            events = self._events
            self._events = []
            dropped = self._dropped
        out = self._metadata() + events
        out.append({"name": "trace_end", "ph": "M", "pid": self.rank,
                    "args": {"dropped_events": dropped,
                             "events": len(events)}})
        with open(self._path, "w") as f:
            for i, ev in enumerate(out):
                f.write(("[\n" if i == 0 else ",\n") + json.dumps(ev))
            f.write("\n]\n")
        return self._path

    @property
    def path(self) -> str:
        return self._path

    def read_bytes(self) -> bytes:
        """The written file's bytes (for the shutdown push over the
        wire). Empty when close() hasn't produced a file."""
        try:
            with open(self._path, "rb") as f:
                return f.read()
        except OSError:
            return b""
