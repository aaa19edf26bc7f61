"""Horovod Timeline: Chrome-tracing JSON profiler for the eager tier — the
port's copy of ``horovod_tpu/common/timeline.py``.

Reference: ``horovod/common/timeline.{h,cc}`` — rank 0 writes one
chrome://tracing file covering all ranks (the coordinator knows every
tensor's lifecycle), with a dedicated writer thread draining a queue so the
hot path never blocks, and a per-tensor state machine
UNKNOWN→NEGOTIATING→TOP_LEVEL→ACTIVITY.

``record()`` enqueues; a daemon thread serializes. Each tensor gets a
chrome "process" (pid) carrying its name. Enabled via
``HOROVOD_TIMELINE=<file>``; cycle markers via
``HOROVOD_TIMELINE_MARK_CYCLES``. The activity names are the JAX
package's, plus ``MEMCPY_D2H`` / ``MEMCPY_H2D``: the card's copies of a
fusion buffer to and from host memory, nested inside
``MEMCPY_IN_FUSION_BUFFER`` / ``MEMCPY_OUT_FUSION_BUFFER``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Dict, Optional

from ..analysis.lockorder import make_lock
from . import hvd_logging as logging
from .. import metrics

# Activity vocabulary (reference common/common.h:30-51; the JAX
# package's names, plus the card's copies).
NEGOTIATE_ALLREDUCE = "NEGOTIATE_ALLREDUCE"
NEGOTIATE_ALLGATHER = "NEGOTIATE_ALLGATHER"
NEGOTIATE_BROADCAST = "NEGOTIATE_BROADCAST"
ALLREDUCE = "ALLREDUCE"
ALLGATHER = "ALLGATHER"
BROADCAST = "BROADCAST"
QUEUE = "QUEUE"
WAIT_FOR_DATA = "WAIT_FOR_DATA"
WAIT_FOR_OTHER_TENSOR_DATA = "WAIT_FOR_OTHER_TENSOR_DATA"
INIT_FUSION_BUFFER = "INIT_FUSION_BUFFER"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
XLA_COLLECTIVE = "XLA_COLLECTIVE"
TCP_COLLECTIVE = "TCP_COLLECTIVE"
MEMCPY_D2H = "MEMCPY_D2H"
MEMCPY_H2D = "MEMCPY_H2D"
CYCLE_START = "CYCLE_START"

_m = None


def _tl_metrics():
    global _m
    if _m is None:
        from types import SimpleNamespace

        _m = SimpleNamespace(
            emitted=metrics.counter(
                "hvd_timeline_events_total",
                "Timeline events enqueued to the writer thread."),
            dropped=metrics.counter(
                "hvd_timeline_events_dropped_total",
                "Timeline events dropped on writer-queue overflow."))
    return _m


class Timeline:
    """Async chrome-trace writer. All public methods are thread-safe and
    non-blocking (enqueue only)."""

    _SHUTDOWN = object()

    def __init__(self, filename: str, mark_cycles: bool = False):
        self._filename = filename
        self.mark_cycles = mark_cycles
        self._queue: "queue.Queue" = queue.Queue(maxsize=1 << 20)
        self._pids: Dict[str, int] = {}
        self._lock = make_lock("timeline.pids")
        self._start = time.monotonic()
        self._file = open(filename, "w")
        self._file.write("[\n")
        self._closed = False
        # Absolute anchor for the otherwise process-private timebase: wall
        # clock at the monotonic origin + rank, so the trace can be laid
        # against another rank's.
        from .config import env_rank

        self._file.write(json.dumps({
            "name": "clock_sync", "ph": "M", "pid": 0,
            # hvdlint: disable=HVD004 (the wall anchor IS the point)
            "args": {"wall_anchor": time.time(),
                     "monotonic_origin": self._start,
                     "rank": env_rank()},
        }) + ",\n")
        self._dropped = 0  # overflow count; surfaced at close()
        # Own lock, NOT self._lock: _tensor_pid emits while holding
        # self._lock, so an overflow inside that call must not re-acquire
        # it (non-reentrant -> self-deadlock).
        self._drop_lock = make_lock("timeline.drops")
        self._writer = threading.Thread(
            target=self._writer_loop, name="hvd-timeline-writer", daemon=True
        )
        self._writer.start()

    # -- internal ----------------------------------------------------------

    def _now_us(self) -> int:
        return int((time.monotonic() - self._start) * 1e6)

    def _emit(self, event: dict) -> None:
        if self._closed:
            return
        try:
            self._queue.put_nowait(event)
        except queue.Full:
            # Drop rather than block the hot path (the reference's lock-free
            # queue has the same overflow policy by construction) — but
            # never silently: count the loss, warn once at close, and stamp
            # the total into the trace metadata.
            with self._drop_lock:
                self._dropped += 1
            if metrics.on():
                _tl_metrics().dropped.inc()
        else:
            if metrics.on():
                _tl_metrics().emitted.inc()

    def _writer_loop(self) -> None:
        while True:
            ev = self._queue.get()
            if ev is Timeline._SHUTDOWN:
                return
            self._file.write(json.dumps(ev) + ",\n")

    def _tensor_pid(self, tensor_name: str) -> int:
        with self._lock:
            pid = self._pids.get(tensor_name)
            if pid is None:
                pid = len(self._pids) + 1
                self._pids[tensor_name] = pid
                # Chrome metadata event naming the "process" after the tensor
                # (reference timeline.cc WriteEvent 'M' records).
                self._emit({
                    "name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": tensor_name},
                })
                self._emit({
                    "name": "process_sort_index", "ph": "M", "pid": pid,
                    "args": {"sort_index": pid},
                })
            return pid

    # -- lifecycle events (reference timeline.h:84-116) ---------------------

    def negotiate_start(self, tensor_name: str, request_type: str) -> None:
        pid = self._tensor_pid(tensor_name)
        self._emit({"name": f"NEGOTIATE_{request_type.upper()}", "ph": "B",
                    "pid": pid, "ts": self._now_us()})

    def negotiate_rank_ready(self, tensor_name: str, rank: int) -> None:
        """Instant event when a rank's request arrives at the coordinator
        (reference records per-rank negotiation phases)."""
        pid = self._tensor_pid(tensor_name)
        self._emit({"name": str(rank), "ph": "i", "pid": pid,
                    "ts": self._now_us(), "s": "p"})

    def negotiate_end(self, tensor_name: str, request_type: str) -> None:
        pid = self._tensor_pid(tensor_name)
        self._emit({"name": f"NEGOTIATE_{request_type.upper()}", "ph": "E",
                    "pid": pid, "ts": self._now_us()})

    def start(self, tensor_name: str, op_name: str) -> None:
        """Top-level operation span (ALLREDUCE/ALLGATHER/BROADCAST)."""
        pid = self._tensor_pid(tensor_name)
        self._emit({"name": op_name, "ph": "B", "pid": pid,
                    "ts": self._now_us()})

    def activity_start(self, tensor_name: str, activity: str) -> None:
        pid = self._tensor_pid(tensor_name)
        self._emit({"name": activity, "ph": "B", "pid": pid, "tid": 1,
                    "ts": self._now_us()})

    def activity_end(self, tensor_name: str) -> None:
        pid = self._tensor_pid(tensor_name)
        self._emit({"ph": "E", "pid": pid, "tid": 1, "ts": self._now_us()})

    def end(self, tensor_name: str) -> None:
        pid = self._tensor_pid(tensor_name)
        self._emit({"ph": "E", "pid": pid, "ts": self._now_us()})

    def mark_cycle_start(self) -> None:
        """Instant event per controller cycle, opt-in
        (``HOROVOD_TIMELINE_MARK_CYCLES``, reference operations.cc:996)."""
        if self.mark_cycles:
            self._emit({"name": CYCLE_START, "ph": "i", "pid": 0,
                        "ts": self._now_us(), "s": "g"})

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(Timeline._SHUTDOWN)
        self._writer.join(timeout=5.0)
        if self._dropped:
            # One-time, not per-drop: a saturated queue would otherwise
            # flood the log from the hot path it exists to protect.
            logging.warning(
                "timeline: dropped %d event(s) on writer-queue overflow — "
                "the trace at %s is incomplete (dropped_events in the "
                "trace_end metadata records the count)",
                self._dropped, self._filename)
        # Chrome tracing accepts a trailing comma-less final entry; emit a
        # terminator metadata record then close the array.
        self._file.write(json.dumps({"name": "trace_end", "ph": "M", "pid": 0,
                                     "args": {"dropped_events": self._dropped}}))
        self._file.write("\n]\n")
        self._file.close()
