"""Crash flight recorder: a bounded ring of structured runtime events,
the port's own copy of the JAX package's ``metrics/recorder.py``.

Every failure mode the fault plane can inject (``horovod_tpu_torch.fault``)
leaves at most a transient log line; a dead terminal leaves nothing. The
recorder keeps the last N structured events — sampled
enqueues, stall warnings, recv-deadline trips, init retries, coordinated
aborts, restart epochs — in memory, and dumps them as JSONL when the job
fails (``Controller._fail_all``, ABORT handling, unclean shutdown), so a
postmortem artifact always survives the crash.

Enable with ``HOROVOD_FLIGHT_RECORDER=<path>``. Each rank writes its own
file: a ``{rank}`` placeholder in the path is substituted, otherwise
``.rank<N>`` is appended when ``HOROVOD_RANK`` is set (one shared env
value from the launcher must not make ranks clobber each other). Knobs:

* ``HOROVOD_FLIGHT_RECORDER_CAPACITY`` — ring size (default 512 events).
* ``HOROVOD_FLIGHT_RECORDER_SAMPLE`` — keep 1-in-N for sampled event
  kinds like per-op enqueues (default 64; rare events are never sampled).

Recording is lock-guarded (events arrive from the controller thread, the
heartbeat thread, and user threads at once) and allocation-light: one
small dict per event, dropped from the left when the ring is full.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

from ..analysis.lockorder import make_lock
from ..common import hvd_logging as logging
from ..common.config import _env_int, env_rank

DEFAULT_CAPACITY = 512
DEFAULT_SAMPLE = 64


def expand_rank_path(path: str, rank: Optional[str]) -> str:
    """Per-process dump path. A rank-less process (the horovodrun
    supervisor) substitutes "launcher", NOT "0" — its restart-history
    dump must never clobber rank 0's crash postmortem."""
    if "{rank}" in path:
        return path.replace("{rank}", rank if rank is not None
                            else "launcher")
    if rank is not None:
        return f"{path}.rank{rank}"
    return path


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None,
                 sample: Optional[int] = None,
                 rank: Optional[str] = None):
        if capacity is None:
            capacity = max(
                16, _env_int("HOROVOD_FLIGHT_RECORDER_CAPACITY",
                             DEFAULT_CAPACITY))
        if sample is None:
            sample = max(1, _env_int("HOROVOD_FLIGHT_RECORDER_SAMPLE",
                                     DEFAULT_SAMPLE))
        # Parse once, defensively: a garbage/empty HOROVOD_RANK must not
        # make telemetry raise on the hot path (telemetry never fails the
        # job it observes).
        if rank is None:
            self.rank: Optional[int] = env_rank()
        else:
            try:
                self.rank = int(rank) if str(rank).strip() else None
            except (TypeError, ValueError):
                self.rank = None
        self.sample = sample
        self._events: deque = deque(maxlen=capacity)
        self._sample_counts: Dict[str, int] = {}
        self._lock = make_lock("metrics.recorder")
        self._seq = 0

    def record(self, kind: str, **fields) -> None:
        # Postmortem timestamps are wall-clock on purpose (they
        # are read next to system logs). hvdlint: disable=HVD004
        event = {"ts": round(time.time(), 6), "kind": kind}
        if self.rank is not None:
            event["rank"] = self.rank
        event.update(fields)
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)

    def record_sampled(self, kind: str, **fields) -> None:
        """Record the 1st and every ``sample``-th event of this kind (the
        reference for high-rate sites like per-op enqueues)."""
        with self._lock:
            n = self._sample_counts.get(kind, 0) + 1
            self._sample_counts[kind] = n
        if n == 1 or n % self.sample == 0:
            self.record(kind, occurrence=n, **fields)

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def dump(self, path: str, reason: str) -> Optional[str]:
        """Write header + ring (oldest first) as JSONL; returns the final
        path. Never raises — a failing dump must not mask the failure that
        triggered it. Concurrent dumps (an abort handler racing the
        unclean-shutdown path) each write a private temp file and
        atomically rename it into place, so the artifact is never a torn
        interleaving — the last completed dump wins whole."""
        out = expand_rank_path(
            path, str(self.rank) if self.rank is not None else None)
        tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            events = self.events()
            header = {"kind": "flight_recorder_dump", "reason": reason,
                      # hvdlint: disable=HVD004 (wall-clock stamp)
                      "ts": round(time.time(), 6), "events": len(events)}
            if self.rank is not None:
                header["rank"] = self.rank
            with open(tmp, "w") as f:
                f.write(json.dumps(header) + "\n")
                for event in events:
                    f.write(json.dumps(event, default=str) + "\n")
            os.replace(tmp, out)
            logging.warning("flight recorder: dumped %d event(s) to %s "
                            "(reason: %s)", len(events), out, reason)
            return out
        except Exception as exc:  # "never raises" is a hard contract here
            logging.error("flight recorder: dump to %s failed: %s",
                          out, exc)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
