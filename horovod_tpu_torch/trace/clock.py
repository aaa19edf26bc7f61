"""Cluster clock synchronization for merged tracing.

Each rank stamps trace events with its own wall clock; laying N rank
timelines on one axis needs each worker's offset from the coordinator's
clock. The coordinator estimates it NTP-style from RTT ping-pong
exchanges piggybacked on the wire's HEARTBEAT frames
(``common/wire.py``): it sends ``{"ping": t0}``, the worker echoes
``{"pong": t0, "wall": <its time.time()>}``, and on receipt at ``t1``

    rtt    = t1 - t0
    offset = peer_wall - (t0 + t1) / 2        # worker clock - ours
    uncertainty = rtt / 2

The midpoint estimate is exact for symmetric paths; for an asymmetric
path the error is bounded by ``rtt / 2`` (the pong may have left the
worker anywhere inside the RTT window), which is why the uncertainty is
recorded next to every offset instead of being rounded away. Samples
refresh continuously; the estimate per rank is the sample with the
smallest RTT inside a bounded window (queueing only ever inflates RTT,
so min-RTT is the least-contaminated observation — the classic NTP
filter).

The table is serialized to ``clock_offsets.json`` in the trace
directory so the offline merge (``trace/merge.py``,
the launcher's ``--trace`` finish) can rebase per-rank timestamps after
the job is gone. The port's copy of ``horovod_tpu/trace/clock.py``, with
a plain ``threading.Lock``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

# Samples kept per rank: enough to ride out a noisy patch, small enough
# that a real clock step (NTP slew on the host) ages out quickly.
DEFAULT_WINDOW = 64


class ClockSync:
    """Per-rank wall-clock offset table, fed by pong observations."""

    def __init__(self, size: int, window: int = DEFAULT_WINDOW):
        self.size = size
        self._window = max(1, window)
        self._samples: Dict[int, deque] = {}
        self._lock = threading.Lock()

    def observe(self, rank: int, t0: float, peer_wall: float,
                t1: Optional[float] = None) -> None:
        """Record one completed ping-pong: sent at ``t0`` (our clock),
        answered with ``peer_wall`` (worker clock), received at ``t1``
        (our clock, default now)."""
        if t1 is None:
            t1 = time.time()
        rtt = t1 - t0
        if rtt < 0:  # our own clock stepped mid-exchange: unusable
            return
        offset = peer_wall - (t0 + t1) / 2.0
        with self._lock:
            dq = self._samples.setdefault(int(rank), deque(
                maxlen=self._window))
            dq.append((rtt, offset, t1))

    def sample_count(self, rank: int) -> int:
        with self._lock:
            dq = self._samples.get(int(rank))
            return len(dq) if dq else 0

    def estimate(self, rank: int) -> "Optional[tuple]":
        """Best current ``(offset, uncertainty, rtt)`` for ``rank`` —
        the min-RTT sample in the window — or None with no samples.
        Rank 0 (the reference clock) is always ``(0, 0, 0)``."""
        if int(rank) == 0:
            return (0.0, 0.0, 0.0)
        with self._lock:
            dq = self._samples.get(int(rank))
            if not dq:
                return None
            rtt, offset, _ = min(dq, key=lambda s: s[0])
        return (offset, rtt / 2.0, rtt)

    def table(self) -> Dict[str, dict]:
        """JSON-clean offset table: the artifact the merge consumes.
        Ranks never observed appear with offset 0 and ``synced: false``
        so the merge stays total and the report can flag them."""
        out: Dict[str, dict] = {}
        for rank in range(self.size):
            est = self.estimate(rank)
            if est is None:
                out[str(rank)] = {"offset_seconds": 0.0,
                                  "uncertainty_seconds": None,
                                  "rtt_seconds": None,
                                  "samples": 0, "synced": False}
            else:
                offset, unc, rtt = est
                out[str(rank)] = {"offset_seconds": round(offset, 9),
                                  "uncertainty_seconds": round(unc, 9),
                                  "rtt_seconds": round(rtt, 9),
                                  "samples": self.sample_count(rank)
                                  if rank else 0,
                                  "synced": True}
        return out

    def write(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.table(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path


def load_offsets(path: str) -> Dict[int, dict]:
    """Read a ``clock_offsets.json`` into {rank: entry}; a missing or
    malformed file yields {} (the merge then rebases with offset 0)."""
    try:
        with open(path) as f:
            raw = json.load(f)
        return {int(k): v for k, v in raw.items()}
    except (OSError, ValueError, TypeError):
        return {}
