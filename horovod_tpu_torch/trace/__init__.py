"""Cluster-wide tracing for the port's eager tier, the JAX package's
``trace`` surface over the port's own copies.

1. **Clock sync** (``clock.py``): the coordinator estimates each
   worker's wall-clock offset ± uncertainty from RTT ping-pong
   piggybacked on the wire's HEARTBEAT frames, written as
   ``clock_offsets.json``.
2. **Span propagation** (``tracer.py`` + the controllers): the
   coordinator assigns a collective sequence id per fused op, carried on
   the cycle reply; every rank emits ``enqueue → negotiate → fuse →
   execute → done`` spans tagged with it into ``trace.rank<N>.json``.
3. **Merge** (``merge.py``): the per-rank files rebased through the
   offset table into one ``merged_trace.json``, a process-row per rank.
4. **Attribution** (``straggler.py``): per collective, which rank
   arrived last at negotiation, written as ``straggler_report.json`` and
   fed into ``hvd_negotiation_slack_seconds`` and
   ``hvd_straggler_cycles_total{rank}``.

Enable with ``HOROVOD_TRACE_DIR=<dir>`` (or ``horovodrun --trace DIR``);
the serving engine writes its own ``trace.serving.rank<N>.json`` there.
"""

from .clock import ClockSync, load_offsets  # noqa: F401
from .merge import (  # noqa: F401
    merge_events,
    merge_trace_dir,
    rank_trace_files,
    write_trace,
)
from .straggler import attribute, summary, write_report  # noqa: F401
from .tracer import (  # noqa: F401
    ALL_PHASES,
    MERGED_TRACE_FILE,
    OFFSETS_FILE,
    PHASES,
    REPORT_FILE,
    SERVING_PHASES,
    TraceWriter,
    rank_trace_path,
)

__all__ = [
    "ClockSync", "TraceWriter", "PHASES", "SERVING_PHASES", "ALL_PHASES",
    "rank_trace_path", "rank_trace_files", "merge_trace_dir",
    "merge_events", "write_trace", "attribute", "write_report", "summary",
    "load_offsets", "MERGED_TRACE_FILE", "OFFSETS_FILE", "REPORT_FILE",
]
