"""Span tracing for the port (the serving engine's spans under
``HOROVOD_TRACE_DIR``); see ``tracer.py``."""

from .tracer import (  # noqa: F401
    ALL_PHASES,
    PHASES,
    SERVING_PHASES,
    TraceWriter,
    rank_trace_path,
)
