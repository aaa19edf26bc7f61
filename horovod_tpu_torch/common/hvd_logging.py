"""Leveled, rank-aware logging — the port's own copy of
``horovod_tpu/common/hvd_logging.py``: stdlib logging with Horovod's
level vocabulary (trace..fatal), the level from ``HOROVOD_LOG_LEVEL`` and
timestamps hidden by ``HOROVOD_LOG_HIDE_TIME``."""

from __future__ import annotations

import logging
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_logger = logging.getLogger("horovod_tpu_torch")
_configured = False
_rank_prefix = ""


def configure(level_name: str | None = None,
              hide_time: bool | None = None) -> None:
    global _configured
    from .config import _env_bool, log_level_name

    if level_name is None:
        level_name = log_level_name()
    if hide_time is None:
        hide_time = _env_bool("HOROVOD_LOG_HIDE_TIME")
    level = _LEVELS.get(level_name, logging.WARNING)
    handler = logging.StreamHandler(sys.stderr)
    fmt = ("[%(levelname)s] %(message)s" if hide_time
           else "%(asctime)s [%(levelname)s] %(message)s")
    handler.setFormatter(logging.Formatter(fmt))
    _logger.handlers[:] = [handler]
    _logger.setLevel(level)
    _logger.propagate = False
    _configured = True


def set_rank(rank: int) -> None:
    global _rank_prefix
    _rank_prefix = "[%d]: " % rank


def _log(level: int, msg: str, *args) -> None:
    if not _configured:
        configure()
    _logger.log(level, _rank_prefix + msg, *args)


def trace(msg, *args):
    _log(TRACE, msg, *args)


def debug(msg, *args):
    _log(logging.DEBUG, msg, *args)


def info(msg, *args):
    _log(logging.INFO, msg, *args)


def warning(msg, *args):
    _log(logging.WARNING, msg, *args)


def error(msg, *args):
    _log(logging.ERROR, msg, *args)


def fatal(msg, *args):
    _log(logging.CRITICAL, msg, *args)
