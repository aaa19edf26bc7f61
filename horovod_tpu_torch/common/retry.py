"""Bounded retries with exponential backoff + jitter — the port's copy of
``retry_call`` from ``horovod_tpu/common/retry.py``. A call either
succeeds or fails after a bounded number of attempts, never hangs. The
port's user is the controller's rendezvous: a worker dials the
coordinator through :func:`retry_call` while rank 0 comes up
(``controller/service.py``).
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional, Sequence

from . import hvd_logging as logging
from .. import metrics

BACKOFF_MAX_SECONDS = 30.0

_m = None


def _retry_metrics():
    global _m
    if _m is None:
        from types import SimpleNamespace

        _m = SimpleNamespace(
            failures=metrics.counter(
                "hvd_retry_attempt_failures_total",
                "Failed attempts inside retry_call (init hardening)."),
            backoff=metrics.counter(
                "hvd_retry_backoff_seconds_total",
                "Total seconds slept backing off between retry attempts."),
            giveups=metrics.counter(
                "hvd_retry_giveups_total",
                "retry_call budgets exhausted (RetryError raised)."))
    return _m


class RetryError(RuntimeError):
    """All attempts failed; ``last`` is the final attempt's exception."""

    def __init__(self, describe: str, attempts: int, last: BaseException):
        self.attempts = attempts
        self.last = last
        super().__init__(
            f"{describe} failed after {attempts} attempt(s): {last}")


def retry_call(fn: Callable[[], Any], *, attempts: int = 3,
               backoff: float = 1.0,
               backoff_max: float = BACKOFF_MAX_SECONDS,
               jitter: float = 0.25, seed: Optional[int] = None,
               describe: str = "operation",
               retry_on: Sequence[type] = (Exception,),
               sleep: Callable[[float], None] = time.sleep) -> Any:
    """Call ``fn`` up to ``attempts`` times with exponential backoff.

    Jitter is drawn from ``random.Random(seed)`` — pass the rank as the
    seed and the delays are deterministic per process yet decorrelated
    across the job. Raises :class:`RetryError` (chained to the last
    failure) when every attempt failed."""
    rng = random.Random(seed)
    retry_on = tuple(retry_on)
    last: Optional[BaseException] = None
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as exc:
            last = exc
            if metrics.on():
                _retry_metrics().failures.inc()
            if attempt == attempts:
                break
            delay = min(backoff_max, backoff * (2.0 ** (attempt - 1)))
            if jitter:
                delay *= 1.0 + jitter * rng.uniform(-1.0, 1.0)
            logging.warning(
                "%s failed (attempt %d/%d): %s; retrying in %.1fs",
                describe, attempt, attempts, exc, max(0.0, delay))
            if delay > 0:
                if metrics.on():
                    _retry_metrics().backoff.inc(delay)
                sleep(delay)
    if metrics.on():
        _retry_metrics().giveups.inc()
    raise RetryError(describe, attempts, last) from last
