"""Spark integration: ``horovod_tpu_torch.spark.run(fn, args=...)`` — the
port's counterpart of ``horovod_tpu/spark/__init__.py``.

Runs ``fn`` on every Spark executor as a rank of one job: a single
registration round trip with the driver service (``driver.py``) hands
each task its topology and rendezvous addresses, and the task's ``fn``
calls ``hvd.init()`` (on the card when the executor has one; a CPU
executor passes ``device="cpu"``). Results come back through Spark's own
collect, in rank order.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional, Sequence

from .driver import SparkDriverService, compute_assignments, register_task  # noqa: F401


def _task_fn(fn: Callable, args: tuple, kwargs: dict, driver_addr: str):
    def task(index, _iterator):
        assignment = register_task(driver_addr, index)
        os.environ.update({
            "HOROVOD_RANK": str(assignment["rank"]),
            "HOROVOD_SIZE": str(assignment["size"]),
            "HOROVOD_LOCAL_RANK": str(assignment["local_rank"]),
            "HOROVOD_LOCAL_SIZE": str(assignment["local_size"]),
            "HOROVOD_CROSS_RANK": str(assignment["cross_rank"]),
            "HOROVOD_CROSS_SIZE": str(assignment["cross_size"]),
            "HOROVOD_CONTROLLER_ADDR": assignment["controller_addr"],
            "HOROVOD_RING_ADDRS": assignment["ring_addrs"],
            "HOROVOD_SPMD_COORDINATOR": assignment["spmd_coordinator"],
            "HOROVOD_SECRET_KEY": assignment["secret"],
        })
        # An executor's worker orphaned mid-job is reaped by the
        # watchdog hvd.init() arms.
        os.environ.setdefault("HOROVOD_PARENT_WATCHDOG", "1")
        yield fn(*args, **kwargs)

    return task


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        num_proc: Optional[int] = None) -> Sequence[Any]:
    """Run ``fn`` as a distributed job on Spark executors; returns every
    rank's return value, in rank order."""
    try:
        import pyspark  # noqa: F401
        from pyspark import SparkContext
    except ImportError as exc:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark, which is not "
            "installed in this environment") from exc

    kwargs = kwargs or {}
    sc = SparkContext._active_spark_context
    if sc is None:
        raise RuntimeError("no active SparkContext; create one before "
                           "horovod_tpu_torch.spark.run(fn)")
    if num_proc is None:
        num_proc = sc.defaultParallelism

    driver = SparkDriverService(num_proc)
    addr = driver.addr()
    results = (
        sc.parallelize(range(num_proc), num_proc)
        .mapPartitionsWithIndex(_task_fn(fn, args, kwargs, addr))
        .collect())
    driver.join()
    return results
