"""The port's Spark front end (``horovod_tpu_torch.spark``) against the JAX
package's (``horovod_tpu.spark``): the scenarios of ``tests/test_spark.py``
and ``tests/test_spark_e2e.py`` through both, with the in-tree fake
pyspark (``tests/fake_pyspark.py``: a process a partition, closures by
cloudpickle) standing in for Spark at 2 ranks.

* ``compute_assignments``: equal assignments on the same registrations
  (the secret is random per job: equal within a job); the port's adds
  ``spmd_coordinator``, rank 0's store address, which its ``hvd.init``
  joins;
* the driver service round trip (threads as executors): equal ranks,
  sizes and local ranks;
* ``run`` end to end: the same user function (init, an allreduce, a
  variable-first-dim allgather) gives equal ordered results through both;
  ``run`` without pyspark, or without an active context, raises in both;
* the MNIST example's training function through both packages' ``run``:
  equal ranks and final losses (float32, rtol 1e-5: the same model, data
  and averaged gradients; summation order only); its ``main`` without
  pyspark fails as the JAX example's does.
"""

import importlib.util
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import horovod_tpu.spark as jspark
import horovod_tpu.spark.driver as jdriver
import horovod_tpu_torch.spark as tspark
import horovod_tpu_torch.spark.driver as tdriver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGS = [
    {"index": 0, "host": "a", "ring_port": 10, "controller_port": 20,
     "store_port": 30},
    {"index": 1, "host": "b", "ring_port": 11, "controller_port": 21,
     "store_port": 31},
    {"index": 2, "host": "a", "ring_port": 12, "controller_port": 22,
     "store_port": 32},
    {"index": 3, "host": "b", "ring_port": 13, "controller_port": 23,
     "store_port": 33},
]


def test_compute_assignments_equal_the_jax_package():
    mine = tdriver.compute_assignments([dict(r) for r in REGS])
    theirs = jdriver.compute_assignments([dict(r) for r in REGS])
    assert len(mine) == len(theirs) == 4
    for m, t in zip(mine, theirs):
        assert {k: v for k, v in sorted(m.items()) if k != "secret"} == {
            **{k: v for k, v in sorted(t.items()) if k != "secret"},
            "spmd_coordinator": "a:30"}
    assert len({a["secret"] for a in mine}) == 1
    # Registration order does not change the assignment.
    shuffled = tdriver.compute_assignments([dict(r) for r in REGS[::-1]])
    assert [{k: v for k, v in sorted(a.items()) if k != "secret"}
            for a in shuffled] == [{k: v for k, v in sorted(a.items())
                                    if k != "secret"} for a in mine]


def _round_trip(driver_mod, num=3):
    driver = driver_mod.SparkDriverService(num, timeout=30.0)
    addr = f"127.0.0.1:{driver.port}"
    results = {}

    def worker(i):
        results[i] = driver_mod.register_task(addr, i)

    threads = [threading.Thread(target=worker, args=(i,),
                                name=f"hvd-test-spark-task-{i}", daemon=True)
               for i in range(num)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    driver.join()
    return results


def test_driver_round_trip_equals_the_jax_package():
    mine, theirs = _round_trip(tdriver), _round_trip(jdriver)
    keys = ("rank", "size", "local_rank", "local_size", "cross_rank",
            "cross_size")
    assert [[m[k] for k in keys] for _, m in sorted(mine.items())] == \
        [[t[k] for k in keys] for _, t in sorted(theirs.items())] == \
        [[i, 3, i, 3, 0, 1] for i in range(3)]
    port0 = mine[0]["spmd_coordinator"].rpartition(":")[2]
    assert all(m["spmd_coordinator"].endswith(":" + port0)
               for _, m in sorted(mine.items()))


def test_run_requires_pyspark_in_both(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyspark", None)
    for pkg in (tspark, jspark):
        with pytest.raises(ImportError, match="requires pyspark"):
            pkg.run(lambda: None)


@pytest.fixture
def spark_ctx(monkeypatch):
    import fake_pyspark as fake

    monkeypatch.setitem(sys.modules, "pyspark", fake)
    sc = fake.SparkContext("local[2]")
    yield sc
    sc.stop()


def _train_fn(pkg, scale):
    """The e2e test's user function, for either package."""
    import importlib

    import numpy as np

    if pkg == "port":
        hvd = importlib.import_module("horovod_tpu_torch")
        hvd.init(device="cpu")
        import torch

        def arr(x):
            return torch.from_numpy(x)
    else:
        hvd = importlib.import_module("horovod_tpu")
        hvd.init()

        def arr(x):
            return x
    rank, size = hvd.rank(), hvd.size()
    summed = hvd.allreduce(arr(np.arange(4, dtype=np.float32) + rank),
                           average=False, name="spark.sum")
    gathered = hvd.allgather(
        arr(np.full((rank + 1, 2), float(rank), np.float32)),
        name="spark.gather")
    hvd.shutdown()
    return {"rank": rank, "size": size, "scale": scale,
            "sum": np.asarray(summed).tolist(),
            "gather_rows": int(np.asarray(gathered).shape[0])}


def _both(port_call, jax_call):
    """The two packages' jobs at once (their executors are processes)."""
    with ThreadPoolExecutor(2) as pool:
        mine, theirs = pool.submit(port_call), pool.submit(jax_call)
        return mine.result(), theirs.result()


def test_run_end_to_end_equals_the_jax_package(spark_ctx):
    mine, theirs = _both(lambda: tspark.run(_train_fn, args=("port", 7)),
                         lambda: jspark.run(_train_fn, args=("jax", 7)))
    assert mine == theirs
    assert [r["rank"] for r in mine] == [0, 1]
    assert mine[0]["sum"] == [1.0, 3.0, 5.0, 7.0]
    assert all(r["gather_rows"] == 3 for r in mine)
    spark_ctx.stop()
    for pkg in (tspark, jspark):
        with pytest.raises(RuntimeError, match="no active SparkContext"):
            pkg.run(_train_fn, args=("port", 0))


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spark_mnist_training_equals_the_jax_example(spark_ctx):
    from horovod_tpu_torch.examples import spark_mnist

    jex = _jax_example("spark_mnist")
    mine, theirs = _both(
        lambda: tspark.run(spark_mnist.train, args=(1, 64, 0.01),
                           num_proc=2),
        lambda: jspark.run(jex.train, args=(1, 64, 0.01), num_proc=2))
    assert [r for r, _ in mine] == [r for r, _ in theirs] == [0, 1]
    np.testing.assert_allclose([loss for _, loss in mine],
                               [loss for _, loss in theirs], rtol=1e-5)


def test_spark_mnist_without_pyspark_fails_as_the_jax_example():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    runs = [subprocess.run(cmd + ["--num-proc", "2"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
            for cmd in ([sys.executable, "-m",
                         "horovod_tpu_torch.examples.spark_mnist"],
                        [sys.executable, os.path.join(REPO, "examples",
                                                      "spark_mnist.py")])]
    for run in runs:
        assert run.returncode != 0
        assert "No module named 'pyspark'" in run.stderr
