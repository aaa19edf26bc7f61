"""The port's TF custom op (``horovod_tpu_torch/tensorflow/src/tf_ops.cc``)
against the JAX package's (``horovod_tpu/tensorflow/src/tf_ops.cc``):

* size 1, in this process: every case of ``tests/test_tf_custom_op.py``
  through both op libraries — each builds from its own source, both load
  here side by side (their ops are named ``HorovodTpuTorch*`` and
  ``HorovodTpu*``), and each drives its own engine (shut one down and the
  other still serves). Equal values, the same errors;
* 2 ranks, under each package's launcher: ``tests/torch_tf_worker.py``
  (the union of ``mp_worker.py::scenario_tensorflow`` and
  ``::scenario_tf_custom_op``) on three paths — the native engine (the
  custom op: the traced graph holds the package's own op node), the native
  engine with rank 1 opted out (the vote drops both ranks to
  ``tf.py_function``) and, ``slow``, the Python controller
  (``tf.py_function``).
  Every rank's values are equal across the packages and across the three
  paths; the port's ranks import nothing of ``horovod_tpu``.

Values compare exactly: sums of two ranks in one order, averages divided
by two.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

tf = pytest.importorskip("tensorflow")

from horovod_tpu.core import bindings as jax_bindings  # noqa: E402
from horovod_tpu.tensorflow import tf_ops as jax_tf_ops  # noqa: E402
from horovod_tpu_torch.core import bindings as port_bindings  # noqa: E402
from horovod_tpu_torch.tensorflow import tf_ops as port_tf_ops  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PY = sys.executable
SECRET = b"\x01" * 32
OPS = {"port": (port_tf_ops, port_bindings, "HorovodTpuTorchAllreduce"),
       "jax": (jax_tf_ops, jax_bindings, "HorovodTpuAllreduce")}


def _init(lib):
    key = (ctypes.c_uint8 * len(SECRET)).from_buffer_copy(SECRET)
    rc = lib.hvd_eng_init(0, 1, b"", key, len(SECRET), 1.0, 1 << 20, 64, 1,
                          60.0, -1.0, b"", 0, 0, 0, 0, 1)
    assert rc == 0, lib.hvd_eng_last_error().decode()


@pytest.fixture(scope="module")
def engines():
    libs = {pkg: bindings.load()
            for pkg, (_, bindings, _) in sorted(OPS.items())}
    for _, lib in sorted(libs.items()):
        _init(lib)
    yield libs
    for _, lib in sorted(libs.items()):
        lib.hvd_eng_shutdown()


def _both(case, *args):
    """``case`` through each package's op module; the port's result."""
    got = {pkg: case(OPS[pkg][0], OPS[pkg][2], *args) for pkg in OPS}
    assert got["port"] == got["jax"], got
    return got["port"]


def _values(t):
    return [t.dtype.name, tf.cast(t, tf.float64).numpy().tolist()]


def test_library_builds_and_loads():
    # The op library must be real here, not a quiet fallback.
    assert port_tf_ops.available(), port_tf_ops._load_failed
    assert jax_tf_ops.available(), jax_tf_ops._load_failed
    assert port_tf_ops._lib_path() != jax_tf_ops._lib_path()
    assert os.path.dirname(port_tf_ops._lib_path()) == os.path.join(
        REPO, "horovod_tpu_torch", "tensorflow", "build")
    # The port passes its core's path through its attach op: the JAX
    # package's variable still names the JAX core.
    assert os.environ["HOROVOD_TPU_CORE_LIB"] == jax_bindings.build()


def test_eager_allreduce_size1(engines):
    def case(ops, _):
        return _values(ops.allreduce_sum(
            tf.constant([1.0, 2.5, -3.0]), name="tfop.smoke.ar"))

    assert _both(case) == ["float32", [1.0, 2.5, -3.0]]


@pytest.mark.parametrize("dtype", [tf.float64, tf.int32, tf.int64,
                                   tf.bfloat16, tf.float16, tf.uint8])
def test_eager_dtypes_size1(engines, dtype):
    def case(ops, _):
        return _values(ops.allreduce_sum(
            tf.cast(tf.constant([[1, 2], [3, 4]]), dtype),
            name=f"tfop.smoke.{dtype.name}"))

    assert _both(case) == [dtype.name, [[1, 2], [3, 4]]]


def test_eager_allgather_broadcast_size1(engines):
    def case(ops, _):
        return [_values(ops.allgather(tf.constant([[1, 2, 3]]),
                                      name="tfop.smoke.ag")),
                _values(ops.broadcast(tf.constant([7.0]), root_rank=0,
                                      name="tfop.smoke.bc"))]

    assert _both(case) == [["int32", [[1, 2, 3]]], ["float32", [7.0]]]


def test_traced_graph_contains_the_packages_own_op(engines):
    def case(ops, op_name):
        @tf.function
        def step(t):
            return ops.allreduce_sum(t, name="tfop.traced.ar")

        cf = step.get_concrete_function(tf.TensorSpec([4], tf.float32))
        types = {op.type for op in cf.graph.get_operations()}
        return [op_name in types, "EagerPyFunc" in types,
                _values(step(tf.constant([1.0, 2.0, 3.0, 4.0])))]

    assert _both(case) == [True, False, ["float32", [1.0, 2.0, 3.0, 4.0]]]


def test_savedmodel_roundtrip(engines, tmp_path):
    def case(ops, op_name):
        class M(tf.Module):
            @tf.function(input_signature=[tf.TensorSpec([3], tf.float32)])
            def __call__(self, t):
                return ops.allreduce_sum(t, name="tfop.saved.ar")

        path = str(tmp_path / op_name)
        tf.saved_model.save(M(), path)
        return _values(tf.saved_model.load(path)(tf.constant([5.0, 6, 7])))

    assert _both(case) == ["float32", [5.0, 6.0, 7.0]]


def test_gradient_through_custom_op(engines):
    def case(ops, _):
        x = tf.Variable([2.0, 3.0])
        with tf.GradientTape() as tape:
            y = ops.allreduce_sum(x, name="tfop.grad.ar")
            loss = tf.reduce_sum(y * y)
        return _values(tape.gradient(loss, x))

    assert _both(case) == ["float32", [4.0, 6.0]]


def test_gradient_of_a_traced_allreduce(engines):
    def case(ops, _):
        @tf.function
        def f(t):
            return tf.reduce_sum(ops.allreduce_sum(t, name="tfop.grad2.ar"))

        x = tf.constant([1.0])
        with tf.GradientTape() as tape:
            tape.watch(x)
            y = f(x)
        return _values(tape.gradient(y, x))

    assert _both(case) == ["float32", [1.0]]


def test_enqueue_after_shutdown_raises_and_each_library_has_its_engine(
        engines):
    """Shut one engine down: that package's op fails with the engine's
    shutdown contract (FailedPrecondition) while the other package's op
    still serves — the two op libraries drive two engines."""
    for down, up in (("port", "jax"), ("jax", "port")):
        engines[down].hvd_eng_shutdown()
        try:
            with pytest.raises(tf.errors.FailedPreconditionError,
                               match="shut down"):
                OPS[down][0].allreduce_sum(tf.constant([1.0]),
                                           name="tfop.after.shutdown")
            out = OPS[up][0].allreduce_sum(tf.constant([2.0]),
                                           name="tfop.other.engine")
            assert out.numpy().tolist() == [2.0]
        finally:
            _init(engines[down])


def test_attach_names_one_core_per_process():
    ops = port_tf_ops.load()
    ops.horovod_tpu_torch_attach(core_path=str(port_bindings.build()))
    with pytest.raises(tf.errors.FailedPreconditionError,
                       match="attached to"):
        ops.horovod_tpu_torch_attach(core_path=jax_bindings.build())


# ---------------------------------------------------------------------------
# 2 ranks under each package's launcher


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(JAX_PLATFORMS="cpu", HOROVOD_CYCLE_TIME="1",
               OMP_NUM_THREADS="1", HVD_TEST_REPO=REPO)
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_CONTROLLER_ADDR",
              "HOROVOD_SPMD_COORDINATOR", "HOROVOD_RENDEZVOUS_FILE",
              "HOROVOD_ENGINE", "HOROVOD_TENSORFLOW_CUSTOM_OP"):
        env.pop(k, None)
    return env


PATHS = {"custom_op": {}, "mixed": {"HVD_TEST_MIXED": "1"},
         "python": {"HOROVOD_ENGINE": "python"}}
LAUNCHERS = {"port": "horovod_tpu_torch.run", "jax": "horovod_tpu.run"}


def _run_paths(paths):
    """Both packages' jobs on each of ``paths``, two jobs at a time (a TF
    rank holds about 1 GB: the suite's other workers share the cores and
    the memory); ``{(pkg, path): (returncode, stdout, stderr)}``."""
    # Both op libraries exist before the ranks start: a rank's vote must
    # not wait on a cold build while its peer sits in the vote.
    port_tf_ops.build()
    jax_tf_ops.build()
    worker = os.path.join(HERE, "torch_tf_worker.py")

    def run(pkg, path):
        res = subprocess.run(
            [PY, "-m", LAUNCHERS[pkg], "-np", "2", PY, worker, pkg],
            cwd=REPO, env=dict(_env(), **PATHS[path]), text=True,
            capture_output=True, timeout=300)
        return res.returncode, res.stdout, res.stderr

    with ThreadPoolExecutor(2) as pool:
        futures = {(pkg, path): pool.submit(run, pkg, path)
                   for path in paths for pkg in sorted(LAUNCHERS)}
        return {k: f.result() for k, f in sorted(futures.items())}


@pytest.fixture(scope="module")
def jobs():
    """The custom op and the vote's py_function path; the Python
    controller's py_function path (``slow``) adds its jobs when it runs."""
    return _run_paths(["custom_op", "mixed"])


def _results(jobs, pkg, path):
    code, stdout, stderr = jobs[(pkg, path)]
    assert code == 0, stdout[-3000:] + stderr[-3000:]
    res = {}
    for line in stdout.splitlines():
        _, _, rest = line.partition("TFRESULT ")
        if rest:
            rec = json.loads(rest)
            res[rec["rank"]] = rec["out"]
    assert sorted(res) == [0, 1], stdout[-3000:]
    return res


# The Python controller's run is slow: the vote's run ("mixed") holds the
# same py_function path on the native engine.
@pytest.mark.parametrize("path", [
    "custom_op", "mixed", pytest.param("python", marks=pytest.mark.slow)])
def test_two_ranks_equal_the_jax_package(jobs, path):
    if path not in {p for _, p in jobs}:
        jobs.update(_run_paths([path]))
    mine, theirs = _results(jobs, "port", path), _results(jobs, "jax", path)
    for rank in (0, 1):
        assert mine[rank].pop("imports") == [], rank
        assert mine[rank] == theirs[rank], rank
    r0, r1 = mine[0], mine[1]
    assert r0["avg"] == ["float32", [0.5, 1.5, 2.5, 3.5, 4.5, 5.5]]
    assert r0["bf16"] == ["float32", [3.0] * 8]
    assert r0["int_avg"] == ["int32", [1, 3, 7]]
    assert r0["scalar"] == ["float32", 1.5]
    assert r0["bool"] == ["bool", [True, True, False, False]]
    assert r0["allgather"] == ["float32", [[0.0, 0.0], [1.0, 1.0],
                                           [1.0, 1.0]]]
    assert r0["broadcast"] == r1["broadcast"] == ["float32", [1.0]]
    assert r0["broadcast_root_error"] == "ValueError"
    assert r0["sparse"] == ["IndexedSlices", ["float32", [[0.5, 0.0],
                                                          [1.0, 0.0]]],
                            ["int32", [0, 1]]]
    assert r0["broadcast_variables"] == [["float32", [1.0] * 3],
                                         ["float32", 1.5]]
    assert r0["tape"] == ["float32", [3.0]]
    assert r0["burst"] == ["float32", [[1.0 + 2 * i] for i in range(32)]]
    assert r0["metric_average"] == {"loss": 0.5, "acc": 0.375}
    assert r1["broadcast_object"] == {"from": 1, "list": [0, 1, 2]}
    # Which data path ran, as the path demands.
    custom = path == "custom_op"
    for r in (r0, r1):
        assert r["custom_op"] is custom
        assert r["graph"] == {"custom": custom, "py_function": not custom}
    if custom:
        assert r1["allgather_grad"] == ["float32", [[4.0, 4.0], [4.0, 4.0]]]
        assert r0["broadcast_grad"] == ["float32", [3.0]]
        assert r1["broadcast_grad"] == ["float32", [0.0]]
        assert r0["mismatch_error"] == "UnknownError"
        assert r0["after_error"] == ["float32", [2.0]]


def test_the_paths_give_equal_values(jobs):
    """Each path that ran gives the custom op's values (the Python
    controller's too when its slow case ran first)."""
    runs = [_results(jobs, "port", path)
            for path in sorted({p for _, p in jobs})]
    shared = set.intersection(*(set(r[0]) for r in runs)) - {
        "custom_op", "graph", "imports"}
    for rank in (0, 1):
        for other in runs[1:]:
            assert {k: other[rank][k] for k in shared} == \
                {k: runs[0][rank][k] for k in shared}, rank
