"""The port's nine TF and Keras examples (``horovod_tpu_torch/examples/``)
against the JAX package's (``examples/``), with the ranks, flags and
``slow`` marks of ``tests/test_examples.py``:

* each pair runs under its package's launcher at 2 ranks (the resume of
  ``keras_imagenet_resnet50`` twice), both through a runner that seeds
  Keras (``keras.utils.set_random_seed(0)``) and turns on TF's op
  determinism first, so both start from equal weights; rank 0's printed
  lines are equal (Keras's per-epoch lines with their timings cut out,
  the synthetic benchmark's lines up to the timed ones);
* ``keras_spark_rossmann``: its training function through each
  package's ``spark.run`` with the in-tree fake pyspark
  (``tests/fake_pyspark.py``) at 2 ranks — equal ranks and final
  ``exp_rmspe`` — and its in-process path (no ``pyspark.sql``) at size 1;
* without tensorflow, each of the nine fails with its front end's
  message naming tensorflow, as on the card machine.

``tensorflow_mnist_eager`` and ``tensorflow_keras_mnist`` are tier-1, as
in ``tests/test_examples.py``; the others are ``slow``
(``keras_mnist``, which that file does not run, too: the 2-rank Keras fit
and its callbacks stay in tier-1 through ``tensorflow_keras_mnist``).
"""

import functools
import importlib.util
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

pytest.importorskip("tensorflow")

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
EX = os.path.join(REPO, "examples")
PY = sys.executable
NINE = ("tensorflow_mnist", "tensorflow_mnist_eager", "tensorflow_keras_mnist",
        "tensorflow_synthetic_benchmark", "tensorflow_word2vec",
        "keras_mnist", "keras_mnist_advanced", "keras_imagenet_resnet50",
        "keras_spark_rossmann")

RUNNER = r'''
import runpy
import sys

import keras
import tensorflow as tf

keras.utils.set_random_seed(0)
tf.config.experimental.enable_op_determinism()
target = sys.argv[1]
sys.argv = [target] + sys.argv[2:]
if target.endswith(".py"):
    runpy.run_path(target, run_name="__main__")
else:
    runpy.run_module(target, run_name="__main__", alter_sys=True)
'''

NO_TF = r'''
import runpy
import sys

sys.modules["tensorflow"] = None  # as where it is not installed
for name in sys.argv[1:]:
    sys.argv = [name]
    try:
        runpy.run_module("horovod_tpu_torch.examples." + name,
                         run_name="__main__", alter_sys=True)
        print(f"NOTF {name} ran")
    except ImportError as exc:
        print(f"NOTF {name} {exc}")
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(JAX_PLATFORMS="cpu", HOROVOD_CYCLE_TIME="1",
               OMP_NUM_THREADS="1")
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_CONTROLLER_ADDR",
              "HOROVOD_SPMD_COORDINATOR", "HOROVOD_RENDEZVOUS_FILE"):
        env.pop(k, None)
    return env


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    path = tmp_path_factory.mktemp("tf_examples") / "runner.py"
    path.write_text(RUNNER)
    return str(path)


def _pair(runner, name, args, np=2):
    """The JAX example and the port's under their launchers, at once;
    each ``(returncode, stdout, stderr)``. ``args`` is both's flags, or
    a dict of each package's."""
    if not isinstance(args, dict):
        args = {"port": args, "jax": args}
    targets = {"port": ("horovod_tpu_torch.run",
                        f"horovod_tpu_torch.examples.{name}"),
               "jax": ("horovod_tpu.run", os.path.join(EX, f"{name}.py"))}

    def run(pkg):
        launcher, target = targets[pkg]
        res = subprocess.run(
            [PY, "-m", launcher, "-np", str(np), PY, runner, target,
             *args[pkg]],
            cwd=REPO, env=_env(), text=True, capture_output=True,
            timeout=600)
        return res.returncode, res.stdout, res.stderr

    with ThreadPoolExecutor(2) as pool:
        futures = {pkg: pool.submit(run, pkg) for pkg in sorted(targets)}
        return {pkg: f.result() for pkg, f in sorted(futures.items())}


_TIMING = re.compile(r" - \d+(\.\d+)?(ms|s|us)(/step)?")
# What the examples print (TF's and Python's warnings aside).
_PRINTED = re.compile(r"(step |epoch |final|Epoch \d|\d+/\d+ - |Model: |"
                      r"Batch size: |Number of workers: |Running |Iter #|"
                      r"Img/sec|Total img/sec|rank \d|pyspark )")


def _lines(res, stop=None):
    """Rank 0's printed lines (the launcher prefixes ``[0]: ``), Keras's
    timings cut out; up to the first line starting with ``stop``."""
    code, stdout, stderr = res
    assert code == 0, stdout[-3000:] + stderr[-3000:]
    out = []
    for line in stdout.splitlines():
        if not line.startswith("[0]: "):
            continue
        text = _TIMING.sub("", line[len("[0]: "):]).rstrip()
        if stop is not None and text.startswith(stop):
            break
        if _PRINTED.match(text):
            out.append(text)
    return out


def _equal_lines(runner, name, args, expect, stop=None):
    got = _pair(runner, name, args)
    mine, theirs = _lines(got["port"], stop), _lines(got["jax"], stop)
    assert mine == theirs, (mine, theirs)
    assert any(expect in line for line in mine), mine
    return mine


# ---------------------------------------------------------------------------
# tier-1


@pytest.fixture(scope="module")
def tier1(runner, tmp_path_factory):
    """The two tier-1 pairs, one pair (two launches) at a time: a TF rank
    holds about 1 GB."""
    model_dir = str(tmp_path_factory.mktemp("keras_mnist_ckpt"))
    cases = {
        "tensorflow_mnist_eager": ["--steps", "5", "--batch-size", "32"],
        "tensorflow_keras_mnist": ["--epochs", "1", "--batch-size", "256",
                                   "--model-dir", model_dir],
    }
    return {name: _pair(runner, name, args)
            for name, args in sorted(cases.items())}


def test_tensorflow_mnist_eager_equals_the_jax_example(tier1):
    got = tier1["tensorflow_mnist_eager"]
    mine, theirs = _lines(got["port"]), _lines(got["jax"])
    assert mine == theirs and mine[0].startswith("step 0: loss"), \
        (mine, theirs)


def test_tensorflow_keras_mnist_equals_the_jax_example(tier1):
    got = tier1["tensorflow_keras_mnist"]
    mine, theirs = _lines(got["port"]), _lines(got["jax"])
    assert mine == theirs, (mine, theirs)
    assert mine[-1].startswith("final: acc=")
    assert mine[0].startswith("8/8 - accuracy: "), mine


def test_without_tensorflow_each_example_fails_with_its_front_end():
    res = subprocess.run([PY, "-c", NO_TF, *NINE], cwd=REPO, env=_env(),
                         text=True, capture_output=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    seen = {}
    for line in res.stdout.splitlines():
        if line.startswith("NOTF "):
            name, _, msg = line[len("NOTF "):].partition(" ")
            seen[name] = msg
    assert sorted(seen) == sorted(NINE)
    for name, msg in sorted(seen.items()):
        front = "keras" if name.startswith("keras_") else "tensorflow"
        assert msg.startswith(f"horovod_tpu_torch.{front} requires the "
                              "'tensorflow' package"), (name, msg)


# ---------------------------------------------------------------------------
# slow: the other seven, as tests/test_examples.py marks them


@pytest.mark.slow
def test_tensorflow_mnist_equals_the_jax_example(runner):
    _equal_lines(runner, "tensorflow_mnist",
                 ["--epochs", "1", "--batch-size", "256"], "epoch 0")


@pytest.mark.slow
def test_keras_mnist_equals_the_jax_example(runner):
    _equal_lines(runner, "keras_mnist",
                 ["--epochs", "1", "--batch-size", "256"], "final: loss=")


@pytest.mark.slow
def test_keras_mnist_advanced_equals_the_jax_example(runner):
    _equal_lines(runner, "keras_mnist_advanced",
                 ["--epochs", "2", "--batch-size", "256",
                  "--warmup-epochs", "1"], "final: acc=")


@pytest.mark.slow
def test_tensorflow_word2vec_equals_the_jax_example(runner):
    mine = _equal_lines(runner, "tensorflow_word2vec",
                        ["--steps", "10", "--batch-size", "64",
                         "--vocab-size", "500", "--embedding-dim", "16"],
                        "embedding grad: IndexedSlices")
    assert "proj grad: EagerTensor" in mine[0]


@pytest.mark.slow
def test_tensorflow_synthetic_benchmark_equals_the_jax_example(runner):
    args = ["--model", "MobileNetV2", "--batch-size", "4", "--image-size",
            "32", "--num-classes", "10", "--num-warmup-batches", "1",
            "--num-batches-per-iter", "2", "--num-iters", "2"]
    got = _pair(runner, "tensorflow_synthetic_benchmark", args)
    mine = _lines(got["port"], stop="Iter #")
    assert mine == _lines(got["jax"], stop="Iter #")
    assert mine == ["Model: MobileNetV2", "Batch size: 4",
                    "Number of workers: 2", "Running warmup...",
                    "Running benchmark..."]
    assert "Total img/sec on 2 worker(s):" in got["port"][1]


@pytest.mark.slow
def test_keras_imagenet_resnet50_train_and_resume_equal_the_jax_example(
        runner, tmp_path):
    fmts = {pkg: str(tmp_path / pkg / "ck-{epoch}.keras")
            for pkg in ("port", "jax")}
    for _, fmt in sorted(fmts.items()):
        os.makedirs(os.path.dirname(fmt))
    for epochs in ("1", "2"):
        got = _pair(runner, "keras_imagenet_resnet50", {
            pkg: ["--steps-per-epoch", "2", "--batch-size", "2",
                  "--image-size", "32", "--num-classes", "10",
                  "--checkpoint-format", fmt, "--epochs", epochs]
            for pkg, fmt in sorted(fmts.items())})
        mine, theirs = _lines(got["port"]), _lines(got["jax"])
        assert mine == theirs, (mine, theirs)
        assert mine[-1].startswith("final:")
        assert os.path.exists(fmts["port"].format(epoch=1))
        if epochs == "2":
            # Rank 0 resumed from the epoch-1 checkpoint through
            # hvd.load_model: only epoch 2 trains.
            assert "Epoch 2/2" in mine and "Epoch 1/2" not in mine


def _rossmann(pkg, *args):
    """The example's training function on a Spark executor, Keras seeded
    first (a module function: the fake pyspark pickles it by value)."""
    import keras
    import tensorflow as tf

    keras.utils.set_random_seed(0)
    tf.config.experimental.enable_op_determinism()
    if pkg == "port":
        from horovod_tpu_torch.examples import keras_spark_rossmann as mod
    else:
        spec = importlib.util.spec_from_file_location(
            "jax_keras_spark_rossmann",
            os.path.join(REPO, "examples", "keras_spark_rossmann.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod.train_fn(*args)


@pytest.mark.slow
def test_keras_spark_rossmann_on_the_fake_spark_equals_the_jax_example(
        monkeypatch):
    import fake_pyspark

    import horovod_tpu.spark as jspark
    import horovod_tpu_torch.spark as tspark
    from horovod_tpu_torch.examples import keras_spark_rossmann as ex

    monkeypatch.setitem(sys.modules, "pyspark", fake_pyspark)
    sc = fake_pyspark.SparkContext("local[2]")
    try:
        cats, conts, target, max_log = ex.engineer_features(
            ex.synthetic_rossmann(1024))
        args = (cats, conts, target, max_log, 1, 256, 1e-3)
        with ThreadPoolExecutor(2) as pool:
            mine = pool.submit(tspark.run, functools.partial(
                _rossmann, "port"), args=args, num_proc=2)
            theirs = pool.submit(jspark.run, functools.partial(
                _rossmann, "jax"), args=args, num_proc=2)
            mine, theirs = mine.result(), theirs.result()
    finally:
        sc.stop()
    assert sorted(mine) == sorted(theirs)
    assert [rank for rank, _ in sorted(mine)] == [0, 1]


@pytest.mark.slow
def test_keras_spark_rossmann_in_process_path_equals_the_jax_example(
        runner):
    outs = {}
    for pkg, target in (("port", "horovod_tpu_torch.examples."
                                 "keras_spark_rossmann"),
                        ("jax", os.path.join(EX, "keras_spark_rossmann.py"))):
        res = subprocess.run(
            [PY, runner, target, "--epochs", "1", "--rows", "1024"],
            cwd=REPO, env=_env(), text=True, capture_output=True,
            timeout=600)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        outs[pkg] = [line for line in res.stdout.splitlines()
                     if line.startswith(("pyspark", "rank "))]
    assert outs["port"] == outs["jax"]
    assert outs["port"][-1].startswith("rank 0: final exp_rmspe=")
