"""The port's MXNet front end (``horovod_tpu_torch.mxnet``) against the JAX
package's (``horovod_tpu.mxnet``), with the in-tree fake mxnet
(``tests/fake_mxnet.py``) installed as ``mxnet``:

* the size-1 scenarios of ``tests/test_mxnet_api.py`` through both
  packages in this process: equal values, the same errors;
* the 2-rank scenario of ``tests/mp_worker.py::scenario_mxnet`` under each
  package's ``horovodrun``: every rank's values equal across the packages
  (allreduce, the parameter broadcast at a non-zero root over dtypes and
  dims, the deferred-init broadcast, ``DistributedOptimizer``,
  ``DistributedTrainer``, ``ResizeEvalDataIter``,
  ``DistributedEvalMetric`` over two batches of uneven sizes, and
  ``allgather_object``/``broadcast_object``/``barrier``, which in the port
  run with the ``torch.distributed`` collectives made to raise: they need
  no process group while the controller runs);
* the two examples at 2 ranks: equal printed lines; without mxnet the
  port's example fails with its front end's message.

The jobs run three at a time (a module fixture). Values compare exactly
(float32 sums of two ranks in one order).
"""

import os
import subprocess
import sys
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import fake_mxnet

mx = sys.modules.setdefault("mxnet", fake_mxnet.module())

import horovod_tpu.mxnet as jmx  # noqa: E402
import horovod_tpu_torch.mxnet as tmx  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PY = sys.executable

WORKER = r'''
import json
import sys

import numpy as np

sys.path.insert(0, TESTS)
import fake_mxnet

mx = fake_mxnet.module()
sys.modules["mxnet"] = mx
if sys.argv[1] == "port":
    import torch.distributed as dist

    import horovod_tpu_torch.mxnet as hvd_mx
else:
    import horovod_tpu.mxnet as hvd_mx

hvd_mx.init()
rank, size = hvd_mx.rank(), hvd_mx.size()
out = {}

g = mx.nd.array(np.arange(4, dtype=np.float32) + rank)
hvd_mx.allreduce_(g, average=False, name="mx.grad")
out["allreduce_"] = g.asnumpy().tolist()
out["allreduce_avg"] = hvd_mx.allreduce(
    mx.nd.array(np.full(3, rank + 1.0, np.float32)), name="mx.avg"
).asnumpy().tolist()
out["allgather"] = hvd_mx.allgather(
    mx.nd.array(np.full((rank + 1, 2), float(rank), np.float32)),
    name="mx.gather").asnumpy().tolist()
out["broadcast"] = hvd_mx.broadcast(
    mx.nd.array(np.full(3, float(rank), np.float32)), root_rank=1,
    name="mx.bcast").asnumpy().tolist()

d = {"w": mx.nd.array(np.full(3, float(rank), dtype=np.float32))}
hvd_mx.broadcast_parameters(d, root_rank=0)
out["broadcast_parameters"] = d["w"].asnumpy().tolist()

opt = mx.optimizer.Optimizer(learning_rate=1.0)
dopt = hvd_mx.DistributedOptimizer(opt)
out["rescale_grad"] = opt.rescale_grad
w = mx.nd.array(np.zeros(2, dtype=np.float32))
grad = mx.nd.array(np.full(2, float(rank + 1), dtype=np.float32))
dopt.update(0, w, grad, None)
out["optimizer_w"] = w.asnumpy().tolist()
w2 = mx.nd.array(np.zeros(2, dtype=np.float32))
grads = [mx.nd.array(np.full(2, float(rank + i), np.float32))
         for i in (1, 2)]
dopt.update_multi_precision([1, 2], w2, grads, None)
out["multi_grads"] = [t.asnumpy().tolist() for t in grads]


class FakeIter:
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return iter(range(self.n))

    def reset(self):
        pass


out["resize"] = hvd_mx.ResizeEvalDataIter(FakeIter(3 + rank)).size

Metric = hvd_mx.DistributedEvalMetric(fake_mxnet.EvalMetric)
m = Metric()
m.update([mx.nd.array(np.full((2 + rank,), float(rank)))],
         [mx.nd.array(np.full((2 + rank,), float(rank) + 10))])
m.update([mx.nd.array(np.full((1 + 2 * rank,), float(rank)))],
         [mx.nd.array(np.full((1 + 2 * rank,), float(rank) - 10))])
out["metric_updates"] = m.num_updates
out["metric_seen"] = [[[np.asarray(a).tolist() for a in part]
                       for part in entry] for entry in m.seen]

matrix = {}
for dt in ("int32", "int64", "float32", "float64"):
    for dim, shape in enumerate([(5,), (5, 3), (2, 3, 4)]):
        matrix[f"m.{dt}.{dim}"] = mx.nd.array(
            np.full(shape, rank).astype(dt))
hvd_mx.broadcast_parameters(matrix, root_rank=1)
out["matrix"] = {k: [str(v.dtype), v.asnumpy().tolist()]
                 for k, v in sorted(matrix.items())}

pd = mx.gluon.parameter.ParameterDict()
pd["ready"] = fake_mxnet.Parameter(
    "ready", data=mx.nd.array(np.full(3, float(rank), np.float32)))
pd["late"] = fake_mxnet.Parameter("late")
hvd_mx.broadcast_parameters(pd, root_rank=0)
pd["late"]._init_impl(np.full(4, 100.0 + rank, np.float32))
out["deferred"] = [pd["ready"].data().asnumpy().tolist(),
                   pd["late"].data().asnumpy().tolist()]

tp = fake_mxnet.Parameter(
    "tw", data=mx.nd.array(np.ones(2, np.float32)),
    grad=mx.nd.array(np.full(2, float(rank + 1), np.float32)))
topt = mx.optimizer.Optimizer(learning_rate=0.5, rescale_grad=1.0)
trainer = hvd_mx.DistributedTrainer([tp], topt)
trainer.step(batch_size=2)
out["trainer_w"] = tp.data().asnumpy().tolist()

if sys.argv[1] == "port":
    # The object collectives run through the controller: no process
    # group collective may take part.
    def refuse(*args, **kwargs):
        raise AssertionError("a torch.distributed collective ran")

    for fn in ("all_gather", "broadcast", "all_reduce", "barrier",
               "all_gather_object", "broadcast_object_list"):
        setattr(dist, fn, refuse)
out["allgather_object"] = hvd_mx.allgather_object({"rank": rank,
                                                   "tag": "x" * rank})
out["broadcast_object"] = hvd_mx.broadcast_object(
    {"from": rank, "list": list(range(rank + 2))}, root_rank=1)
hvd_mx.barrier()
print("MXRESULT " + json.dumps({"rank": rank, "out": out}), flush=True)
hvd_mx.shutdown()
'''

RUNNER = r'''
import runpy
import sys

sys.path.insert(0, TESTS)
import fake_mxnet

sys.modules["mxnet"] = fake_mxnet.module()
mod = sys.argv[1]
sys.argv = [mod] + sys.argv[2:]
runpy.run_module(mod, run_name="__main__")
'''

RESNET_ARGS = ["--epochs", "1", "--steps-per-epoch", "2", "--batch-size",
               "4", "--image-size", "16", "--num-classes", "10"]


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
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mxnet")
    head = f"TESTS = {HERE!r}\n"
    worker, runner = tmp / "worker.py", tmp / "runner.py"
    worker.write_text(head + WORKER)
    runner.write_text(head + RUNNER)
    port_run = [PY, "-m", "horovod_tpu_torch.run", "-np", "2", PY]
    jax_run = [PY, "-m", "horovod_tpu.run", "-np", "2", PY]
    cmds = {
        "scenario_port": port_run + [str(worker), "port"],
        "scenario_jax": jax_run + [str(worker), "jax"],
        "mnist_port": port_run + [str(runner), "horovod_tpu_torch.examples."
                                  "mxnet_mnist", "--epochs", "2"],
        "mnist_jax": jax_run + [os.path.join(REPO, "examples",
                                             "mxnet_mnist.py"),
                                "--epochs", "2"],
        "resnet_port": port_run + [str(runner), "horovod_tpu_torch."
                                   "examples.mxnet_imagenet_resnet50"]
        + RESNET_ARGS,
        "resnet_jax": jax_run + [os.path.join(
            REPO, "examples", "mxnet_imagenet_resnet50.py")] + RESNET_ARGS,
        "no_mxnet": [PY, "-m", "horovod_tpu_torch.examples.mxnet_mnist"],
    }
    def run(cmd):
        res = subprocess.run(cmd, cwd=REPO, env=_env(), text=True,
                             capture_output=True, timeout=240)
        return res.returncode, res.stdout, res.stderr

    # Three jobs at a time: the suite's other workers share the cores.
    with ThreadPoolExecutor(3) as pool:
        futures = {k: pool.submit(run, c) for k, c in sorted(cmds.items())}
        return {k: f.result() for k, f in sorted(futures.items())}


def _ok(jobs, name):
    code, stdout, stderr = jobs[name]
    assert code == 0, stdout[-3000:] + stderr[-3000:]
    return stdout


def _results(stdout):
    import json

    res = {}
    for line in stdout.splitlines():
        _, _, rest = line.partition("MXRESULT ")
        if rest:
            rec = json.loads(rest)
            res[rec["rank"]] = rec["out"]
    return res


def test_two_rank_scenario_equals_the_jax_package(jobs):
    mine = _results(_ok(jobs, "scenario_port"))
    theirs = _results(_ok(jobs, "scenario_jax"))
    assert sorted(mine) == sorted(theirs) == [0, 1]
    for rank in (0, 1):
        assert mine[rank] == theirs[rank], rank
    r0, r1 = mine[0], mine[1]
    assert r0["allreduce_"] == [1.0, 3.0, 5.0, 7.0]
    assert r0["broadcast_parameters"] == r1["broadcast_parameters"] == \
        [0.0] * 3
    assert r0["optimizer_w"] == r1["optimizer_w"] == [-1.5, -1.5]
    assert r0["resize"] == r1["resize"] == 4
    assert r0["metric_updates"] == 4 and r1["metric_updates"] == 0
    assert r0["deferred"] == [[0.0] * 3, [100.0] * 4]
    assert r0["trainer_w"] == r1["trainer_w"] == [0.625, 0.625]
    assert r0["allgather_object"] == [{"rank": 0, "tag": ""},
                                      {"rank": 1, "tag": "x"}]
    assert r0["broadcast_object"] == {"from": 1, "list": [0, 1, 2]}


def _lines(stdout, prefix):
    return [ln.partition("]: ")[2] for ln in stdout.splitlines()
            if ln.partition("]: ")[2].startswith(prefix)]


def test_mnist_example_equals_the_jax_example(jobs):
    mine = _lines(_ok(jobs, "mnist_port"), "epoch")
    theirs = _lines(_ok(jobs, "mnist_jax"), "epoch")
    assert mine == theirs and len(mine) == 2, (mine, theirs)


def test_imagenet_resnet50_example_equals_the_jax_example(jobs):
    mine = _lines(_ok(jobs, "resnet_port"), "epoch")
    theirs = _lines(_ok(jobs, "resnet_jax"), "epoch")
    assert mine == theirs and len(mine) == 1, (mine, theirs)


def test_example_without_mxnet_fails_with_the_front_ends_message(jobs):
    code, _, stderr = jobs["no_mxnet"]
    assert code != 0
    assert "horovod_tpu_torch.mxnet requires the 'mxnet' package" in stderr


# ---------------------------------------------------------------------------
# The size-1 scenarios through both packages, in this process


@pytest.fixture
def packages():
    # Both inits are per test: the suite's conftest shuts the JAX
    # package down after each one.
    tmx.init()
    jmx.init()
    yield {"port": tmx, "jax": jmx}
    tmx.shutdown()


def _ops_size1(hvd_mx):
    x = mx.nd.array(np.arange(6, dtype=np.float32))
    out = hvd_mx.allreduce(x, average=True, name="ar")
    assert out is not x
    y = mx.nd.array(np.ones(4, dtype=np.float32))
    assert hvd_mx.allreduce_(y, average=False, name="ar_") is y
    assert hvd_mx.broadcast_(y, root_rank=0, name="bc_") is y
    for fn, args in ((hvd_mx.broadcast, (x,)), (hvd_mx.broadcast_, (y,))):
        with pytest.raises(ValueError, match="root_rank"):
            fn(*args, root_rank=3)
    return [out.asnumpy().tolist(),
            hvd_mx.allgather(x, name="ag").asnumpy().tolist(),
            hvd_mx.broadcast(x, root_rank=0, name="bc").asnumpy().tolist(),
            hvd_mx.size(), hvd_mx.rank()]


def _optimizer_size1(hvd_mx):
    opt = mx.optimizer.Optimizer(learning_rate=0.5, rescale_grad=2.0)
    dopt = hvd_mx.DistributedOptimizer(opt)
    w = mx.nd.array(np.ones(3, dtype=np.float32))
    g = mx.nd.array(np.ones(3, dtype=np.float32))
    dopt.update(0, w, g, None)
    w2 = mx.nd.array(np.zeros(2, dtype=np.float32))
    dopt.update_multi_precision([1, 2], w2, [g, g], None)
    dopt.set_learning_rate(0.1)
    dopt.set_lr_mult({"a": 1.0})
    dopt.set_wd_mult({"a": 0.0})
    return [opt.rescale_grad, w.asnumpy().tolist(), opt.updates, dopt.lr]


def _trainer_size1(hvd_mx):
    opt = mx.optimizer.Optimizer(learning_rate=1.0)
    dopt = hvd_mx.DistributedOptimizer(opt)
    p = fake_mxnet.Parameter(
        "w", data=mx.nd.array(np.ones(2, dtype=np.float32)),
        grad=mx.nd.array(np.full(2, 3.0, dtype=np.float32)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = hvd_mx.DistributedTrainer(
            [p], dopt, optimizer_params={"rescale_grad": 4.0})
    assert any("unwrapped" in str(w.message) for w in caught)
    assert trainer._optimizer is opt
    trainer.step(batch_size=1)
    skip = fake_mxnet.Parameter("frozen", data=mx.nd.array([0.0]),
                                grad=None, grad_req="null")
    hvd_mx.DistributedTrainer([skip], opt).step(batch_size=1)
    return [trainer._scale, p.data().asnumpy().tolist(),
            skip.data().asnumpy().tolist()]


def _broadcast_size1(hvd_mx):
    d = {"b": mx.nd.array(np.ones(2)), "a": mx.nd.array(np.zeros(2))}
    hvd_mx.broadcast_parameters(d)
    pd = mx.gluon.parameter.ParameterDict()
    pd["ready"] = fake_mxnet.Parameter("ready", data=mx.nd.array(np.ones(3)))
    deferred = fake_mxnet.Parameter("deferred")
    pd["deferred"] = deferred
    hvd_mx.broadcast_parameters(pd)
    deferred._init_impl(np.full(3, 7.0))
    with pytest.raises(ValueError, match="invalid params"):
        hvd_mx.broadcast_parameters([1, 2, 3])
    return [deferred.data().asnumpy().tolist()]


def _eval_size1(hvd_mx):
    class FakeIter:
        def __init__(self, n):
            self.n, self.resets = n, 0

        def __iter__(self):
            return iter(range(self.n))

        def reset(self):
            self.resets += 1

    it = FakeIter(5)
    resized = hvd_mx.ResizeEvalDataIter(it)
    assert isinstance(resized, mx.io.ResizeIter)
    m = hvd_mx.DistributedEvalMetric(fake_mxnet.EvalMetric)()
    m.update([mx.nd.array(np.arange(4))], [mx.nd.array(np.arange(4) + 1)])
    return [resized.size, it.resets, m.num_updates,
            np.asarray(m.seen[0][1][0]).tolist()]


@pytest.mark.parametrize("scenario", [_ops_size1, _optimizer_size1,
                                      _trainer_size1, _broadcast_size1,
                                      _eval_size1],
                         ids=lambda f: f.__name__.strip("_"))
def test_size1_scenario_equals_the_jax_package(packages, scenario):
    mine = scenario(packages["port"])
    theirs = scenario(packages["jax"])
    assert mine == theirs
