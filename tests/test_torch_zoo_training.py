"""Training the port's model zoo held against the JAX package's, on the
same weights and batches: three ``DistributedOptimizer(SGD(0.1,
momentum=0.9))`` steps of ``ResNetTiny`` against
``horovod_tpu.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))``
(parameters and BatchNorm statistics), three AdamW steps of
``BERT_TINY`` against ``optax.adamw(1e-4)``, a 2-rank gloo data-parallel
ResNet step against ``jax.shard_map`` (gradients averaged, each rank's
BatchNorm statistics its own), and both examples
(``synthetic_benchmark``, ``bert_pretraining``) on the CPU at tiny size.

Tolerances: float32 on both sides. Parameters after the steps at atol
1e-5 + rtol 1e-4 of each tensor's largest magnitude (an SGD step moves
a weight by lr times a gradient, whose small entries are cancellations:
see ``tests/test_torch_models.py``); statistics, losses and BERT's
AdamW parameters at atol 2e-5 / rtol 1e-4 (summation order only).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu import models as jm
from horovod_tpu_torch import models as tm
from horovod_tpu_torch.examples import bert_pretraining, synthetic_benchmark
from horovod_tpu_torch.models import convert
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=1e-4)
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
LAUNCH_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
               "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
               "HOROVOD_CROSS_SIZE", "OMPI_COMM_WORLD_RANK",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
               "OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_RANK", "PMI_SIZE",
               "HOROVOD_CONTROLLER_ADDR", "HOROVOD_SPMD_COORDINATOR",
               "HOROVOD_RENDEZVOUS_FILE")


@pytest.fixture
def port_state():
    """The port's hvd state, shut down after the test."""
    yield
    thvd.shutdown()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_state(model, params, batch_stats=None, param_tol=None):
    """``model``'s parameters (and buffers) against the flax trees."""
    want = convert.zoo_state_dict(model, _np(params), _np(batch_stats or {}))
    got = model.state_dict()
    assert sorted(want) == sorted(got)
    buffers = {name for name, _ in model.named_buffers()}
    for name in sorted(want):
        w, g = want[name].numpy(), got[name].numpy()
        if name in buffers or param_tol is None:
            np.testing.assert_allclose(g, w, **TOL, err_msg=name)
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=param_tol[0] + param_tol[1] *
                float(np.abs(w).max()), err_msg=name)


def _resnet_setup(batch):
    jmodel = jm.ResNetTiny(dtype=jnp.float32)
    x = np.random.RandomState(0).rand(batch, 32, 32, 3).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 10, batch)
    variables = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), x,
                                              train=True))(jnp.asarray(x))
    return jmodel, variables, x, y


def _jax_sgd_step(jmodel, tx):
    """The JAX synthetic benchmark's train_step (at size 1)."""
    def loss_fn(p, st, xb, yb):
        logits, new = jmodel.apply({"params": p, "batch_stats": st}, xb,
                                   train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, yb).mean()
        return loss, new["batch_stats"]

    def step(p, st, s, xb, yb):
        (loss, st), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, st, xb, yb)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), st, s, loss

    return step


def test_three_sgd_momentum_steps_of_resnet_tiny_match_jax(port_state):
    jmodel, variables, x, y = _resnet_setup(4)
    jhvd.init()
    tx = jhvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    p, st = variables["params"], variables["batch_stats"]
    s = tx.init(p)
    step = jax.jit(_jax_sgd_step(jmodel, tx))
    jlosses = []
    for _ in range(3):
        p, st, s, loss = step(p, st, s, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(loss))

    thvd.init(device="cpu")
    model = convert.resnet_from_flax(
        tm.ResNetTiny(dtype=torch.float32, device="cpu"),
        _np(variables["params"]), _np(variables["batch_stats"]))
    opt = synthetic_benchmark.make_optimizer(model)
    tx_, ty = torch.from_numpy(x), torch.from_numpy(y)
    losses = [float(synthetic_benchmark.train_step(model, opt, tx_, ty))
              for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, **TOL)
    _assert_state(model, p, st, param_tol=(PARAM_ATOL, PARAM_RTOL))


def test_three_adamw_steps_of_bert_tiny_match_jax(port_state):
    jcfg = dataclasses.replace(jm.BERT_TINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(tm.BERT_TINY, dtype=torch.float32)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    mlm = rng.rand(2, 16) < 0.15
    jmodel = jm.BertEncoder(jcfg)
    params = jax.jit(lambda i: jmodel.init(jax.random.PRNGKey(0), i,
                                           deterministic=True))(
        jnp.asarray(ids))["params"]
    jhvd.init()
    tx = jhvd.DistributedOptimizer(optax.adamw(1e-4))
    s = tx.init(params)

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(lambda p: jm.mlm_loss(
            jmodel.apply({"params": p}, jnp.asarray(ids), deterministic=True),
            jnp.asarray(ids), jnp.asarray(mlm)))(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    p, jlosses = params, []
    for _ in range(3):
        p, s, loss = step(p, s)
        jlosses.append(float(loss))

    thvd.init(device="cpu")
    model = convert.bert_from_flax(tm.BertEncoder(tcfg, device="cpu"),
                                   _np(params))
    opt = bert_pretraining.make_optimizer(model)
    t_ids, t_mlm = torch.from_numpy(ids).long(), torch.from_numpy(mlm)
    losses = [float(bert_pretraining.train_step(model, opt, t_ids, t_mlm))
              for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, **TOL)
    # The key projection's bias adds q·b to every logit of a query row,
    # which the softmax cancels: its gradient is zero but for rounding,
    # and Adam scales rounding up to steps of up to lr. Both sides keep
    # it within 3 steps of zero; every other leaf compares at TOL.
    p = jax.tree_util.tree_map(np.asarray, p)
    for i in range(tcfg.num_layers):
        attn = p[f"layer_{i}"]["SelfAttention_0"]
        got = getattr(model, f"layer_{i}").SelfAttention_0.key.bias
        for leaf in (attn["key"]["bias"], got.detach().numpy()):
            assert np.abs(leaf).max() <= 3 * 1e-4 * (1 + 1e-3)
        with torch.no_grad():
            got.copy_(torch.from_numpy(attn["key"]["bias"].reshape(-1)))
    _assert_state(model, p)


def test_resnet50_forward_macs_match_the_flop_count():
    """4.09 GMAC per 224² image: the 3 x 2 x 4.1 GMAC x batch FLOPs per
    training step the chip report divides by."""
    model = tm.ResNet50(device="cpu", dtype=torch.float32)
    macs = synthetic_benchmark.forward_macs(model, 224)
    assert macs == 4_089_184_256


def test_synthetic_benchmark_runs_and_reports(port_state, capsys):
    thvd.init(device="cpu")             # main()'s init() then keeps it
    out = synthetic_benchmark.main([
        "--model", "resnet50", "--image-size", "32", "--batch-size", "2",
        "--num-iters", "2", "--num-batches", "2"])
    assert len(out["img_per_s_windows"]) == 2
    assert out["img_per_s"] == np.median(out["img_per_s_windows"]) > 0
    assert len(out["losses"]) == 5 and np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("Model: resnet50, batch/card: 2")
    assert lines[-1].startswith("Total img/sec on 1 card(s): ")
    assert out["x"].shape == (2, 32, 32, 3)


def test_bert_example_runs_and_reports(port_state, capsys):
    thvd.init(device="cpu")
    out = bert_pretraining.main(["--model", "tiny", "--seq-len", "16",
                                 "--batch-size", "2", "--num-iters", "3"])
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 4
    assert out["losses"][-1] < out["losses"][0]
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("BERT-tiny seq=16: ") and "sequences/sec" in line
    assert all(p.dtype == torch.float32 for p in out["model"].parameters())


# ---------------------------------------------------------------------------
# Two ranks


WORKER = '''
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples import synthetic_benchmark
from horovod_tpu_torch.models import ResNetTiny, convert


def tree(arrays, prefix):
    out = {}
    for key in arrays.files:
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arrays[key]
    return out


if __name__ == "__main__":
    hvd.init(device="cpu")
    arrays = np.load(sys.argv[1])
    model = convert.resnet_from_flax(
        ResNetTiny(dtype=torch.float32, device="cpu"),
        tree(arrays, "params/"), tree(arrays, "batch_stats/"))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = synthetic_benchmark.make_optimizer(model)
    r = hvd.rank()
    x = torch.from_numpy(arrays["x"][2 * r:2 * r + 2])
    y = torch.from_numpy(arrays["y"][2 * r:2 * r + 2])
    synthetic_benchmark.train_step(model, opt, x, y)
    np.savez(sys.argv[2] + f".rank{r}.npz",
             **{k: v.numpy() for k, v in model.state_dict().items()})
    hvd.shutdown()
    print("worker ok")
'''


def _flatten(tree, prefix=""):
    out = {}
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def _run_two_ranks(tmp_path, *args, timeout=120):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    for rank in range(2):
        env = {k: v for k, v in sorted(os.environ.items())
               if k not in LAUNCH_VARS}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                   HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_RENDEZVOUS_FILE=str(tmp_path / "store"))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, text) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0 and "worker ok" in text, (
            f"rank {rank} exited {proc.returncode}:\n{text}")


def test_two_rank_resnet_step_averages_gradients_not_statistics(tmp_path):
    """Each rank takes half the batch: the parameters after one step equal
    ``jax.shard_map``'s (gradients averaged over ``"data"``), and each
    rank's running statistics are those of its own half alone."""
    jmodel, variables, x, y = _resnet_setup(4)
    jhvd.init()
    tx = jhvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                   axis_name="data")
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    step = jax.jit(jax.shard_map(
        _jax_sgd_step(jmodel, tx), mesh=mesh,
        in_specs=(P(), P(), P(), P("data"), P("data")),
        out_specs=(P(), P("data"), P(), P()), check_vma=False))
    p, st = variables["params"], variables["batch_stats"]
    # Statistics come back stacked per shard: (2 * C,) per leaf.
    new_p, new_st, _, _ = step(p, st, tx.init(p), jnp.asarray(x),
                               jnp.asarray(y))

    data = tmp_path / "dp.npz"
    np.savez(data, x=x, y=y, **_flatten(_np(variables)))
    _run_two_ranks(tmp_path, str(data), str(tmp_path / "out"))
    template = tm.ResNetTiny(dtype=torch.float32, device="cpu")
    for rank in range(2):
        got = np.load(tmp_path / f"out.rank{rank}.npz")
        shard = jax.tree_util.tree_map(
            lambda a: np.split(np.asarray(a), 2)[rank], new_st)
        want = convert.zoo_state_dict(template, _np(new_p), shard)
        buffers = {name for name, _ in template.named_buffers()}
        for name in sorted(want):
            w = want[name].numpy()
            tol = (TOL if name in buffers else dict(
                rtol=0, atol=PARAM_ATOL + PARAM_RTOL * float(np.abs(w).max())))
            np.testing.assert_allclose(got[name], w, **tol,
                                       err_msg=f"rank {rank} {name}")
    r0, r1 = (np.load(tmp_path / f"out.rank{r}.npz") for r in range(2))
    assert not np.allclose(r0["bn_init.running_mean"],
                           r1["bn_init.running_mean"])
