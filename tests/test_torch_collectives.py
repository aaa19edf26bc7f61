"""The port's ``init``/topology and collectives (``horovod_tpu_torch``),
and a 2-rank data-parallel step held against the JAX package's.

Topology and the lifecycle errors run in-process. The collectives run as
2-rank gloo jobs on the CPU: two worker processes launched with
``HOROVOD_RANK``/``HOROVOD_SIZE`` and a ``FileStore`` rendezvous under
``tmp_path`` (no port, so parallel test workers cannot collide), each
job under its own timeout. The data-parallel step gives each rank half
the batch of a ``LLAMA_TINY`` model and compares the updated weights
with ``jax.shard_map`` over a 2-device CPU mesh running
``horovod_tpu.DistributedOptimizer(optax.adamw(3e-4), axis_name="data")``
(float32 atol 2e-5 / rtol 1e-4: summation order only).
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
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu.models import llama as jllama
from horovod_tpu.ops.attention import make_attention_fn as jmake
from horovod_tpu_torch.common import topology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
               "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
               "HOROVOD_CROSS_SIZE", "OMPI_COMM_WORLD_RANK",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
               "OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_RANK", "PMI_SIZE",
               "HOROVOD_CONTROLLER_ADDR", "HOROVOD_SPMD_COORDINATOR",
               "HOROVOD_RENDEZVOUS_FILE")


@pytest.fixture
def clean_env(monkeypatch):
    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    thvd.shutdown()


# ---------------------------------------------------------------------------
# Topology and lifecycle, in-process


def test_api_before_init_raises(clean_env):
    for fn in (thvd.rank, thvd.size, thvd.local_rank, thvd.device):
        with pytest.raises(ValueError, match="has not been initialized"):
            fn()


def test_no_launcher_env_is_rank_0_of_1(clean_env):
    thvd.init(device="cpu")
    thvd.init(device="cpu")                     # idempotent
    assert (thvd.rank(), thvd.size(), thvd.local_rank(),
            thvd.local_size()) == (0, 1, 0, 1)
    assert thvd.is_initialized() and thvd.device().type == "cpu"
    thvd.shutdown()
    assert not thvd.is_initialized()


def test_topology_from_launcher_env(clean_env):
    clean_env.setenv("HOROVOD_RANK", "5")
    clean_env.setenv("HOROVOD_SIZE", "8")
    clean_env.setenv("HOROVOD_LOCAL_RANK", "1")
    clean_env.setenv("HOROVOD_LOCAL_SIZE", "4")
    topo = topology.detect()
    assert (topo.rank, topo.size, topo.local_rank, topo.local_size,
            topo.cross_rank, topo.cross_size) == (5, 8, 1, 4, 1, 2)
    assert topo.launched and topo.device_index == 1
    clean_env.setenv("HOROVOD_CROSS_RANK", "0")
    clean_env.setenv("HOROVOD_CROSS_SIZE", "3")
    topo = topology.detect()
    assert (topo.cross_rank, topo.cross_size) == (0, 3)


def test_topology_reads_mpi_aliases(clean_env):
    clean_env.setenv("OMPI_COMM_WORLD_RANK", "2")
    clean_env.setenv("OMPI_COMM_WORLD_SIZE", "3")
    topo = topology.detect()
    assert (topo.rank, topo.size) == (2, 3)


@pytest.mark.parametrize("name", ["HOROVOD_RANK", "HOROVOD_SIZE"])
def test_half_set_launcher_env_raises(clean_env, name):
    clean_env.setenv(name, "1")
    with pytest.raises(RuntimeError, match="partially-set launcher"):
        topology.detect()
    with pytest.raises(RuntimeError, match="partially-set launcher"):
        thvd.init(device="cpu")


def test_init_ranks_narrows_the_job(clean_env):
    clean_env.setenv("HOROVOD_RANK", "2")
    clean_env.setenv("HOROVOD_SIZE", "4")
    topo = topology.detect(ranks=[3, 2])
    assert (topo.rank, topo.size, topo.local_rank, topo.local_size) == (
        1, 2, 0, 1)
    with pytest.raises(RuntimeError, match="not in init"):
        topology.detect(ranks=[0, 1])
    with pytest.raises(ValueError, match="duplicates"):
        topology.detect(ranks=[2, 2])
    # A subset of one is a whole job: init builds its group and runs.
    thvd.init(ranks=[2], device="cpu")
    assert (thvd.rank(), thvd.size()) == (0, 1)


def test_launched_size_one_builds_a_group_and_collectives_are_identity(
        clean_env):
    import torch
    import torch.distributed as dist

    clean_env.setenv("HOROVOD_RANK", "0")
    clean_env.setenv("HOROVOD_SIZE", "1")
    thvd.init(device="cpu")
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    x = torch.arange(5.0)
    for out in (thvd.allreduce(x), thvd.allgather(x),
                thvd.broadcast(x, 0), thvd.allreduce_async(x).wait()):
        assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="out of range"):
        thvd.broadcast(x, 1)
    with pytest.raises(ValueError, match="not both"):
        thvd.allreduce(x, average=True, op=thvd.Sum)
    thvd.shutdown()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# 2-rank gloo jobs

WORKER = '''
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd


def collectives():
    r = hvd.rank()
    x = torch.arange(6, dtype=torch.float32) + 10 * r
    base = torch.arange(6, dtype=torch.float32)
    assert torch.equal(hvd.allreduce(x), base + 5)
    assert torch.equal(hvd.allreduce(x, op=hvd.Average), base + 5)
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum), 2 * base + 10)
    assert torch.equal(hvd.allreduce(x, average=False), 2 * base + 10)
    try:
        hvd.allreduce(x, average=True, op=hvd.Sum)
        raise AssertionError("average= with op= did not raise")
    except ValueError:
        pass
    ints = torch.tensor([3, 4]) + r            # mean 3.5, 4.5 -> 3, 4
    assert torch.equal(hvd.allreduce(ints), torch.tensor([3, 4]))
    y = x.clone()
    hvd.allreduce_(y)
    assert torch.equal(y, base + 5)
    # grouped, sync and in place
    a, b = hvd.grouped_allreduce([x, 2 * x], op=hvd.Sum)
    assert torch.equal(a, 2 * base + 10) and torch.equal(b, 4 * base + 20)
    g = [x.clone(), (3 * x).clone()]
    hvd.grouped_allreduce_(g)
    assert torch.equal(g[0], base + 5) and torch.equal(g[1], 3 * base + 15)
    # async + poll + synchronize
    handles = hvd.grouped_allreduce_async([x, x + 1])
    handles.append(hvd.allreduce_async(x, average=False))
    outs = [hvd.synchronize(h) for h in handles]
    assert all(hvd.poll(h) for h in handles)
    assert torch.equal(outs[0], base + 5)
    assert torch.equal(outs[1], base + 6)
    assert torch.equal(outs[2], 2 * base + 10)
    # allgather with different first dims per rank
    t = torch.full((r + 1, 2), float(r))
    got = hvd.allgather(t)
    assert torch.equal(got, torch.tensor([[0., 0.], [1., 1.], [1., 1.]]))
    assert torch.equal(hvd.synchronize(hvd.allgather_async(t)), got)
    leaf = t.clone().requires_grad_()
    hvd.allgather(leaf).sum().backward()
    assert torch.equal(leaf.grad, torch.full_like(t, 2.0))
    # broadcast from rank 1, out of place and in place
    assert torch.equal(hvd.broadcast(x, 1), base + 10)
    z = x.clone()
    hvd.broadcast_(z, 0)
    assert torch.equal(z, base)
    try:
        hvd.broadcast(x, 2)
        raise AssertionError("root_rank 2 of 2 did not raise")
    except ValueError:
        pass
    # autograd through allreduce: d(mean)/dx_r = 1/size per rank,
    # summed back over ranks by the backward allreduce (average)
    leaf = x.clone().requires_grad_()
    hvd.allreduce(leaf).sum().backward()
    assert torch.equal(leaf.grad, torch.ones(6))
    # compression: the wire dtype halves, the result keeps float32
    for comp, wire in ((hvd.Compression.fp16, torch.float16),
                       (hvd.Compression.bf16, torch.bfloat16)):
        out = hvd.allreduce(x / 3, compression=comp)
        assert out.dtype == torch.float32
        want = ((base / 3).to(wire).float() + ((base + 10) / 3).to(
            wire).float()).to(wire).float() / 2
        assert torch.allclose(out, want, atol=0, rtol=1e-2), (out, want)
        assert comp.compress(x)[0].dtype == wire
    hvd.barrier()


def dp_step(data, out):
    from horovod_tpu_torch.examples import llama_training
    from horovod_tpu_torch.models.convert import llama_from_flax, llama_to_flax
    from horovod_tpu_torch.models.llama import LLAMA_TINY
    from horovod_tpu_torch.ops.attention import make_attention_fn

    arrays = np.load(data)
    tree = {}
    for key in arrays.files:
        if key == "ids":
            continue
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arrays[key]
    cfg = LLAMA_TINY.__class__(**{**LLAMA_TINY.__dict__,
                                  "dtype": torch.float32})
    model = llama_from_flax(tree, cfg, device="cpu",
                            attention_fn=make_attention_fn(causal=True),
                            param_dtype=torch.float32)
    opt = llama_training.make_optimizer("adamw", model)
    r = hvd.rank()
    ids = torch.from_numpy(arrays["ids"][2 * r:2 * r + 2]).long()
    loss = llama_training.train_step(model, opt, ids,
                                     llama_training.make_loss_fn(0))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v

    walk(llama_to_flax(model), "")
    flat["loss"] = np.asarray(float(hvd.allreduce(loss)))
    np.savez(out, **flat)


if __name__ == "__main__":
    hvd.init(device="cpu")
    assert hvd.size() == 2 and torch.distributed.get_backend() == "gloo"
    if sys.argv[1] == "collectives":
        collectives()
    else:
        dp_step(sys.argv[2], sys.argv[3] + f".rank{hvd.rank()}.npz")
    hvd.shutdown()
    print("worker ok")
'''


def _run_job(tmp_path, *args, timeout=120):
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


def test_two_rank_gloo_collectives(tmp_path):
    _run_job(tmp_path, "collectives")


def _flatten(tree, prefix=""):
    out = {}
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def test_two_rank_distributed_optimizer_step_matches_jax_data_parallel(
        tmp_path):
    cfg = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
    model = jllama.LlamaLM(cfg, attention_fn=jmake(causal=True))
    params = jllama.LlamaLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)

    jhvd.init()
    tx = jhvd.DistributedOptimizer(optax.adamw(3e-4), axis_name="data")
    opt_state = tx.init(params)

    def train_step(p, s, ids):
        loss, grads = jax.value_and_grad(
            lambda p, ids: jllama.causal_lm_loss(
                model.apply({"params": p}, ids), ids))(p, ids)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, jhvd.allreduce(loss)

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    step = jax.jit(jax.shard_map(
        train_step, mesh=mesh, in_specs=(P(), P(), P("data")),
        out_specs=(P(), P(), P()), check_vma=False))
    new_params, _, loss = step(params, opt_state, jnp.asarray(ids))
    want = _flatten(jax.tree_util.tree_map(np.asarray, new_params))

    data = tmp_path / "dp.npz"
    np.savez(data, ids=ids, **_flatten(
        jax.tree_util.tree_map(np.asarray, params)))
    _run_job(tmp_path, "dp", str(data), str(tmp_path / "out"))
    for rank in range(2):
        got = np.load(tmp_path / f"out.rank{rank}.npz")
        np.testing.assert_allclose(float(got["loss"]), float(loss),
                                   rtol=1e-5)
        for key, leaf in sorted(want.items()):
            np.testing.assert_allclose(got[key], leaf, atol=2e-5, rtol=1e-4,
                                       err_msg=f"rank {rank} {key}")
