"""The port's profiler (``horovod_tpu_torch/common/profiler.py``) after
``tests/test_profiler.py``: the trace wrappers are no-ops without a
directory, write a Chrome trace with one, and the collectives run under
the ``hvd.<op>[.<name>]`` labels that the JAX package's traced
collectives carry into HLO — the same names for the same calls.

The port's collectives run on a fake-backend world of 8 ranks in one
subprocess (nothing moves; every call is recorded), so no process group
outlives this file."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.common import profiler as jprofiler
from horovod_tpu.parallel import make_mesh

from horovod_tpu_torch.common import profiler
from horovod_tpu_torch.utils.hlo_phases import Timeline, newest_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEV = 8
SCOPE = re.compile(r"hvd\.[A-Za-z_]+(?:\.[A-Za-z0-9_]+)*")

PORT = r'''
import json, sys
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples import comm_volume_report as r
from horovod_tpu_torch.utils.hlo_phases import Timeline

r.init_fake_world()
w = dist.group.WORLD


def labels(path):
    tl = Timeline(path)
    return sorted({tl.name(i) for i in tl.parents
                   if tl.name(i).startswith("hvd.")})


def collectives():
    x = torch.arange(float(8 * 4)).reshape(8 * 4, 1)[:4]
    hvd.allreduce(x, name="grads", group=w)
    hvd.allgather(x.mean(0, keepdim=True), name="stats", group=w)
    hvd.reducescatter(torch.ones(8, 1), group=w)
    hvd.alltoall(torch.ones(8, 1), group=w)


with hvd.profiler.trace(sys.argv[1]) as path:
    collectives()
out = {"collectives": labels(path),
       "optimizer": labels(r.dp_trace(sys.argv[1]))}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def port_labels(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", PORT, str(tmp_path_factory.mktemp("prof"))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _scopes(fn, *args):
    text = jax.jit(fn).lower(*args).as_text(debug_info=True)
    return set(SCOPE.findall(text))


def test_all_and_env_name_equal_jax():
    assert profiler.__all__ == jprofiler.__all__
    assert profiler.PROFILE_DIR_ENV == jprofiler.PROFILE_DIR_ENV


def test_collective_labels_equal_the_jax_scopes(port_labels):
    mesh = make_mesh({"data": N_DEV})
    x = jnp.arange(float(N_DEV * N_DEV)).reshape(N_DEV * N_DEV, 1)

    def body(x):
        r = hvd.allreduce(x, name="grads")
        g = hvd.allgather(jnp.mean(x, keepdims=True), name="stats")
        return (r.sum() + g.sum() + hvd.reducescatter(x).sum()
                + hvd.alltoall(x).sum())

    f = jax.shard_map(body, mesh=mesh, in_specs=P("data"), out_specs=P(),
                      check_vma=False)
    want = _scopes(f, x)
    assert want == {"hvd.allreduce.grads", "hvd.allgather.stats",
                    "hvd.reducescatter", "hvd.alltoall"}
    # The port's reducescatter is an allreduce and a slice on the
    # process group: its inner allreduce carries the bare label.
    assert set(port_labels["collectives"]) - {"hvd.allreduce"} == want


def test_distributed_optimizer_labels_equal_the_jax_scopes(port_labels):
    mesh = make_mesh({"data": N_DEV})
    params = {"w": jnp.ones((64, 32)), "b": jnp.ones((32,))}
    tx = hvd.DistributedOptimizer(optax.sgd(0.1), axis_name="data")
    x = jnp.ones((N_DEV * 4, 64))

    def body(p, x):
        def loss(p):
            return ((x @ p["w"] + p["b"]) ** 2).mean()
        g = jax.grad(loss)(p)
        u, _ = tx.update(g, tx.init(p), p)
        return sum(a.sum() for a in jax.tree.leaves(
            optax.apply_updates(p, u)))

    f = jax.shard_map(body, mesh=mesh, in_specs=(P(), P("data")),
                      out_specs=P(), check_vma=False)
    assert set(port_labels["optimizer"]) == _scopes(f, params, x) == {
        "hvd.allreduce.DistributedOptimizer.0",
        "hvd.allreduce.DistributedOptimizer.1"}


def test_trace_noop_without_config(monkeypatch):
    monkeypatch.delenv(profiler.PROFILE_DIR_ENV, raising=False)
    with profiler.trace() as path:      # no dir, no env: a no-op
        y = torch.ones(3).sum()
    assert path is None and float(y) == 3.0
    with pytest.raises(ValueError, match="HOROVOD_PROFILE_DIR") as err:
        profiler.start_trace()
    with pytest.raises(ValueError) as jerr:
        jprofiler.start_trace()
    assert str(err.value) == str(jerr.value)
    assert profiler.stop_trace() is None


def test_trace_writes_profile_with_step_and_annotation(tmp_path):
    d = str(tmp_path / "prof")
    with profiler.trace(d) as path:
        with profiler.step(0):
            with profiler.annotate("data.load"):
                torch.ones(8).mul(2).sum()
    assert os.path.isfile(path) and newest_trace(d) == path
    tl = Timeline(path)
    names = {tl.name(i) for i in tl.parents}
    assert {"ProfilerStep#0", "data.load", "aten::mul"} <= names
    inner = next(i for i in tl.parents if tl.name(i) == "aten::mul")
    assert [tl.name(j) for j in tl.stack(inner)][-2:] == [
        "ProfilerStep#0", "data.load"]


def test_env_dir_and_start_stop(tmp_path, monkeypatch):
    monkeypatch.setenv(profiler.PROFILE_DIR_ENV, str(tmp_path))
    with profiler.trace() as path:
        with profiler.named_scope("hvd.custom.region"):
            torch.ones(2).add(1)
    assert os.path.dirname(path) == str(tmp_path)
    started = profiler.start_trace(str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="already running"):
        profiler.start_trace(str(tmp_path / "c"))
    with profiler.named_scope("hvd.custom.region"):
        torch.ones(2).add(1)
    assert profiler.stop_trace() == started
    for p in (path, started):
        tl = Timeline(p)
        assert "hvd.custom.region" in {tl.name(i) for i in tl.parents}


def test_labels_cost_one_check_when_off():
    assert not profiler.enabled()
    assert profiler.named_scope("x") is profiler._OFF
    assert profiler.collective_label("allreduce", "w", torch.ones(2),
                                     8) is profiler._OFF
    from horovod_tpu_torch.torch import mpi_ops

    assert mpi_ops._label("allreduce", "w", torch.ones(2)) is profiler._OFF
