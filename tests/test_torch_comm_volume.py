"""Communication-volume accounting of the port
(``horovod_tpu_torch/utils/comm_accounting.py``) against the JAX
package's (``tests/test_comm_volume.py``): the ring-model functions
equal as data, and the payloads the port reads out of a profiled step
against those the JAX package reads out of the compiled HLO of the same
step, on a world of 8.

The port's steps run in one subprocess (``examples/comm_volume_report``:
a fake-backend world of 8 ranks in one process, every collective
recorded by the profiler, nothing moved), so no process group outlives
this file's tests."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu.parallel import make_mesh
from horovod_tpu.utils import comm_accounting as jca

from horovod_tpu_torch.utils import comm_accounting as tca
from horovod_tpu_torch.utils.hlo_phases import Timeline
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
OPS = ("all-reduce", "reduce-scatter", "all-gather", "collective-permute",
       "all-to-all")

PORT = r'''
import json, sys
from horovod_tpu_torch.examples import comm_volume_report as r
from horovod_tpu_torch.utils import comm_accounting as ca
from horovod_tpu_torch.utils.hlo_phases import Timeline

r.init_fake_world()
out = {}
for mode, fn in (("dp", r.dp_trace), ("zero1", r.zero1_trace),
                 ("fsdp", r.fsdp_trace)):
    tl = Timeline(fn(sys.argv[1]))
    colls = ca.collective_records(tl)
    out[mode] = {
        "payload": ca.payload_by_op([c for _, c, _ in colls]),
        "count": ca.count_by_op([c for _, c, _ in colls]),
        "groups": sorted({c.group_size for _, c, _ in colls}),
        "labels": sorted({l for _, _, l in colls}),
        "all_labels": sorted({tl.name(i) for i in tl.parents
                              if tl.name(i).startswith("hvd.")}),
        "wire": ca.wire_bytes_per_device([c for _, c, _ in colls], 8),
    }
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def port_steps(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", PORT,
         str(tmp_path_factory.mktemp("traces"))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _random_collectives(seed, module):
    rng = np.random.RandomState(seed)
    return [module.Collective(OPS[rng.randint(len(OPS))],
                              int(rng.randint(1, 1 << 24)),
                              int(rng.choice([1, 2, 4, 8, 3])))
            for _ in range(int(rng.randint(1, 40)))]


@pytest.mark.parametrize("seed", range(6))
def test_ring_model_equals_jax_bit_for_bit(seed):
    jc = _random_collectives(seed, jca)
    tc = _random_collectives(seed, tca)
    assert [(c.op, c.payload_bytes, c.group_size) for c in jc] == \
        [(c.op, c.payload_bytes, c.group_size) for c in tc]
    for n in (2, 4, 8):
        assert tca.wire_bytes_per_device(tc, n) == \
            jca.wire_bytes_per_device(jc, n)
    assert tca.count_by_op(tc) == jca.count_by_op(jc)
    assert tca.payload_by_op(tc) == jca.payload_by_op(jc)
    rng = np.random.RandomState(seed)
    for _ in range(20):
        n, b = int(rng.randint(1, 64)), int(rng.randint(0, 1 << 30))
        assert tca.ring_allreduce_bytes(n, b) == \
            jca.ring_allreduce_bytes(n, b)
        assert tca.ring_reduce_scatter_bytes(n, b) == \
            jca.ring_reduce_scatter_bytes(n, b)
        assert tca.ring_all_gather_bytes(n, b) == \
            jca.ring_all_gather_bytes(n, b)


def test_decode_path_markers_and_opcodes_equal_jax():
    assert tca.DECODE_PATH_MARKERS == jca.DECODE_PATH_MARKERS
    assert tca.COLLECTIVE_OPS == jca.COLLECTIVE_OPS


def _grad_bytes(params):
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(params))


def _compile(f, *args):
    return jax.jit(f).lower(*args).compile()


def _jax_dp():
    mesh = make_mesh({"data": N})
    params = {"w": jnp.zeros((64, 32)), "b": jnp.zeros((32,))}
    tx = hvd.DistributedOptimizer(optax.sgd(0.1), axis_name="data")
    x = jnp.ones((N * 4, 64))

    def body(p, x):
        def loss(p):
            return ((x @ p["w"] + p["b"]) ** 2).mean()
        g = jax.grad(loss)(p)
        u, _ = tx.update(g, tx.init(p), p)
        return sum(a.sum() for a in jax.tree.leaves(
            optax.apply_updates(p, u)))

    f = jax.shard_map(body, mesh=mesh, in_specs=(P(), P("data")),
                      out_specs=P(), check_vma=False)
    return params, _compile(f, params, x)


def test_dp_payload_equals_jax(port_steps):
    params, compiled = _jax_dp()
    jc = jca.collectives(compiled)
    port = port_steps["dp"]
    gbytes = _grad_bytes(params)
    assert port["payload"] == jca.payload_by_op(jc) == {"all-reduce": gbytes}
    # One allreduce a gradient (XLA may combine them: 1..2).
    assert port["count"] == {"all-reduce": 2}
    assert port["groups"] == [N]
    np.testing.assert_allclose(port["wire"],
                               jca.wire_bytes_per_device(jc, default_n=N))
    assert port["labels"] == ["hvd.allreduce.DistributedOptimizer.0",
                              "hvd.allreduce.DistributedOptimizer.1"]


def test_zero1_payload_equals_jax(port_steps):
    from horovod_tpu.jax import zero_sharded_optimizer
    from horovod_tpu.jax.zero import zero_state_specs

    mesh = make_mesh({"data": N})
    params = {"w": jnp.zeros((64, 32)), "b": jnp.zeros((32,))}
    inner = optax.sgd(0.1)
    tx = zero_sharded_optimizer(inner, axis_name="data")
    specs = zero_state_specs(inner, params, "data", N)
    x = jnp.ones((N * 4, 64))

    def body(p, s, x):
        def loss(p):
            return ((x @ p["w"] + p["b"]) ** 2).mean()
        g = jax.grad(loss)(p)
        u, s = tx.update(g, s, p)
        return sum(a.sum() for a in jax.tree.leaves(
            optax.apply_updates(p, u)))

    init = jax.jit(jax.shard_map(tx.init, mesh=mesh, in_specs=P(),
                                 out_specs=specs, check_vma=False))
    state = init(params)
    f = jax.shard_map(body, mesh=mesh, in_specs=(P(), specs, P("data")),
                      out_specs=P(), check_vma=False)
    jpay = jca.payload_by_op(jca.collectives(_compile(f, params, state, x)))
    port = port_steps["zero1"]
    # The invariant is the payload: the port packs each dtype's slices
    # into one collective (XLA keeps one a leaf).
    for op in ("reduce-scatter", "all-gather"):
        assert port["payload"][op] == jpay[op], (port, jpay)
    assert port["payload"].get("all-reduce", 0) < _grad_bytes(params) / 4
    padded = sum(-(-x.size // N) * N * x.dtype.itemsize
                 for x in jax.tree.leaves(params))
    assert port["payload"]["reduce-scatter"] == padded // N
    assert port["payload"]["all-gather"] == padded
    assert port["groups"] == [N]


def test_fsdp_payload_against_jax(port_steps):
    """The JAX test's invariants on both packages: the parameters
    gathered on use, the gradients reduced with at least half their
    bytes. The port gathers every parameter and reduce-scatters every
    gradient whole (one flat buffer: both exactly the gradient bytes);
    XLA's CPU partitioner keeps part of the second product sharded, so
    its bytes are smaller and are no equality target."""
    from jax.sharding import NamedSharding

    from horovod_tpu.jax.fsdp import (fsdp_param_specs, fsdp_shardings,
                                      fsdp_state_specs)

    mesh = make_mesh({"data": N})
    params = {"w": jnp.zeros((256, 128)), "v": jnp.zeros((128, 256))}
    tx = optax.sgd(0.1)
    specs = fsdp_param_specs(params, num_shards=N, min_leaf_elems=1)
    psh = fsdp_shardings(mesh, specs)
    ssh = fsdp_shardings(mesh, fsdp_state_specs(tx, params, specs))
    x = jax.device_put(jnp.ones((N * 4, 256)),
                       NamedSharding(mesh, P("data")))
    p_sh = jax.device_put(params, psh)
    s_sh = jax.jit(tx.init, out_shardings=ssh)(p_sh)

    def step(p, s, x):
        def loss(p):
            return ((jnp.tanh(x @ p["w"]) @ p["v"]) ** 2).mean()
        l, g = jax.value_and_grad(loss)(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, l

    jpay = jca.payload_by_op(jca.collectives(jax.jit(
        step, out_shardings=(psh, ssh, None)).lower(p_sh, s_sh, x)
        .compile()))
    gbytes = _grad_bytes(params)
    port = port_steps["fsdp"]["payload"]
    for pay in (jpay, port):
        assert pay.get("all-gather", 0) > 0
        reduced = pay.get("reduce-scatter", 0) * N + pay.get("all-reduce", 0)
        assert reduced >= gbytes / 2, pay
    assert port["all-gather"] == gbytes
    assert port["reduce-scatter"] * N == gbytes
    assert port_steps["fsdp"]["labels"] == ["hvd.allgather",
                                            "hvd.reducescatter"]


def _annotation(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1,
            "tid": tid, "ts": ts, "dur": dur, "args": {}}


def _op(name, ts, dur, dims, types, inputs=None, tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur,
            "args": {"Input Dims": dims, "Input type": types,
                     "Concrete Inputs": inputs or [""] * len(dims)}}


def test_list_ops_take_dtype_and_group_from_the_label():
    events = [
        _annotation("hvd.allreduce.grads", 0, 100),
        _op(tca.MARK_OP, 1, 1, [[64, 32], []], ["c10::BFloat16", "Scalar"],
            ["", "4"]),
        _op("c10d::allreduce_", 10, 50, [[[64, 32]], [], []],
            ["TensorList", "", ""]),
        # Unlabelled, with one tensor argument: dtype from the call, the
        # group size from the shapes.
        _op("c10d::_reduce_scatter_base_", 200, 10, [[2, 8], [16, 8]],
            ["float", "float"]),
        _op("c10d::alltoall_base_", 300, 10, [[8, 3], [8, 3]],
            ["long int", "long int"]),
    ]
    colls = tca.collectives({"traceEvents": events})
    assert [(c.op, c.payload_bytes, c.group_size) for c in colls] == [
        ("all-reduce", 64 * 32 * 2, 4), ("reduce-scatter", 2 * 8 * 4, 8),
        ("all-to-all", 8 * 3 * 8, 1)]
    with pytest.raises(ValueError, match="element type"):
        tca.collectives({"traceEvents": [_op(
            "c10d::allreduce_", 0, 5, [[[4]]], ["TensorList"])]})


def _jax_markers(cfg, prompt, index):
    from horovod_tpu.models import LlamaLM, init_kv_cache

    model = LlamaLM(cfg)
    variables = model.init(jax.random.PRNGKey(0), prompt[:, :4])
    cache = init_kv_cache(cfg, prompt.shape[0], 16)
    tokens = prompt if index == 0 else prompt[:, :1]
    compiled = jax.jit(lambda v, t, c: model.apply(
        v, t, cache=c, cache_index=index)).lower(
        variables, tokens, cache).compile()
    return jca.decode_path_markers(compiled)


def test_generate_markers_name_the_jax_paths(tmp_path):
    """A tiny Llama's ``generate()`` on the CPU: the port's profiled run
    shows the paths the JAX package's compiled prefill and decode step
    carry, and no other."""
    import torch

    from horovod_tpu.models import LLAMA_TINY as JCFG
    from horovod_tpu_torch.common import profiler
    from horovod_tpu_torch.models.llama import (LLAMA_TINY, LlamaLM,
                                                generate)

    prompt = np.random.RandomState(0).randint(0, 512, (2, 6))
    jax_paths = set()
    for index in (0, 5):
        jax_paths |= {m for m, n in sorted(_jax_markers(
            JCFG, jnp.asarray(prompt, jnp.int32), index).items()) if n}
    model = LlamaLM(LLAMA_TINY, device="cpu", seed=0)
    with profiler.trace(str(tmp_path)) as path:
        generate(model, torch.from_numpy(prompt), max_new_tokens=4)
    markers = tca.decode_path_markers(path)
    assert {m for m, n in sorted(markers.items()) if n} == jax_paths == {
        "hvd.decode.prefill", "hvd.decode.kernel"}
    # One prefill and three decode steps over LLAMA_TINY's two layers.
    assert markers["hvd.decode.prefill"] == 2
    assert markers["hvd.decode.kernel"] == 2 * 3


def test_timeline_reads_the_labels_of_a_profiled_cpu_step(tmp_path):
    import torch

    from horovod_tpu_torch.common import profiler

    with profiler.trace(str(tmp_path)) as path:
        with profiler.collective_label("allgather", "stats",
                                       torch.ones(3), 2):
            torch.ones(3).sum()
    tl = Timeline(path)
    names = {tl.name(i) for i in tl.parents}
    assert {"hvd.allgather.stats", tca.MARK_OP} <= names
