"""The port's sharded training state — ZeRO-1 (``torch.zero``) and FSDP
(``torch.fsdp``) — held against the JAX package (``jax/zero.py``,
``jax/fsdp.py``).

A 2-rank and a 4-rank gloo job on the CPU run every distributed case of
the port once (module fixture); each test runs the JAX counterpart
under ``jax.shard_map`` or ``jax.jit`` with shardings on as many CPU
devices, from the same seeded numpy inputs, and compares. Mirrors
``tests/test_zero.py`` (Adam and momentum SGD against the unsharded
optimizer and the JAX ZeRO wrapper: losses rtol 1e-5, params rtol 1e-5
atol 1e-6; the padded state sizes; a scalar parameter; an unknown state
leaf refused) and ``tests/test_fsdp.py`` (the spec rule, its
composition with a tensor-parallel base, None as replicated, state-spec
matching, the refusal of a large unmatched state; Llama-tiny FSDP
training in float32 against the single-device and the FSDP step: loss
rtol 2e-5, params rtol 2e-4 atol 2e-5; the dp x tp hybrid at rtol 1e-3).

Dims: the port keeps flax's (in, out) kernel layout but flattens the
heads (``wq`` is (dim, H*D) where flax has (dim, H, D), ``wo`` (H*D,
dim) where flax has (H, D, dim)), so the spec of a leaf can name another
index; the tests compare what each package shards and
``sharded_size_bytes``, which the rule keeps equal.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import horovod_tpu as jhvd
from horovod_tpu.jax import zero_sharded_optimizer as jzero
from horovod_tpu.jax.fsdp import fsdp_param_specs as j_param_specs
from horovod_tpu.jax.fsdp import fsdp_shardings as j_shardings
from horovod_tpu.jax.fsdp import fsdp_state_specs as j_state_specs
from horovod_tpu.jax.fsdp import sharded_size_bytes as j_size_bytes
from horovod_tpu.jax.zero import zero_state_specs as j_zero_state_specs
from horovod_tpu.models import llama as jllama
from horovod_tpu.parallel import make_mesh as jmesh
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.torch import fsdp as tfsdp
from horovod_tpu_torch.torch import zero as tzero
from horovod_tpu_torch.torch.partition import P, abstract_state

from torch_gloo import WORKER_HEAD, run_job

FEATURES = 13
ROWS = 64                    # the global batch of the ZeRO cases
ZERO_STEPS = 25
LLAMA_ROWS, LLAMA_SEQ = 8, 32
JCFG = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)

WORKER = WORKER_HEAD + '''
import dataclasses

import torch.distributed as dist

from horovod_tpu_torch.models.convert import llama_from_flax, llama_to_flax
from horovod_tpu_torch.models.llama import (LLAMA_TINY, LlamaLM,
                                            causal_lm_loss,
                                            llama_tp_param_specs)
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.torch.fsdp import fsdp_param_specs, fully_shard

CFG = dataclasses.replace(LLAMA_TINY, dtype=torch.float32)


def zero_run(res, arrays, spec, r, n, dtype, sharded):
    """``spec``'s optimizer for ``steps`` steps: ZeRO over the job on
    this rank's rows, or (``sharded=False``) unwrapped on every row."""
    tag = f"{spec['name']}/{str(dtype)[6:]}/{'zero' if sharded else 'full'}"
    x, y = (torch.from_numpy(arrays[k]).to(dtype)
            for k in ("zero/x", "zero/y"))
    if sharded:
        rows = x.shape[0] // n
        x, y = x[r * rows:(r + 1) * rows], y[r * rows:(r + 1) * rows]
    params = {k: torch.tensor(arrays[f"zero/{k}"], dtype=dtype,
                              requires_grad=True) for k in ("w", "b")}
    inner = (torch.optim.Adam(params.values(), lr=1e-2)
             if spec["opt"] == "adam" else
             torch.optim.SGD(params.values(), lr=1e-2, momentum=0.9))
    opt = hvd.zero_sharded_optimizer(inner) if sharded else inner
    losses = []
    for _ in range(spec["steps"]):
        opt.zero_grad()
        loss = ((x @ params["w"] + params["b"] - y) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(hvd.allreduce(loss.detach()) if sharded
                      else loss.detach())
    res[f"{tag}/losses"] = torch.stack(losses)
    for k, v in params.items():
        res[f"{tag}/{k}"] = v
    if sharded:
        sd = opt.state_dict()
        key = "exp_avg" if spec["opt"] == "adam" else "momentum_buffer"
        for i, k in enumerate(params):
            res[f"{tag}/state_{k}"] = sd["state"][i][key]
        opt.load_state_dict(sd)         # this rank's slice back


def zero_case(res, arrays, spec, r, n):
    zero_run(res, arrays, spec, r, n, torch.float32, True)
    zero_run(res, arrays, spec, r, n, torch.float32, False)
    zero_run(res, arrays, spec, r, n, torch.float64, True)


def scalar_case(res, n):
    params = {"w": torch.ones(4, requires_grad=True),
              "t": torch.tensor(0.5, requires_grad=True)}
    opt = hvd.zero_sharded_optimizer(
        torch.optim.Adam(params.values(), lr=1e-2))
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    res["scalar/t"] = params["t"]
    res["scalar/w"] = params["w"]
    res["scalar/mu_t"] = opt.state_dict()["state"][1]["exp_avg"]


def fsdp_case(res, arrays, spec, mesh):
    name = spec["name"]
    tp = mesh.axis_size("model")
    data, dr = mesh.axis_size("data"), mesh.axis_index("data")
    model = llama_from_flax(tree_of(arrays, "llama/params/"), CFG,
                            device="cpu", param_dtype=torch.float32,
                            mesh=mesh if tp > 1 else None)
    with torch.device("meta"):
        shapes = dict(LlamaLM(CFG, device="meta", param_dtype=torch.float32)
                      .named_parameters())
    base = llama_tp_param_specs(shapes) if tp > 1 else None
    specs = fsdp_param_specs(shapes, data, base_specs=base,
                             min_leaf_elems=1024)
    fully_shard(model, specs, mesh.group("data"))
    wq = model.layers[0].attention.wq
    res[f"{name}/wq_shard_numel"] = np.array(wq.numel())
    res[f"{name}/bytes"] = np.array(sum(
        p.numel() * p.element_size() for p in model.parameters()))
    opt = (torch.optim.Adam(model.parameters(), lr=1e-2)
           if spec["opt"] == "adam" else
           torch.optim.SGD(model.parameters(), lr=1e-2, momentum=0.9))
    ids = torch.from_numpy(arrays["llama/ids"]).long()
    rows = ids.shape[0] // data
    ids = ids[dr * rows:(dr + 1) * rows]
    losses = []
    for _ in range(spec["steps"]):
        opt.zero_grad()
        loss = causal_lm_loss(model(ids), ids)
        loss.backward()
        opt.step()
        ls = loss.detach().clone()
        dist.all_reduce(ls, group=mesh.group("data"))
        losses.append(ls / data)
    res[f"{name}/losses"] = torch.stack(losses)
    if tp == 1:
        plain = LlamaLM(CFG, device="cpu", param_dtype=torch.float32)
        plain.load_state_dict(model.full_state_dict())
        for key, value in flatten(llama_to_flax(plain)):
            res[f"{name}/params/{key}"] = value


def main():
    hvd.init(device="cpu")
    arrays, specs = load_cases()
    r, n = hvd.rank(), hvd.size()
    res = {}
    for spec in specs:
        if spec["kind"] == "zero":
            zero_case(res, arrays, spec, r, n)
        elif spec["kind"] == "scalar":
            scalar_case(res, n)
        elif spec["kind"] == "fsdp":
            mesh = make_mesh({"data": n // spec["tp"], "model": spec["tp"]})
            fsdp_case(res, arrays, spec, mesh)
        else:
            raise ValueError(spec["kind"])
    save(res)
    hvd.shutdown()
    print("worker ok")


if __name__ == "__main__":
    main()
'''


def _zero_setup():
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(FEATURES, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    x = rng.randn(ROWS, FEATURES).astype(np.float32)
    y = rng.randn(ROWS, 4).astype(np.float32)
    return params, x, y


def _llama_setup():
    model = jllama.LlamaLM(JCFG)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, JCFG.vocab_size, (LLAMA_ROWS, LLAMA_SEQ))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.asarray(ids[:1]))["params"]
    return model, params, ids


def _flat(tree, prefix=""):
    out = {}
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            out.update(_flat(value, prefix + key + "/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


ZERO_CASES = {"zero_adam": "adam", "zero_sgd": "sgd"}
JOBS = {2: [("fsdp", 1, "sgd")], 4: [("hybrid", 2, "adam")]}


def _build(world):
    params, x, y = _zero_setup()
    inputs = {"zero/w": params["w"], "zero/b": params["b"], "zero/x": x,
              "zero/y": y}
    specs = [dict(name=name, kind="zero", opt=opt, steps=ZERO_STEPS)
             for name, opt in sorted(ZERO_CASES.items())]
    specs.append(dict(name="scalar", kind="scalar"))
    _, lparams, ids = _llama_setup()
    inputs["llama/ids"] = ids
    inputs.update({f"llama/params/{k}": v
                   for k, v in sorted(_flat(lparams).items())})
    for name, tp, opt in JOBS[world]:
        specs.append(dict(name=name, kind="fsdp", tp=tp, opt=opt, steps=2))
    return inputs, specs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both gloo jobs, run once: world -> per-rank outputs."""
    return {world: run_job(tmp_path_factory.mktemp(f"zero_fsdp{world}"),
                           world, WORKER, *_build(world))
            for world in (2, 4)}


@pytest.fixture(scope="module")
def jax_hvd():
    jhvd.init()
    yield
    jhvd.shutdown()


# ---------------------------------------------------------------------------
# ZeRO-1


def _jax_mesh(axes):
    n = int(np.prod(sorted(axes.values())))
    return jmesh(axes, devices=jax.devices()[:n])


def _jax_zero_train(world, opt, steps=ZERO_STEPS, dtype=jnp.float32):
    """``tests/test_zero.py``'s ``_train`` over ``world`` devices."""
    params, x, y = _zero_setup()
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    x, y = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
    inner = (lambda: optax.adam(1e-2)) if opt == "adam" else \
        (lambda: optax.sgd(1e-2, momentum=0.9))
    tx = jzero(inner(), axis_name="data")
    sspecs = j_zero_state_specs(inner(), params, "data", world)
    mesh = _jax_mesh({"data": world})

    def loss_fn(p, xb, yb):
        return jnp.mean((xb @ p["w"] + p["b"] - yb) ** 2)

    def body(p, s, xb, yb):
        loss, g = jax.value_and_grad(loss_fn)(p, xb, yb)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, jax.lax.pmean(loss, "data")

    init = jax.jit(jax.shard_map(tx.init, mesh=mesh, in_specs=JP(),
                                 out_specs=sspecs, check_vma=False))
    step = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(JP(), sspecs, JP("data"), JP("data")),
        out_specs=(JP(), sspecs, JP()), check_vma=False))
    state = init(params)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
    return params, state, losses


def _jax_unsharded(opt, steps=ZERO_STEPS, dtype=jnp.float32):
    params, x, y = _zero_setup()
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    x, y = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
    tx = optax.adam(1e-2) if opt == "adam" else \
        optax.sgd(1e-2, momentum=0.9)
    state = tx.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(
            lambda q: jnp.mean((x @ q["w"] + q["b"] - y) ** 2))(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return params, losses


BAR = dict(rtol=1e-5, atol=1e-6)         # tests/test_zero.py's


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(ZERO_CASES))
def test_zero_matches_unsharded_and_jax_zero(results, jax_hvd, world, name):
    """At the JAX test's bar: float32 ZeRO against the same optimizer
    unsharded on the full batch (the JAX test's own comparison), and its
    losses against the JAX package's unsharded and ZeRO runs; float64
    ZeRO against both JAX runs in float64, losses and parameters. (The
    float32 parameters are not held against XLA's: XLA's and torch's
    float32 gradients differ by ~2e-7 at step 0, which 25 Adam steps of
    the unsharded optimizer alone carry to ~3e-6, over the bar.)"""
    opt = ZERO_CASES[name]
    ref_params, ref_losses = _jax_unsharded(opt)
    _, _, j_losses = _jax_zero_train(world, opt)
    with jax.enable_x64(True):
        ref64, ref64_losses = _jax_unsharded(opt, dtype=jnp.float64)
        j64, _, j64_losses = _jax_zero_train(world, opt, dtype=jnp.float64)
    for rank in results[world]:
        f32, full, f64 = (f"{name}/{t}" for t in
                          ("float32/zero", "float32/full", "float64/zero"))
        np.testing.assert_allclose(rank[f"{f32}/losses"],
                                   rank[f"{full}/losses"], rtol=1e-5)
        for want in (ref_losses, j_losses):
            np.testing.assert_allclose(rank[f"{f32}/losses"], want,
                                       rtol=1e-5)
        for want in (ref64_losses, j64_losses):
            np.testing.assert_allclose(rank[f"{f64}/losses"], want,
                                       rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(rank[f"{f32}/{k}"],
                                       rank[f"{full}/{k}"], **BAR,
                                       err_msg=k)
            for want in (ref64[k], j64[k]):
                np.testing.assert_allclose(rank[f"{f64}/{k}"],
                                           np.asarray(want), **BAR,
                                           err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_zero_state_is_sharded_and_padded(results, jax_hvd, world):
    """``state_dict()`` holds the full padded leaf JAX's global state
    array shows (56 / 8 entries for w / b at 8 ranks; here 2 and 4),
    equal (float64) to the JAX ZeRO wrapper's first moment after 25
    steps."""
    with jax.enable_x64(True):
        _, j_state, _ = _jax_zero_train(world, "adam", dtype=jnp.float64)
        mu = jax.tree.map(np.asarray, j_state[0].mu)
    for rank in results[world]:
        for k, numel in (("w", FEATURES * 4), ("b", 4)):
            padded = -(-numel // world) * world
            for dtype in ("float32", "float64"):
                got = rank[f"zero_adam/{dtype}/zero/state_{k}"]
                assert got.shape == (padded,) == mu[k].shape, (k, got.shape)
            np.testing.assert_allclose(got, mu[k], **BAR)


@pytest.mark.parametrize("world", [2, 4])
def test_zero_scalar_param_leaf(results, jax_hvd, world):
    """A scalar's moments live as one entry a rank; every rank applies
    the same update to it (JAX: ``test_zero_scalar_param_leaf``)."""
    mesh = _jax_mesh({"data": world})
    params = {"w": jnp.ones((4,)), "t": jnp.asarray(0.5)}
    inner = optax.adam(1e-2)
    tx = jzero(inner, axis_name="data")
    specs = j_zero_state_specs(inner, params, "data", world)
    state = jax.jit(jax.shard_map(tx.init, mesh=mesh, in_specs=JP(),
                                  out_specs=specs, check_vma=False))(params)

    def body(p, s):
        u, s = tx.update(jax.tree.map(jnp.ones_like, p), s, p)
        return optax.apply_updates(p, u), s

    p2, state = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(JP(), specs), out_specs=(JP(), specs),
        check_vma=False))(params, state)
    for rank in results[world]:
        assert rank["scalar/mu_t"].shape == (world,)
        assert float(rank["scalar/t"]) != 0.5
        np.testing.assert_allclose(rank["scalar/t"], np.asarray(p2["t"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(rank["scalar/w"], np.asarray(p2["w"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(rank["scalar/mu_t"],
                                   np.asarray(state[0].mu["t"]), rtol=1e-6)


def test_zero_state_specs_match_jax_and_refuse_unknown_leaf():
    params = {"w": torch.zeros(FEATURES, 4), "b": torch.zeros(4)}
    adam = torch.optim.Adam([params["w"], params["b"]], lr=1e-2)
    specs = tzero.zero_state_specs(adam, params, "data", 8)
    jspecs = j_zero_state_specs(
        optax.adam(1e-2), jax.tree.map(jnp.asarray, _zero_setup()[0]),
        "data", 8)
    for k in ("w", "b"):
        assert specs[k] == {"step": P(), "exp_avg": P("data"),
                            "exp_avg_sq": P("data")}
        assert tuple(jspecs[0].mu[k]) == tuple(specs[k]["exp_avg"])
    assert tuple(jspecs[0].count) == tuple(specs["w"]["step"])

    class Weird(torch.optim.Optimizer):
        """State not derived from the parameters (JAX: a schedule
        table)."""

        def __init__(self, ps):
            super().__init__(ps, {})

        def step(self, closure=None):
            for g in self.param_groups:
                for p in g["params"]:
                    self.state[p]["table"] = torch.zeros(100,
                                                         device=p.device)

    with pytest.raises(ValueError, match="cannot be inferred") as info:
        tzero.zero_state_specs(Weird([params["w"], params["b"]]), params,
                               "data", 8)
    weird = optax.GradientTransformation(
        init=lambda p: {"table": jnp.zeros((100,))},
        update=lambda u, s, p=None: (u, s))
    with pytest.raises(ValueError, match="cannot be inferred") as jinfo:
        j_zero_state_specs(weird, {"w": jnp.zeros((FEATURES, 4))}, "data",
                           8)
    assert str(info.value).split(" matches")[0] == \
        str(jinfo.value).split(" matches")[0]


# ---------------------------------------------------------------------------
# FSDP specs


def _both_specs(shapes, n, **kw):
    tparams = {k: tuple(s) for k, s in sorted(shapes.items())}
    jparams = {k: jnp.zeros(s) for k, s in sorted(shapes.items())}
    return (tfsdp.fsdp_param_specs(tparams, n, **kw),
            j_param_specs(jparams, n, **kw))


def test_param_specs_pick_largest_free_divisible_dim():
    shapes = {"w": (16, 64, 24), "embed": (512, 48), "odd": (30, 42),
              "scale": (64,)}
    for threshold in (1, 128):
        t, j = _both_specs(shapes, 8, min_leaf_elems=threshold)
        for k in shapes:
            assert tuple(t[k]) == tuple(j[k]), (k, t[k], j[k])
    t, _ = _both_specs(shapes, 8, min_leaf_elems=1)
    assert t == {"w": P(None, "data", None), "embed": P("data", None),
                 "odd": P(), "scale": P("data")}


def _port_llama_params(cfg):
    with torch.device("meta"):
        model = tllama.LlamaLM(cfg, device="meta",
                               param_dtype=torch.float32)
    return dict(model.named_parameters())


def _jax_llama_params(cfg):
    model = jllama.LlamaLM(cfg)
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]


def test_param_specs_compose_with_tp_base():
    tparams = _port_llama_params(tllama.LLAMA_TINY)
    jparams = _jax_llama_params(jllama.LLAMA_TINY)
    tp = tllama.llama_tp_param_specs(tparams, axis="model")
    specs = tfsdp.fsdp_param_specs(tparams, 2, axis="data", base_specs=tp,
                                   min_leaf_elems=1)
    jtp = jllama.llama_tp_param_specs(jparams, axis="model")
    jspecs = j_param_specs(jparams, 2, axis="data", base_specs=jtp,
                           min_leaf_elems=1)
    # TP claims the heads; FSDP the free input dim, in both packages.
    assert specs["layers.0.attention.wq"] == P("data", "model")
    assert tuple(jspecs["layer_0"]["attention"]["wq"]["kernel"]) == \
        ("data", "model", None)
    assert specs["lm_head"] == P("data", "model") == \
        tuple(jspecs["lm_head"]["kernel"])
    axes = {"data": 2, "model": 2}
    assert tfsdp.sharded_size_bytes(tparams, specs, axes) == \
        j_size_bytes(jparams, jspecs, axes)
    with pytest.raises(ValueError, match="already uses axis"):
        tfsdp.fsdp_param_specs(tparams, 2, axis="model", base_specs=tp)


def test_param_specs_accept_none_as_replicated_base():
    params = {"w": (64, 16), "b": (16,)}
    specs = tfsdp.fsdp_param_specs(params, 8,
                                   base_specs={"w": P(None, "model"),
                                               "b": None},
                                   min_leaf_elems=1)
    assert specs == {"w": P("data", "model"), "b": P("data")}


def test_state_specs_structural_match():
    params = {"w": torch.zeros(64, 16),
              "nested.w": torch.zeros(32, 8)}
    specs = tfsdp.fsdp_param_specs(params, 8, min_leaf_elems=1)
    opt = torch.optim.AdamW(sorted(params.items()), lr=1e-3)
    sspecs = tfsdp.fsdp_state_specs(opt, specs)
    jparams = {"w": jnp.zeros((64, 16)), "nested": {"w": jnp.zeros((32, 8))}}
    jspecs = j_param_specs(jparams, 8, min_leaf_elems=1)
    jss = j_state_specs(optax.adamw(1e-3), jparams, jspecs)
    mu = jss[0].mu
    for name, jmu in (("w", mu["w"]), ("nested.w", mu["nested"]["w"])):
        assert sspecs[name]["exp_avg"] == sspecs[name]["exp_avg_sq"] == \
            P("data", None) == tuple(jmu)
        assert sspecs[name]["step"] == P() == tuple(jss[0].count)


def test_state_specs_small_unmatched_state_replicates():
    params = {"w": torch.zeros(256, 512)}
    specs = tfsdp.fsdp_param_specs(params, 8, min_leaf_elems=1)
    opt = torch.optim.Adafactor(sorted(params.items()), lr=1e-3)
    sspecs = tfsdp.fsdp_state_specs(opt, specs)
    # The factored row/col moments match no parameter shape: replicated.
    state = abstract_state(opt, {"w": (params["w"], (256, 512),
                                       torch.float32)})["w"]
    factored = [k for k, v in sorted(state.items())
                if torch.is_tensor(v) and v.ndim and v.shape != (256, 512)]
    assert factored and all(sspecs["w"][k] == P() for k in factored)
    jss = j_state_specs(optax.adafactor(1e-3), {"w": jnp.zeros((256, 512))},
                        j_param_specs({"w": jnp.zeros((256, 512))}, 8,
                                      min_leaf_elems=1))
    assert JP() in jax.tree_util.tree_leaves(
        jss, is_leaf=lambda s: isinstance(s, JP))


def test_state_specs_refuse_large_unmatched_leaf():
    params = {"w": torch.zeros(256, 512)}
    specs = tfsdp.fsdp_param_specs(params, 8, min_leaf_elems=1)

    class Tabled(torch.optim.Adam):
        def step(self, closure=None):
            super().step(closure)
            for g in self.param_groups:
                for p in g["params"]:
                    self.state[p]["table"] = torch.zeros(4096, 4096,
                                                         device=p.device)

    with pytest.raises(ValueError, match="matches no parameter"):
        tfsdp.fsdp_state_specs(Tabled(sorted(params.items()), lr=1e-3), specs)
    with pytest.raises(ValueError, match="named_parameters"):
        tfsdp.fsdp_state_specs(torch.optim.Adam([params["w"]]), specs)


@pytest.mark.parametrize("which", ["TINY", "300M", "8B"])
def test_sharded_size_bytes_equal_jax(which):
    """Per-rank parameter and Adam-moment bytes at every shard count,
    the port's spec functions over its modules on ``meta`` against the
    JAX package's over ``jax.eval_shape``."""
    tcfg = getattr(tllama, f"LLAMA_{which}")
    jcfg = getattr(jllama, f"LLAMA_{which}")
    tparams = _port_llama_params(tcfg)
    jparams = _jax_llama_params(jcfg)
    opt = torch.optim.Adam(sorted(tparams.items()), lr=1e-4)
    state = abstract_state(opt, {k: (p, tuple(p.shape), p.dtype)
                                 for k, p in sorted(tparams.items())})
    jstate = jax.eval_shape(optax.adam(1e-4).init, jparams)
    for n in (1, 2, 8, 64):
        for threshold in (tfsdp.FSDP_MIN_LEAF_ELEMS, 1024):
            specs = tfsdp.fsdp_param_specs(tparams, n,
                                           min_leaf_elems=threshold)
            jspecs = j_param_specs(jparams, n, min_leaf_elems=threshold)
            axes = {"data": n}
            assert tfsdp.sharded_size_bytes(tparams, specs, axes) == \
                j_size_bytes(jparams, jspecs, axes), (n, threshold)
            sspecs = tfsdp.fsdp_state_specs(opt, specs)
            moments = {k: {m: v[m] for m in ("exp_avg", "exp_avg_sq")}
                       for k, v in sorted(state.items())}
            mspecs = {k: {m: v[m] for m in ("exp_avg", "exp_avg_sq")}
                      for k, v in sorted(sspecs.items())}
            jss = j_state_specs(optax.adam(1e-4), jparams, jspecs)
            jmoments = j_size_bytes(jstate[0].mu, jss[0].mu, axes) + \
                j_size_bytes(jstate[0].nu, jss[0].nu, axes)
            assert tfsdp.sharded_size_bytes(moments, mspecs, axes) == \
                jmoments, (n, threshold)


# ---------------------------------------------------------------------------
# FSDP training


def _jax_llama_steps(mesh_axes, opt, steps=2, tp=False):
    """``steps`` steps of the JAX package: single-device, and with the
    FSDP (``tp``: dp x tp) shardings on ``mesh_axes``. Returns (losses
    single, params single, losses sharded, params sharded)."""
    model, params, ids = _llama_setup()
    tx = optax.adam(1e-2) if opt == "adam" else \
        optax.sgd(1e-2, momentum=0.9)
    mesh = _jax_mesh(mesh_axes)
    base = jllama.llama_tp_param_specs(params, axis="model") if tp else None
    specs = j_param_specs(params, num_shards=mesh_axes["data"],
                          base_specs=base, min_leaf_elems=1024)
    psh = j_shardings(mesh, specs)
    ssh = j_shardings(mesh, j_state_specs(tx, params, specs))

    def step(p, s, ids):
        loss, g = jax.value_and_grad(lambda q: jllama.causal_lm_loss(
            model.apply({"params": q}, ids), ids))(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    ids = jnp.asarray(ids)
    p_sh = jax.device_put(params, psh)
    s_sh = jax.jit(tx.init, out_shardings=ssh)(p_sh)
    step_sh = jax.jit(step, out_shardings=(psh, ssh, None))
    ids_sh = jax.device_put(ids, NamedSharding(mesh, JP("data")))
    step_ref = jax.jit(step)
    p, s = params, tx.init(params)
    single, sharded = [], []
    for _ in range(steps):
        p, s, loss = step_ref(p, s, ids)
        single.append(float(loss))
        p_sh, s_sh, loss_sh = step_sh(p_sh, s_sh, ids_sh)
        sharded.append(float(loss_sh))
    return single, p, sharded, p_sh


def test_fsdp_training_parity_and_memory(results):
    """Two momentum-SGD steps of Llama-tiny (float32) with FSDP over 2
    gloo ranks equal JAX's single-device step and its FSDP step; each
    rank holds half of ``wq`` and exactly its ``sharded_size_bytes``;
    ``full_state_dict()`` loads a plain model that ``llama_to_flax``
    reads."""
    single, p_ref, sharded, p_sh = _jax_llama_steps({"data": 2}, "sgd")
    cfg = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
    tparams = _port_llama_params(cfg)
    specs = tfsdp.fsdp_param_specs(tparams, 2, min_leaf_elems=1024)
    want_bytes = tfsdp.sharded_size_bytes(tparams, specs, {"data": 2})
    for rank in results[2]:
        np.testing.assert_allclose(rank["fsdp/losses"], single, rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(rank["fsdp/losses"], sharded, rtol=2e-5,
                                   atol=1e-6)
        assert int(rank["fsdp/wq_shard_numel"]) * 2 == 64 * 64
        assert int(rank["fsdp/bytes"]) == want_bytes
        got = {k[len("fsdp/params/"):]: v for k, v in sorted(rank.items())
               if k.startswith("fsdp/params/")}
        for want in (_flat(p_ref), _flat(p_sh)):
            assert sorted(got) == sorted(want)
            for k, v in sorted(want.items()):
                np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=2e-5,
                                           err_msg=k)


def test_fsdp_dp_tp_hybrid_trains(results):
    """dp x tp (2 x 2 gloo ranks), Adam: the port's TP model sharded over
    ``data`` on its TP layout, against JAX's single-device and hybrid
    steps (``test_fsdp_dp_tp_hybrid_trains``'s bar, rtol 1e-3)."""
    single, _, sharded, _ = _jax_llama_steps({"data": 2, "model": 2},
                                             "adam", tp=True)
    for rank in results[4]:
        np.testing.assert_allclose(rank["hybrid/losses"], single, rtol=1e-3)
        np.testing.assert_allclose(rank["hybrid/losses"], sharded,
                                   rtol=1e-3)
        # wq: its heads over model (2), its input dim over data (2).
        assert int(rank["hybrid/wq_shard_numel"]) * 4 == 64 * 64
