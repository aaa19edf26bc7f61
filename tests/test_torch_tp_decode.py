"""The port's tensor-parallel decode (``models.llama`` with ``mesh=``,
``classify_decode_sharding``, ``ops.decode_attention.sharded_*_step``,
``generate()`` and ``ServingEngine`` on the ``kernel_tp`` path, and the
converter's TP slicing) held against the JAX package.

A 2-rank and a 4-rank gloo job on the CPU run every case of the port;
each test runs the JAX counterpart on as many CPU devices with the same
seeded numpy inputs. Mirrors ``tests/test_decode_attention.py`` (the
sharded steps on (1, 2), (2, 2) and (1, 4) meshes, their checks, the
classifier's three verdicts) and ``tests/test_serving.py`` (the TP
engine's parity). The JAX steps run their Pallas kernel in interpret
mode; the port's run the kernels' plain versions. float32; steps
within atol 2e-5 + rtol 1e-4 and caches within 1e-6 (the JAX tests'
tolerances), greedy tokens exactly equal.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from horovod_tpu.models import llama as jllama
from horovod_tpu.ops import decode_attention as jdec
from horovod_tpu.serving import ServingConfig as JServingConfig
from horovod_tpu.serving.engine import ServingEngine as JServingEngine

from torch_gloo import WORKER_HEAD, run_job
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=2e-5, rtol=1e-4)
JCFG = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32,
                           max_seq_len=64)
SCFG = dict(max_batch=4, block_size=8, num_blocks=0, queue_depth=64,
            max_seq_len=64)

WORKER = WORKER_HEAD + '''
import dataclasses

import torch.distributed as dist

from horovod_tpu_torch.models import llama
from horovod_tpu_torch.models.convert import llama_from_flax, llama_to_flax
from horovod_tpu_torch.ops import decode_attention as dec
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.serving import ServingConfig, ServingEngine

CFG = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32,
                          max_seq_len=64)


def step_case(res, arrays, spec, mesh):
    """This rank's shard of a sharded decode step: its batch rows (over
    ``batch_axis``) and its heads (over ``model``)."""
    name = spec["name"]
    tp, r = mesh.axis_size("model"), mesh.axis_index("model")
    a = {k: torch.from_numpy(arrays[f"{name}/{k}"])
         for k in ("q", "kn", "vn", "kc", "vc")}
    h, hkv, d = a["q"].shape[2], a["kn"].shape[2], a["q"].shape[3]
    rows = slice(None)
    if spec.get("batch_axis"):
        dp, di = mesh.axis_size("data"), mesh.axis_index("data")
        nb = a["q"].shape[0] // dp
        rows = slice(di * nb, (di + 1) * nb)
    hl, kl = h // tp, hkv // tp
    q = a["q"][rows, :, r * hl:(r + 1) * hl].contiguous()
    kn, vn = (a[x][rows, :, r * kl:(r + 1) * kl].contiguous()
              for x in ("kn", "vn"))
    if spec["kind"] == "step":
        kc, vc = (a[x][rows, :, r * kl * d:(r + 1) * kl * d].contiguous()
                  for x in ("kc", "vc"))
        out, k2, v2 = dec.sharded_decode_step(
            q, kn, vn, kc, vc, spec["idx"], hkv, mesh=mesh,
            head_axis="model", batch_axis=spec.get("batch_axis"))
    else:
        kc, vc = (a[x][:, :, r * kl * d:(r + 1) * kl * d].contiguous()
                  for x in ("kc", "vc"))
        tables = torch.from_numpy(arrays[f"{name}/tables"])
        lens = torch.from_numpy(arrays[f"{name}/lens"])
        out, k2, v2 = dec.sharded_paged_decode_step(
            q, kn, vn, kc, vc, tables, lens, hkv, mesh=mesh,
            head_axis="model")
    res.update({f"{name}/out": out, f"{name}/k": k2, f"{name}/v": v2})


def checks(res, mesh):
    q = torch.zeros(2, 1, 2, 8)
    kn = torch.zeros(2, 1, 1, 8)
    kc = torch.zeros(2, 16, 8)
    cases = {
        "uneven": lambda: dec.sharded_decode_step(
            q, kn, kn, kc, kc, 0, 3, mesh=mesh, head_axis="model"),
        "multi_token": lambda: dec.sharded_decode_step(
            torch.zeros(2, 2, 2, 8), kn, kn, kc, kc, 0, 2, mesh=mesh,
            head_axis="model"),
        "paged_dp": lambda: dec.sharded_paged_decode_step(
            q, kn, kn, kc, kc, torch.zeros(2, 2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 2, mesh=mesh,
            head_axis="model", batch_axis="data"),
    }
    for label, fn in cases.items():
        try:
            fn()
            res[f"checks/{label}"] = np.array("no error")
        except (ValueError, NotImplementedError) as exc:
            res[f"checks/{label}"] = np.array(
                f"{type(exc).__name__}: {exc}")


def model_cases(res, arrays, specs, mesh, tag):
    tree = tree_of(arrays, "params/")
    model = llama_from_flax(tree, CFG, device="cpu", mesh=mesh)
    info = llama.classify_decode_sharding(
        model, torch.zeros(4, 1, dtype=torch.int64), CFG.num_kv_heads)
    res[f"{tag}/verdict"] = np.array(info.path)
    res[f"{tag}/reason"] = np.array(info.reason)
    prompt = torch.from_numpy(arrays["generate/prompt"])
    out = llama.generate(model, prompt, 5)
    res[f"{tag}/generate"] = out
    res[f"{tag}/generate_path"] = np.array(llama.LAST_DECODE_PATH.path)
    for name in ("mixed", "sharing"):
        if f"{tag}/{name}" not in specs:
            continue
        engine = ServingEngine(model, ServingConfig(**specs["scfg"]))
        res[f"{tag}/{name}/path"] = np.array(engine.decode_path.path)
        handles = []
        i = 0
        while f"{name}/prompt{i}" in arrays:
            handles.append(engine.submit(arrays[f"{name}/prompt{i}"],
                                         int(arrays[f"{name}/new"][i])))
            i += 1
        engine.run_until_idle()
        for i, h in enumerate(handles):
            res[f"{tag}/{name}/tokens{i}"] = np.array(h.result(timeout=0))
        res[f"{tag}/{name}/prefix_hits"] = np.array(
            engine.stats()["prefix_hits"])
        try:
            engine.start()
            res[f"{tag}/{name}/start"] = np.array("started")
        except RuntimeError as exc:
            res[f"{tag}/{name}/start"] = np.array(str(exc))
        engine.shutdown()
    if f"{tag}/roundtrip" in specs:
        for key, arr in flatten(llama_to_flax(model)):
            res[f"{tag}/roundtrip/{key}"] = arr
        # The gradients of the loss, gathered: a TP training step's.
        train = llama_from_flax(tree, CFG, device="cpu", mesh=mesh,
                                param_dtype=torch.float32)
        ids = torch.from_numpy(arrays["grad/ids"])
        llama.causal_lm_loss(train(ids), ids).backward()
        res[f"{tag}/logits"] = train(ids).detach()
        for key, arr in flatten(llama_to_flax(train, grads=True)):
            res[f"{tag}/grad/{key}"] = arr


def main():
    hvd.init(device="cpu")
    arrays, specs = load_cases()
    n = hvd.size()
    res = {}
    tp_mesh = make_mesh({"data": 1, "model": n})
    if n == 4:
        dp_mesh = make_mesh({"data": 2, "model": 2})
    for spec in specs["steps"]:
        step_case(res, arrays, spec,
                  dp_mesh if spec.get("mesh") == "2x2" else tp_mesh)
    if n == 2:
        checks(res, tp_mesh)
    model_cases(res, arrays, specs, tp_mesh, f"tp{n}")
    save(res)
    hvd.shutdown()
    print("worker ok")


if __name__ == "__main__":
    main()
'''


def _params():
    model = jllama.LlamaLM(JCFG)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _flat(tree, prefix=""):
    out = {}
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            out.update(_flat(value, prefix + key + "/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def _step_inputs(seed, b=4, L=32, hkv=4, h=8, d=16):
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.4).astype(np.float32)  # noqa: E731
    return dict(q=mk(b, 1, h, d), kn=mk(b, 1, hkv, d), vn=mk(b, 1, hkv, d),
                kc=mk(b, L, hkv * d), vc=mk(b, L, hkv * d))


def _paged_inputs(seed, b=4, hkv=4, h=8, d=16, bs=4, slots=4):
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.4).astype(np.float32)  # noqa: E731
    n_phys = b * slots + 1
    tables = (rng.permutation(n_phys - 1) + 1).reshape(b, slots)
    return dict(q=mk(b, 1, h, d), kn=mk(b, 1, hkv, d), vn=mk(b, 1, hkv, d),
                kc=mk(n_phys, bs, hkv * d), vc=mk(n_phys, bs, hkv * d),
                tables=tables.astype(np.int32),
                lens=np.array([0, 5, 9, 15], np.int32))


# name -> (world, mesh, JAX (data, model, batch_axis), spec)
STEPS = {
    "step_tp2": (2, "tp", (1, 2, None), dict(kind="step", idx=9)),
    "step_tp2_last": (2, "tp", (1, 2, None), dict(kind="step", idx=31)),
    "paged_tp2": (2, "tp", (1, 2, None), dict(kind="paged")),
    "step_dp2_tp2": (4, "2x2", (2, 2, "data"),
                     dict(kind="step", idx=9, batch_axis="data")),
    "step_tp4": (4, "tp", (1, 4, None), dict(kind="step", idx=9)),
    "paged_tp4": (4, "tp", (1, 4, None), dict(kind="paged")),
}


def _workload(rng, n, prompt_lens, new_tokens):
    prompts = [rng.randint(0, JCFG.vocab_size,
                           (prompt_lens[i % len(prompt_lens)],)
                           ).astype(np.int32) for i in range(n)]
    return prompts, [new_tokens[i % len(new_tokens)] for i in range(n)]


def _shared_workload(rng, n, prefix_len, tail_lens, new_tokens):
    prefix = rng.randint(0, JCFG.vocab_size, (prefix_len,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(
        0, JCFG.vocab_size, (tail_lens[i % len(tail_lens)],)).astype(
            np.int32)]) for i in range(n)]
    return prompts, [new_tokens[i % len(new_tokens)] for i in range(n)]


WORKLOADS = {
    "mixed": lambda: _workload(np.random.RandomState(1), 4, [5, 12], [5, 7]),
    "sharing": lambda: _shared_workload(np.random.RandomState(8), 6, 16,
                                        [4, 7, 12], [5, 7]),
}


def _build(world):
    _, params = _params()
    inputs = {f"params/{k}": v for k, v in sorted(_flat(params).items())}
    specs = {"steps": [], "scfg": SCFG}
    for i, (name, (w, mesh, _, spec)) in enumerate(sorted(STEPS.items())):
        if w != world:
            continue
        make = _paged_inputs if spec["kind"] == "paged" else _step_inputs
        inputs.update({f"{name}/{k}": v
                       for k, v in sorted(make(40 + i).items())})
        specs["steps"].append(dict(name=name, mesh=mesh, **spec))
    inputs["generate/prompt"] = np.random.RandomState(3).randint(
        0, JCFG.vocab_size, (4, 5))
    inputs["grad/ids"] = np.random.RandomState(4).randint(
        0, JCFG.vocab_size, (2, 16))
    for name, make in sorted(WORKLOADS.items()):
        prompts, news = make()
        for i, p in enumerate(prompts):
            inputs[f"{name}/prompt{i}"] = p
        inputs[f"{name}/new"] = np.array(news)
    tag = f"tp{world}"
    specs[f"{tag}/mixed"] = True
    if world == 2:
        specs[f"{tag}/sharing"] = True
        specs[f"{tag}/roundtrip"] = True
    return inputs, specs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = {}
    for world in (2, 4):
        inputs, specs = _build(world)
        out[world] = run_job(tmp_path_factory.mktemp(f"tp{world}"), world,
                             WORKER, inputs, specs)
    return out


def _jax_mesh(dp, tp):
    return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))


def _heads(ranks, key, tp, axis, dp=1):
    """The ranks' shards of ``key`` reassembled: heads (or flat head
    columns) on ``axis`` within a data row, batch rows across data rows.
    Ranks are laid out data-major, as ``make_mesh`` lays them."""
    rows = [np.concatenate([ranks[di * tp + r][key] for r in range(tp)],
                           axis=axis) for di in range(dp)]
    return np.concatenate(rows, axis=0) if dp > 1 else rows[0]


@pytest.mark.parametrize("name", sorted(STEPS))
def test_sharded_step_matches_jax(results, name):
    world, _, (dp, tp, batch_axis), spec = STEPS[name]
    i = sorted(STEPS).index(name)
    mesh = _jax_mesh(dp, tp)
    if spec["kind"] == "paged":
        a = {k: jnp.asarray(v)
             for k, v in sorted(_paged_inputs(40 + i).items())}
        out, k2, v2 = jdec.sharded_paged_decode_step(
            a["q"], a["kn"], a["vn"], a["kc"], a["vc"], a["tables"],
            a["lens"], 4, mesh=mesh, head_axis="model")
        dp_pool = 1
    else:
        a = {k: jnp.asarray(v)
             for k, v in sorted(_step_inputs(40 + i).items())}
        out, k2, v2 = jdec.sharded_decode_step(
            a["q"], a["kn"], a["vn"], a["kc"], a["vc"], spec["idx"], 4,
            mesh=mesh, head_axis="model", batch_axis=batch_axis)
        dp_pool = dp
    ranks = results[world]
    np.testing.assert_allclose(_heads(ranks, f"{name}/out", tp, 2, dp),
                               np.asarray(out), **TOL)
    for key, want in (("k", k2), ("v", v2)):
        np.testing.assert_allclose(_heads(ranks, f"{name}/{key}", tp, 2,
                                          dp_pool), np.asarray(want),
                                   atol=1e-6)


def test_sharded_step_checks_match_jax(results):
    got = {k.split("/", 1)[1]: str(v)
           for k, v in sorted(results[2][0].items())
           if k.startswith("checks/")}
    assert got["uneven"].startswith("ValueError: heads not shardable over "
                                    "'model' (size 2): need Hkv (3)"), got
    assert got["multi_token"] == ("ValueError: sharded_decode_step is "
                                  "single-token (s=2)"), got
    # The JAX refusal, word for word.
    with pytest.raises(NotImplementedError) as info:
        jdec.sharded_paged_decode_step(
            *(jnp.zeros(s) for s in ((2, 1, 2, 8), (2, 1, 1, 8),
                                     (2, 1, 1, 8), (2, 16, 8), (2, 16, 8))),
            jnp.zeros((2, 2), jnp.int32), jnp.zeros(2, jnp.int32), 2,
            mesh=_jax_mesh(1, 2), head_axis="model", batch_axis="data")
    assert got["paged_dp"] == f"NotImplementedError: {info.value}"


def _jax_verdict(tp):
    """The JAX classifier's verdict on LLAMA_TINY sharded with the
    Megatron specs over a ``model`` axis of ``tp`` devices (tp=4 splits
    Hkv=2 unevenly: wq sharded, wk/wv replicated, as the JAX test builds
    it)."""
    from horovod_tpu.models import llama_tp_param_specs

    model, params = _params()
    mesh = _jax_mesh(1, tp)
    prompt = jnp.zeros((4, 1), jnp.int32)
    if tp == 4:
        repl = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P())), params)
        wq = repl["layer_0"]["attention"]["wq"]["kernel"]
        repl["layer_0"]["attention"]["wq"]["kernel"] = jax.device_put(
            jax.device_get(wq), NamedSharding(mesh, P(None, "model", None)))
        return jllama.classify_decode_sharding({"params": repl}, prompt,
                                               JCFG.num_kv_heads)
    specs = llama_tp_param_specs(params, axis="model")
    sharded = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
        specs)
    return jllama.classify_decode_sharding({"params": sharded}, prompt,
                                           JCFG.num_kv_heads)


def test_classifier_replicated_matches_jax():
    import torch

    from horovod_tpu_torch.models import llama as tllama
    from horovod_tpu_torch.models.llama import LlamaLM

    model, params = _params()
    want = jllama.classify_decode_sharding(
        {"params": params}, jnp.zeros((4, 1), jnp.int32), JCFG.num_kv_heads)
    tcfg = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
    got = tllama.classify_decode_sharding(
        LlamaLM(tcfg, device="cpu"), torch.zeros(4, 1), 2)
    assert (got.path, got.reason) == (want.path, want.reason)


@pytest.mark.parametrize("world", [2, 4])
def test_classifier_verdict_and_reason_match_jax(results, world):
    want = _jax_verdict(world)
    for rank in results[world]:
        path, reason = str(rank[f"tp{world}/verdict"]), str(
            rank[f"tp{world}/reason"])
        assert path == want.path
        # The reason names the same split; only the mechanism after
        # the colon differs ("shard_mapped kernel" / "per-rank kernel").
        assert reason.split(":")[0] == want.reason.split(":")[0], (
            reason, want.reason)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_generate_matches_jax(results, world):
    from horovod_tpu.models import llama_tp_param_specs

    model, params = _params()
    prompt = jnp.asarray(np.random.RandomState(3).randint(
        0, JCFG.vocab_size, (4, 5)), jnp.int32)
    base = jllama.generate(model, {"params": params}, prompt,
                           max_new_tokens=5)
    if world == 2:
        mesh = _jax_mesh(1, 2)
        specs = llama_tp_param_specs(params, axis="model")
        sharded = {"params": jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
            specs)}
        with mesh:
            tp = jllama.generate(model, sharded, prompt, max_new_tokens=5)
        assert jllama.LAST_DECODE_PATH.path == "kernel_tp"
        np.testing.assert_array_equal(np.asarray(tp), np.asarray(base))
    for rank in results[world]:
        np.testing.assert_array_equal(rank[f"tp{world}/generate"],
                                      np.asarray(base))
        assert str(rank[f"tp{world}/generate_path"]) == (
            "kernel_tp" if world == 2 else "einsum")


def _jax_tp_engine_tokens(name):
    """JAX's TP engine on a (1, 2) mesh over the workload, with the
    parity its tests assert against bare generate()."""
    from horovod_tpu.models import llama_tp_param_specs

    model, params = _params()
    mesh = _jax_mesh(1, 2)
    specs = llama_tp_param_specs(params, axis="model")
    sharded = {"params": jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
        specs)}
    engine = JServingEngine(model, sharded, config=JServingConfig(**SCFG))
    assert engine.decode_path.path == "kernel_tp"
    prompts, news = WORKLOADS[name]()
    handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
    engine.run_until_idle()
    tokens = [h.result(timeout=0) for h in handles]
    for p, n, got in zip(prompts, news, tokens):
        ref = jllama.generate(model, {"params": params},
                              jnp.asarray(p[None]), max_new_tokens=n)
        assert got == list(np.asarray(ref)[0, len(p):])
    return tokens, engine.stats()["prefix_hits"]


@pytest.mark.parametrize("world,name", [(2, "mixed"), (2, "sharing"),
                                        (4, "mixed")])
def test_tp_engine_tokens_match_jax_tp_engine(results, world, name):
    tokens, hits = _jax_tp_engine_tokens(name)
    tag = f"tp{world}/{name}"
    for rank in results[world]:
        assert str(rank[f"{tag}/path"]) == ("kernel_tp" if world == 2
                                            else "einsum")
        for i, want in enumerate(tokens):
            assert list(rank[f"{tag}/tokens{i}"]) == want, (i, want)
        if name == "sharing":
            assert int(rank[f"{tag}/prefix_hits"]) == hits > 0
        assert "lockstep" in str(rank[f"{tag}/start"])


def test_tp_slices_round_trip_through_the_converter(results):
    _, params = _params()
    for rank in results[2]:
        for key, want in sorted(_flat(params).items()):
            np.testing.assert_array_equal(rank[f"tp2/roundtrip/{key}"],
                                          want, err_msg=key)


def test_tp_training_gradients_match_jax(results):
    model, params = _params()
    ids = jnp.asarray(np.random.RandomState(4).randint(
        0, JCFG.vocab_size, (2, 16)))
    logits = model.apply({"params": params}, ids)
    grads = _flat(jax.jit(jax.grad(lambda p: jllama.causal_lm_loss(
        model.apply({"params": p}, ids), ids)))(params))
    for rank in results[2]:
        np.testing.assert_allclose(rank["tp2/logits"], np.asarray(logits),
                                   **TOL)
        for key, want in sorted(grads.items()):
            np.testing.assert_allclose(rank[f"tp2/grad/{key}"], want,
                                       **TOL, err_msg=key)
