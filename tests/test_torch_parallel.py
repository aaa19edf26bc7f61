"""The port's meshes, hierarchical collectives and pipelines
(``horovod_tpu_torch.parallel``), and the examples of the parallel
modes, on gloo ranks on the CPU.

One 4-rank job runs every case; each test holds it against the JAX
package on as many CPU devices with the same seeded numpy inputs:
``make_mesh`` / ``make_multislice_mesh`` rank layouts against the JAX
meshes' device grids, ``hierarchical_allreduce`` / ``allgather`` on a
2 x 2 mesh (``tests/test_hierarchical.py``), and GPipe and 1F1B loss,
outputs and gradients on a 4-stage ``pipe`` axis
(``tests/test_pipeline.py``). The examples run in the same job:
the pieces of ``llama_training --seq-parallel 2`` in float32 on a
2 x 2 ``data x seq`` mesh against the single-process run at the same
global batch, and the same command in bf16 as a user runs it,
``pipeline_parallel`` (both schedules), ``long_context_ring_attention``
(both layouts) and ``tp_decode_profile``. float32 within atol 2e-5 +
rtol 1e-4, as the port's other CPU tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.parallel import hierarchical as jhier
from horovod_tpu.parallel import pipeline as jpipe

from torch_gloo import WORKER_HEAD, run_job

TOL = dict(atol=2e-5, rtol=1e-4)
S, M, F, MB = 4, 8, 8, 4      # stages, microbatches, features, rows
SP_ARGS = ["--model", "tiny", "--seq-len", "64", "--batch-size", "2",
           "--num-iters", "2", "--optimizer", "sgd"]

WORKER = WORKER_HEAD + '''
import dataclasses

import torch.distributed as dist

from horovod_tpu_torch.parallel import (make_mesh, make_multislice_mesh,
                                        replicate, ring_exchange,
                                        shard_batch)
from horovod_tpu_torch.parallel.hierarchical import (hierarchical_allgather,
                                                     hierarchical_allreduce)
from horovod_tpu_torch.parallel.pipeline import (collect_from_last_stage,
                                                 pipeline_apply,
                                                 pipeline_loss)


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def meshes(res):
    m = make_mesh({"data": 2, "model": 2})
    res["mesh/devices"] = m.devices
    for axis in ("data", "model"):
        res[f"mesh/{axis}"] = np.array(m.ranks(axis))
        g = m.group(axis)
        t = torch.tensor([float(hvd.rank())])
        dist.all_reduce(t, group=g)
        res[f"mesh/{axis}_sum"] = t
    res["mesh/inferred"] = make_mesh({"data": -1, "model": 2}).devices
    errors = {"two": lambda: make_mesh({"a": -1, "b": -1}),
              "size": lambda: make_mesh({"data": 3}),
              "indivisible": lambda: make_mesh({"data": -1, "model": 3}),
              "no_slices": lambda: make_multislice_mesh(),
              "slices": lambda: make_multislice_mesh(n_slices=3)}
    for label, fn in errors.items():
        try:
            fn()
            res[f"mesh/error/{label}"] = np.array("no error")
        except ValueError as exc:
            res[f"mesh/error/{label}"] = np.array(str(exc))
    ms = make_multislice_mesh(n_slices=2)
    res["mesh/multislice"] = ms.devices
    res["mesh/multislice_names"] = np.array(",".join(ms.axis_names))
    res["mesh/shard_batch"] = shard_batch(torch.arange(8.0), m)
    res["mesh/replicate"] = replicate(
        {"x": torch.full((2,), float(hvd.rank()))}, m)["x"]
    return ms


def hierarchical(res, arrays, ms):
    inner, outer = ms.group("ici"), ms.group("dcn")
    r = hvd.rank()
    for n in (8, 7, 1):
        x = torch.from_numpy(arrays[f"hier/x{n}"][r:r + 1])
        res[f"hier/sum{n}"] = hierarchical_allreduce(x, inner, outer)
    x = torch.from_numpy(arrays["hier/avg"][r:r + 1])
    res["hier/avg"] = hierarchical_allreduce(x, inner, outer, average=True)
    x = torch.from_numpy(arrays["hier/gather"][r:r + 1])
    res["hier/gather"] = hierarchical_allgather(x, inner, outer)
    leaf = torch.from_numpy(arrays["hier/x8"][r:r + 1]).requires_grad_()
    (hierarchical_allreduce(leaf, inner, outer) * (r + 1)).sum().backward()
    res["hier/grad"] = leaf.grad


def pipelines(res, arrays):
    m = make_mesh({"data": 1, "pipe": 4})
    pipe, s = m.group("pipe"), m.axis_index("pipe")
    data = torch.from_numpy(arrays["pipe/data"])
    target = torch.from_numpy(arrays["pipe/target"])

    def mine():
        return {k: torch.from_numpy(arrays[f"pipe/{k}"][s]).requires_grad_()
                for k in ("w", "b")}

    for remat in (True, False):
        p = mine()
        out = pipeline_apply(stage_fn, p, data, group=pipe, remat=remat)
        res[f"pipe/out_remat{int(remat)}"] = collect_from_last_stage(
            out, pipe)
        per_mb = (out ** 2).mean(dim=(1, 2))
        loss = pipeline_loss(per_mb, pipe)
        loss.backward()
        res[f"pipe/loss_remat{int(remat)}"] = loss
        for k in p:
            res[f"pipe/grad_remat{int(remat)}/{k}"] = p[k].grad
    loss, grads = pipeline_apply(stage_fn, mine(), data, group=pipe,
                                 schedule="1f1b",
                                 loss_fn=lambda y: (y ** 2).mean())
    res["pipe/1f1b_loss"] = loss
    for k, g in grads.items():
        res[f"pipe/1f1b_grad/{k}"] = g
    loss, grads = pipeline_apply(stage_fn, mine(), data, group=pipe,
                                 schedule="1f1b",
                                 loss_fn=lambda y, t: ((y - t) ** 2).mean(),
                                 targets=target)
    res["pipe/1f1b_t_loss"] = loss
    for k, g in grads.items():
        res[f"pipe/1f1b_t_grad/{k}"] = g
    res["pipe/mask"] = pipeline_loss(torch.tensor([float(s)]), pipe)
    # The exchange alone, and its gradient: the cotangent goes back.
    x = torch.full((3,), float(s)).requires_grad_()
    (y,) = ring_exchange([x], pipe, shift=1)
    (y * (s + 1)).sum().backward()
    res["pipe/exchange"] = y
    res["pipe/exchange_grad"] = x.grad


def examples(res, specs):
    from horovod_tpu_torch.examples import (llama_training,
                                            long_context_ring_attention,
                                            pipeline_parallel,
                                            tp_decode_profile)
    from horovod_tpu_torch.models.convert import llama_to_flax

    # The example's pieces in float32 (its CLI computes in bf16): three
    # SGD steps on a 2 x 2 data x seq mesh, as --seq-parallel 2 builds.
    ex = llama_training
    cfg = dataclasses.replace(ex.CONFIGS["tiny"], dtype=torch.float32)
    mesh = make_mesh({"data": 2, "seq": 2})
    seq = mesh.group("seq")
    model = ex.make_model(cfg, device="cpu", seq_group=seq)
    opt = ex.make_optimizer("sgd", model, mesh.group("data"))
    loss_fn = ex.make_sp_loss_fn(seq)
    ids = ex.batch_ids(cfg, 2, 64, "cpu", mesh)
    res["sp/losses"] = np.array([
        float(ex.train_step(model, opt, ids, loss_fn, seq))
        for _ in range(3)])
    for key, arr in flatten(llama_to_flax(model)):
        res[f"sp/weights/{key}"] = arr
    out = llama_training.main(specs["sp_args"] + ["--seq-parallel", "2"])
    res["sp/cli_losses"] = np.array(out["losses"])
    for schedule in ("gpipe", "1f1b"):
        got = pipeline_parallel.main([
            "--steps", "12", "--microbatches", "8", "--microbatch-size",
            "4", "--features", "16", "--lr", "3e-3", "--schedule",
            schedule, "--device", "cpu"])
        res[f"pp/{schedule}"] = np.array(got["losses"])
    for layout in ("contiguous", "zigzag"):
        rec = long_context_ring_attention.main([
            "--seq-len", "256", "--heads", "2", "--head-dim", "8",
            "--causal", "--layout", layout, "--iters", "1", "--device",
            "cpu"])
        res[f"lc/{layout}"] = np.array(rec["out_shape"] + [rec["finite"]])
    rec = tp_decode_profile.main(["--model", "tiny", "--batch-size", "4",
                                  "--max-new-tokens", "6", "--tp", "2",
                                  "--f32", "--device", "cpu"])
    res["tpd/ok"] = np.array(rec["ok"])
    res["tpd/path"] = np.array(rec["path"])
    res["tpd/parity"] = np.array(rec["token_parity_mismatches"])
    res["tpd/mesh"] = np.array([rec["mesh"]["data"], rec["mesh"]["model"]])
    res["tpd/markers"] = np.array(
        [rec["decode_path_markers"][m] for m in (
            "hvd.decode.kernel_tp", "hvd.decode.einsum",
            "hvd.decode.kernel")])


def main():
    hvd.init(device="cpu")
    arrays, specs = load_cases()
    res = {}
    ms = meshes(res)
    hierarchical(res, arrays, ms)
    pipelines(res, arrays)
    examples(res, specs)
    save(res)
    hvd.shutdown()
    print("worker ok")


if __name__ == "__main__":
    main()
'''


def _stages():
    rng = np.random.RandomState(0)
    ws = [(rng.randn(F, F) * 0.5).astype(np.float32) for _ in range(S)]
    bs = [(rng.randn(F) * 0.1).astype(np.float32) for _ in range(S)]
    w, b = np.stack(ws), np.stack(bs)
    data = rng.randn(M, MB, F).astype(np.float32)
    target = (np.random.RandomState(3).randn(M, MB, F) * 0.1).astype(
        np.float32)
    return {"w": w, "b": b}, data, target


def _inputs():
    stacked, data, target = _stages()
    inputs = {"pipe/w": stacked["w"], "pipe/b": stacked["b"],
              "pipe/data": data, "pipe/target": target}
    for n in (8, 7, 1):
        inputs[f"hier/x{n}"] = np.arange(4 * n, dtype=np.float32).reshape(
            4, n)
    inputs["hier/avg"] = (np.ones((4, 4), np.float32)
                          * np.arange(4, dtype=np.float32)[:, None])
    inputs["hier/gather"] = np.arange(8, dtype=np.float32).reshape(4, 2)
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_job(tmp_path_factory.mktemp("parallel"), 4, WORKER,
                   _inputs(), {"sp_args": SP_ARGS}, timeout=300)


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def test_make_mesh_lays_ranks_out_as_jax_lays_devices(ranks):
    jmesh = _jmesh((2, 2), ("data", "model"))
    grid = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r, rank in enumerate(ranks):
        np.testing.assert_array_equal(rank["mesh/devices"], grid)
        np.testing.assert_array_equal(rank["mesh/inferred"], grid)
        i, j = np.argwhere(grid == r)[0]
        np.testing.assert_array_equal(rank["mesh/data"], grid[:, j])
        np.testing.assert_array_equal(rank["mesh/model"], grid[i, :])
        # The groups run: the sum of the slice's ranks.
        assert float(rank["mesh/data_sum"][0]) == grid[:, j].sum()
        assert float(rank["mesh/model_sum"][0]) == grid[i, :].sum()


def test_mesh_errors_match_jax_wording(ranks):
    from horovod_tpu.parallel import make_mesh, make_multislice_mesh

    got = {k.rsplit("/", 1)[1]: str(v)
           for k, v in sorted(ranks[0].items())
           if k.startswith("mesh/error/")}
    for label, fn in (("two", lambda: make_mesh({"a": -1, "b": -1})),
                      ("no_slices", lambda: make_multislice_mesh())):
        with pytest.raises(ValueError) as info:
            fn()
        # The JAX message says "devices" where the port has ranks.
        want = str(info.value).replace("devices", "ranks").replace(
            "they form a single slice or carry no slice_index (virtual "
            "platforms)", "processes carry no slice index")
        assert got[label] == want
    assert got["size"] == "mesh axes {'data': 3} != 4 ranks"
    assert got["indivisible"] == ("cannot infer axis: 4 ranks not "
                                  "divisible by 3")
    assert got["slices"] == "4 ranks not divisible by 3 slices"


def test_multislice_mesh_groups_contiguously_as_jax(ranks):
    from horovod_tpu.parallel import make_multislice_mesh

    jm = make_multislice_mesh(n_slices=2, devices=jax.devices()[:4])
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    for rank in ranks:
        np.testing.assert_array_equal(rank["mesh/multislice"], grid)
        assert str(rank["mesh/multislice_names"]) == ",".join(jm.axis_names)


def test_shard_batch_and_replicate(ranks):
    for r, rank in enumerate(ranks):
        # data-major layout: rank r sits at data row r // 2.
        d = r // 2
        np.testing.assert_array_equal(rank["mesh/shard_batch"],
                                      np.arange(8.0)[4 * d:4 * d + 4])
        np.testing.assert_array_equal(rank["mesh/replicate"], [0.0, 0.0])


def _jax_hier(fn, x):
    mesh = _jmesh((2, 2), ("outer", "inner"))
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P(("outer", "inner")), out_specs=P(),
        check_vma=False))(jnp.asarray(x)))


@pytest.mark.parametrize("n", [8, 7, 1])
def test_hierarchical_allreduce_matches_jax(ranks, n):
    x = np.arange(4 * n, dtype=np.float32).reshape(4, n)
    want = _jax_hier(lambda t: jhier.hierarchical_allreduce(
        t, "inner", "outer"), x)
    for rank in ranks:
        np.testing.assert_allclose(rank[f"hier/sum{n}"], want, rtol=1e-6)


def test_hierarchical_allreduce_average_and_gradient(ranks):
    x = (np.ones((4, 4), np.float32)
         * np.arange(4, dtype=np.float32)[:, None])
    want = _jax_hier(lambda t: jhier.hierarchical_allreduce(
        t, "inner", "outer", average=True), x)
    for rank in ranks:
        np.testing.assert_allclose(rank["hier/avg"], want, rtol=1e-6)
        # Each rank weights the sum by (rank + 1): the gradient of every
        # input is the sum of the weights, as for a flat allreduce.
        np.testing.assert_allclose(rank["hier/grad"],
                                   np.full((1, 8), 10.0), rtol=1e-6)


def test_hierarchical_allgather_matches_jax(ranks):
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    want = _jax_hier(lambda t: jhier.hierarchical_allgather(
        t, "inner", "outer"), x)
    for rank in ranks:
        np.testing.assert_array_equal(rank["hier/gather"], want)


def _jax_stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_pipe():
    stacked, data, target = _stages()
    mesh = _jmesh((S,), ("pipe",))
    return ({k: jnp.asarray(v) for k, v in sorted(stacked.items())},
            jnp.asarray(data), jnp.asarray(target), mesh)


def test_gpipe_forward_matches_jax(ranks):
    stacked, data, _, mesh = _jax_pipe()
    want = np.asarray(jax.jit(jax.shard_map(
        lambda p, x: jpipe.collect_from_last_stage(
            jpipe.pipeline_apply(_jax_stage_fn, p, x, axis_name="pipe")),
        mesh=mesh, in_specs=(P("pipe"), P(None)), out_specs=P(None),
        check_vma=False))(stacked, data))
    for rank in ranks:
        for remat in (0, 1):
            np.testing.assert_allclose(rank[f"pipe/out_remat{remat}"], want,
                                       **TOL)


def test_gpipe_loss_and_gradients_match_jax(ranks):
    stacked, data, _, mesh = _jax_pipe()

    def body(p, x):
        outs = jpipe.pipeline_apply(_jax_stage_fn, p, x, axis_name="pipe")
        per_mb = jnp.mean(outs ** 2, axis=(1, 2))
        return jpipe.pipeline_loss(per_mb, "pipe")

    f = jax.shard_map(body, mesh=mesh, in_specs=(P("pipe"), P(None)),
                      out_specs=P(), check_vma=False)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: f(p, data)))(stacked)
    for s, rank in enumerate(ranks):
        for remat in (0, 1):
            np.testing.assert_allclose(float(rank[f"pipe/loss_remat{remat}"]),
                                       float(loss), rtol=1e-6)
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    rank[f"pipe/grad_remat{remat}/{k}"],
                    np.asarray(grads[k][s]), **TOL, err_msg=k)


@pytest.mark.parametrize("targets", [False, True])
def test_1f1b_loss_and_gradients_match_jax(ranks, targets):
    stacked, data, target, mesh = _jax_pipe()
    if targets:
        f = jax.shard_map(
            lambda p, x, t: jpipe.pipeline_apply(
                _jax_stage_fn, p, x, axis_name="pipe", schedule="1f1b",
                loss_fn=lambda y, tt: jnp.mean((y - tt) ** 2), targets=t),
            mesh=mesh, in_specs=(P("pipe"), P(None), P(None)),
            out_specs=(P(), P("pipe")), check_vma=False)
        loss, grads = jax.jit(f)(stacked, data, target)
        tag = "1f1b_t"
    else:
        f = jax.shard_map(
            lambda p, x: jpipe.pipeline_apply(
                _jax_stage_fn, p, x, axis_name="pipe", schedule="1f1b",
                loss_fn=lambda y: jnp.mean(y ** 2)),
            mesh=mesh, in_specs=(P("pipe"), P(None)),
            out_specs=(P(), P("pipe")), check_vma=False)
        loss, grads = jax.jit(f)(stacked, data)
        tag = "1f1b"
    for s, rank in enumerate(ranks):
        np.testing.assert_allclose(float(rank[f"pipe/{tag}_loss"]),
                                   float(loss), rtol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(rank[f"pipe/{tag}_grad/{k}"],
                                       np.asarray(grads[k][s]), **TOL,
                                       err_msg=k)


def test_pipeline_loss_keeps_the_last_stage(ranks):
    for rank in ranks:
        assert float(rank["pipe/mask"]) == S - 1


def test_ring_exchange_and_its_gradient(ranks):
    # Stage s receives stage s - 1's tensor; its cotangent (weight s + 1)
    # goes back, so stage s's input gets stage s + 1's weight, s + 2.
    for s, rank in enumerate(ranks):
        np.testing.assert_array_equal(rank["pipe/exchange"],
                                      np.full(3, float((s - 1) % S)))
        np.testing.assert_array_equal(rank["pipe/exchange_grad"],
                                      np.full(3, float((s + 1) % S + 1)))


def test_pipeline_argument_checks_match_jax():
    from horovod_tpu_torch.parallel import pipeline as tpipe

    x = torch.zeros(2, 1, 4)
    with pytest.raises(ValueError, match="unknown schedule 'zigzag'"):
        tpipe.pipeline_apply(lambda p, h: h, {}, x, schedule="zigzag")
    with pytest.raises(ValueError, match="loss_fn is required"):
        tpipe.pipeline_apply(lambda p, h: h, {}, x, schedule="1f1b")
    # One stage (no process group): the pipeline is the stage itself.
    w = torch.randn(4, 4)
    out = tpipe.pipeline_apply(lambda p, h: h @ p["w"], {"w": w}, x)
    torch.testing.assert_close(out, x @ w)
    stacked = tpipe.stack_stage_params([{"w": w}, {"w": 2 * w}])
    torch.testing.assert_close(stacked["w"][1], 2 * w)


def test_seq_parallel_example_equals_the_single_process_run(ranks):
    """``llama_training --seq-parallel 2`` on a 2 x 2 data x seq mesh:
    three SGD steps equal three single-process steps at the same global
    batch (DistributedOptimizer averaging over data only, the gradients
    summed over seq)."""
    import dataclasses

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.models.convert import llama_to_flax
    from horovod_tpu_torch.models.llama import causal_lm_loss

    cfg = dataclasses.replace(ex.CONFIGS["tiny"], dtype=torch.float32)
    model = ex.make_model(cfg, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 64)))
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = causal_lm_loss(model(ids), ids)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    # Each rank's loss is its data row's (the seq group's global mean);
    # the data rows' mean is the whole batch's. Ranks lie data-major.
    np.testing.assert_allclose(ranks[0]["sp/losses"], ranks[1]["sp/losses"],
                               rtol=1e-6)
    np.testing.assert_allclose(
        (ranks[0]["sp/losses"] + ranks[2]["sp/losses"]) / 2, losses,
        rtol=1e-5)
    flat = {}

    def walk(node, prefix):
        for k, v in sorted(node.items()):
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v

    walk(llama_to_flax(model), "")
    for key, want in sorted(flat.items()):
        np.testing.assert_allclose(ranks[0][f"sp/weights/{key}"], want,
                                   **TOL, err_msg=key)


def test_seq_parallel_example_cli_trains(ranks):
    """``llama_training --seq-parallel 2`` as a user runs it (bf16
    compute): finite losses, the same on both ranks of a seq group, and
    a first loss within 2e-2 relative of the float32 run's (bf16
    rounding of every activation; the weights are the same draws)."""
    for peer_a, peer_b in ((0, 1), (2, 3)):
        got = ranks[peer_a]["sp/cli_losses"]
        assert got.shape == (3,) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, ranks[peer_b]["sp/cli_losses"])
        np.testing.assert_allclose(got[0], ranks[peer_a]["sp/losses"][0],
                                   rtol=2e-2)


def test_pipeline_example_trains_with_both_schedules(ranks):
    for rank in ranks:
        gpipe, f1b = rank["pp/gpipe"], rank["pp/1f1b"]
        assert np.isfinite(gpipe).all() and gpipe[-1] < 0.9 * gpipe[0]
        # Same math, different schedule.
        np.testing.assert_allclose(f1b, gpipe, rtol=1e-4)


def test_long_context_example_runs_both_layouts(ranks):
    for layout in ("contiguous", "zigzag"):
        got = ranks[0][f"lc/{layout}"]
        assert list(got) == [1, 256, 2, 8, 1], got


def test_tp_decode_profile_example(ranks):
    for rank in ranks:
        assert bool(rank["tpd/ok"]) and str(rank["tpd/path"]) == "kernel_tp"
        assert int(rank["tpd/parity"]) == 0
        assert list(rank["tpd/mesh"]) == [2, 2]
        # One profiled prefill and two decode steps, two layers: the
        # shard-local kernel's label at each step and layer, no other.
        assert list(rank["tpd/markers"]) == [2 * 2, 0, 0]
