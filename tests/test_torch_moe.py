"""The port's MoE substrate (``horovod_tpu_torch.parallel.moe``) held
against ``horovod_tpu.parallel.moe`` on the same numpy inputs, and its
expert-parallel mode on gloo ranks.

Routing must agree exactly (expert ids and capacity slots), combine
weights and the balancing loss within 1e-6, at top-1 and top-2, with
ample and binding capacity. ``moe_apply_dense``'s output and gradients
(through the gather-only custom Functions) are held against
``jax.grad`` of the JAX version and against a reference that lets
autograd transpose the gathers itself (float32 atol 2e-5 / rtol 1e-4:
summation order only). On 4 gloo ranks, ``MoeLM`` in expert mode gives
its dense twin's logits and gradients, and the 2 x 2 data x expert
example lowers its loss.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import moe as jmoe
from horovod_tpu_torch.parallel import moe as tmoe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=1e-4)
T, E, D, H = 24, 4, 8, 16
LAUNCH_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
               "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
               "HOROVOD_CROSS_SIZE", "OMPI_COMM_WORLD_RANK",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
               "OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_RANK", "PMI_SIZE",
               "HOROVOD_CONTROLLER_ADDR", "HOROVOD_SPMD_COORDINATOR",
               "HOROVOD_RENDEZVOUS_FILE")

# (top-k, capacity factor): 0.5 binds (drops assignments), 4.0 is ample.
ROUTES = [(1, 0.5), (1, 4.0), (2, 0.5), (2, 4.0)]


def _probs(seed):
    logits = np.random.RandomState(seed).randn(T, E).astype(np.float32)
    return logits, np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))


def test_capacity_is_the_jax_expression():
    for tokens, e, cf, k in ((24, 4, 1.25, 2), (24, 4, 0.5, 1), (1, 8, 4.0,
                             2), (3, 8, 1.25, 2), (8192, 8, 1.25, 2),
                             (16, 4, 2.0, 2), (7, 3, 1.0, 1)):
        assert tmoe._capacity(tokens, e, cf, k) == \
            jmoe._capacity(tokens, e, cf, k)
    # Binding and ample: a ceiling with the floor at k.
    assert tmoe._capacity(24, 4, 1.25, 2) == 15
    assert tmoe._capacity(1, 8, 1.25, 2) == 2


@pytest.mark.parametrize("k,cf", ROUTES)
def test_route_matches_jax(k, cf):
    _, probs = _probs(k * 10 + int(cf))
    cap = tmoe._capacity(T, E, cf, k)
    jr, jaux = jmoe._route(jnp.asarray(probs), cap, k, True, jnp.float32)
    tr, taux = tmoe._route(torch.from_numpy(probs), cap, k, True,
                           torch.float32)
    for r in range(k):
        np.testing.assert_array_equal(tr.expert_idx[r].numpy(),
                                      np.asarray(jr.expert_idx[r]))
        np.testing.assert_array_equal(tr.slot[r].numpy(),
                                      np.asarray(jr.slot[r]))
        np.testing.assert_allclose(tr.combine_w[r].numpy(),
                                   np.asarray(jr.combine_w[r]), atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
    dropped = sum(int((s >= cap).sum()) for s in tr.slot)
    assert (dropped > 0) == (cf < 1), (dropped, cap)


def test_route_counts_slots_past_256_exactly():
    # Every token on one expert: slots run 0..T-1 in an integer count.
    probs = np.full((600, 4), 0.1, np.float32)
    probs[:, 2] = 0.7
    tr, _ = tmoe._route(torch.from_numpy(probs), 1000, 1, True,
                        torch.bfloat16)
    assert tr.slot[0].tolist() == list(range(600))
    assert (tr.expert_idx[0] == 2).all()


def test_routing_indices_mask_dropped_assignments():
    _, probs = _probs(3)
    cap = tmoe._capacity(T, E, 0.5, 2)
    tr, _ = tmoe._route(torch.from_numpy(probs), cap, 2, True,
                        torch.float32)
    dests, keeps, inv_token, inv_round, inv_valid = tmoe._routing_indices(
        tr, E, cap, T)
    j = jmoe._routing_indices(
        jmoe._route(jnp.asarray(probs), cap, 2, True, jnp.float32)[0], E,
        cap, T)
    for got, want in zip((dests, keeps, inv_token, inv_round, inv_valid), j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Each kept assignment owns its slot; every other slot is unowned.
    assert int(inv_valid.sum()) == int(keeps.sum())


def _jax_expert(p, t):
    return jax.nn.gelu(t @ p["wi"]) @ p["wo"]


def _port_expert(p, t):
    return torch.bmm(torch.nn.functional.gelu(torch.bmm(t, p["wi"]),
                                              approximate="tanh"), p["wo"])


def _autograd_reference(x, wi, wo, logits, cf, k):
    """``moe_apply_dense`` with plain indexing in place of the custom
    Functions, so autograd transposes the gathers (index_add)."""
    cap = tmoe._capacity(T, E, cf, k)
    probs = torch.softmax(logits, -1)
    routing, aux = tmoe._route(probs, cap, k, True, x.dtype)
    dests, keeps, inv_token, inv_round, inv_valid = tmoe._routing_indices(
        routing, E, cap, T)
    buf = torch.where(inv_valid[:, None], x[inv_token],
                      torch.zeros(())).reshape(E, cap, D)
    out = _port_expert({"wi": wi, "wo": wo}, buf).reshape(E * cap, D)
    w = torch.stack(routing.combine_w)
    y = sum(out[dests[r]] * w[r][:, None] for r in range(k))
    return y, aux


@pytest.mark.parametrize("k,cf", ROUTES)
def test_moe_apply_dense_output_and_grads_match_jax(k, cf):
    rng = np.random.RandomState(100 + k)
    logits = rng.randn(T, E).astype(np.float32)
    x = rng.randn(T, D).astype(np.float32)
    wi = (rng.randn(E, D, H) * 0.3).astype(np.float32)
    wo = (rng.randn(E, H, D) * 0.3).astype(np.float32)
    dy = rng.randn(T, D).astype(np.float32)

    def jloss(x, wi, wo, lg):
        y, aux = jmoe.moe_apply_dense(_jax_expert, {"wi": wi, "wo": wo}, x,
                                      lg, capacity_factor=cf,
                                      num_selected=k)
        return jnp.sum(y * dy) + aux, y

    (jl, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                      has_aux=True)(
        jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo),
        jnp.asarray(logits))
    runs = []
    for fn in ("port", "autograd"):
        leaves = [torch.tensor(a, requires_grad=True)
                  for a in (x, wi, wo, logits)]
        if fn == "port":
            y, aux = tmoe.moe_apply_dense(
                _port_expert, {"wi": leaves[1], "wo": leaves[2]}, leaves[0],
                leaves[3], capacity_factor=cf, num_selected=k)
        else:
            y, aux = _autograd_reference(*leaves, cf, k)
        loss = (y * torch.from_numpy(dy)).sum() + aux
        loss.backward()
        runs.append((y.detach().numpy(), [t.grad.numpy() for t in leaves]))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
        for got, want in zip(runs[-1][1], jg):
            np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for got, want in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# 4 gloo ranks

WORKER = '''
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.convert import moe_to_flax
from horovod_tpu_torch.models.llama import causal_lm_loss
from horovod_tpu_torch.models.moe_lm import MOE_TINY, MoeLM


def expert_mode():
    """Each rank its own ids; the dense twin on the same ids is the
    reference. Summed over ranks, the replicated leaves' gradients and
    rank e's expert rows equal the dense twin's summed gradients."""
    cfg = dataclasses.replace(MOE_TINY, dtype=torch.float32)
    r, n = hvd.rank(), hvd.size()
    ids = torch.from_numpy(np.random.RandomState(10 + r).randint(
        0, cfg.vocab_size, (2, 16))).long()
    grads, logits = {}, {}
    for mode in ("dense", "expert"):
        kwargs = {} if mode == "dense" else dict(
            expert_group=dist.group.WORLD, local_experts=1)
        model = MoeLM(cfg, device="cpu", seed=0,
                      param_dtype=torch.float32, **kwargs)
        out, aux = model(ids, return_aux=True)
        (causal_lm_loss(out, ids) + 0.01 * aux).backward()
        logits[mode] = out.detach()
        flat = {}

        def walk(node, prefix):
            for k, v in sorted(node.items()):
                if isinstance(v, dict):
                    walk(v, prefix + k + "/")
                else:
                    flat[prefix + k] = torch.from_numpy(v)
        walk(moe_to_flax(model, grads=True), "")
        grads[mode] = flat
    torch.testing.assert_close(logits["expert"], logits["dense"],
                               atol=1e-5, rtol=1e-4)
    for key in sorted(grads["dense"]):
        dense = grads["dense"][key].clone()
        dist.all_reduce(dense)
        got = grads["expert"][key].clone()
        if key.endswith("moe_ffn/wi") or key.endswith("moe_ffn/wo"):
            dense = dense[r:r + 1]
        else:
            dist.all_reduce(got)
        torch.testing.assert_close(got, dense, atol=2e-5, rtol=1e-4,
                                   msg=lambda m: key + ": " + m)


def example():
    from horovod_tpu_torch.examples import moe_training
    # Four ranks would make one expert group of four; 2 x 2 exercises the
    # data groups too.
    moe_training.layout = lambda n: (2, n // 2)
    out = moe_training.main(["--steps", "40", "--tokens-per-device", "64",
                             "--d-model", "32", "--d-hidden", "64",
                             "--lr", "3e-3"])
    assert (out["ep"], out["dp"]) == (2, 2), out
    losses = out["losses"]
    assert np.isfinite(losses).all() and losses[-1] < 0.8 * losses[0], \\
        losses[::10]


if __name__ == "__main__":
    hvd.init(device="cpu")
    {"expert_mode": expert_mode, "example": example}[sys.argv[1]]()
    hvd.shutdown()
    print("worker ok")
'''


def _run_job(tmp_path, size, *args, timeout=180):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    for rank in range(size):
        env = {k: v for k, v in sorted(os.environ.items())
               if k not in LAUNCH_VARS}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(size),
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


def test_four_rank_expert_mode_equals_the_dense_twin(tmp_path):
    _run_job(tmp_path, 4, "expert_mode")


def test_data_by_expert_example_lowers_its_loss(tmp_path):
    _run_job(tmp_path, 4, "example")


def test_moe_lm_refuses_a_group_of_the_wrong_size():
    from horovod_tpu_torch.models.moe_lm import MOE_TINY, MoeLM

    cfg = dataclasses.replace(MOE_TINY, dtype=torch.float32)
    with pytest.raises(ValueError, match="one expert per rank"):
        MoeLM(cfg, device="cpu", expert_group=object(), local_experts=2)
