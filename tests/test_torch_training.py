"""The port's training path held against the JAX package's, on the same
weights and batch: ``LlamaLM`` at ``LLAMA_TINY`` widths in float32 with
flash attention forced on both sides (the JAX Pallas kernels in
interpret mode, the port's plain versions on the CPU).

Loss and every gradient leaf (through ``llama_to_flax(grads=True)``) are
compared with ``jax.value_and_grad``, for ``causal_lm_loss`` and
``chunked_causal_lm_loss``; remat gives the same gradients; three
``DistributedOptimizer(AdamW)`` steps at size 1 match
``horovod_tpu.DistributedOptimizer(optax.adamw(3e-4))`` leaf by leaf.
Tolerances: float32 atol 2e-5 / rtol 1e-4 (summation order only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu.models import llama as jllama
from horovod_tpu.ops.attention import make_attention_fn as jmake
from horovod_tpu_torch.examples import llama_training
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models.convert import llama_from_flax, llama_to_flax
from horovod_tpu_torch.ops import attention as tattn

JCFG = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
TOL = dict(atol=2e-5, rtol=1e-4)
BATCH, SEQ = 2, 32


@pytest.fixture(scope="module")
def setup():
    jmodel = jllama.LlamaLM(JCFG, attention_fn=jmake(causal=True,
                                                     use_flash=True))
    params = jllama.LlamaLM(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    ids = np.random.RandomState(0).randint(
        0, JCFG.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return jmodel, params, ids


@pytest.fixture
def port_state():
    """The port's hvd state, shut down after the test."""
    yield
    thvd.shutdown()


def _port_model(params, cfg=TCFG, use_flash=True):
    return llama_from_flax(
        jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu",
        attention_fn=tattn.make_attention_fn(causal=True,
                                             use_flash=use_flash),
        param_dtype=torch.float32)


def _assert_trees_close(got, want, tol=TOL, what=""):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat_w:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(
            node, np.asarray(leaf), **tol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _jax_loss_fn(jmodel, chunks):
    if chunks:
        def loss_fn(p, ids):
            hidden = jmodel.apply({"params": p}, ids, return_hidden=True)
            return jllama.chunked_causal_lm_loss(
                hidden, p["lm_head"]["kernel"], ids, num_chunks=chunks)
    else:
        def loss_fn(p, ids):
            return jllama.causal_lm_loss(jmodel.apply({"params": p}, ids),
                                         ids)
    return loss_fn


@pytest.mark.parametrize("chunks", [0, 4], ids=["causal_lm_loss",
                                                "chunked_causal_lm_loss"])
def test_loss_and_grads_match_jax(setup, chunks):
    jmodel, params, ids = setup
    j_loss, j_grads = jax.value_and_grad(_jax_loss_fn(jmodel, chunks))(
        params, jnp.asarray(ids))
    model = _port_model(params)
    loss = llama_training.make_loss_fn(chunks)(
        model, torch.from_numpy(ids).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    _assert_trees_close(llama_to_flax(model, grads=True), j_grads,
                        what="grad")


def test_remat_gives_the_same_grads(setup):
    _, params, ids = setup
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(TCFG, remat=remat)
        model = _port_model(params, cfg)
        tllama.causal_lm_loss(model(torch.from_numpy(ids).long()),
                              torch.from_numpy(ids).long()).backward()
        grads.append(llama_to_flax(model, grads=True))
    _assert_trees_close(grads[1], grads[0], tol=dict(atol=1e-7, rtol=1e-6),
                        what="remat grad")


def test_three_adamw_steps_match_jax(setup, port_state):
    jmodel, params, ids = setup
    jhvd.init()
    tx = jhvd.DistributedOptimizer(optax.adamw(3e-4))
    opt_state = tx.init(params)
    loss_fn = _jax_loss_fn(jmodel, 0)
    p = params
    for _ in range(3):
        grads = jax.grad(loss_fn)(p, jnp.asarray(ids))
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)

    thvd.init(device="cpu")
    model = _port_model(params)
    opt = llama_training.make_optimizer("adamw", model)
    t_ids = torch.from_numpy(ids).long()
    for _ in range(3):
        llama_training.train_step(model, opt, t_ids,
                                  llama_training.make_loss_fn(0))
    _assert_trees_close(llama_to_flax(model), p, what="param")


def test_auto_attention_takes_the_plain_path_below_min_seq(setup,
                                                           monkeypatch):
    _, params, ids = setup
    model = _port_model(params, use_flash="auto")
    plain = _port_model(params, use_flash=False)
    monkeypatch.setattr(tattn, "flash_attention", lambda *a, **k: 1 / 0)
    t_ids = torch.from_numpy(ids).long()
    with torch.no_grad():
        np.testing.assert_array_equal(model(t_ids).numpy(),
                                      plain(t_ids).numpy())


def test_training_example_runs_and_reports(port_state, capsys):
    thvd.init(device="cpu")             # main()'s init() then keeps it
    out = llama_training.main(["--model", "tiny", "--seq-len", "64",
                               "--batch-size", "2", "--num-iters", "3"])
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 4
    assert out["losses"][-1] < out["losses"][0]
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("llama-tiny seq=64: ") and "tokens/sec" in line
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in out["model"].parameters())
