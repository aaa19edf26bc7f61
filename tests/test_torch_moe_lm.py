"""The port's MoE LM (``horovod_tpu_torch.models.moe_lm.MoeLM``) held
against ``horovod_tpu.models.MoeLM`` at ``MOE_TINY`` widths in float32,
on the same weights (crossed through ``moe_from_flax``) and numpy ids.

Logits and the summed balancing loss; loss and every gradient leaf
(``moe_to_flax(grads=True)`` against ``jax.value_and_grad``); three
``DistributedOptimizer(AdamW)`` steps against
``horovod_tpu.DistributedOptimizer(optax.adamw(3e-4))``; the flash
``attention_fn`` seam (the port's plain kernel versions on the CPU)
against the plain path; remat; the chunked loss; greedy ``generate()``
against JAX's; KV-cache decoding against the no-cache argmax loop (at a
size where the full forward's capacity does not bind); and the serving
engine against ``generate()``, inactive slots included. Tolerances:
float32 atol 2e-5 / rtol 1e-4 (summation order only) unless stated.
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
from horovod_tpu.models import MOE_TINY as J_MOE_TINY
from horovod_tpu.models import MoeLM as JMoeLM
from horovod_tpu.models import causal_lm_loss as jloss
from horovod_tpu.models import chunked_causal_lm_loss as jchunked
from horovod_tpu.models.llama import generate as jgenerate
from horovod_tpu_torch.examples import llama_training, moe_lm_training
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models import moe_lm as tmoe_lm
from horovod_tpu_torch.models.convert import moe_from_flax, moe_to_flax
from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.serving import ServingConfig, ServingEngine
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JCFG = dataclasses.replace(J_MOE_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(tmoe_lm.MOE_TINY, dtype=torch.float32)
TOL = dict(atol=2e-5, rtol=1e-4)
B, S = 2, 16
AUX_WEIGHT = 0.01


@pytest.fixture(scope="module")
def setup():
    ids = np.random.RandomState(0).randint(
        0, JCFG.vocab_size, (B, S)).astype(np.int32)
    params = JMoeLM(JCFG).init(jax.random.PRNGKey(0),
                               jnp.asarray(ids))["params"]
    return params, ids


@pytest.fixture
def port_state():
    yield
    thvd.shutdown()


def _np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port(params, cfg=TCFG, use_flash=False, **kwargs):
    return moe_from_flax(
        _np(params), cfg, device="cpu",
        attention_fn=tattn.make_attention_fn(causal=True,
                                             use_flash=use_flash),
        **kwargs)


def _assert_trees_close(got, want, tol=TOL, what=""):
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(
            node, np.asarray(leaf), **tol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _jax_objective(model):
    def loss_fn(p, ids):
        logits, col = model.apply({"params": p}, ids, mutable=["aux_loss"])
        return (jloss(logits, ids)
                + AUX_WEIGHT * sum(jax.tree.leaves(col["aux_loss"])))
    return loss_fn


def test_logits_and_aux_match_jax(setup):
    params, ids = setup
    logits, col = JMoeLM(JCFG).apply({"params": params}, jnp.asarray(ids),
                                     mutable=["aux_loss"])
    aux = sum(jax.tree.leaves(col["aux_loss"]))
    model = _port(params)
    with torch.no_grad():
        got, got_aux = model(torch.from_numpy(ids).long(), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), **TOL)
    np.testing.assert_allclose(float(got_aux), float(aux), atol=1e-6)
    assert got_aux.dtype == torch.float32
    # The routed layers are the JAX tree's: layer_1 of 2.
    assert [type(b).__name__ for b in model.layers] == ["LlamaBlock",
                                                        "MoeBlock"]


def test_loss_and_grads_match_jax(setup):
    params, ids = setup
    j_loss, j_grads = jax.value_and_grad(_jax_objective(JMoeLM(JCFG)))(
        params, jnp.asarray(ids))
    model = _port(params, param_dtype=torch.float32)
    loss = moe_lm_training.make_loss_fn(AUX_WEIGHT)(
        model, torch.from_numpy(ids).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    _assert_trees_close(moe_to_flax(model, grads=True), j_grads, what="grad")


def test_three_adamw_steps_match_jax(setup, port_state):
    params, ids = setup
    jhvd.init()
    tx = jhvd.DistributedOptimizer(optax.adamw(3e-4))
    opt_state = tx.init(params)
    loss_fn = _jax_objective(JMoeLM(JCFG))
    p = params
    for _ in range(3):
        grads = jax.grad(loss_fn)(p, jnp.asarray(ids))
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)

    thvd.init(device="cpu")
    model = _port(params, param_dtype=torch.float32)
    opt = llama_training.make_optimizer("adamw", model)
    t_ids = torch.from_numpy(ids).long()
    for _ in range(3):
        llama_training.train_step(model, opt, t_ids,
                                  moe_lm_training.make_loss_fn(AUX_WEIGHT))
    _assert_trees_close(moe_to_flax(model), p, what="param")


def test_flash_attention_seam_matches_the_plain_path(setup):
    params, ids = setup
    t_ids = torch.from_numpy(ids).long()
    grads, outs = [], []
    for use_flash in (True, False):
        model = _port(params, use_flash=use_flash, param_dtype=torch.float32)
        logits, aux = model(t_ids, return_aux=True)
        (tllama.causal_lm_loss(logits, t_ids) + aux).backward()
        outs.append(logits.detach().numpy())
        grads.append(moe_to_flax(model, grads=True))
    np.testing.assert_allclose(outs[0], outs[1], **TOL)
    _assert_trees_close(grads[0], grads[1], what="flash grad")


def test_remat_gives_the_same_grads(setup):
    params, ids = setup
    t_ids = torch.from_numpy(ids).long()
    grads = []
    for remat in (False, True):
        model = _port(params, dataclasses.replace(TCFG, remat=remat),
                      param_dtype=torch.float32)
        logits, aux = model(t_ids, return_aux=True)
        (tllama.causal_lm_loss(logits, t_ids) + aux).backward()
        grads.append(moe_to_flax(model, grads=True))
    _assert_trees_close(grads[1], grads[0], tol=dict(atol=1e-7, rtol=1e-6),
                        what="remat grad")


def test_chunked_loss_equals_the_full_one_and_jax(setup):
    params, ids = setup
    p = params
    hidden, _ = JMoeLM(JCFG).apply({"params": p}, jnp.asarray(ids),
                                   return_hidden=True, mutable=["aux_loss"])
    j_chunk = jchunked(hidden, p["lm_head"]["kernel"], jnp.asarray(ids),
                       num_chunks=4)
    model = _port(params)
    t_ids = torch.from_numpy(ids).long()
    with torch.no_grad():
        full = tllama.causal_lm_loss(model(t_ids), t_ids)
        chunk = tllama.chunked_causal_lm_loss(
            model(t_ids, return_hidden=True), model.lm_head, t_ids,
            num_chunks=4)
    np.testing.assert_allclose(float(chunk), float(full), rtol=1e-6)
    np.testing.assert_allclose(float(chunk), float(j_chunk), rtol=1e-5)


def test_greedy_generate_matches_jax(setup):
    params, _ = setup
    prompt = np.random.RandomState(9).randint(
        0, JCFG.vocab_size, (2, 5)).astype(np.int32)
    want = jgenerate(JMoeLM(JCFG), {"params": params}, jnp.asarray(prompt),
                     max_new_tokens=6)
    got = tllama.generate(_port(params), torch.from_numpy(prompt),
                          max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # MoeConfig declares no max_seq_len: the window is prompt + new.
    assert not hasattr(TCFG, "max_seq_len")


def test_kv_cache_decode_matches_the_full_forward(setup):
    # On this input the full forward's capacity (MOE_TINY's factor 1.25)
    # drops nothing, as in tests/test_moe_lm.py: decoding (no-drop
    # capacity) and the no-cache argmax loop must then agree exactly.
    params, _ = setup
    model = _port(params)
    prompt = torch.from_numpy(np.random.RandomState(9).randint(
        0, TCFG.vocab_size, (2, 5)))
    out = tllama.generate(model, prompt, max_new_tokens=5)
    seq = prompt.long()
    with torch.no_grad():
        for _ in range(5):
            nxt = torch.argmax(model(seq)[:, -1].float(), dim=-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), seq.numpy())


def test_serving_engine_tokens_equal_generate(setup):
    params, _ = setup
    model = _port(params)
    scfg = ServingConfig(max_batch=4, block_size=8, num_blocks=0,
                         queue_depth=64, max_seq_len=64)
    engine = ServingEngine(model, config=scfg)
    rng = np.random.RandomState(3)
    # More slots than live requests at the end: inactive slots feed their
    # garbage tokens through the routed layer, which at no-drop capacity
    # cannot displace a live token.
    lens, news = [5, 9, 16, 3, 11], [6, 4, 8, 3, 5]
    prompts = [rng.randint(0, TCFG.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
    engine.run_until_idle()
    for prompt, n, handle in zip(prompts, news, handles):
        ref = tllama.generate(model, torch.from_numpy(prompt[None]),
                              max_new_tokens=n)
        assert handle.result(timeout=0) == ref[0, len(prompt):].tolist()
    assert engine.stats()["tokens_generated"] == sum(news)


def test_engine_needs_a_window_for_a_model_without_max_seq_len(setup):
    params, _ = setup
    model = _port(params)
    with pytest.raises(ValueError, match="declares no max_seq_len"):
        ServingEngine(model, config=ServingConfig(max_seq_len=0))
    engine = ServingEngine(model, config=ServingConfig(max_batch=2,
                                                       max_seq_len=32))
    assert engine._config.max_seq_len == 32


def test_moe_lm_training_example_runs_and_reports(port_state, capsys):
    thvd.init(device="cpu")
    out = moe_lm_training.main(["--model", "tiny", "--seq-len", "32",
                                "--batch-size", "2", "--num-iters", "3"])
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 4
    assert out["losses"][-1] < out["losses"][0]
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("moe-tiny seq=32: ") and "tokens/sec (" in line
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in out["model"].parameters())
