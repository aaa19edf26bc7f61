"""The port's optax optimizers (``horovod_tpu_torch/torch/optim.py``) held
against optax on the same numpy parameters and gradients.

* ``Adafactor`` against ``optax.adafactor(3e-4)`` over 5 steps on a tree
  with factored matrices (both dims >= 128, the largest dim first and
  last), an unfactored narrow matrix, a vector and a 3-D tensor;
* ``Adagrad`` against ``optax.adagrad(0.05)`` over 5 steps with rows whose
  gradient stays zero, at the default accumulator start and at 0 (where
  optax's update is zero, not a division by ``eps``);
* three ``--optimizer adafactor`` steps of the training example on tiny
  Llama (f32) through ``DistributedOptimizer``, against the JAX example's
  ``DistributedOptimizer(optax.adafactor(3e-4))`` step;
* ``fsdp_state_specs`` over the port's Adafactor: the factored moments
  match no parameter shape and replicate, the unfactored moment takes
  its parameter's spec.

Tolerance: atol 1e-6 / rtol 1e-5 for the unit steps (float32 rounding of
the same formulas), and the training test's atol 2e-5 / rtol 1e-4 for
the Llama steps (XLA's and torch's gradients differ in summation order).
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
from horovod_tpu_torch.torch import fsdp as tfsdp
from horovod_tpu_torch.torch.optim import Adafactor, Adagrad, factored_dims
from horovod_tpu_torch.torch.partition import P
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

UNIT_TOL = dict(atol=1e-6, rtol=1e-5)
TRAIN_TOL = dict(atol=2e-5, rtol=1e-4)
SHAPES = {"tall": (160, 130), "wide": (130, 200), "narrow": (200, 64),
          "vec": (48,), "cube": (4, 130, 140)}


def _tree(seed, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32)
            for k, s in sorted(shapes.items())}


def _run_both(jtx, make_opt, grads, params):
    jp = {k: jnp.asarray(v) for k, v in sorted(params.items())}
    state = jtx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True)
          for k, v in sorted(params.items())}
    opt = make_opt([tp[k] for k in sorted(tp)])
    update = jax.jit(jtx.update)
    for g in grads:
        updates, state = update(
            {k: jnp.asarray(v) for k, v in sorted(g.items())}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in sorted(tp):
            tp[k].grad = torch.tensor(g[k])
        opt.step()
    return ({k: np.asarray(v) for k, v in sorted(jp.items())},
            {k: v.detach().numpy() for k, v in sorted(tp.items())}, opt)


def test_factored_dims_match_optax():
    from optax._src.factorized import _factored_dims

    for shape in [(160, 130), (130, 200), (200, 64), (48,), (4, 130, 140),
                  (128, 128), (127, 512), (3, 256, 4, 300)]:
        assert factored_dims(shape) == _factored_dims(shape, True, 128), \
            shape


def test_adafactor_matches_optax_over_five_steps():
    params = _tree(0)
    grads = [_tree(1 + i) for i in range(5)]
    want, got, opt = _run_both(optax.adafactor(3e-4),
                               lambda ps: Adafactor(ps, lr=3e-4),
                               grads, params)
    for name in sorted(want):
        assert np.abs(want[name] - params[name]).max() > 1e-5, name
        np.testing.assert_allclose(got[name], want[name], **UNIT_TOL,
                                   err_msg=name)
    # The state took optax's form: row/column moments where both of the
    # two largest dims reach 128, a full moment elsewhere.
    kinds = {tuple(p.shape): sorted(opt.state[p]) for p in
             opt.param_groups[0]["params"]}
    assert kinds[(160, 130)] == kinds[(130, 200)] == \
        kinds[(4, 130, 140)] == ["step", "v_col", "v_row"]
    assert kinds[(200, 64)] == kinds[(48,)] == ["step", "v"]


def test_adafactor_requires_its_learning_rate():
    params = [torch.nn.Parameter(torch.ones(3))]
    with pytest.raises(ValueError, match="lr"):
        Adafactor(params)
    # A rebuild from parameter groups that carry lr needs no argument, as
    # DistributedOptimizer's does.
    groups = Adafactor(params, lr=3e-4).param_groups
    assert Adafactor(groups).param_groups[0]["lr"] == 3e-4


@pytest.mark.parametrize("init", [0.1, 0.0])
def test_adagrad_matches_optax_with_zero_gradient_rows(init):
    params = _tree(5)
    grads = []
    for i in range(5):
        g = _tree(6 + i)
        g["tall"][:7] = 0.0
        g["narrow"][::3] = 0.0
        grads.append(g)
    want, got, _ = _run_both(
        optax.adagrad(0.05, initial_accumulator_value=init),
        lambda ps: Adagrad(ps, lr=0.05, initial_accumulator_value=init),
        grads, params)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], **UNIT_TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got["tall"][:7], params["tall"][:7])


def test_fsdp_state_specs_replicate_the_factored_moments():
    params = {"w": torch.zeros(256, 512), "n": torch.zeros(512, 64)}
    specs = tfsdp.fsdp_param_specs(params, 8, min_leaf_elems=1)
    opt = Adafactor(sorted(params.items()), lr=1e-3)
    sspecs = tfsdp.fsdp_state_specs(opt, specs)
    assert sspecs["w"]["v_row"] == sspecs["w"]["v_col"] == P()
    assert sspecs["w"]["step"] == sspecs["n"]["step"] == P()
    assert sspecs["n"]["v"] == specs["n"]


JCFG = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
TCFG = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)


def test_three_adafactor_steps_match_jax():
    jmodel = jllama.LlamaLM(JCFG, attention_fn=jmake(causal=True,
                                                     use_flash=True))
    params = jllama.LlamaLM(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    ids = np.random.RandomState(0).randint(
        0, JCFG.vocab_size, (2, 32)).astype(np.int32)

    jhvd.init()
    tx = jhvd.DistributedOptimizer(optax.adafactor(3e-4))
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s):
        grads = jax.grad(lambda p: jllama.causal_lm_loss(
            jmodel.apply({"params": p}, jnp.asarray(ids)),
            jnp.asarray(ids)))(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s

    p = params
    for _ in range(3):
        p, opt_state = step(p, opt_state)

    thvd.init(device="cpu")
    try:
        model = llama_from_flax(
            jax.tree_util.tree_map(np.asarray, params), TCFG, device="cpu",
            attention_fn=tattn.make_attention_fn(causal=True,
                                                 use_flash=True),
            param_dtype=torch.float32)
        opt = llama_training.make_optimizer("adafactor", model)
        assert isinstance(opt, Adafactor)
        t_ids = torch.from_numpy(ids).long()
        for _ in range(3):
            llama_training.train_step(model, opt, t_ids,
                                      llama_training.make_loss_fn(0))
    finally:
        thvd.shutdown()
    got = llama_to_flax(model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf), **TRAIN_TOL,
                                   err_msg=jax.tree_util.keystr(path))
