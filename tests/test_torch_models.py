"""The port's model zoo (``horovod_tpu_torch.models``: ResNet, VGG,
Inception V3, the MNIST MLP, BERT, ViT) held against the JAX package's
flax modules on the same weights and inputs.

The JAX modules initialise the weights; they cross to the port through
``convert.zoo_from_flax`` as numpy trees. Inputs are numpy arrays from a
seed; both sides run float32 on the CPU (dropout off where the mode would
draw it). Each test compares the forward output, the gradient of every
parameter (JAX's gradient tree mapped into the port's layouts by
``convert.zoo_state_dict``) and, for the BatchNorm models, the new
running statistics after one train-mode forward.

Tolerance: ``TOL`` = atol 2e-5 / rtol 1e-4 on outputs and statistics
(float32 on both sides: the two differ in summation order only), and
``GRAD_TOL`` = atol 1e-5 + rtol 1e-4 of each gradient tensor's largest
magnitude: a gradient sums many products of activations of both signs,
so its smallest entries are cancellations whose absolute error, not
relative error, is what summation order bounds.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import models as jm
from horovod_tpu.ops.attention import make_attention_fn as jmake
from horovod_tpu_torch import models as tm
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.layers import Conv, same_padding
from horovod_tpu_torch.ops import attention as tattn

TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
KEYS = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, b, size, c=3):
    return np.random.RandomState(seed).rand(b, size, size, c).astype(
        np.float32)


def _weights(seed, shape):
    """Fixed random cotangent: loss = sum(out * w) reaches every output."""
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _init(jmodel, x, **kw):
    return jax.jit(lambda x: jmodel.init(KEYS, x, **kw))(jnp.asarray(x))


def _port(tmodel, variables):
    return convert.zoo_from_flax(tmodel, _np(variables["params"]),
                                 _np(variables.get("batch_stats", {})))


def _assert_grads(tmodel, jgrads):
    want = convert.zoo_state_dict(tmodel, _np(jgrads))
    params = dict(tmodel.named_parameters())
    assert sorted(want) == sorted(params)
    for name in sorted(want):
        w = want[name].numpy()
        g = params[name].grad
        got = np.zeros_like(w) if g is None else g.numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=GRAD_ATOL + GRAD_RTOL * scale,
                                   err_msg=f"grad {name}")


def _assert_stats(tmodel, jstats):
    want = convert.zoo_state_dict(tmodel, {}, _np(jstats))
    buffers = dict(tmodel.named_buffers())
    assert sorted(want) == sorted(buffers)
    for name in sorted(want):
        np.testing.assert_allclose(buffers[name].numpy(), want[name].numpy(),
                                   **TOL, err_msg=f"stat {name}")


def _train_check(jmodel, tmodel, variables, x, n_out=1, **jkw):
    """One train-mode forward + backward of sum(out * w) on both sides:
    outputs, every gradient and the new BatchNorm statistics."""
    has_stats = "batch_stats" in variables
    shapes = jax.eval_shape(
        lambda: jmodel.apply(variables, jnp.asarray(x), **jkw,
                             mutable=["batch_stats"])[0])
    outs = shapes if n_out > 1 else (shapes,)
    ws = [_weights(10 + i, o.shape) for i, o in enumerate(outs)]

    def loss_fn(p):
        out, new = jmodel.apply({**variables, "params": p}, jnp.asarray(x),
                                **jkw, mutable=["batch_stats"])
        out = out if n_out > 1 else (out,)
        return sum((o * w).sum() for o, w in zip(out, ws)), (out, new)

    (_, (jout, jnew)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tout = tmodel(torch.from_numpy(x), **{k: v for k, v in sorted(
        jkw.items())})
    tout = tout if n_out > 1 else (tout,)
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(tout, ws)).backward()
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    _assert_grads(tmodel, jgrads)
    if has_stats:
        _assert_stats(tmodel, jnew["batch_stats"])


# ---------------------------------------------------------------------------
# XLA's SAME padding


@pytest.mark.parametrize("n", [8, 9], ids=["even", "odd"])
@pytest.mark.parametrize("k", [1, 3])
def test_stride2_same_conv_matches_flax(n, k):
    x = np.random.RandomState(n).randn(2, n, n, 4).astype(np.float32)
    jconv = fnn.Conv(6, (k, k), (2, 2), padding="SAME", use_bias=False)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    tconv = Conv(4, 6, k, torch.float32, torch.Generator(), strides=2,
                 use_bias=False)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(np.asarray(
            variables["params"]["kernel"]).transpose(3, 2, 0, 1)))
        got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_same_padding_is_xlas_rule():
    assert same_padding(56, 3, 2) == (0, 1)      # torch's padding=1: (1, 1)
    assert same_padding(57, 3, 2) == (1, 1)
    assert same_padding(56, 1, 2) == (0, 0)
    assert same_padding(56, 3, 1) == (1, 1)
    assert same_padding(224, 16, 16) == (0, 0)


# ---------------------------------------------------------------------------
# Vision models


@pytest.mark.parametrize("size", [32, 36], ids=["even", "odd"])
def test_resnet_tiny_matches_jax(size):
    """At 32² the stride-2 3x3 sees an 8x8 grid (SAME pads (0, 1)), at
    36² a 9x9 one ((1, 1))."""
    x = _images(size, 2, size)
    jmodel = jm.ResNetTiny(dtype=jnp.float32)
    variables = _init(jmodel, x, train=True)
    tmodel = _port(tm.ResNetTiny(dtype=torch.float32, device="cpu"),
                   variables)
    _train_check(jmodel, tmodel, variables, x, train=True)
    # Eval mode reads the (converted) running statistics.
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    tmodel = _port(tm.ResNetTiny(dtype=torch.float32, device="cpu"),
                   variables)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_resnet_third_norm_starts_at_zero_scale():
    model = tm.ResNetTiny(dtype=torch.float32, device="cpu")
    for i in range(2):
        block = getattr(model, f"BottleneckBlock_{i}")
        assert torch.equal(block.BatchNorm_2.weight,
                           torch.zeros_like(block.BatchNorm_2.weight))
        assert torch.equal(block.BatchNorm_0.weight,
                           torch.ones_like(block.BatchNorm_0.weight))


def test_resnet50_has_the_reference_parameter_count():
    model = tm.ResNet50(device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    assert model.conv_init.weight.is_contiguous(
        memory_format=torch.channels_last)


def test_vgg_tiny_matches_jax():
    x = _images(1, 2, 32)
    jmodel = jm.VGGTiny(dtype=jnp.float32, dropout_rate=0.0)
    variables = _init(jmodel, x, train=True)
    tmodel = _port(tm.VGGTiny(dtype=torch.float32, dropout_rate=0.0,
                              image_size=32, device="cpu"), variables)
    _train_check(jmodel, tmodel, variables, x, train=True)


def test_vgg_dropout_draws_from_the_model_generator():
    x = torch.from_numpy(_images(2, 2, 32))
    outs = []
    for _ in range(2):
        model = tm.VGGTiny(dtype=torch.float32, image_size=32, device="cpu",
                           seed=3)
        outs.append([model(x, train=True) for _ in range(2)])
    assert torch.equal(outs[0][0], outs[1][0])          # same seed, same
    assert not torch.equal(outs[0][0], outs[0][1])      # next draw differs
    model = tm.VGGTiny(dtype=torch.float32, image_size=32, device="cpu")
    assert torch.equal(model(x, train=False), model(x, train=False))


@pytest.fixture(scope="module")
def inception_variables():
    """One init with the aux head; the model without it takes the same
    tree less the aux modules."""
    jmodel = jm.InceptionV3(num_classes=7, aux_logits=True, dropout_rate=0.0,
                            dtype=jnp.float32)
    return _init(jmodel, _images(0, 1, 75), train=True)


def _inception_pair(variables, aux, jdtype, tdtype):
    if not aux:
        variables = {col: {k: v for k, v in sorted(tree.items())
                           if k not in ("ConvBN_5", "ConvBN_6", "aux_head")}
                     for col, tree in sorted(variables.items())}
    jmodel = jm.InceptionV3(num_classes=7, aux_logits=aux, dropout_rate=0.0,
                            dtype=jdtype)
    tmodel = _port(tm.InceptionV3(num_classes=7, aux_logits=aux,
                                  dropout_rate=0.0, dtype=tdtype,
                                  image_size=75, device="cpu"), variables)
    return jmodel, tmodel, variables


@pytest.mark.parametrize("aux", [True, False], ids=["aux", "no_aux"])
def test_inception_v3_train_mode_matches_jax(inception_variables, aux):
    """Train mode runs float64 activations on both sides (parameters,
    statistics and the float32 heads as in float32 runs). At 75² the
    last blocks' BatchNorms normalise over 2 (a 1x1 grid) to 18 values
    (3x3) per channel, which amplify rounding by orders of magnitude: a
    float32 run of either package lands visibly off a float64 run at the
    head, each differently, so only wider activations compare the two at
    ``TOL``."""
    with jax.enable_x64(True):
        jmodel, tmodel, variables = _inception_pair(
            inception_variables, aux, jnp.float64, torch.float64)
        _train_check(jmodel, tmodel, variables, _images(3, 2, 75),
                     n_out=2 if aux else 1, train=True)


def test_inception_v3_eval_mode_matches_jax_in_float32(inception_variables):
    """Eval mode normalises with the running statistics (an affine map,
    no amplification): float32 on both sides at ``TOL``."""
    jmodel, tmodel, variables = _inception_pair(
        inception_variables, False, jnp.float32, torch.float32)
    _train_check(jmodel, tmodel, variables, _images(3, 2, 75), train=False)


def test_mnist_mlp_matches_jax():
    x = _images(4, 3, 28, 1)
    jmodel = jm.MnistMLP()
    variables = _init(jmodel, x)
    tmodel = _port(tm.MnistMLP(device="cpu"), variables)
    _train_check(jmodel, tmodel, variables, x)


def test_vit_tiny_matches_jax():
    cfg = dataclasses.replace(jm.VIT_TINY, dtype=jnp.float32)
    x = _images(5, 2, 32)
    jmodel = jm.VisionTransformer(cfg)
    variables = _init(jmodel, x)
    tmodel = _port(tm.VisionTransformer(
        dataclasses.replace(tm.VIT_TINY, dtype=torch.float32),
        device="cpu"), variables)
    _train_check(jmodel, tmodel, variables, x)


# ---------------------------------------------------------------------------
# BERT


JBERT = dataclasses.replace(jm.BERT_TINY, dtype=jnp.float32)
TBERT = dataclasses.replace(tm.BERT_TINY, dtype=torch.float32)


def _bert_pair(ids, attention_fns=(None, None)):
    jmodel = jm.BertEncoder(JBERT, attention_fn=attention_fns[0])
    variables = _init(jm.BertEncoder(JBERT), ids, deterministic=True)
    tmodel = _port(tm.BertEncoder(TBERT, attention_fn=attention_fns[1],
                                  device="cpu"), variables)
    return jmodel, variables, tmodel


def _bert_loss_check(jmodel, variables, tmodel, ids, mask, labels_mask):
    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids),
                              attention_mask=jnp.asarray(mask),
                              deterministic=True)
        return jm.mlm_loss(logits, jnp.asarray(ids),
                           jnp.asarray(labels_mask)), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    t_ids = torch.from_numpy(ids).long()
    logits = tmodel(t_ids, attention_mask=torch.from_numpy(mask))
    loss = tm.mlm_loss(logits, t_ids, torch.from_numpy(labels_mask))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads(tmodel, jgrads)


def test_bert_tiny_matches_jax():
    rng = np.random.RandomState(6)
    ids = rng.randint(0, TBERT.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 9:] = 0
    labels_mask = (rng.rand(2, 12) < 0.3).astype(np.float32)
    jmodel, variables, tmodel = _bert_pair(ids)
    _bert_loss_check(jmodel, variables, tmodel, ids, mask, labels_mask)


def test_bert_tiny_key_mask_through_flash_matches_jax(monkeypatch):
    """Flash forced on both sides (JAX's Pallas kernels in interpret
    mode, the port's plain versions of its kernels on the CPU), with the
    key mask [1,1,1,1,0,0,0,0]."""
    ids = np.random.RandomState(7).randint(
        0, TBERT.vocab_size, (2, 8)).astype(np.int32)
    mask = np.array([[1, 1, 1, 1, 0, 0, 0, 0]] * 2, np.int32)
    labels_mask = np.ones((2, 8), np.float32)
    fns = (jmake(use_flash=True), tattn.make_attention_fn(use_flash=True))
    jmodel, variables, tmodel = _bert_pair(ids, fns)
    calls = []
    real = tattn.flash_attention_forward_plain

    def spy(q, k, v, key_mask, causal, sm_scale):
        calls.append((causal, tuple(key_mask.shape)))
        return real(q, k, v, key_mask, causal, sm_scale)

    monkeypatch.setattr(tattn, "flash_attention_forward_plain", spy)
    _bert_loss_check(jmodel, variables, tmodel, ids, mask, labels_mask)
    # Non-causal with the key mask, in every layer.
    assert calls == [(False, (2, 8))] * TBERT.num_layers
    # A masked key's token leaves the unmasked rows unchanged.
    ids2 = ids.copy()
    ids2[:, 6] = (ids2[:, 6] + 1) % TBERT.vocab_size
    with torch.no_grad():
        a, b = (tmodel(torch.from_numpy(i).long(),
                       attention_mask=torch.from_numpy(mask))
                for i in (ids, ids2))
    np.testing.assert_array_equal(a[:, :4].numpy(), b[:, :4].numpy())


def test_bert_without_a_mask_attends_every_key():
    ids = torch.from_numpy(np.random.RandomState(8).randint(
        0, TBERT.vocab_size, (2, 8)))
    model = tm.BertEncoder(TBERT, device="cpu")
    seen = []
    model.layer_0.SelfAttention_0.attention_fn = (
        lambda q, k, v, mask: seen.append(mask) or
        tattn.reference_attention(q, k, v, mask))
    with torch.no_grad():
        model(ids)
    assert seen[0].dtype == torch.bool and bool(seen[0].all())
    assert seen[0].shape == (2, 8)


def test_bert_positions_index_the_position_table():
    ids = np.random.RandomState(9).randint(
        0, TBERT.vocab_size, (1, 8)).astype(np.int32)
    jmodel = jm.BertEncoder(JBERT)
    variables = _init(jmodel, ids, deterministic=True)
    tmodel = _port(tm.BertEncoder(TBERT, device="cpu"), variables)
    positions = np.arange(8) + 16
    want = jmodel.apply(variables, jnp.asarray(ids),
                        positions=jnp.asarray(positions))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(),
                     positions=torch.from_numpy(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("family", ["bert", "vit"])
def test_remat_with_dropout_gives_the_same_grads(family):
    """Recomputation replays the dropout generator: with dropout on,
    remat and no remat give the same gradients."""
    grads = []
    for remat in (False, True):
        if family == "bert":
            cfg = dataclasses.replace(TBERT, remat=remat)
            model = tm.BertEncoder(cfg, device="cpu", seed=1)
            ids = torch.from_numpy(np.random.RandomState(10).randint(
                0, cfg.vocab_size, (2, 8)))
            out = model(ids, deterministic=False)
        else:
            cfg = dataclasses.replace(tm.VIT_TINY, dtype=torch.float32,
                                      dropout_rate=0.1, remat=remat)
            model = tm.VisionTransformer(cfg, device="cpu", seed=1)
            out = model(torch.from_numpy(_images(11, 2, 32)),
                        deterministic=False)
        (out.float() ** 2).mean().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name in sorted(grads[0]):
        torch.testing.assert_close(grads[1][name], grads[0][name], atol=1e-7,
                                   rtol=1e-6, msg=f"remat grad {name}")


def test_zoo_state_dict_names_what_it_cannot_map():
    x = _images(0, 1, 32)
    variables = _np(_init(jm.ResNetTiny(dtype=jnp.float32), x, train=True))
    model = tm.ResNetTiny(dtype=torch.float32, device="cpu")
    params = dict(variables["params"], extra={"kernel": np.zeros((1, 1))})
    with pytest.raises(ValueError, match="extra/kernel"):
        convert.zoo_state_dict(model, params)
    params = dict(variables["params"])
    params["head"] = {"kernel": np.zeros((3, 10), np.float32),
                      "bias": np.zeros(10, np.float32)}
    with pytest.raises(ValueError, match="head.weight"):
        convert.zoo_state_dict(model, params)
    with pytest.raises(RuntimeError, match="running_mean"):
        convert.resnet_from_flax(model, variables["params"])
