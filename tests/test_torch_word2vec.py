"""``examples/word2vec.py`` on the port against ``examples/jax_word2vec.py``.

* ``build_corpus`` (the synthetic Zipf stream and a text file) and
  ``skipgram_batches`` give equal arrays on the same seeds, and the
  port's example draws its batches and negatives from ``RandomState(rank)``
  in the JAX example's order;
* from the same initial tables (the JAX example's ``jax.random.uniform``
  draw, carried across as numpy: the torch generator cannot redraw it),
  three steps of the port's example equal the JAX example's step (its
  loss, ``optax.adagrad`` through ``DistributedOptimizer`` at size 1) in
  the loss and both tables.

Tolerance: atol 1e-6 / rtol 1e-5 on the losses and tables (float32;
summation order only), and each table's movement over the three steps
within 1e-3 of its largest entry.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu_torch.examples import word2vec
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-6, rtol=1e-5)
V, D, B, WINDOW, K, LR = 1000, 32, 64, 2, 8, 0.05


@pytest.fixture(scope="module")
def jex():
    spec = importlib.util.spec_from_file_location(
        "jax_word2vec", os.path.join(REPO, "examples", "jax_word2vec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_corpus_and_batches_equal_as_data(jex, tmp_path):
    np.testing.assert_array_equal(word2vec.build_corpus(None, V),
                                  jex.build_corpus(None, V))
    text = tmp_path / "words.txt"
    text.write_text("the cat sat on the mat the end a cat\n")
    np.testing.assert_array_equal(word2vec.build_corpus(str(text), 4),
                                  jex.build_corpus(str(text), 4))
    corpus = jex.build_corpus(None, V)
    mine = word2vec.skipgram_batches(corpus, B, WINDOW,
                                     np.random.RandomState(1))
    theirs = jex.skipgram_batches(corpus, B, WINDOW,
                                  np.random.RandomState(1))
    for _ in range(3):
        for a, b in zip(next(mine), next(theirs)):
            np.testing.assert_array_equal(a, b)


def _jax_reference(jex, tables, steps):
    """The JAX example's train_step at size 1, on its own data stream."""
    params = {k: jnp.asarray(v) for k, v in sorted(tables.items())}
    jhvd.init()
    tx = jhvd.DistributedOptimizer(optax.adagrad(LR))
    state = tx.init(params)

    def loss_fn(p, centers, contexts, negatives):
        v = p["in"][centers]
        u_pos = p["out"][contexts]
        u_neg = p["out"][negatives]
        pos = jax.nn.log_sigmoid(jnp.sum(v * u_pos, axis=-1))
        neg = jax.nn.log_sigmoid(-jnp.einsum("bd,bkd->bk", v, u_neg))
        return -(pos + neg.sum(axis=-1)).mean()

    @jax.jit
    def step(p, s, centers, contexts, negatives):
        loss, grads = jax.value_and_grad(loss_fn)(p, centers, contexts,
                                                  negatives)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    corpus = jex.build_corpus(None, V)
    rng = np.random.RandomState(0)
    data = jex.skipgram_batches(corpus, B, WINDOW, rng)
    losses = []
    for _ in range(steps):
        centers, contexts = next(data)
        negatives = rng.randint(1, V, size=(B, K))
        params, state, loss = step(params, state, jnp.asarray(centers),
                                   jnp.asarray(contexts),
                                   jnp.asarray(negatives))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in sorted(params.items())}


def test_three_steps_equal_jax(jex):
    k_in, _ = jax.random.split(jax.random.PRNGKey(0))
    tables = {"in": np.asarray(jax.random.uniform(
        k_in, (V, D), minval=-0.5, maxval=0.5) / D),
              "out": np.zeros((V, D), np.float32)}
    want_losses, want = _jax_reference(jex, tables, 3)
    thvd.init(device="cpu")
    try:
        out = word2vec.main(["--vocab-size", str(V), "--embedding-dim",
                             str(D), "--batch-size", str(B), "--steps", "3",
                             "--lr", str(LR)], tables=tables)
    finally:
        thvd.shutdown()
    np.testing.assert_allclose(out["losses"], want_losses, **TOL)
    for name in ("in", "out"):
        got = out["tables"][name].numpy()
        np.testing.assert_allclose(got, want[name], **TOL, err_msg=name)
        # The steps' own movement (the "in" table moves by ~5e-6 in three
        # steps, under TOL's atol): equal to 1e-3 of its largest entry.
        moved = want[name] - tables[name]
        scale = float(np.abs(moved).max())
        assert scale > 0, name
        np.testing.assert_allclose(got - tables[name], moved, rtol=0,
                                   atol=1e-3 * scale, err_msg=name)
