"""Word2vec (skip-gram) with the TensorFlow adapter.

The port's counterpart of ``examples/tensorflow_word2vec.py``: the same
synthetic data, flags and printed lines, over
``horovod_tpu_torch.tensorflow``. Without tensorflow the front end's import
raises its message.

Counterpart of the reference's ``examples/tensorflow_word2vec.py``: each
rank trains embeddings on its shard of a synthetic corpus with sampled
softmax. The embedding gradients are ``tf.IndexedSlices``, so every step
exercises the sparse path — ``hvd.allreduce`` turns them into an allgather
of values+indices instead of a dense sum (reference
``tensorflow/__init__.py:62-78``). Launch:

    python -m horovod_tpu_torch.run -np 2 python -m \
        horovod_tpu_torch.examples.tensorflow_word2vec
"""

import argparse

import numpy as np

# The front end first: without tensorflow its import raises the message.
import horovod_tpu_torch.tensorflow as hvd
import tensorflow as tf  # noqa: E402


def synthetic_corpus(vocab_size, n_pairs, seed=0):
    """Skip-gram pairs with Zipfian centers and nearby-id contexts (stands
    in for the reference's text8 download)."""
    rng = np.random.RandomState(seed)
    zipf = 1.0 / np.arange(1, vocab_size + 1)
    centers = rng.choice(vocab_size, size=n_pairs, p=zipf / zipf.sum())
    contexts = (centers + rng.randint(-4, 5, size=n_pairs)) % vocab_size
    return centers.astype(np.int64), contexts.astype(np.int64)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--vocab-size", type=int, default=5000)
    parser.add_argument("--embedding-dim", type=int, default=64)
    parser.add_argument("--num-sampled", type=int, default=16)
    parser.add_argument("--lr", type=float, default=0.5)
    args = parser.parse_args(argv)

    hvd.init()
    centers, contexts = synthetic_corpus(args.vocab_size, 1 << 17)
    centers = centers[hvd.rank()::hvd.size()]
    contexts = contexts[hvd.rank()::hvd.size()]

    embeddings = tf.Variable(tf.random.uniform(
        [args.vocab_size, args.embedding_dim], -1.0, 1.0, seed=1))
    # Dense projection between lookup and loss: every sampled-softmax grad
    # is IndexedSlices, so this matrix is what keeps the dense allreduce
    # path exercised alongside the sparse one.
    proj = tf.Variable(tf.eye(args.embedding_dim)
                       + 0.01 * tf.random.normal(
                           [args.embedding_dim, args.embedding_dim], seed=4))
    nce_w = tf.Variable(tf.random.truncated_normal(
        [args.vocab_size, args.embedding_dim],
        stddev=1.0 / np.sqrt(args.embedding_dim), seed=2))
    nce_b = tf.Variable(tf.zeros([args.vocab_size]))
    variables = [embeddings, proj, nce_w, nce_b]
    opt = tf.keras.optimizers.SGD(args.lr * hvd.size())

    rng = np.random.RandomState(hvd.rank())
    for step in range(args.steps):
        idx = rng.randint(0, len(centers), size=args.batch_size)
        xb = centers[idx]
        yb = contexts[idx].reshape(-1, 1)
        with tf.GradientTape() as tape:
            embed = tf.nn.embedding_lookup(embeddings, xb) @ proj
            loss = tf.reduce_mean(tf.nn.sampled_softmax_loss(
                weights=nce_w, biases=nce_b, labels=yb, inputs=embed,
                num_sampled=args.num_sampled, num_classes=args.vocab_size,
                seed=3))
        grads = tape.gradient(loss, variables)
        # The embedding/nce grads are IndexedSlices and ride the sparse
        # allgather path; the projection grad is dense and rides allreduce.
        grads = [hvd.allreduce(g, name=f"w2v.grad.{i}")
                 for i, g in enumerate(grads)]
        opt.apply_gradients(zip(grads, variables))
        if step == 0:
            hvd.broadcast_variables(variables, root_rank=0)
            hvd.broadcast_variables(opt.variables, root_rank=0)
        if step % 50 == 0 and hvd.rank() == 0:
            print(f"step {step}: loss {float(loss):.4f} "
                  f"(embedding grad: {type(grads[0]).__name__}, "
                  f"proj grad: {type(grads[1]).__name__})")


if __name__ == "__main__":
    main()
