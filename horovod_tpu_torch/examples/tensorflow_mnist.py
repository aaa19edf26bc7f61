"""MNIST with the TensorFlow adapter, compiled with ``tf.function``.

The port's counterpart of ``examples/tensorflow_mnist.py``: the same
synthetic data, flags and printed lines, over
``horovod_tpu_torch.tensorflow``. Without tensorflow the front end's import
raises its message.

Counterpart of the reference's ``examples/tensorflow_mnist.py`` (TF1 graph
mode there; ``tf.function`` is the TF2 spelling of "build a graph once, run
it per step" — the allreduce is embedded in the traced graph the way the
reference's ``HorovodAllreduce`` op is). For the pure-eager idiom see
``tensorflow_mnist_eager.py``. Launch:

    python -m horovod_tpu_torch.run -np 2 python -m \
        horovod_tpu_torch.examples.tensorflow_mnist
"""

import argparse

import numpy as np

# The front end first: without tensorflow its import raises the message.
import horovod_tpu_torch.tensorflow as hvd
import tensorflow as tf  # noqa: E402


def synthetic_mnist(n=4096, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, size=n).astype(np.int64)
    centers = rng.rand(10, 784).astype(np.float32)
    x = centers[y] + 0.3 * rng.rand(n, 784).astype(np.float32)
    return x, y


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=64)
    args = parser.parse_args(argv)

    hvd.init()
    x, y = synthetic_mnist()
    x = x[hvd.rank()::hvd.size()]
    y = y[hvd.rank()::hvd.size()]

    model = tf.keras.Sequential([
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10),
    ])
    loss_obj = tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True)
    opt = tf.keras.optimizers.SGD(0.01 * hvd.size())

    @tf.function
    def train_step(xb, yb):
        with hvd.DistributedGradientTape() as tape:
            loss = loss_obj(yb, model(xb, training=True))
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        return loss

    first_batch = True
    for epoch in range(args.epochs):
        perm = np.random.RandomState(epoch).permutation(len(x))
        total = 0.0
        for i in range(0, len(x) - args.batch_size + 1, args.batch_size):
            idx = perm[i:i + args.batch_size]
            loss = train_step(tf.constant(x[idx]), tf.constant(y[idx]))
            if first_batch:
                # Consistent start after variables exist (reference
                # BroadcastGlobalVariablesHook semantics).
                hvd.broadcast_variables(model.variables, root_rank=0)
                hvd.broadcast_variables(opt.variables, root_rank=0)
                first_batch = False
            total += float(loss)
        avg = hvd.allreduce(tf.constant(total), name="epoch_loss")
        if hvd.rank() == 0:
            print(f"epoch {epoch}: mean rank loss {float(avg):.4f}")


if __name__ == "__main__":
    main()
