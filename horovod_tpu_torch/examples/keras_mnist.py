"""MNIST with the Keras adapter — Horovod UX on the eager tier.

The port's counterpart of ``examples/keras_mnist.py``: the same synthetic
data, flags and printed lines, over ``horovod_tpu_torch.keras``. Without
tensorflow the front end's import raises its message.

Counterpart of the reference's ``examples/keras_mnist.py``: scale the
learning rate by world size, wrap the optimizer, broadcast initial variables
from rank 0, average metrics at epoch end, warm the learning rate up over the
first epochs. Run under the launcher:

    python -m horovod_tpu_torch.run -np 2 python -m \
        horovod_tpu_torch.examples.keras_mnist

Uses a synthetic MNIST-shaped dataset (no network egress).
"""

import argparse

import numpy as np

# The front end first: without tensorflow its import raises the message.
import horovod_tpu_torch.keras as hvd
import tensorflow as tf  # noqa: E402


def synthetic_mnist(n=4096, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, size=n).astype(np.int32)
    centers = rng.rand(10, 28 * 28).astype(np.float32)
    x = centers[y] + 0.3 * rng.rand(n, 28 * 28).astype(np.float32)
    return x.reshape(n, 28, 28, 1), y


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-3)
    args = parser.parse_args(argv)

    hvd.init()

    x, y = synthetic_mnist()
    # Each rank trains on its shard (the reference shards by Keras's
    # steps_per_epoch trick; explicit slicing is equivalent and clearer).
    x, y = x[hvd.rank()::hvd.size()], y[hvd.rank()::hvd.size()]

    model = tf.keras.Sequential([
        tf.keras.layers.Conv2D(32, 3, activation="relu",
                               input_shape=(28, 28, 1)),
        tf.keras.layers.MaxPooling2D(),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10),
    ])

    # Reference recipe: scale lr by size, then let the wrapped optimizer
    # average gradients across ranks (keras_mnist.py in the reference).
    opt = tf.keras.optimizers.Adam(args.lr * hvd.size())
    opt = hvd.DistributedOptimizer(opt)

    model.compile(
        optimizer=opt,
        loss=tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True),
        metrics=["accuracy"],
    )

    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
        hvd.callbacks.LearningRateWarmupCallback(
            warmup_epochs=1, steps_per_epoch=max(1, len(x) // args.batch_size),
            verbose=0),
    ]

    model.fit(x, y, batch_size=args.batch_size, epochs=args.epochs,
              callbacks=callbacks, verbose=2 if hvd.rank() == 0 else 0)

    if hvd.rank() == 0:
        loss, acc = model.evaluate(x, y, verbose=0)
        print(f"final: loss={loss:.4f} acc={acc:.4f}")


if __name__ == "__main__":
    main()
