"""Advanced Keras MNIST: augmentation, warmup, schedule, rank-aware epochs.

The port's counterpart of ``examples/keras_mnist_advanced.py``: the same
synthetic data, flags and printed lines, over ``horovod_tpu_torch.keras``.
Without tensorflow the front end's import raises its message.

Counterpart of the reference's ``examples/keras_mnist_advanced.py``, which
adds to the plain MNIST example: data augmentation, learning-rate warmup
into a stepped decay schedule, and scaling the *number of epochs* down by
world size (train time stays roughly constant as ranks are added). The
reference's ``ImageDataGenerator`` is gone in Keras 3; the same random
shift/rotation augmentation is applied with numpy.

    python -m horovod_tpu_torch.run -np 2 python -m \
        horovod_tpu_torch.examples.keras_mnist_advanced
"""

import argparse
import math

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


def augment(x, rng):
    """Random +-2px shifts (the reference's width/height_shift_range=0.08)."""
    out = np.empty_like(x)
    for i in range(len(x)):
        dx, dy = rng.randint(-2, 3, size=2)
        out[i] = np.roll(np.roll(x[i], dx, axis=0), dy, axis=1)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=24,
                        help="total epochs at size=1; divided by world size")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--warmup-epochs", type=int, default=3)
    args = parser.parse_args(argv)

    hvd.init()

    x, y = synthetic_mnist()
    x, y = x[hvd.rank()::hvd.size()], y[hvd.rank()::hvd.size()]

    model = tf.keras.Sequential([
        tf.keras.layers.Conv2D(32, 3, activation="relu",
                               input_shape=(28, 28, 1)),
        tf.keras.layers.Conv2D(64, 3, activation="relu"),
        tf.keras.layers.MaxPooling2D(),
        tf.keras.layers.Dropout(0.25),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dropout(0.5),
        tf.keras.layers.Dense(10),
    ])

    # Reference recipe: lr scaled by size; epochs scaled *down* by size so
    # wall-clock is constant as ranks are added (keras_mnist_advanced.py).
    epochs = int(math.ceil(args.epochs / hvd.size()))
    opt = tf.keras.optimizers.Adam(args.lr * hvd.size())
    opt = hvd.DistributedOptimizer(opt)

    model.compile(
        optimizer=opt,
        loss=tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True),
        metrics=["accuracy"],
    )

    steps_per_epoch = max(1, len(x) // args.batch_size)
    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
        hvd.callbacks.LearningRateWarmupCallback(
            warmup_epochs=args.warmup_epochs,
            steps_per_epoch=steps_per_epoch, verbose=0),
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1e-1, start_epoch=max(args.warmup_epochs, 8),
            end_epoch=16),
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1e-2, start_epoch=16),
    ]

    rng = np.random.RandomState(hvd.rank())

    def generator():
        while True:
            perm = rng.permutation(len(x))
            for i in range(0, len(x) - args.batch_size + 1, args.batch_size):
                idx = perm[i:i + args.batch_size]
                yield augment(x[idx], rng), y[idx]

    model.fit(generator(), steps_per_epoch=steps_per_epoch, epochs=epochs,
              callbacks=callbacks, verbose=2 if hvd.rank() == 0 else 0)

    score = model.evaluate(x, y, verbose=0)
    avg = hvd.allreduce(tf.constant(score[1]), name="eval_acc")
    if hvd.rank() == 0:
        print(f"final: acc={float(avg):.4f}")


if __name__ == "__main__":
    main()
