"""MNIST with the TF Keras front end and ``model.fit``.
``model.fit``.

The port's counterpart of ``examples/tensorflow_keras_mnist.py``: the same
synthetic data, flags and printed lines, over
``horovod_tpu_torch.tensorflow.keras``. Without tensorflow the front end's
import raises its message.

Fills the slot of the reference's ``examples/tensorflow_mnist_estimator.py``:
``tf.estimator`` is gone from TF2, and its surviving idiom — a packaged
train loop with hooks — is ``tf.keras`` ``model.fit`` with callbacks. The
reference's ``BroadcastGlobalVariablesHook`` maps to
``BroadcastGlobalVariablesCallback``, its estimator checkpointing to a
rank-0 ``ModelCheckpoint``. Launch:

    python -m horovod_tpu_torch.run -np 2 python -m \
        horovod_tpu_torch.examples.tensorflow_keras_mnist
"""

import argparse
import tempfile

import numpy as np

# The front end first: without tensorflow its import raises the message.
import horovod_tpu_torch.tensorflow.keras as hvd
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
    parser.add_argument("--model-dir", default=None,
                        help="rank-0 checkpoint dir (tempdir if unset)")
    args = parser.parse_args(argv)

    hvd.init()

    x, y = synthetic_mnist()
    x, y = x[hvd.rank()::hvd.size()], y[hvd.rank()::hvd.size()]

    model = tf.keras.Sequential([
        tf.keras.layers.Conv2D(32, 3, activation="relu",
                               input_shape=(28, 28, 1)),
        tf.keras.layers.MaxPooling2D(),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10),
    ])

    opt = hvd.DistributedOptimizer(
        tf.keras.optimizers.Adam(args.lr * hvd.size()))
    model.compile(
        optimizer=opt,
        loss=tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True),
        metrics=["accuracy"],
    )

    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
    ]
    # Estimator semantics: only the chief writes checkpoints.
    if hvd.rank() == 0:
        model_dir = args.model_dir or tempfile.mkdtemp(prefix="hvd_keras_")
        callbacks.append(tf.keras.callbacks.ModelCheckpoint(
            f"{model_dir}/ckpt-{{epoch}}.weights.h5",
            save_weights_only=True))
        print(f"checkpoints -> {model_dir}")

    model.fit(x, y, batch_size=args.batch_size, epochs=args.epochs,
              callbacks=callbacks, verbose=2 if hvd.rank() == 0 else 0)

    score = model.evaluate(x, y, verbose=0)
    avg = hvd.allreduce(tf.constant(score[1]), name="eval_acc")
    if hvd.rank() == 0:
        print(f"final: acc={float(avg):.4f}")


if __name__ == "__main__":
    main()
