"""MNIST with the TensorFlow adapter, pure eager execution.

The port's counterpart of ``examples/tensorflow_mnist_eager.py``: the same
synthetic data, flags and printed lines, over
``horovod_tpu_torch.tensorflow``. Without tensorflow the front end's import
raises its message.

Counterpart of the reference's ``examples/tensorflow_mnist_eager.py``: a
``GradientTape`` loop with per-step gradient allreduce
(``DistributedGradientTape``) and a one-time variable broadcast after the
first step, no graph compilation anywhere. Launch:

    python -m horovod_tpu_torch.run -np 2 python -m \
        horovod_tpu_torch.examples.tensorflow_mnist_eager
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
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=64)
    args = parser.parse_args(argv)

    hvd.init()
    x, y = synthetic_mnist()
    x, y = x[hvd.rank()::hvd.size()], y[hvd.rank()::hvd.size()]

    model = tf.keras.Sequential([
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10),
    ])
    loss_obj = tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True)
    # Reference eager example: lr scaled by world size.
    opt = tf.keras.optimizers.SGD(0.01 * hvd.size())

    rng = np.random.RandomState(hvd.rank())
    for step in range(args.steps):
        idx = rng.randint(0, len(x), size=args.batch_size)
        with hvd.DistributedGradientTape() as tape:
            loss = loss_obj(y[idx], model(x[idx], training=True))
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        if step == 0:
            # Variables exist after the first step; sync everyone to rank 0
            # (the reference broadcasts here too).
            hvd.broadcast_variables(model.variables, root_rank=0)
            hvd.broadcast_variables(opt.variables, root_rank=0)
        if step % 10 == 0 and hvd.rank() == 0:
            print(f"step {step}: loss {float(loss):.4f}")


if __name__ == "__main__":
    main()
