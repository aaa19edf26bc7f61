"""MNIST with the MXNet adapter on the port's eager tier — the port's
counterpart of ``examples/mxnet_mnist.py``: a gluon model,
``DistributedTrainer`` (gradients averaged across ranks each step),
``broadcast_parameters`` after init, the learning rate scaled by the
world size.

    python -m horovod_tpu_torch.run -np 2 \
        python -m horovod_tpu_torch.examples.mxnet_mnist --epochs 1

Needs the ``mxnet`` package (end of life; without it the front end's
import raises). The tests install the in-tree fake as ``mxnet`` before
running this module.
"""

import argparse

import numpy as np


def synthetic_mnist(n=2048, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, size=n).astype(np.int32)
    centers = rng.rand(10, 28 * 28).astype(np.float32)
    x = centers[y] + 0.3 * rng.rand(n, 28 * 28).astype(np.float32)
    return x, y


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.01)
    args = parser.parse_args(argv)

    # The front end first: without mxnet its import raises the message.
    import horovod_tpu_torch.mxnet as hvd

    import mxnet as mx

    hvd.init()

    x, y = synthetic_mnist()
    x, y = x[hvd.rank()::hvd.size()], y[hvd.rank()::hvd.size()]

    net = mx.gluon.nn.Dense(10, in_units=28 * 28)
    net.initialize()
    params = net.collect_params()

    # Reference recipe (mxnet_mnist.py): broadcast initial parameters, then
    # DistributedTrainer averages gradients across ranks every step.
    hvd.broadcast_parameters(params, root_rank=0)
    trainer = hvd.DistributedTrainer(
        params, mx.optimizer.SGD(learning_rate=args.lr * hvd.size()))

    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for epoch in range(args.epochs):
        total, batches = 0.0, 0
        for i in range(0, len(x) - args.batch_size + 1, args.batch_size):
            xb = mx.nd.array(x[i:i + args.batch_size])
            yb = mx.nd.array(y[i:i + args.batch_size])
            with mx.autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            trainer.step(args.batch_size)
            total += loss.mean().asscalar()
            batches += 1
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss={total / max(1, batches):.4f}")


if __name__ == "__main__":
    main()
