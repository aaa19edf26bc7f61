"""ImageNet ResNet-50 with the MXNet adapter on the port's eager tier —
the port's counterpart of ``examples/mxnet_imagenet_resnet50.py``: a
gluon model, ``DistributedTrainer``, ``broadcast_parameters`` after init,
a world-size-scaled learning rate with warmup and 30/60/80 step decay,
and metrics averaged across ranks with ``DistributedEvalMetric``.

    python -m horovod_tpu_torch.run -np 2 \
        python -m horovod_tpu_torch.examples.mxnet_imagenet_resnet50 \
        --epochs 1 --steps-per-epoch 2 --image-size 32 --batch-size 4

Needs the ``mxnet`` package (end of life; without it the front end's
import raises). With gluon's model zoo the model is ``resnet50_v1``; an
``mxnet`` without it (the tests' in-tree fake) gets a Dense head over
the flattened images. The distributed mechanics (broadcast, gradient
averaging, metric reduction, the schedule) are the same either way.
"""

import argparse

import numpy as np


def synthetic_imagenet(n, image_size, num_classes, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3 * image_size * image_size).astype(np.float32)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    return x, y


def lr_multiplier(epoch, batch, batches, warmup_epochs, size):
    """Linear warmup over the first epochs, then 10x decay at 30/60/80
    (the reference example's schedule)."""
    if epoch < warmup_epochs:
        progress = (batch + epoch * batches) / max(1, warmup_epochs * batches)
        return 1.0 / size * (progress * (size - 1) + 1)
    if epoch < 30:
        return 1.0
    if epoch < 60:
        return 1e-1
    if epoch < 80:
        return 1e-2
    return 1e-3


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=90)
    parser.add_argument("--steps-per-epoch", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--base-lr", type=float, default=0.0125)
    parser.add_argument("--warmup-epochs", type=int, default=5)
    args = parser.parse_args(argv)

    # The front end first: without mxnet its import raises the message.
    import horovod_tpu_torch.mxnet as hvd

    import mxnet as mx

    hvd.init()
    zoo = hasattr(mx.gluon, "model_zoo")

    n = args.steps_per_epoch * args.batch_size
    x, y = synthetic_imagenet(n, args.image_size, args.num_classes,
                              seed=hvd.rank())

    if zoo:
        net = mx.gluon.model_zoo.vision.resnet50_v1(
            classes=args.num_classes)
        net.initialize()
        reshape = (args.batch_size, 3, args.image_size, args.image_size)
    else:
        net = mx.gluon.nn.Dense(args.num_classes,
                                in_units=3 * args.image_size ** 2)
        net.initialize()
        reshape = None

    params = net.collect_params()
    hvd.broadcast_parameters(params, root_rank=0)

    base_lr = args.base_lr * hvd.size()
    opt = mx.optimizer.SGD(learning_rate=base_lr)
    trainer = hvd.DistributedTrainer(params, opt)

    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    # mxnet's EvalMetric is abstract; Accuracy is its stock concrete
    # subclass. The in-tree fake's EvalMetric is already concrete.
    if zoo:
        metric = hvd.DistributedEvalMetric(mx.metric.Accuracy)()
    else:
        metric = hvd.DistributedEvalMetric(mx.metric.EvalMetric)(name="acc")

    batches = max(1, n // args.batch_size)
    for epoch in range(args.epochs):
        for b in range(batches):
            opt.set_learning_rate(
                base_lr * lr_multiplier(epoch, b, batches,
                                        args.warmup_epochs, hvd.size()))
            sl = slice(b * args.batch_size, (b + 1) * args.batch_size)
            xb = x[sl].reshape(reshape) if reshape else x[sl]
            xb, yb = mx.nd.array(xb), mx.nd.array(y[sl])
            with mx.autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            trainer.step(args.batch_size)
        metric.reset()
        metric.update([mx.nd.array(y[:args.batch_size])],
                      [net(mx.nd.array(
                          x[:args.batch_size].reshape(reshape)
                          if reshape else x[:args.batch_size]))])
        name, val = metric.get()
        if hvd.rank() == 0:
            print(f"epoch {epoch}: {name}={val:.4f}")


if __name__ == "__main__":
    main()
