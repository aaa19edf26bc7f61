"""ImageNet ResNet-50 with the Keras adapter.

The port's counterpart of ``examples/keras_imagenet_resnet50.py``: the same
synthetic data, flags and printed lines, over ``horovod_tpu_torch.keras``.
Without tensorflow the front end's import raises its message.

Counterpart of the reference's ``examples/keras_imagenet_resnet50.py``:
``tf.keras.applications`` ResNet-50 trained with the wrapped optimizer, the
reference's callback stack (broadcast, metric averaging, 5-epoch warmup then
30/60/80 decay) and rank-0 checkpointing. Synthetic ImageNet-shaped data by
default so it runs without the dataset:

    python -m horovod_tpu_torch.run -np 2 python -m \
        horovod_tpu_torch.examples.keras_imagenet_resnet50 \
        --epochs 1 --steps-per-epoch 2 --image-size 64 --batch-size 4
"""

import argparse
import os

import numpy as np

# The front end first: without tensorflow its import raises the message.
import horovod_tpu_torch.keras as hvd
import tensorflow as tf  # noqa: E402


def synthetic_imagenet(n, image_size, num_classes, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, image_size, image_size, 3).astype(np.float32)
    y = rng.randint(0, num_classes, size=n).astype(np.int64)
    return x, y


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=90)
    parser.add_argument("--steps-per-epoch", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--base-lr", type=float, default=0.0125)
    parser.add_argument("--warmup-epochs", type=int, default=5)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--wd", type=float, default=5e-5)
    parser.add_argument("--checkpoint-format",
                        default="checkpoint-{epoch}.keras")
    args = parser.parse_args(argv)

    hvd.init()

    n = args.steps_per_epoch * args.batch_size
    x, y = synthetic_imagenet(n, args.image_size, args.num_classes,
                              seed=hvd.rank())

    # Resume from the newest checkpoint on disk, agreed across ranks
    # (reference examples/keras_imagenet_resnet50.py:64-74: rank 0 has the
    # checkpoints; everyone adopts its answer).
    resume_from_epoch = 0
    for try_epoch in range(args.epochs, 0, -1):
        if os.path.exists(args.checkpoint_format.format(epoch=try_epoch)):
            resume_from_epoch = try_epoch
            break
    resume_from_epoch = hvd.broadcast_object(resume_from_epoch, root_rank=0,
                                             name="resume_from_epoch")

    if resume_from_epoch > 0 and hvd.rank() == 0:
        # Restore model AND optimizer state with the optimizer re-wrapped in
        # DistributedOptimizer (reference :100-104 via hvd.load_model); the
        # broadcast callback below syncs the other ranks from this worker.
        model = hvd.load_model(
            args.checkpoint_format.format(epoch=resume_from_epoch))
    else:
        model = tf.keras.applications.resnet50.ResNet50(
            weights=None, input_shape=(args.image_size, args.image_size, 3),
            classes=args.num_classes)

        # Reference recipe: lr scaled by world size; warmup callback walks it
        # up from the single-worker rate over the first epochs.
        opt = tf.keras.optimizers.SGD(
            learning_rate=args.base_lr * hvd.size(), momentum=args.momentum)
        opt = hvd.DistributedOptimizer(opt)

        model.compile(
            optimizer=opt,
            loss=tf.keras.losses.SparseCategoricalCrossentropy(
                from_logits=False),
            metrics=["accuracy"],
        )

    # Explicit initial_lr on every schedule callback: a model restored via
    # hvd.load_model carries the DECAYED rate, so lazy first-use capture
    # would double-apply the multiplier on the resuming rank and diverge
    # the LR across ranks.
    base_lr = args.base_lr * hvd.size()
    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
        hvd.callbacks.LearningRateWarmupCallback(
            warmup_epochs=args.warmup_epochs,
            steps_per_epoch=args.steps_per_epoch, verbose=0,
            initial_lr=base_lr),
        # 30/60/80 decay, as in the reference example.
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1.0, start_epoch=args.warmup_epochs, end_epoch=30,
            initial_lr=base_lr),
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1e-1, start_epoch=30, end_epoch=60,
            initial_lr=base_lr),
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1e-2, start_epoch=60, end_epoch=80,
            initial_lr=base_lr),
        hvd.callbacks.LearningRateScheduleCallback(
            multiplier=1e-3, start_epoch=80, initial_lr=base_lr),
    ]
    if hvd.rank() == 0:
        # Full-model .keras checkpoints so hvd.load_model can restore the
        # optimizer (slot state included) on resume.
        callbacks.append(tf.keras.callbacks.ModelCheckpoint(
            args.checkpoint_format))

    model.fit(x, y, batch_size=args.batch_size, epochs=args.epochs,
              initial_epoch=resume_from_epoch,
              callbacks=callbacks, verbose=2 if hvd.rank() == 0 else 0)

    score = model.evaluate(x, y, verbose=0)
    avg_loss = hvd.allreduce(tf.constant(score[0]), name="eval_loss")
    if hvd.rank() == 0:
        print(f"final: loss={float(avg_loss):.4f} acc={score[1]:.4f}")


if __name__ == "__main__":
    main()
