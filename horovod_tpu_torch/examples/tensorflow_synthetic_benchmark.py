"""TensorFlow synthetic benchmark on the TF adapter tier.

The port's counterpart of ``examples/tensorflow_synthetic_benchmark.py``:
the same synthetic data, flags and printed lines, over
``horovod_tpu_torch.tensorflow``. Without tensorflow the front end's import
raises its message.

Counterpart of the reference's ``examples/tensorflow_synthetic_benchmark.py``
(the script its benchmark docs drive, ``docs/benchmarks.md:10-34``): any
``tf.keras.applications`` model on synthetic data, gradients averaged across
ranks each step, img/sec per worker and total reported from rank 0. The
TF1 session/``tf.train`` machinery of the original becomes a ``tf.function``
train step with ``DistributedGradientTape``; collectives ride the custom-op
fast path when the native engine is live (``HOROVOD_TENSORFLOW_CUSTOM_OP=0``
forces the ``tf.py_function`` fallback for A/B measurement).

    python -m horovod_tpu_torch.run -np 2 python -m \
        horovod_tpu_torch.examples.tensorflow_synthetic_benchmark \
        --model ResNet50 --batch-size 32

NOTE: this measures the TF HOST tier (CPU collectives, like the reference's
CPU path). The card's path is the torch tier
(``horovod_tpu_torch.examples.synthetic_benchmark``).
"""

import argparse
import timeit

import numpy as np

# The front end first: without tensorflow its import raises the message.
import horovod_tpu_torch.tensorflow as hvd
import tensorflow as tf  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="TensorFlow Synthetic Benchmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--fp16-allreduce", action="store_true", default=False,
                        help="use fp16 compression during allreduce")
    parser.add_argument("--model", type=str, default="ResNet50",
                        help="tf.keras.applications model to benchmark")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--image-size", type=int, default=224,
                        help="square input size (reference fixes 224)")
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--num-warmup-batches", type=int, default=10)
    parser.add_argument("--num-batches-per-iter", type=int, default=10)
    parser.add_argument("--num-iters", type=int, default=10)
    args = parser.parse_args(argv)

    hvd.init()

    # classifier_activation=None: the applications default softmax head
    # would feed probabilities into a from_logits loss (softmax-of-softmax,
    # vanishing gradients) — the reference trains on logits too.
    model = getattr(tf.keras.applications, args.model)(
        weights=None, input_shape=(args.image_size, args.image_size, 3),
        classes=args.num_classes, classifier_activation=None)
    opt = tf.keras.optimizers.SGD(0.01)

    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)

    rng = np.random.RandomState(hvd.rank())
    data = tf.constant(rng.rand(
        args.batch_size, args.image_size, args.image_size, 3).astype("f4"))
    target = tf.constant(rng.randint(
        0, args.num_classes, size=(args.batch_size,)).astype("i8"))

    loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True)

    @tf.function
    def benchmark_step():
        with hvd.DistributedGradientTape(compression=compression) as tape:
            logits = model(data, training=True)
            loss = loss_fn(target, logits)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        return loss

    def log(s):
        if hvd.rank() == 0:
            print(s, flush=True)

    # Start from identical weights, as training would (reference bcast_op).
    hvd.broadcast_variables(model.variables, root_rank=0)

    log(f"Model: {args.model}")
    log(f"Batch size: {args.batch_size}")
    log(f"Number of workers: {hvd.size()}")

    def step():
        # Fetch the loss: the barrier that makes wall-clock honest.
        benchmark_step().numpy()

    log("Running warmup...")
    timeit.timeit(step, number=args.num_warmup_batches)

    log("Running benchmark...")
    img_secs = []
    for x in range(args.num_iters):
        t = timeit.timeit(step, number=args.num_batches_per_iter)
        img_sec = args.batch_size * args.num_batches_per_iter / t
        log(f"Iter #{x}: {img_sec:.1f} img/sec per worker")
        img_secs.append(img_sec)

    img_sec_mean = float(np.mean(img_secs))
    img_sec_conf = float(1.96 * np.std(img_secs))
    log(f"Img/sec per worker: {img_sec_mean:.1f} +-{img_sec_conf:.1f}")
    log(f"Total img/sec on {hvd.size()} worker(s): "
        f"{hvd.size() * img_sec_mean:.1f} +-{hvd.size() * img_sec_conf:.1f}")


if __name__ == "__main__":
    main()
