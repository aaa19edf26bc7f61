"""MNIST through the Spark integration: each executor becomes a rank of
one job — the port's counterpart of ``examples/spark_mnist.py``. Spark
owns the data prep, then every executor runs the same training function
(``horovod_tpu_torch.spark.run``), on its card when it has one:

    python -m horovod_tpu_torch.examples.spark_mnist --num-proc 2

Needs a local pyspark (without it the Spark front end raises).
"""

import argparse


def train(epochs, batch_size, lr):
    # Runs on each Spark executor as one rank; the topology is in the
    # environment when horovod_tpu_torch.spark.run hands control here.
    import numpy as np
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd

    hvd.init(device=None if torch.cuda.is_available() else "cpu")
    device = hvd.device()
    torch.manual_seed(0)

    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, size=2048).astype(np.int64)
    centers = rng.rand(10, 28 * 28).astype(np.float32)
    x = centers[y] + 0.3 * rng.rand(2048, 28 * 28).astype(np.float32)
    x, y = x[hvd.rank()::hvd.size()], y[hvd.rank()::hvd.size()]

    model = torch.nn.Sequential(
        torch.nn.Linear(28 * 28, 128), torch.nn.ReLU(),
        torch.nn.Linear(128, 10)).to(device)
    optimizer = torch.optim.SGD(model.parameters(), lr=lr * hvd.size())
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    loss_val = None
    for _ in range(epochs):
        for i in range(0, len(x) - batch_size + 1, batch_size):
            xb = torch.from_numpy(x[i:i + batch_size]).to(device)
            yb = torch.from_numpy(y[i:i + batch_size]).to(device)
            optimizer.zero_grad()
            loss = F.cross_entropy(model(xb), yb)
            loss.backward()
            optimizer.step()
            loss_val = float(loss)
    rank = hvd.rank()
    hvd.shutdown()
    return rank, loss_val


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-proc", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.01)
    args = parser.parse_args(argv)

    from pyspark.sql import SparkSession

    spark = (SparkSession.builder.master(f"local[{args.num_proc}]")
             .appName("horovod_tpu_torch_spark_mnist").getOrCreate())

    import horovod_tpu_torch.spark

    results = horovod_tpu_torch.spark.run(
        train, args=(args.epochs, args.batch_size, args.lr),
        num_proc=args.num_proc)
    for rank, loss in results:
        print(f"rank {rank}: final loss={loss:.4f}")
    spark.stop()
    return results


if __name__ == "__main__":
    main()
