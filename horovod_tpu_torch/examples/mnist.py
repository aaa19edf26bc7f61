"""MNIST training on the port — the counterpart of
``examples/jax_mnist.py``, the quickstart:

    python -m horovod_tpu_torch.examples.mnist [--epochs 3] [--batch-size 512]

``MnistMLP`` with Adam through ``DistributedOptimizer``. Synthetic
MNIST-shaped data by default (class-dependent blobs, as the JAX example
draws them); ``--data-dir`` with the standard IDX files trains on real
MNIST. ``--batch-size`` is the global batch: each rank takes its slice
of every batch of the epoch's permutation.
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.mlp import MnistMLP


def load_mnist(data_dir: str):
    def read_idx(path):
        with gzip.open(path, "rb") as f:
            magic, = struct.unpack(">I", f.read(4))
            dims = magic & 0xFF
            shape = struct.unpack(f">{dims}I", f.read(4 * dims))
            return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)

    x = read_idx(os.path.join(data_dir, "train-images-idx3-ubyte.gz"))
    y = read_idx(os.path.join(data_dir, "train-labels-idx1-ubyte.gz"))
    return x.astype(np.float32) / 255.0, y.astype(np.int64)


def synthetic_mnist(n: int = 8192, seed: int = 0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, size=n).astype(np.int64)
    # Class-dependent blobs so the model has something to learn.
    centers = rng.rand(10, 28 * 28).astype(np.float32)
    x = centers[y] + 0.3 * rng.rand(n, 28 * 28).astype(np.float32)
    return x.reshape(n, 28, 28), y


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=512,
                        help="global batch (split across ranks)")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--data-dir", default=None)
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init()
    device = hvd.device()
    n, rank = hvd.size(), hvd.rank()
    x, y = (load_mnist(args.data_dir) if args.data_dir
            else synthetic_mnist())
    model = MnistMLP(device=device, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8),
        named_parameters=model.named_parameters())

    bs = args.batch_size - args.batch_size % n
    per_rank = bs // n
    steps_per_epoch = len(x) // bs
    losses = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        perm = np.random.RandomState(epoch).permutation(len(x))[
            :steps_per_epoch * bs].reshape(steps_per_epoch, bs)
        for batch_idx in perm:
            mine = batch_idx[rank * per_rank:(rank + 1) * per_rank]
            xb = torch.from_numpy(x[mine]).to(device)
            yb = torch.from_numpy(y[mine]).to(device)
            opt.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(model(xb).float(), yb)
            loss.backward()
            opt.step()
        losses.append(float(hvd.allreduce(loss.detach())))
        if rank == 0:
            print(f"epoch {epoch}: loss={losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return {"losses": losses, "model": model}


if __name__ == "__main__":
    main()
