"""ImageNet ResNet-50 training on the port — the full data-parallel
recipe, the counterpart of ``examples/jax_imagenet_resnet50.py`` (and of
the reference's ``pytorch_imagenet_resnet50.py``):

    python -m horovod_tpu_torch.examples.imagenet_resnet50 --steps 100 \\
        --checkpoint-dir /path/to/ckpts

ResNet-50 with bf16 activations (float32 parameters and BatchNorm
statistics), SGD with momentum 0.9 under ``DistributedOptimizer``. The
learning rate is linear in the global batch (``base_lr * batch / 32``),
warmed up linearly from a tenth of that peak over ``--warmup-steps``,
then cosine-decayed to 0 over ``--steps`` (optax's ``join_schedules`` of
``linear_schedule`` and ``cosine_decay_schedule``). Rank 0 saves the
parameters, the BatchNorm statistics, the optimizer state and the step
every ``--checkpoint-every`` steps; a run with ``--checkpoint-dir``
resumes from the latest complete checkpoint there, every rank taking
rank 0's values.

Trains on synthetic ImageNet-shaped batches (the reference's benchmark
mode). Each step's batch is drawn from the step number, so a resumed run
sees the batches the uninterrupted run would have: its parameters end
equal.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import ResNet50
from horovod_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                restore_checkpoint,
                                                save_checkpoint)

IMAGE_SIZE = 224
NUM_CLASSES = 1000


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-per-chip", type=int, default=64)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--base-lr", type=float, default=0.0125,
                        help="lr per 32-image batch; scaled linearly")
    parser.add_argument("--warmup-steps", type=int, default=20)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--checkpoint-every", type=int, default=50)
    parser.add_argument("--image-size", type=int, default=IMAGE_SIZE)
    return parser.parse_args(argv)


def learning_rate(step: int, peak: float, warmup: int, steps: int) -> float:
    """optax.join_schedules([linear_schedule(peak/10, peak, warmup),
    cosine_decay_schedule(peak, max(1, steps))], [warmup]) at ``step``."""
    if step < warmup:
        return peak / 10 + (peak - peak / 10) * step / warmup
    decay = max(1, steps)
    t = min(step - warmup, decay)
    return peak * 0.5 * (1 + math.cos(math.pi * t / decay))


def synthetic_batch(step: int, batch: int, image_size: int, device):
    """This rank's slice of step ``step``'s global batch: uniform images
    and random labels from a generator seeded with the step."""
    gen = torch.Generator(device=device).manual_seed(step)
    n = batch * hvd.size()
    x = torch.rand(n, image_size, image_size, 3, generator=gen,
                   device=device)
    y = torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device)
    lo, hi = hvd.rank() * batch, (hvd.rank() + 1) * batch
    return x[lo:hi], y[lo:hi]


def train_state(model, optimizer, step: int) -> Dict:
    """What a checkpoint holds: the parameters, the BatchNorm
    statistics, the optimizer state and the step."""
    return {"params": {k: v for k, v in model.named_parameters()},
            "batch_stats": {k: v for k, v in model.named_buffers()},
            "opt_state": optimizer.state_dict(), "step": step}


def load_train_state(model, optimizer, state: Dict) -> int:
    """Copy a restored :func:`train_state` into ``model`` and
    ``optimizer`` (onto their devices); returns its step."""
    with torch.no_grad():
        for k, v in model.named_parameters():
            v.copy_(state["params"][k])
        for k, v in model.named_buffers():
            v.copy_(state["batch_stats"][k])
    optimizer.load_state_dict(state["opt_state"])
    return int(state["step"])


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init()
    device = hvd.device()
    batch = args.batch_per_chip * hvd.size()
    peak_lr = args.base_lr * batch / 32

    model = ResNet50(num_classes=NUM_CLASSES, dtype=torch.bfloat16,
                     device=device, seed=0)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=peak_lr, momentum=0.9),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    start_step = 0
    if args.checkpoint_dir:
        path = latest_checkpoint(args.checkpoint_dir)
        if path:
            start_step = load_train_state(model, optimizer,
                                          restore_checkpoint(path))
            if hvd.rank() == 0:
                print(f"resumed from {path} at step {start_step}",
                      flush=True)

    losses = []
    t0 = time.perf_counter()
    window_start = start_step
    for step in range(start_step, args.steps):
        for group in optimizer.param_groups:
            group["lr"] = learning_rate(step, peak_lr, args.warmup_steps,
                                        args.steps)
        x, y = synthetic_batch(step, args.batch_per_chip, args.image_size,
                               device)
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x, train=True), y)
        loss.backward()
        optimizer.step()
        losses.append(hvd.allreduce(loss.detach()))
        if (step + 1) % 10 == 0 and hvd.rank() == 0:
            dt = time.perf_counter() - t0
            print(f"step {step + 1}: loss={float(losses[-1]):.4f} "
                  f"{(step + 1 - window_start) * batch / dt:.0f} img/sec",
                  flush=True)
            t0 = time.perf_counter()
            window_start = step + 1
        if args.checkpoint_dir and (step + 1) % args.checkpoint_every == 0:
            save_checkpoint(
                os.path.join(args.checkpoint_dir, f"ckpt_{step + 1}"),
                train_state(model, optimizer, step + 1))
    return {"losses": [float(v) for v in losses], "model": model,
            "optimizer": optimizer, "start_step": start_step}


if __name__ == "__main__":
    main()
