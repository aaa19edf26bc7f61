"""Vision Transformer training on the port, synthetic ImageNet shapes —
the counterpart of ``examples/jax_vit_training.py`` (the JAX bench row
``vit_s16_224_b64_adamw_spc8``):

    python -m horovod_tpu_torch.examples.vit_training --model s16 \\
        --batch-per-chip 64 --attention flash

One process per card; under a launcher environment every rank trains on
its own batch and ``DistributedOptimizer`` averages the gradients over
NCCL. AdamW (optax's defaults) with the JAX example's linear warmup from
``base_lr / 10`` to ``base_lr * size`` over ``--warmup-steps`` calls;
dropout off. ``--attention xla`` is the plain softmax path (the JAX
example's name for it), ``flash`` the flash kernels, non-causal (the
kernels take S=197 as it is: they mask their ragged last tiles, which is
what the JAX package's padding to its tiles gives). ``--steps-per-call``
runs that many optimizer steps per timed call, each on its own batch (a
Python loop where the JAX example scans on the device). Reports img/s.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.vit import (VIT_B16, VIT_S16, VIT_TINY,
                                          VisionTransformer,
                                          classification_loss)
from horovod_tpu_torch.ops.attention import make_attention_fn

CONFIGS = {"b16": VIT_B16, "s16": VIT_S16, "tiny": VIT_TINY}


def _positive(v):
    v = int(v)
    if v < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return v


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=sorted(CONFIGS), default="s16")
    parser.add_argument("--batch-per-chip", type=int, default=64)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--warmup-steps", type=int, default=5,
                        help="calls excluded from throughput timing")
    parser.add_argument("--base-lr", type=float, default=1e-3)
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--attention", choices=["xla", "flash"],
                        default="xla",
                        help="attention core: the plain softmax path "
                             "(default) or the flash kernels")
    parser.add_argument("--steps-per-call", type=_positive, default=1,
                        help="optimizer steps per timed call")
    return parser.parse_args(argv)


def make_optimizer(model, args, n: int):
    """AdamW under optax.linear_schedule(base_lr / 10, base_lr * n,
    warmup_steps * steps_per_call), counted in optimizer steps."""
    end = args.base_lr * n
    start = args.base_lr / 10
    ramp = args.warmup_steps * args.steps_per_call
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=end, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=model.named_parameters())

    def factor(step: int) -> float:
        frac = min(step, ramp) / ramp if ramp else 1.0
        return (start + (end - start) * frac) / end

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init()
    device = hvd.device()
    n = hvd.size()
    cfg = CONFIGS[args.model]
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    attention_fn = None
    if args.attention == "flash":
        attention_fn = make_attention_fn(causal=False, use_flash=True)
    model = VisionTransformer(cfg, attention_fn=attention_fn, device=device,
                              seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    optimizer, schedule = make_optimizer(model, args, n)

    spc = args.steps_per_call
    rng = np.random.RandomState(hvd.rank())
    lead = (spc, args.batch_per_chip)
    x = torch.from_numpy(rng.rand(*lead, cfg.image_size, cfg.image_size,
                                  3).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randint(0, cfg.num_classes,
                                     size=lead)).to(device)

    def call() -> torch.Tensor:
        for i in range(spc):
            optimizer.zero_grad(set_to_none=True)
            loss = classification_loss(model(x[i], deterministic=True), y[i])
            loss.backward()
            optimizer.step()
            schedule.step()
        return loss.detach()

    losses = [call() for _ in range(args.warmup_steps)]
    if losses:
        float(losses[-1])
    timed = max(1, args.steps - args.warmup_steps)
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(call())
    loss = float(hvd.allreduce(losses[-1]))
    dt = time.perf_counter() - t0
    img_sec = timed * spc * args.batch_per_chip * n / dt
    if hvd.rank() == 0:
        print(f"vit-{args.model} {cfg.image_size}px: {img_sec:.0f} img/sec "
              f"({img_sec / n:.0f}/chip), loss={loss:.3f}", flush=True)
    return {"images_per_s": img_sec, "call_ms": dt / timed * 1e3,
            "step_ms": dt / (timed * spc) * 1e3,
            "losses": [float(v) for v in losses], "loss": loss,
            "model": model, "call": call}


if __name__ == "__main__":
    main()
