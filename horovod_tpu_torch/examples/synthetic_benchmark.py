"""Synthetic CNN training benchmark on the port — the counterpart of
``examples/jax_synthetic_benchmark.py`` (random data, img/s):

    python -m horovod_tpu_torch.examples.synthetic_benchmark \\
        --model resnet50 --batch-size 128

One process per card; under a launcher environment every rank trains on
its slice of the global batch and ``DistributedOptimizer`` averages the
gradients over NCCL. BatchNorm statistics stay per rank, as in the JAX
example (its BatchNorm has no ``axis_name``). Models at their native
input size (``--image-size`` overrides): ResNet-50/101 and VGG-16 at
224², Inception V3 at 299². Activations bf16 (``--fp32``: float32),
parameters float32, ``SGD(0.1, momentum=0.9)``; the convolutions run in
``channels_last`` with cuDNN's autotuner on. Timing: one warm-up step,
then ``--num-batches`` windows of ``--num-iters`` steps, each ending in a
sync; img/s per window, their median and spread (1.96 standard
deviations, as the JAX example reports).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import VGG16, InceptionV3, ResNet50, ResNet101
from horovod_tpu_torch.models.layers import Conv, Dense

# name -> (constructor, native input size)
MODELS = {
    "resnet50": (ResNet50, 224),
    "resnet101": (ResNet101, 224),
    "inception3": (InceptionV3, 299),
    "vgg16": (VGG16, 224),
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=list(MODELS), default="resnet50")
    parser.add_argument("--batch-size", type=int, default=128,
                        help="per-card batch size")
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--num-batches", type=int, default=5)
    parser.add_argument("--image-size", type=int, default=0,
                        help="override the model's native input size")
    parser.add_argument("--fp32", action="store_true",
                        help="float32 activations instead of bf16")
    return parser.parse_args(argv)


def make_model(name: str, image_size: int, dtype: torch.dtype, device):
    """``name``'s model for 1000 classes at ``image_size`` squared."""
    cls, _ = MODELS[name]
    kw = {} if name.startswith("resnet") else {"image_size": image_size}
    return cls(num_classes=1000, dtype=dtype, device=device, seed=0, **kw)


def make_optimizer(model) -> torch.optim.Optimizer:
    """``optax.sgd(0.1, momentum=0.9)`` (dampening 0, no Nesterov) in
    ``DistributedOptimizer``."""
    return hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())


def batch(image_size: int, batch_size: int, device):
    """This rank's slice of the global batch, drawn as the JAX example
    draws it: images from ``RandomState(0)``, labels from
    ``RandomState(1)``."""
    n = batch_size * hvd.size()
    lo, hi = hvd.rank() * batch_size, (hvd.rank() + 1) * batch_size
    x = np.random.RandomState(0).rand(n, image_size, image_size, 3)
    y = np.random.RandomState(1).randint(0, 1000, n)
    return (torch.from_numpy(x[lo:hi].astype(np.float32)).to(device),
            torch.from_numpy(y[lo:hi]).to(device))


def train_step(model, optimizer, x, y) -> torch.Tensor:
    """One step: softmax cross entropy on the float32 logits, backward,
    SGD. Returns the loss, detached, without a sync."""
    optimizer.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(x, train=True), y)
    loss.backward()
    optimizer.step()
    return loss.detach()


def forward_macs(model, image_size: int) -> int:
    """Multiply-accumulates of one image's forward pass through the
    model's convolutions and dense layers, counted from the shapes they
    see (one eval-mode forward of a single image)."""
    total = 0

    def count(module, _, out):
        nonlocal total
        w = module.weight
        if isinstance(module, Conv):
            total += out[0].numel() * w[0].numel()
        else:
            total += out[0].numel() * w.shape[1]

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    try:
        with torch.no_grad():
            model(torch.zeros(1, image_size, image_size, 3,
                              device=next(model.parameters()).device),
                  train=False)
    finally:
        for h in hooks:
            h.remove()
    return total


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init()
    device = hvd.device()
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    size = args.image_size or MODELS[args.model][1]
    model = make_model(args.model, size, dtype, device)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    optimizer = make_optimizer(model)
    x, y = batch(size, args.batch_size, device)
    n = hvd.size()
    if hvd.rank() == 0:
        print(f"Model: {args.model}, batch/card: {args.batch_size}, "
              f"cards: {n}, dtype: {str(dtype).replace('torch.', '')}, "
              f"image {size}x{size}", flush=True)

    losses = [train_step(model, optimizer, x, y)]          # warm-up
    float(losses[0])
    img_secs = []
    for i in range(args.num_batches):
        t0 = time.perf_counter()
        for _ in range(args.num_iters):
            losses.append(train_step(model, optimizer, x, y))
        float(losses[-1])
        img_secs.append(args.batch_size * n * args.num_iters
                        / (time.perf_counter() - t0))
        if hvd.rank() == 0:
            print(f"Iter #{i}: {img_secs[-1]:.1f} img/sec total", flush=True)
    median = float(np.median(img_secs))
    spread = float(1.96 * np.std(img_secs))
    if hvd.rank() == 0:
        print(f"Img/sec per card: {median / n:.1f} +- {spread / n:.1f}")
        print(f"Total img/sec on {n} card(s): {median:.1f} +- {spread:.1f}",
              flush=True)
    return {"img_per_s": median, "img_per_s_windows": img_secs,
            "spread": spread,
            "step_ms": args.batch_size * n / median * 1e3,
            "losses": [float(v) for v in losses], "model": model,
            "optimizer": optimizer, "x": x, "y": y, "image_size": size}


if __name__ == "__main__":
    main()
