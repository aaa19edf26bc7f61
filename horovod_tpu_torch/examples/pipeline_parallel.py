"""Pipeline-parallel training over a ``data x pipe`` mesh (GPipe or 1F1B)
— the port's counterpart of ``examples/jax_pipeline_parallel.py``.

A deep stack of residual MLP blocks is split into stages, one per rank
of the ``pipe`` group (``horovod_tpu_torch.parallel.pipeline``);
microbatches stream through the stages with neighbour exchanges.
``--schedule gpipe`` (default) takes gradients with ``backward()``
through ``pipeline_apply`` (its backward is the mirrored schedule, each
stage recomputed); ``--schedule 1f1b`` runs the fused forward/backward
schedule, whose activation stash is O(stages) whatever the microbatch
count. Gradients are averaged over ``data`` by ``DistributedOptimizer``.

    python -m horovod_tpu_torch.examples.pipeline_parallel --steps 50 \\
        --microbatches 16
    ... --schedule 1f1b

The pipe axis takes 4 ranks when the job's size divides by 4, else 2,
else 1; ``--device cpu`` runs on gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_loss,
    stack_stage_params,
)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--microbatches", type=int, default=16)
    parser.add_argument("--microbatch-size", type=int, default=32)
    parser.add_argument("--features", type=int, default=256)
    parser.add_argument("--layers-per-stage", type=int, default=2)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--schedule", choices=["gpipe", "1f1b"],
                        default="gpipe")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the card)")
    return parser.parse_args(argv)


def stage_fn(p, x):
    """``layers-per-stage`` residual blocks ``h + gelu(h @ w + b)`` (the
    JAX example's, with flax's tanh-approximated gelu)."""
    for w, b in zip(p["w"], p["b"]):
        x = x + F.gelu(x @ w + b, approximate="tanh")
    return x


def make_stages(rng, n_stages: int, layers: int, f: int):
    """Every stage's parameters, drawn as the JAX example draws them."""
    return [{"w": torch.from_numpy((rng.randn(layers, f, f) / np.sqrt(f))
                                   .astype(np.float32)),
             "b": torch.zeros(layers, f)} for _ in range(n_stages)]


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init(device=args.device)
    device = hvd.device()
    n = hvd.size()
    pp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    dp = n // pp
    mesh = make_mesh({"data": dp, "pipe": pp})
    pipe, data = mesh.group("pipe"), mesh.group("data")
    stage, di = mesh.axis_index("pipe"), mesh.axis_index("data")
    if hvd.rank() == 0:
        bubble = (pp - 1) / (args.microbatches + pp - 1)
        print(f"mesh: data={dp} x pipe={pp}; {args.microbatches} "
              f"microbatches -> {bubble:.0%} bubble", flush=True)

    rng = np.random.RandomState(0)
    f = args.features
    stacked = stack_stage_params(make_stages(rng, pp, args.layers_per_stage,
                                             f))
    params = {k: torch.nn.Parameter(v[stage].to(device))
              # hvdlint: disable=HVD002 (one insertion order on every rank)
              for k, v in stacked.items()}
    mb_total = args.microbatch_size * dp
    data_all = rng.randn(args.microbatches, mb_total, f).astype(np.float32)
    w_true = (rng.randn(f, f) / np.sqrt(f)).astype(np.float32)
    target_all = np.tanh(data_all @ w_true)
    rows = slice(di * args.microbatch_size, (di + 1) * args.microbatch_size)
    x = torch.from_numpy(data_all[:, rows]).to(device)
    y = torch.from_numpy(target_all[:, rows]).to(device)

    # Both walks see one insertion order on every rank (the dict is built
    # by the same code everywhere).
    optimizer = hvd.DistributedOptimizer(
        # hvdlint: disable=HVD002
        torch.optim.Adam(params.values(), lr=args.lr),
        named_parameters=params.items(), group=data)  # hvdlint: disable=HVD002

    def step():
        optimizer.zero_grad(set_to_none=True)
        if args.schedule == "gpipe":
            outs = pipeline_apply(stage_fn, params, x, group=pipe)
            per_mb = ((outs - y) ** 2).mean(dim=(1, 2))
            loss = pipeline_loss(per_mb, pipe)
            loss.backward()
        else:
            loss, grads = pipeline_apply(
                stage_fn, params, x, group=pipe, schedule="1f1b",
                loss_fn=lambda o, t: ((o - t) ** 2).mean(), targets=y)
            for k, p in params.items():  # hvdlint: disable=HVD002
                p.grad = grads[k]
            # 1F1B fills .grad itself: the optimizer's hooks did not
            # fire, so the data-group average runs here.
            if dp > 1:
                # hvdlint: disable=HVD002 (one insertion order on every rank)
                for p in params.values():
                    hvd.allreduce_(p.grad, group=data)
        optimizer.step()
        return loss.detach()

    losses, t0 = [], None
    for i in range(args.steps):
        losses.append(float(hvd.allreduce(step(), group=data)))
        if i == 0:
            t0 = time.perf_counter()
        if i % 10 == 0 and hvd.rank() == 0:
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    elapsed = time.perf_counter() - t0
    samples = args.microbatches * mb_total * (args.steps - 1)
    rate = samples / elapsed if args.steps > 1 else None
    if hvd.rank() == 0:
        print(f"final loss {losses[-1]:.4f}; "
              f"{rate or 0:,.0f} samples/sec through {pp} stages",
              flush=True)
    return {"losses": losses, "samples_per_s": rate, "pipe": pp, "data": dp}


if __name__ == "__main__":
    main()
