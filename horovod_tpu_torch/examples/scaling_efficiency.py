"""Scaling-efficiency harness: throughput at world sizes 1, 2, 4, ... on
one host — the port's counterpart of ``examples/scaling_efficiency.py``.

Trains the model data-parallel at each world size under the port's
launcher (``python -m horovod_tpu_torch.run -np N``: the controller and
its default data plane carry ``DistributedOptimizer``'s gradients), with
a fixed per-rank batch, and reports ``rate(N) / (N * rate(1))``.

The default is the MLP on gloo ranks on the CPU (``--device cpu``):
ranks share the host's cores, so the numbers show the eager tier's
overhead, not a cluster's scaling. ``--model resnet50`` runs ResNet-50
(bf16) with every rank on the one card (``cuda:0``, a gloo group built
before ``hvd.init``): the card is shared, so N ranks split one card's
throughput.

    python -m horovod_tpu_torch.examples.scaling_efficiency \\
        --model mlp --sizes 1,2 --steps 20 --device cpu

One JSON line per world size, the summary last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=["mlp", "resnet50"], default="mlp")
    p.add_argument("--batch-per-rank", type=int, default=64)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--sizes", default="1,2,4",
                   help="world sizes to run, comma separated")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def worker(args) -> None:
    """One rank: train ``--steps`` steps after ``--warmup``; rank 0
    prints the rate."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd

    if args.model == "resnet50":
        size = int(os.environ.get("HOROVOD_SIZE", "1"))
        if size > 1:
            import datetime

            import torch.distributed as dist

            from horovod_tpu_torch.common import config

            # Ranks sharing one card: a gloo group over the launcher's
            # store (NCCL takes one rank a device), adopted by init.
            torch.cuda.set_device(0)
            dist.init_process_group(
                "gloo", init_method=f"tcp://{config.spmd_coordinator()}",
                rank=int(os.environ["HOROVOD_RANK"]), world_size=size,
                timeout=datetime.timedelta(seconds=600))
        hvd.init(device="cuda:0")
    else:
        hvd.init(device="cpu")
    device = hvd.device()
    rng = np.random.RandomState(hvd.rank())
    b = args.batch_per_rank
    if args.model == "mlp":
        from horovod_tpu_torch.models import MnistMLP

        model = MnistMLP(features=(1024, 1024), device=device, seed=0)
        x = torch.from_numpy(rng.rand(b, 28, 28).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 10, b))

        def loss_fn():
            return F.cross_entropy(model(xd), yd)
    else:
        from horovod_tpu_torch.models import ResNet50

        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         device=device, seed=0)
        x = torch.from_numpy(rng.rand(b, 224, 224, 3).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 1000, b))

        def loss_fn():
            return F.cross_entropy(model(xd, train=True), yd)
    xd, yd = x.to(device), y.to(device)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        optimizer.step()
        return loss

    for _ in range(args.warmup):
        step()
    float(step())
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step()
        # The host fetch is the barrier, as the JAX harness's device_get.
        float(loss)
    dt = time.perf_counter() - t0
    if hvd.rank() == 0:
        print("SCALING " + json.dumps({
            "size": hvd.size(), "img_sec": b * hvd.size() * args.steps / dt,
            "step_ms": dt / args.steps * 1e3}), flush=True)
    hvd.shutdown()


def measure(args, n: int) -> dict:
    """Rank 0's record of one job of ``n`` ranks."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(n),
           sys.executable, "-m", "horovod_tpu_torch.examples."
           "scaling_efficiency", "--worker", "--model", args.model,
           "--batch-per-rank", str(args.batch_per_rank), "--steps",
           str(args.steps), "--warmup", str(args.warmup)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600, cwd=REPO)
    for line in proc.stdout.splitlines():
        _, _, rest = line.partition("SCALING ")
        if rest:
            return json.loads(rest)
    raise RuntimeError(f"world size {n} failed (exit {proc.returncode}):\n"
                       f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    if args.worker:
        worker(args)
        return {}
    from horovod_tpu_torch.utils.timing import device_label, probe_device

    label = device_label(probe_device("cpu" if args.model == "mlp"
                                      else "cuda"))
    sizes = [int(s) for s in args.sizes.split(",")]
    rates = {}
    for n in sizes:
        rec = measure(args, n)
        rates[n] = rec["img_sec"]
        print(json.dumps({"metric": "scaling_rate", "size": n,
                          "img_sec": rec["img_sec"],
                          "per_rank": rec["img_sec"] / n,
                          "step_ms": rec["step_ms"], "device": label}),
              flush=True)
    base = rates[sizes[0]] / sizes[0]
    efficiency = {n: rates[n] / (n * base) for n in sizes}
    summary = {"metric": "scaling_efficiency", "model": args.model,
               "sizes": sizes, "device": label,
               "img_sec": {str(k): v for k, v in sorted(rates.items())},
               "efficiency": {str(k): v
                              for k, v in sorted(efficiency.items())}}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
