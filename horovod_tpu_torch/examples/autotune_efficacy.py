"""Autotune efficacy A/B/C: tuned against fixed knobs on a gradient-shaped
eager workload — the port's counterpart of
``examples/autotune_efficacy.py``. Host only: the tensors are CPU
tensors and the controller carries them.

The same multi-tensor workload (a mix of gradient-like sizes enqueued
together, the shape ``DistributedOptimizer`` produces each step) runs
under the port's ``horovodrun`` three times:

  A) the default fixed knobs,
  B) deliberately bad fixed knobs (a 4 KiB fusion threshold, a 25 ms
     cycle),
  C) ``HOROVOD_AUTOTUNE=1`` starting from B's knobs,

and rank 0 prints steps/s per window, so B against C shows the tuner
recovering mid-run and A against C what tuning is worth over the
defaults. Ranks share the host's cores: quote the relative numbers.

    python -m horovod_tpu_torch.examples.autotune_efficacy \\
        --runs A,B,C --np 2 --steps 120 --window 20

Each rank runs the workload with ``--worker`` (the launcher's command);
the driver prints one JSON line per run and the summary last.
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

# Gradient-shaped mix a step: a few big tensors, a tail of small ones
# (ResNet-like: conv kernels, then biases and norms).
TENSOR_SIZES = ([1 << 20] * 2 + [1 << 18] * 6 + [1 << 16] * 10
                + [1 << 12] * 22)  # floats; ~4.3 MiB a step

BAD_KNOBS = {"HOROVOD_FUSION_THRESHOLD": "4096", "HOROVOD_CYCLE_TIME": "25"}
RUNS = {"A": {}, "B": dict(BAD_KNOBS),
        "C": dict(BAD_KNOBS, HOROVOD_AUTOTUNE="1")}


def worker(args) -> None:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    rng = np.random.RandomState(rank)
    tensors = [torch.from_numpy(rng.rand(n).astype(np.float32))
               for n in TENSOR_SIZES]
    step_bytes = sum(4 * n for n in TENSOR_SIZES)

    # Warm-up (also primes the response cache).
    for i, t in enumerate(tensors):
        hvd.allreduce(t, average=False, name=f"warm.{i}")

    windows = []
    t0 = time.perf_counter()
    for it in range(args.steps):
        handles = [hvd.allreduce_async(t, average=True, name=f"g.{i}")
                   for i, t in enumerate(tensors)]
        for h in handles:
            hvd.synchronize(h)
        if (it + 1) % args.window == 0:
            dt = time.perf_counter() - t0
            windows.append(args.window / dt)
            if rank == 0:
                print(f"window {len(windows)}: {windows[-1]:.2f} steps/s "
                      f"({args.window * step_bytes / dt / 1e6:.0f} MB/s)",
                      flush=True)
            t0 = time.perf_counter()
    if rank == 0:
        print("AUTOTUNE " + json.dumps({
            "autotune": bool(os.environ.get("HOROVOD_AUTOTUNE")),
            "fusion_threshold": os.environ.get("HOROVOD_FUSION_THRESHOLD"),
            "cycle_time": os.environ.get("HOROVOD_CYCLE_TIME"),
            "size": size, "step_bytes": step_bytes,
            "windows_steps_per_s": windows}), flush=True)
    hvd.shutdown()


def run_job(label: str, args) -> dict:
    env = {k: v for k, v in sorted(os.environ.items())
           if k not in ("HOROVOD_AUTOTUNE", "HOROVOD_FUSION_THRESHOLD",
                        "HOROVOD_CYCLE_TIME")}
    env.update(RUNS[label])
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np",
           str(args.np), sys.executable, "-m",
           "horovod_tpu_torch.examples.autotune_efficacy", "--worker",
           "--steps", str(args.steps), "--window", str(args.window)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600, cwd=REPO)
    for line in proc.stdout.splitlines():
        _, _, rest = line.partition("AUTOTUNE ")
        if rest:
            return {"run": label, **json.loads(rest)}
    raise RuntimeError(f"run {label} failed (exit {proc.returncode}):\n"
                       f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default="A,B,C")
    ap.add_argument("--np", type=int, default=2)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--window", type=int, default=20,
                    help="steps a reported throughput window")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return {}
    records = {}
    for label in args.runs.split(","):
        records[label] = run_job(label, args)
        print(json.dumps(records[label]), flush=True)
    summary = {"metric": "autotune_efficacy", "np": args.np,
               "steps": args.steps, "window": args.window,
               "last_window_steps_per_s": {
                   k: r["windows_steps_per_s"][-1]
                   for k, r in sorted(records.items())
                   if r["windows_steps_per_s"]}}
    if "A" in summary["last_window_steps_per_s"] and \
            "C" in summary["last_window_steps_per_s"]:
        last = summary["last_window_steps_per_s"]
        summary["tuned_over_default"] = last["C"] / last["A"]
    print(json.dumps(summary), flush=True)
    return {"runs": records, **summary}


if __name__ == "__main__":
    main()
