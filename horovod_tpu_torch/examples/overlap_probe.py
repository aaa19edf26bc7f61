"""Backward-order bucket-scheduler overlap probe, the port's counterpart
of ``examples/overlap_probe.py``:

    python -m horovod_tpu_torch.examples.overlap_probe --device cuda:0

Runs a 2-rank job under the port's ``horovodrun`` and drives a simulated
backward pass (``--tensors`` gradients of ``--tensor-mib`` each, produced
one by one with ``--compute-ms`` of sleep between them) through two
paths:

* **unbucketed**: wait for every gradient, then allreduce them all;
* **bucketed**: ``hvd.BucketScheduler``, which on the pipelined native
  engine launches each gradient's allreduce as it is produced (batched
  buckets otherwise), with the last backward bucket tagged priority 1.

Rank 0 reports both paths' step times, the measured
``overlap_efficiency`` (the fraction of the backward window with at
least one reduction in flight, the union formula of
``utils.scaling_model``), and whether on every rank the bucketed results
equal the unbucketed ones bit for bit. The parent adds the scaling model's
predicted overlap for the same schedule and the negotiation-vs-wire
split of the post-ready stall, from the control-plane calibration in
``artifacts/simcluster_r13.json`` (a CPU simulation of the coordinator,
not a measurement of this machine). The last stdout line is the JSON
summary.

The gradients are CUDA tensors with ``--device cuda:0`` (both ranks share
the card over a gloo group built before ``hvd.init``, as NCCL refuses two
ranks on one device) and CPU tensors with ``--device cpu``. A/B flags:
``--no-pipeline`` (``HOROVOD_PIPELINE=0``: the serial engine),
``--no-priority``, ``--engine python`` (the Python controller).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CALIBRATION = os.path.join(REPO, "artifacts", "simcluster_r13.json")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tensors", type=int, default=16)
    p.add_argument("--tensor-mib", type=float, default=2.0)
    p.add_argument("--compute-ms", type=float, default=10.0,
                   help="simulated backward compute per produced gradient")
    p.add_argument("--bucket-mib", type=float, default=8.0)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--engine", choices=["native", "python"],
                   default="native")
    p.add_argument("--priority", dest="priority", action="store_true",
                   default=True,
                   help="tag the last backward bucket with launch "
                        "priority 1 (default)")
    p.add_argument("--no-priority", dest="priority", action="store_false")
    p.add_argument("--no-pipeline", action="store_true",
                   help="HOROVOD_PIPELINE=0 in the ranks: the serial "
                        "engine")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _init(device: str):
    """``hvd.init`` on ``device``; on a card, over a gloo group built
    first (both ranks share it)."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import config

    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
        dist.init_process_group(
            "gloo", init_method=f"tcp://{config.spmd_coordinator()}",
            rank=int(os.environ["HOROVOD_RANK"]),
            world_size=int(os.environ["HOROVOD_SIZE"]),
            timeout=datetime.timedelta(seconds=600))
    hvd.init(device=device)
    return hvd


def child_main(args: argparse.Namespace) -> None:
    import numpy as np
    import torch

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.controller.bucket_scheduler import (
        BucketScheduler,
        partition_buckets,
    )

    hvd = _init(args.device)
    ctl = basics.controller()
    device = hvd.device()
    n = int(args.tensor_mib * (1 << 20)) // 4
    grads = [torch.from_numpy(np.random.RandomState(100 + i).randn(n)
                              .astype(np.float32)).to(device)
             for i in range(args.tensors)]
    compute_s = args.compute_ms / 1e3
    bucket_bytes = int(args.bucket_mib * (1 << 20))
    # The last backward bucket, first needed by the optimizer, is known
    # ahead of time from the plan; its members carry priority 1.
    priority_names = []
    if args.priority:
        plan = partition_buckets(
            [(f"grad.{i}", g.numel() * 4) for i, g in enumerate(grads)],
            bucket_bytes)
        priority_names = plan[-1].names if plan else []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def produce():
        # The simulated backward: one gradient a compute slice, in
        # production order.
        for i, g in enumerate(grads):
            time.sleep(compute_s)
            yield f"grad.{i}", g

    def run_unbucketed():
        t0 = time.monotonic()
        ready = list(produce())
        handles = [(name, ctl.allreduce_async(g, average=True, name=name))
                   for name, g in ready]
        results = {name: h.wait() for name, h in handles}
        sync()
        return time.monotonic() - t0, results, None

    def run_bucketed():
        t0 = time.monotonic()
        sched = BucketScheduler(ctl, bucket_bytes=bucket_bytes,
                                priority_names=priority_names)
        sched.backward_started()
        for name, g in produce():
            sched.grad_ready(name, g)
        results, report = sched.finish()
        sync()
        return time.monotonic() - t0, results, report

    # Warm both paths (connections, fusion buffers, staging memory).
    run_unbucketed()
    run_bucketed()
    un_times, bu_times, reports = [], [], []
    identical = True
    for _ in range(args.steps):
        t, un, _ = run_unbucketed()
        un_times.append(t)
        t, bu, rep = run_bucketed()
        bu_times.append(t)
        reports.append(rep)
        identical = identical and sorted(un) == sorted(bu) and all(
            torch.equal(un[k], bu[k]) for k in sorted(un))
    # Every rank's verdict: the count of ranks whose results agreed.
    agreed = int(hvd.allreduce(torch.tensor([int(identical)]),
                               average=False, name="probe.identical"))
    if hvd.rank() == 0:
        def median(xs):
            return sorted(xs)[len(xs) // 2]

        rep = reports[bu_times.index(median(bu_times))]
        print("OVERLAP " + json.dumps({
            "unbucketed_step_ms": round(median(un_times) * 1e3, 3),
            "bucketed_step_ms": round(median(bu_times) * 1e3, 3),
            "pipeline": bool(getattr(ctl, "pipeline_enabled", False)),
            "engine": type(ctl).__name__,
            "device": str(device),
            "bit_identical": agreed == hvd.size(),
            "report": rep,
        }), flush=True)
    hvd.shutdown()


def summarize(payload: dict, args: argparse.Namespace) -> dict:
    """The scaling model's view of rank 0's measured step: the predicted
    overlap of the same schedule (the pipelined event model when the
    launches were eager) and the stall split."""
    from horovod_tpu_torch.utils.scaling_model import (
        BucketEvent,
        control_plane_from_artifact,
        modeled_events_from_measured,
        overlap_efficiency_from_events,
        pipelined_modeled_events,
        stall_split_report,
    )

    report = payload["report"]
    window = report["compute_window_s"]
    if report.get("eager"):
        modeled = pipelined_modeled_events(report["events"], window)
    else:
        modeled = modeled_events_from_measured(
            [BucketEvent(e["launch_s"], e["complete_s"])
             for e in report["events"]], window)
    predicted = overlap_efficiency_from_events(modeled, 0.0, window)
    summary = {
        "tensors": args.tensors, "tensor_mib": args.tensor_mib,
        "bucket_mib": args.bucket_mib,
        "compute_ms_per_tensor": args.compute_ms,
        "device": payload["device"], "engine": payload["engine"],
        "pipeline": payload["pipeline"], "priority": bool(args.priority),
        "bit_identical": payload["bit_identical"],
        "unbucketed_step_ms": payload["unbucketed_step_ms"],
        "bucketed_step_ms": payload["bucketed_step_ms"],
        "speedup_bucketed": round(payload["unbucketed_step_ms"] / max(
            1e-9, payload["bucketed_step_ms"]), 3),
        "overlap_efficiency": report["overlap_efficiency"],
        "buckets": report["buckets"],
        "model_predicted_overlap_efficiency": round(predicted, 4),
        "model_vs_measured_abs_diff": round(
            abs(predicted - report["overlap_efficiency"]), 4),
        "median_step_report": report,
    }
    if os.path.exists(CALIBRATION):
        with open(CALIBRATION) as f:
            cal = control_plane_from_artifact(json.load(f))
        summary["stall_split"] = stall_split_report(report["events"], cal,
                                                    n=2)
    return summary


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    if args.child:
        child_main(args)
        return {}
    env = {k: v for k, v in sorted(os.environ.items())
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env.update(PYTHONPATH=REPO, HOROVOD_CYCLE_TIME="1")
    if args.no_pipeline:
        env["HOROVOD_PIPELINE"] = "0"
    if args.engine == "python":
        env["HOROVOD_ENGINE"] = "python"
    child = [sys.executable, "-m", "horovod_tpu_torch.examples.overlap_probe",
             "--child", "--tensors", str(args.tensors), "--tensor-mib",
             str(args.tensor_mib), "--compute-ms", str(args.compute_ms),
             "--bucket-mib", str(args.bucket_mib), "--steps",
             str(args.steps), "--device", args.device]
    if not args.priority:
        child.append("--no-priority")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", *child],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=args.timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"overlap probe job exited {proc.returncode}")
    payload = None
    for line in proc.stdout.splitlines():
        head, _, rest = line.partition("OVERLAP ")
        if rest and head.strip() in ("", "[0]:"):
            payload = json.loads(rest)
    if payload is None:
        sys.stderr.write(proc.stdout[-4000:])
        raise SystemExit("rank 0 printed no OVERLAP record")
    summary = summarize(payload, args)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
