"""Data-parallel scaling-efficiency projection from inputs taken on this
card — the port's counterpart of ``examples/scaling_projection.py``.

One card cannot measure a 256-card job, but every input of the
efficiency function can be pinned on its own, and
``utils/scaling_model.py``'s pipelined-reduction event model (the JAX
package's) turns them into a curve:

1. the single-card step time: measured here (``--measure``: the model's
   train step on the card, median of timed steps) or passed in
   (``--step-ms``);
2. the gradient groups, their bytes and their order of readiness: from
   one profiled step of ``DistributedOptimizer`` on two ranks
   (``horovodrun --spmd``: the gradients' allreduces run on the process
   group, gloo on the CPU, each inside its ``hvd.allreduce`` label), read
   by ``utils/overlap.overlap_report`` and
   ``scaling_model.groups_from_overlap_report``. The bytes are the
   model's; the readiness fractions are those of the profiled (CPU)
   step. ``--trace PATH`` reads a trace already taken. No group parsed
   is a loud error: an empty list would project perfect scaling;
3. the link bandwidths: explicit optimistic and conservative figures
   (:data:`LINKS`), each with its source. They are the one assumed
   input, given as a band.

    python -m horovod_tpu_torch.examples.scaling_projection \\
        --model resnet50 --measure [--out PATH]

The last line is the summary JSON; ``--out`` writes the record.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from horovod_tpu_torch.utils import scaling_model as sm
from horovod_tpu_torch.utils.hlo_phases import newest_trace
from horovod_tpu_torch.utils.overlap import overlap_report

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Per-GPU one-way link bandwidth, bytes/s. The conservative band takes
# half: a ring reaches a share of the wire, not all of it (an assumption
# carried as a parameter, not a measurement).
LINKS = {
    "nvlink4": {
        "bytes_per_s": 450e9, "conservative_fraction": 0.5,
        "source": ("NVIDIA H100 SXM5 datasheet: NVLink 900 GB/s per GPU, "
                   "both directions together; 450 GB/s each way")},
    "infiniband_ndr": {
        "bytes_per_s": 50e9, "conservative_fraction": 0.5,
        "source": ("NVIDIA ConnectX-7 NDR InfiniBand: 400 Gb/s a port, "
                   "50 GB/s each way; one port per GPU (DGX H100)")},
}
GPUS_PER_NODE = 8
SIZES = [8, 16, 32, 64, 128, 256]
#: Per-card batch of the measured step time.
BATCH = {"mlp": 64, "resnet50": 128}
#: The profiled two-rank step's batch and image size (its gradients'
#: bytes are the model's at any batch).
GROUPS_BATCH, GROUPS_IMAGE_SIZE = 2, 32


def project(step_time_s: float, report: dict, grad_bytes: int) -> dict:
    """The JAX ``project()``'s arithmetic over measured inputs: one
    efficiency curve per link (optimistic, conservative, conservative
    without overlap) and the two-tier layout (NVLink inside a node of
    :data:`GPUS_PER_NODE`, InfiniBand across nodes)."""
    groups = sm.groups_from_overlap_report(report)
    if not groups:
        # An empty group list would project PERFECT scaling with zero
        # gradient traffic: a change in the trace's form must fail here.
        raise RuntimeError(
            "no gradient allreduce groups parsed from the profiled step; "
            "the overlap reader needs updating for this trace")
    trace_bytes = sum(g.payload_bytes for g in groups)
    curves = {}
    for name, link in sorted(LINKS.items()):
        bw = link["bytes_per_s"]
        lo = bw * link["conservative_fraction"]
        curves[name] = {
            "bw_optimistic_GBps": bw / 1e9,
            "bw_conservative_GBps": lo / 1e9,
            "source": link["source"],
            "efficiency_optimistic": sm.efficiency_curve(
                step_time_s, groups, SIZES, bw),
            "efficiency_conservative": sm.efficiency_curve(
                step_time_s, groups, SIZES, lo),
            "efficiency_no_overlap_conservative": sm.efficiency_curve(
                step_time_s, groups, SIZES, lo, overlap=False),
        }
    intra, inter = LINKS["nvlink4"], LINKS["infiniband_ndr"]
    multi_node = {
        "layout": (f"{GPUS_PER_NODE} GPUs a node on NVLink, nodes on "
                   "InfiniBand, hierarchical allreduce"),
        "conservative": {
            n: sm.multislice_efficiency(
                step_time_s, groups, n_slices=n // GPUS_PER_NODE,
                ici_size=GPUS_PER_NODE,
                ici_bw=intra["bytes_per_s"] * intra["conservative_fraction"],
                dcn_bw_per_chip=(inter["bytes_per_s"]
                                 * inter["conservative_fraction"]))
            for n in SIZES if n >= 2 * GPUS_PER_NODE},
    }
    return {
        "measured_input": {"step_time_s": step_time_s},
        "trace_input": {
            "gradient_groups": [dataclasses.asdict(g) for g in groups],
            "allreduce_payload_bytes": trace_bytes,
            "param_bytes_crosscheck": grad_bytes,
        },
        "projection": curves,
        "multi_node": multi_node,
        "overlap_evidence": {
            "async_pairs": report["async_pairs"],
            "n_compute_ops": report["n_compute_ops"],
        },
    }


def _build(model_name: str, device, image_size: int):
    import torch

    if model_name == "mlp":
        from horovod_tpu_torch.models import MnistMLP

        model = MnistMLP(features=(1024, 1024), device=device, seed=0)
        shape = (28, 28)
        classes = 10

        def loss_fn(x, y):
            return torch.nn.functional.cross_entropy(model(x), y)
    else:
        from horovod_tpu_torch.models import ResNet50

        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         device=device, seed=0)
        shape = (image_size, image_size, 3)
        classes = 1000

        def loss_fn(x, y):
            return torch.nn.functional.cross_entropy(model(x, train=True),
                                                     y)
    return model, shape, classes, loss_fn


def _batch(shape, classes, batch, device, seed=0):
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((batch,) + shape, generator=gen).to(device)
    y = torch.randint(0, classes, (batch,), generator=gen).to(device)
    return x, y


def measure_step_s(model_name: str, batch: int, device, image_size: int,
                   steps: int = 10, warmup: int = 3) -> float:
    """Median seconds of one train step (SGD with momentum) on one
    device."""
    import torch

    from horovod_tpu_torch.utils.timing import wall_s

    model, shape, classes, loss_fn = _build(model_name, device, image_size)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    x, y = _batch(shape, classes, batch, device)

    def step():
        opt.zero_grad(set_to_none=True)
        loss_fn(x, y).backward()
        opt.step()

    for _ in range(warmup):
        step()
    return statistics.median(wall_s(step, device) for _ in range(steps))


def groups_worker(args) -> None:
    """One rank of the profiled two-rank step (``horovodrun --spmd``)."""
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    model, shape, classes, loss_fn = _build(args.model, hvd.device(),
                                            GROUPS_IMAGE_SIZE)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=model.named_parameters())
    x, y = _batch(shape, classes, GROUPS_BATCH, hvd.device(),
                  seed=hvd.rank())

    def step():
        opt.zero_grad(set_to_none=True)
        loss_fn(x, y).backward()
        opt.step()

    step()
    trace_dir = args.trace_dir if hvd.rank() == 0 else None
    with hvd.profiler.trace(trace_dir):
        step()
    hvd.shutdown()


def profiled_groups_trace(args, trace_dir: str) -> str:
    """Run the two-rank profiled step; rank 0's trace path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "--spmd", "-np",
           "2", sys.executable, "-m",
           "horovod_tpu_torch.examples.scaling_projection",
           "--groups-worker", "--model", args.model, "--trace-dir",
           trace_dir]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"the profiled step failed (exit "
                           f"{proc.returncode}):\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return newest_trace(trace_dir)


def param_bytes(model_name: str, image_size: int) -> int:
    model, _, _, _ = _build(model_name, "cpu", image_size)
    return sum(p.numel() * p.element_size() for p in model.parameters())


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(BATCH), default="resnet50")
    ap.add_argument("--measure", action="store_true",
                    help="measure the single-card step time here")
    ap.add_argument("--step-ms", type=float, default=None,
                    help="the single-card step time, ms (instead of "
                    "--measure)")
    ap.add_argument("--trace", default=None,
                    help="a profiled two-rank step's trace (instead of "
                    "taking one)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--groups-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--trace-dir", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    if args.groups_worker:
        groups_worker(args)
        return {}
    from horovod_tpu_torch.utils.timing import device_label, probe_device

    batch = BATCH[args.model]
    if args.step_ms is not None:
        step_s, label = args.step_ms / 1e3, "--step-ms"
    elif args.measure:
        device = probe_device(args.device)
        label = device_label(device)
        t0 = time.perf_counter()
        step_s = measure_step_s(args.model, batch, device, 224)
        print(f"step time {step_s * 1e3:.3f} ms [{label}] "
              f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)
    else:
        raise SystemExit("pass --measure or --step-ms")
    trace = args.trace or profiled_groups_trace(
        args, tempfile.mkdtemp(prefix="projection-trace-"))
    report = overlap_report(trace)
    out = {
        "what": ("weak-scaling projection of data parallelism from "
                 "measured inputs: the step time, the gradient groups of "
                 "a profiled DistributedOptimizer step, link bandwidths "
                 "as a band"),
        "model": args.model, "batch": batch, "step_time_from": label,
        "event_model": "utils/scaling_model.py pipelined-reduction model",
        **project(step_s, report, param_bytes(args.model,
                                              GROUPS_IMAGE_SIZE)),
    }
    for name, curve in sorted(out["projection"].items()):
        print(json.dumps({"metric": "projected_efficiency", "link": name,
                          "conservative": curve["efficiency_conservative"],
                          "optimistic": curve["efficiency_optimistic"]}),
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    last = max(SIZES)
    summary = {
        "metric": "scaling_projection", "model": args.model,
        "step_time_s": step_s, "device": label,
        "groups": len(out["trace_input"]["gradient_groups"]),
        f"nvlink4_eff{last}_conservative": out["projection"]["nvlink4"][
            "efficiency_conservative"][last],
        f"infiniband_eff{last}_conservative": out["projection"][
            "infiniband_ndr"]["efficiency_conservative"][last],
        "out": args.out}
    print(json.dumps(summary), flush=True)
    return out


if __name__ == "__main__":
    main()
