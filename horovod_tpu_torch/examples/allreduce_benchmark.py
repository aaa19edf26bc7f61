"""Allreduce bus-bandwidth benchmark — the port's counterpart of
``examples/allreduce_benchmark.py``.

Three modes, chosen by the job:
  * size > 1 under ``horovodrun`` (``python -m horovod_tpu_torch.run``):
    the eager tier's fused allreduce through the controller and its
    default data plane (the native engine's ring), on tensors on each
    rank's device;
  * size > 1 with ``--process-group``: ``hvd.allreduce(...,
    group=<the world group>)``, the ``torch.distributed`` group's
    allreduce (NCCL across cards, gloo on the CPU);
  * size 1: the port has no single-process multi-device tier, so this
    times ``hvd.allreduce`` on one tensor and says that it measures the
    call's own cost (a size-1 allreduce moves nothing).

Bus bandwidth uses the standard convention: 2(N-1)/N * bytes / time.

    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.allreduce_benchmark --size-mb 64

One JSON line per measurement from rank 0, the summary last.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.utils.timing import device_label, probe_device, sync


def _timed(fn, iters: int, device) -> float:
    """Seconds per call of ``fn`` over ``iters`` calls (synchronized)."""
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    sync(device)
    return (time.perf_counter() - t0) / iters


def run(args) -> dict:
    device = hvd.device()
    n = hvd.size()
    elems = args.size_mb * (1 << 20) // 4
    x = torch.full((elems,), float(hvd.rank()), dtype=torch.float32,
                   device=device)
    # Warm-up and a check of the sum.
    group = dist.group.WORLD if args.process_group else None
    out = hvd.allreduce(x, average=False, name="bw.warm", group=group)
    expected = sum(range(n))
    if abs(float(out[0]) - expected) > 1e-3:
        raise AssertionError(f"allreduce gave {float(out[0])}, "
                             f"expected {expected}")
    if n == 1:
        mode = "size 1: the call's own cost (nothing crosses a link)"
        dt = _timed(lambda i: hvd.allreduce(x, average=False,
                                            name=f"bw.{i}"),
                    args.iters, device)
    elif args.process_group:
        mode = f"process group ({dist.get_backend()})"
        dt = _timed(lambda i: hvd.allreduce(x, average=False,
                                            name=f"bw.{i}", group=group),
                    args.iters, device)
    else:
        ctl = basics.controller()
        if ctl is None:
            raise RuntimeError("size > 1 without a controller: launch with "
                               "horovodrun, or pass --process-group")
        if args.inplace:
            mode = f"{type(ctl).__name__}, in place"
            dt = _timed(lambda i: ctl.allreduce_async(
                x, average=False, name=f"bw.{i}", inplace=True).wait(),
                args.iters, device)
        else:
            mode = f"{type(ctl).__name__}, into a new tensor"
            dt = _timed(lambda i: hvd.allreduce(x, average=False,
                                                name=f"bw.{i}"),
                        args.iters, device)
    nbytes = elems * 4
    bus = (2 * (n - 1) / n * nbytes / dt) if n > 1 else nbytes / dt
    return {"metric": "allreduce_bus_bandwidth", "size_mb": args.size_mb,
            "ranks": n, "mode": mode, "ms": dt * 1e3,
            "bus_GB_s": bus / 1e9, "device": device_label(device)}


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size-mb", type=int, default=64)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--inplace", action="store_true",
                        help="eager mode: reduce in place on the caller's "
                             "tensor")
    parser.add_argument("--process-group", action="store_true",
                        help="the torch.distributed group's allreduce")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = probe_device(args.device)
    hvd.init(device=None if device.type == "cuda" else "cpu")
    record = run(args)
    if hvd.rank() == 0:
        print(json.dumps(record), flush=True)
        print(json.dumps({"metric": "allreduce_benchmark",
                          "bus_GB_s": record["bus_GB_s"],
                          "ranks": record["ranks"],
                          "mode": record["mode"]}), flush=True)
    return record


if __name__ == "__main__":
    main()
