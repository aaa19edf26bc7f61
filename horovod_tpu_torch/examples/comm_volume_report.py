"""Per-mode communication-volume report from profiled steps — the port's
counterpart of ``examples/comm_volume_report.py``.

Runs one step of each parallel mode on a world of 8 ranks in ONE
process (``torch.distributed``'s fake backend: every collective is
called, recorded by the profiler and moves nothing), profiles it under
``hvd.profiler.trace`` and reads the ``c10d`` collectives back out of
the trace (``utils/comm_accounting.collectives``): their kinds, counts
and payload bytes, and the ring model's wire bytes a device. The bytes
a step moves are a property of the program, as the JAX report's are of
the compiled HLO; ``tests/test_torch_comm_volume.py`` holds them against
the JAX package's.

Run: python -m horovod_tpu_torch.examples.comm_volume_report [--out F]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

import horovod_tpu_torch as hvd
from horovod_tpu_torch.utils.comm_accounting import (collectives,
                                                     count_by_op,
                                                     payload_by_op,
                                                     wire_bytes_per_device)

N = 8


def init_fake_world(n: int = N) -> None:
    """A world of ``n`` ranks in this process, this process rank 0, on
    the fake backend (collectives are recorded, nothing moves)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)


class Linear(nn.Module):
    """The JAX test's DP/ZeRO model: ``x @ w + b``."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(64, 32))
        self.b = nn.Parameter(torch.zeros(32))

    def forward(self, x):
        return x @ self.w + self.b


class TwoLayer(nn.Module):
    """The JAX test's FSDP model: ``tanh(x @ w) @ v``."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(256, 128))
        self.v = nn.Parameter(torch.zeros(128, 256))

    def forward(self, x):
        return torch.tanh(x @ self.w) @ self.v


def _profiled(step, trace_dir: str) -> str:
    with hvd.profiler.trace(trace_dir) as path:
        step()
    return path


def dp_trace(trace_dir: str) -> str:
    """DistributedOptimizer over the world: one allreduce a gradient."""
    model = Linear()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([model.b, model.w], lr=0.1),
        named_parameters=[("b", model.b), ("w", model.w)],
        group=dist.group.WORLD)
    x = torch.ones(4, 64)

    def step():
        ((model(x)) ** 2).mean().backward()
        opt.step()

    return _profiled(step, trace_dir)


def zero1_trace(trace_dir: str) -> str:
    """ZeRO-1: the gradients reduce-scattered, the updated slices
    all-gathered."""
    model = Linear()
    opt = hvd.zero_sharded_optimizer(
        torch.optim.SGD([model.w, model.b], lr=0.1), group=dist.group.WORLD)
    x = torch.ones(4, 64)

    def step():
        ((model(x)) ** 2).mean().backward()
        opt.step()

    return _profiled(step, trace_dir)


def fsdp_trace(trace_dir: str) -> str:
    """FSDP: the parameters gathered on use, the gradients
    reduce-scattered."""
    model = TwoLayer()
    specs = hvd.fsdp_param_specs(dict(model.named_parameters()),
                                 num_shards=N, min_leaf_elems=1)
    hvd.fully_shard(model, specs, dist.group.WORLD)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    x = torch.ones(4, 256)

    def step():
        ((model(x)) ** 2).mean().backward()
        opt.step()

    return _profiled(step, trace_dir)


def report(name: str, trace: str, default_n: int, note: str = "") -> dict:
    colls = collectives(trace)
    row = {
        "mode": name,
        "collective_counts": count_by_op(colls),
        "payload_bytes_by_op": payload_by_op(colls),
        "ring_wire_bytes_per_device": wire_bytes_per_device(
            colls, default_n=default_n),
        "note": note,
    }
    print(json.dumps(row))
    return row


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=os.path.join(
        tempfile.gettempdir(), "comm_volume_traces"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    init_fake_world()
    gbytes = (64 * 32 + 32) * 4
    rows = [
        report("dp-allreduce", dp_trace(args.trace_dir), N,
               note=f"grad bytes {gbytes}; ring theory 2(N-1)/N*grads = "
                    f"{2 * (N - 1) / N * gbytes:.0f} wire bytes/device"),
        report("dp-zero1", zero1_trace(args.trace_dir), N,
               note="same wire bytes as one ring allreduce, split into its "
                    "reduce-scatter + all-gather halves; one collective per "
                    "dtype bucket"),
        report("dp-zero3-fsdp", fsdp_trace(args.trace_dir), N,
               note="all-gather params on use; grads reduce-scattered"),
    ]
    out = {"what": "Communication volume per parallel mode, from profiled "
                   "steps on a fake world of 8 ranks. Counts and payloads "
                   "are program properties; wire bytes use the ring model.",
           "rows": rows}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
