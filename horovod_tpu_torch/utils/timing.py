"""Device timing for the port's probes (``examples/*_benchmark.py``,
``*_probe.py``, ``resnet50_roofline.py``) and the card's peaks they are
scored against.

On a card a call is timed with CUDA events, alone, after the L2 cache was
flushed (a 256 MiB write, as ``chip_smoke.py``'s kernel phases do), and
the median of the repeats is kept. On the CPU (the tests) the host clock
times the same calls; those numbers say nothing of a card.

The peaks are the NVIDIA H100 SXM5's datasheet figures (NVIDIA H100
Tensor Core GPU datasheet, SXM5 column; dense, without sparsity). A card
set below its 700 W limit runs slower under load, so every number a
probe prints stands beside :func:`card_line`.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Optional

import torch

#: HBM3 bandwidth, bytes/s (datasheet: 3.35 TB/s).
H100_SXM_HBM_BYTES_PER_S = 3.35e12
#: Dense bfloat16 tensor-core peak, FLOP/s (datasheet: 1,979 TFLOPS with
#: sparsity, half of it dense).
H100_SXM_BF16_FLOPS = 989e12
#: Dense TF32 tensor-core peak, FLOP/s (datasheet: 989 TFLOPS with
#: sparsity): the fastest a float32 convolution or product can run.
H100_SXM_TF32_FLOPS = 494.5e12

#: Bytes the L2 flush writes (twice the H100's 50 MB L2).
FLUSH_BYTES = 256 << 20


def probe_device(name: str) -> torch.device:
    """``--device`` of a probe: ``cuda`` (the default) raises when there
    is no card; ``cpu`` is for the tests."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: this probe measures the card "
            "(pass --device cpu to run it on the CPU, for the tests)")
    return device


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_label(device: torch.device) -> str:
    """What a probe's records name as their device: the card's line, or
    ``cpu``."""
    return card_line() if device.type == "cuda" else "cpu"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class L2Flush:
    """A callable that evicts the card's L2 (one write of
    :data:`FLUSH_BYTES`); a no-op on the CPU."""

    def __init__(self, device: torch.device):
        self.buf = (torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                                device=device)
                    if device.type == "cuda" else None)

    def __call__(self) -> None:
        if self.buf is not None:
            self.buf.zero_()


#: Cycles the card spins before a timed call's start event (about 3 ms
#: at the H100's clocks): the host queues the whole call meanwhile, so
#: the events time the card's work and not the host's Python.
HOLD_CYCLES = 5_000_000


def median_ms(fn: Callable[[], object], device: torch.device,
              repeats: int = 25, flush: Optional[L2Flush] = None,
              warmup: int = 1) -> float:
    """Median time of ``fn()`` over ``repeats`` calls, each timed alone:
    on a card, CUDA events around the call after ``flush()`` and a spin
    of :data:`HOLD_CYCLES` (the device time of the call's kernels, its
    host work hidden behind the spin as long as it is shorter); on the
    CPU the host clock."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(repeats):
        if flush is not None:
            flush()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def wall_s(fn: Callable[[], object], device: torch.device) -> float:
    """Host wall seconds of one call of ``fn()``, synchronized on both
    sides (a loop of steps whose host time is the measurement)."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0
