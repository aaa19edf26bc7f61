"""Long-context attention via ring sequence parallelism — the port's
counterpart of ``examples/jax_long_context_ring_attention.py``.

Each rank holds S/N tokens of q, k and v, and K/V blocks rotate around
the job (``horovod_tpu_torch.parallel.sequence.ring_attention``). From
``FLASH_AUTO_MIN_SEQ`` tokens per kernel call each ring block runs
through the flash kernels (no S_local x S_local matrix), so the longest
context grows with the number of ranks. ``--layout zigzag`` balances
causal work across ranks and streams half-blocks through the same
kernels.

    python -m horovod_tpu_torch.examples.long_context_ring_attention \\
        --seq-len 8192
    ... --causal --layout zigzag

One process per card under a launcher environment (or any process group
already initialised, e.g. gloo ranks sharing a card); ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.parallel.sequence import (
    ring_attention,
    zigzag_shard,
    zigzag_unshard,
)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seq-len", type=int, default=8192)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--head-dim", type=int, default=64)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--causal", action="store_true")
    parser.add_argument("--layout", choices=["contiguous", "zigzag"],
                        default="contiguous",
                        help="zigzag balances causal work across ranks "
                             "(see parallel.sequence.zigzag_shard)")
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the card)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init(device=args.device)
    n = hvd.size()
    if args.seq_len % n:
        raise SystemExit(f"--seq-len must divide by {n} ranks")
    mesh = make_mesh({"seq": n})
    group, idx = mesh.group("seq"), mesh.axis_index("seq")
    device = hvd.device()
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    rng = np.random.RandomState(0)
    shape = (args.batch, args.seq_len, args.heads, args.head_dim)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.3)
               for _ in range(3))
    if args.layout == "zigzag":
        q, k, v = (zigzag_shard(x, n) for x in (q, k, v))
    s_local = args.seq_len // n
    q, k, v = (x[:, idx * s_local:(idx + 1) * s_local].to(device, dtype)
               .contiguous() for x in (q, k, v))

    def run():
        with torch.no_grad():
            return ring_attention(q, k, v, group, causal=args.causal,
                                  layout=args.layout)

    out = run()
    float(out[0, 0, 0, 0])
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = run()
    float(out[0, 0, 0, 0])
    dt = (time.perf_counter() - t0) / args.iters
    full = hvd.allgather(out.transpose(0, 1).contiguous(),
                         group=group).transpose(0, 1).float().cpu()
    if args.layout == "zigzag":
        full = zigzag_unshard(full, n)       # back to natural token order
    s = args.seq_len
    flops = 4 * args.batch * args.heads * s * s * args.head_dim
    record = {"seq_len": s, "ranks": n, "layout": args.layout,
              "causal": args.causal, "ms_per_iter": dt * 1e3,
              "tflops": flops / dt / 1e12, "out_shape": list(full.shape),
              "finite": bool(torch.isfinite(full).all())}
    if hvd.rank() == 0:
        print(f"ring attention S={s} on {n} rank(s): {dt * 1e3:.1f} ms/iter, "
              f"{flops / dt / 1e12:.2f} TFLOP/s, out shape "
              f"{tuple(full.shape)}, layout={args.layout}", flush=True)
    return record


if __name__ == "__main__":
    main()
