"""Flash attention kernel micro-benchmark (forward and forward+backward)
on the card — the port's counterpart of
``examples/flash_attention_benchmark.py``.

Times the port's ``flash_attention`` (kernel 1 forward; kernels 2 and 3
in the backward, ``csrc/flash_attention.cu``) at the JAX probe's
defaults, so a kernel change can be re-measured with one command:

    python -m horovod_tpu_torch.examples.flash_attention_benchmark
    python -m horovod_tpu_torch.examples.flash_attention_benchmark --sweep
    python -m horovod_tpu_torch.examples.flash_attention_benchmark --plain
    python -m horovod_tpu_torch.examples.flash_attention_benchmark \\
        --device cpu --plain --batch 1 --seq-len 64 --iters 2   # tests

Timing: CUDA events around each call, alone, after an L2 flush; the
median of ``--iters`` calls (``utils/timing.median_ms``). ``fwd_ms`` is
the forward; ``train_ms`` the forward, then the gradients of
``sum(out**2)`` with respect to q, k and v (the JAX probe's loss).

One JSON line per configuration:
  {"metric": "flash_fwd_ms", "B":..,"S":..,"H":..,"Hkv":..,"D":..,
   "block_q":..,"block_k":..,"fwd_ms":..,"train_ms":..,"device":..}
``--plain`` times the plain torch versions of the three kernels instead
(``metric`` ``plain_attn_fwd_ms``); the SDPA row (``sdpa_fwd_ms``,
``torch.nn.functional.scaled_dot_product_attention``) is the library's
yardstick, printed after the kernels' row on a card: the port never
calls it. ``--sweep`` runs every tile the kernels compile for this dtype
and head width (``ops.attention.FLASH_TILES``); the kernels compile one,
so the sweep prints that one row and says so. In a sweep a configuration
that fails prints an ``error`` row and the sweep goes on; a single
configuration that fails raises. The last line is a summary (the best
forward and its tile).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops import attention as flash_ops
from horovod_tpu_torch.utils.timing import (L2Flush, device_label,
                                            median_ms, probe_device)


def make_qkv(b: int, s: int, h: int, hkv: int, d: int, dtype, device):
    """q (B, S, H, D), k/v (B, S, Hkv, D): seeded normals * 0.3, the JAX
    probe's inputs."""
    rng = np.random.RandomState(0)

    def mk(heads):
        x = rng.randn(b, s, heads, d).astype(np.float32) * 0.3
        return torch.from_numpy(x).to(device=device, dtype=dtype)

    return mk(h), mk(hkv), mk(hkv)


def attention_fn(kind: str, causal: bool, block_q=None, block_k=None):
    """``(q, k, v) -> out``: the kernels (``flash``), their plain
    versions (``plain``) or SDPA (``sdpa``)."""
    if kind == "flash":
        return lambda q, k, v: flash_ops.flash_attention(
            q, k, v, causal=causal, block_q=block_q, block_k=block_k)
    if kind == "plain":
        return lambda q, k, v: _PlainFn.apply(q, k, v, causal)
    if kind == "sdpa":
        def sdpa(q, k, v):
            out = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)
            return out.transpose(1, 2)
        return sdpa
    raise ValueError(kind)


class _PlainFn(torch.autograd.Function):
    """The plain versions of kernels 1-3 as one differentiable call."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_ops.flash_attention_forward_plain(q, k, v, None,
                                                           causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_ops.flash_attention_backward_plain(
            q, k, v, None, out, lse, g.contiguous(), ctx.causal)
        return dq, dk, dv, None


def bench_config(q, k, v, attn, iters: int, flush) -> tuple:
    """(fwd_ms, train_ms) of ``attn`` on q, k, v."""
    device = q.device

    def fwd():
        with torch.no_grad():
            attn(q, k, v)

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def train():
        out = attn(*leaves)
        torch.autograd.grad((out.float() ** 2).sum(), leaves)

    return (median_ms(fwd, device, iters, flush),
            median_ms(train, device, iters, flush))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--kv-heads", type=int, default=None,
                   help="K/V heads (grouped-query); default --heads")
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--block-q", type=int, default=None,
                   help="the forward's query tile; default the compiled one")
    p.add_argument("--block-k", type=int, default=None)
    p.add_argument("--iters", type=int, default=25,
                   help="timed calls per measurement (median)")
    p.add_argument("--sweep", action="store_true",
                   help="every tile the kernels compile")
    p.add_argument("--plain", action="store_true",
                   help="time the plain torch versions of the kernels")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parse_args(argv)
    device = probe_device(args.device)
    dtype, causal = torch.bfloat16, True
    hkv = args.kv_heads or args.heads
    label = device_label(device)
    tiles = flash_ops.flash_tiles(dtype, args.head_dim)
    if args.sweep and not args.plain:
        configs = [tiles["forward"]]
        print(f"note: the kernels compile one tile for bfloat16 at "
              f"head_dim {args.head_dim} (forward {tiles['forward']}, dq "
              f"{tiles['backward_dq']}, dk/dv {tiles['backward_dkdv']}); "
              "the sweep times that one", file=sys.stderr)
    else:
        if args.sweep:
            print("note: --sweep has no effect with --plain (no tiles); "
                  "timing one configuration", file=sys.stderr)
        flash_ops.check_blocks(dtype, args.head_dim, args.block_q,
                               args.block_k)
        configs = [tiles["forward"]]
    q, k, v = make_qkv(args.batch, args.seq_len, args.heads, hkv,
                       args.head_dim, dtype, device)
    flush = L2Flush(device)
    shape = {"B": args.batch, "S": args.seq_len, "H": args.heads,
             "Hkv": hkv, "D": args.head_dim, "dtype": "bfloat16",
             "causal": causal}
    records = []
    for bq, bk in configs:
        rec = {"metric": "plain_attn_fwd_ms" if args.plain
               else "flash_fwd_ms", **shape, "block_q": bq, "block_k": bk}
        try:
            attn = attention_fn("plain" if args.plain else "flash", causal,
                                None if args.plain else bq,
                                None if args.plain else bk)
            fwd_ms, train_ms = bench_config(q, k, v, attn, args.iters,
                                            flush)
        except Exception as exc:  # noqa: BLE001 — a sweep goes on
            if not args.sweep:
                raise
            rec.update(error=type(exc).__name__, error_detail=str(exc)[:200])
            print(json.dumps(rec), flush=True)
            records.append(rec)
            continue
        rec.update(fwd_ms=fwd_ms, train_ms=train_ms, device=label)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    if device.type == "cuda" and not args.plain:
        fwd_ms, train_ms = bench_config(q, k, v, attention_fn("sdpa", causal),
                                        args.iters, flush)
        rec = {"metric": "sdpa_fwd_ms", **shape, "fwd_ms": fwd_ms,
               "train_ms": train_ms, "device": label,
               "note": "the library's yardstick; not a port of a kernel"}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    timed = [r for r in records if "fwd_ms" in r
             and r["metric"] != "sdpa_fwd_ms"]
    summary = {"metric": "flash_attention_benchmark", **shape,
               "rows": len(records), "device": label,
               "plain": bool(args.plain)}
    if timed:
        best = min(timed, key=lambda r: r["fwd_ms"])
        summary.update(best_fwd_ms=best["fwd_ms"],
                       best_block_q=best["block_q"],
                       best_block_k=best["block_k"])
    print(json.dumps(summary), flush=True)
    return records


if __name__ == "__main__":
    main()
