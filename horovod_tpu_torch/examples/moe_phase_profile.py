"""MoE per-phase time accounting — the port's counterpart of
``examples/moe_phase_profile.py``.

Profiles the MoE-LM training step (flash attention, the loss plus 0.01
of the balancing loss, AdamW: ``examples/moe_lm_training.py``'s
objective) under ``hvd.profiler.trace`` and buckets every kernel by its
provenance (``utils/hlo_phases.kernel_rows``) into router, route/sort,
dispatch and combine, expert matmuls, attention and the rest.

Run: python -m horovod_tpu_torch.examples.moe_phase_profile \\
         --model small --seq-len 1024 --batch-size 8 [--device cpu]

Keys the port names differently, beside the JAX ones: the router is the
``router`` scope, the expert matmuls ``aten::bmm`` under ``moe_ffn``,
top-k ``topk``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.utils.hlo_phases import (add_to_bucket,
                                                finalize_buckets, kernel_rows)

# Ordered: first hit wins.
PHASES = (
    ("attention", ("/attention/", "flash")),
    ("expert_mm", ("vmap()/dot_general", "vmap(jvp(", "silu",
                   "moe_ffn/aten::bmm")),
    ("route_sort", ("cumsum", "sort", "one_hot", "argmax", "top_k", "topk",
                    "iota")),
    ("router", ("softmax", "/moe_ffn/dot_general",
                "/moe_ffn/convert_element_type", "router")),
    ("dispatch_combine", ("/moe_ffn/", "moe_ffn/")),
    ("lm_head_embed", ("lm_head", "embed")),
)


def classify(tf_op_name: str) -> str:
    for phase, keys in PHASES:
        if any(k in tf_op_name for k in keys):
            return phase
    return "other"


def capture(model_name: str, seq: int, batch: int, trace_dir: str,
            steps: int = 5, device=None) -> str:
    from horovod_tpu_torch.models.llama import causal_lm_loss
    from horovod_tpu_torch.models.moe_lm import MOE_SMALL, MOE_TINY, MoeLM
    from horovod_tpu_torch.ops.attention import make_attention_fn

    cfg = {"tiny": MOE_TINY, "small": MOE_SMALL}[model_name]
    model = MoeLM(cfg, device=device, seed=0,
                  attention_fn=make_attention_fn(causal=True),
                  param_dtype=torch.float32)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (batch, seq))).to(model.device)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        logits, aux = model(ids, return_aux=True)
        loss = causal_lm_loss(logits, ids) + 0.01 * aux
        loss.backward()
        opt.step()
        return loss.detach()

    for _ in range(3):
        loss = step()
    float(loss)
    t0 = time.perf_counter()
    with hvd.profiler.trace(trace_dir) as path:
        for i in range(steps):
            with hvd.profiler.step(i):
                loss = step()
        float(loss)
    wall = time.perf_counter() - t0
    print(f"capture s{seq} b{batch}: {batch * seq * steps / wall:.0f} "
          "tok/s during trace", file=sys.stderr)
    return path


def phase_table(trace, steps: int = 5, dump: bool = False) -> dict:
    buckets = {}
    total = 0.0
    for row in kernel_rows(trace):
        t_ms = row["self_ms"] / steps
        op = row["tf_op_name"]
        phase = classify(op)
        total += t_ms
        add_to_bucket(buckets, phase, t_ms, row)
        if dump and t_ms > 0.3:
            print(f"{phase:16s} {t_ms:6.2f}ms {op[-110:]}", file=sys.stderr)
    return {"total_ms_per_step": round(total, 1),
            "phases": finalize_buckets(buckets)}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="small", choices=["tiny", "small"])
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--trace", default=None,
                    help="analyze this trace instead of capturing one")
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    trace_dir = args.trace_dir or os.path.join(
        tempfile.gettempdir(), f"moe_trace_s{args.seq_len}_b{args.batch_size}")
    trace = args.trace or capture(args.model, args.seq_len, args.batch_size,
                                  trace_dir, args.steps,
                                  hvd.default_device(args.device))
    table = phase_table(trace, steps=args.steps, dump=args.dump)
    out = {"model": args.model, "seq_len": args.seq_len,
           "batch_per_chip": args.batch_size, "trace": trace, **table}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: (v if k != "phases" else {
        # hvdlint: disable=HVD002 (a printed summary, no rank walks it)
        p: b["ms"] for p, b in v.items()}) for k, v in out.items()
        if k != "trace"}))
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
