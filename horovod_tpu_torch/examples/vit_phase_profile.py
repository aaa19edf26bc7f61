"""ViT per-phase time accounting — the port's counterpart of
``examples/vit_phase_profile.py``.

Profiles the ViT training step (``examples/vit_training.py``'s model and
classification loss, AdamW) under ``hvd.profiler.trace`` with every
submodule labelled by its flax name (``profiler.module_scopes``) and
buckets every kernel by that provenance
(``utils/hlo_phases.kernel_rows``).

Run: python -m horovod_tpu_torch.examples.vit_phase_profile \\
         --model s16 --batch-per-chip 64 [--device cpu]

Keys as the JAX table's; ``--attention flash`` runs the flash kernels
(the JAX step runs XLA's attention).
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
from horovod_tpu_torch.common.profiler import module_scopes
from horovod_tpu_torch.utils.hlo_phases import (add_to_bucket,
                                                finalize_buckets, kernel_rows)

# Ordered: first hit wins.
PHASES = (
    ("attn_proj", ("/query/", "/key/", "/value/", "/out/")),
    ("attn_core", ("/SelfAttention_0/", "softmax", "flash")),
    ("mlp", ("/Dense_0/", "/Dense_1/", "gelu")),
    ("layernorm", ("LayerNorm", "final_norm")),
    ("patch_embed", ("patch_embed", "conv")),
    ("head_loss", ("/head/", "token_nll", "logsumexp", "while",
                   "nll_loss")),
)


def classify(tf_op_name: str) -> str:
    for phase, keys in PHASES:
        if any(k in tf_op_name for k in keys):
            return phase
    return "other"


def capture(model_name: str, batch: int, trace_dir: str, steps: int = 5,
            attention: str = "xla", device=None) -> str:
    from horovod_tpu_torch.models.vit import (VIT_B16, VIT_S16, VIT_TINY,
                                              VisionTransformer,
                                              classification_loss)
    from horovod_tpu_torch.ops.attention import make_attention_fn

    cfg = {"b16": VIT_B16, "s16": VIT_S16, "tiny": VIT_TINY}[model_name]
    attention_fn = (make_attention_fn(causal=False, use_flash=True)
                    if attention == "flash" else None)
    model = VisionTransformer(cfg, attention_fn=attention_fn, device=device,
                              seed=0)
    dev = next(model.parameters()).device
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, cfg.image_size, cfg.image_size,
                                  3).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, cfg.num_classes,
                                     size=(batch,))).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = classification_loss(model(x, deterministic=True), y)
        loss.backward()
        opt.step()
        return loss.detach()

    for _ in range(3):
        loss = step()
    float(loss)
    t0 = time.perf_counter()
    with hvd.profiler.trace(trace_dir) as path, module_scopes(model):
        for i in range(steps):
            with hvd.profiler.step(i):
                loss = step()
        float(loss)
    wall = time.perf_counter() - t0
    print(f"capture b{batch}: {batch * steps / wall:.0f} img/s during "
          "trace", file=sys.stderr)
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
        if dump and t_ms > 0.1:
            print(f"{phase:12s} {t_ms:6.2f}ms {op[-120:]}", file=sys.stderr)
    return {"total_ms_per_step": round(total, 1),
            "phases": finalize_buckets(buckets)}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="s16", choices=["b16", "s16", "tiny"])
    ap.add_argument("--batch-per-chip", type=int, default=64)
    ap.add_argument("--attention", choices=["xla", "flash"], default="xla")
    ap.add_argument("--steps", type=int, default=5,
                    help="steps inside the trace; also the divisor turning "
                    "trace totals into per-step ms (pass the capture's "
                    "value when analyzing an existing --trace)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--trace", default=None,
                    help="analyze this trace instead of capturing one")
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    trace_dir = args.trace_dir or os.path.join(
        tempfile.gettempdir(),
        f"vit_trace_{args.model}_b{args.batch_per_chip}")
    trace = args.trace or capture(args.model, args.batch_per_chip,
                                  trace_dir, steps=args.steps,
                                  attention=args.attention,
                                  device=hvd.default_device(args.device))
    table = phase_table(trace, steps=args.steps, dump=args.dump)
    out = {"model": args.model, "batch_per_chip": args.batch_per_chip,
           "attention": args.attention, "trace": trace, **table}
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
