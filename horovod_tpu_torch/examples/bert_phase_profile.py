"""BERT per-phase time accounting and MFU — the port's counterpart of
``examples/bert_phase_profile.py``.

Profiles the MLM training step (``examples/bert_pretraining.py``'s
model, loss and AdamW) under ``hvd.profiler.trace`` with every
submodule labelled by its flax name (``profiler.module_scopes``),
buckets every kernel by that provenance
(``utils/hlo_phases.kernel_rows``; a backward kernel carries its forward
op's stack) and quotes MFU from the analytic transformer FLOP count.

Run: python -m horovod_tpu_torch.examples.bert_phase_profile \\
         --model base --seq-len 128 --batch-per-chip 128 [--device cpu]

Keys as the JAX table's, plus the port's: ``SelfAttention`` (the
attention module's flax name here) for the attention core and
``nll_loss`` for the head's loss.
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

# Ordered: first hit wins. Keys match the provenance of a kernel, e.g.
# "transpose(encoder/layer_3/SelfAttention_0/query/aten::linear)/...".
PHASES = (
    ("attn_proj", ("/query/", "/key/", "/value/", "/out/")),
    ("attn_core", ("/attention/", "softmax", "flash", "SelfAttention")),
    ("mlp", ("/intermediate/", "/output/", "gelu", "/Dense_")),
    ("layernorm", ("LayerNorm", "layer_norm")),
    ("embed", ("embed", "one_hot", "position", "token_type")),
    ("head_loss", ("mlm", "logsumexp", "token_nll", "take_along",
                   "nll_loss")),
)


def classify(tf_op_name: str) -> str:
    for phase, keys in PHASES:
        if any(k in tf_op_name for k in keys):
            return phase
    return "other"


def train_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Analytic fwd+bwd FLOPs of one MLM step: 6 * 2ND matmul FLOPs
    over the encoder + lm head, plus the attention O(S^2) term."""
    h, L = cfg.hidden_size, cfg.num_layers
    inter = cfg.intermediate_size
    per_layer = 4 * h * h + 2 * h * inter
    matmul_params = L * per_layer + h * cfg.vocab_size
    tokens = batch * seq
    dense = 6.0 * tokens * matmul_params
    attn = 6.0 * 2.0 * L * batch * seq * seq * h
    return dense + attn


def capture(model_name: str, batch: int, seq: int, trace_dir: str,
            steps: int = 5, attention: str = "xla", device=None):
    from horovod_tpu_torch.models.bert import (BERT_BASE, BERT_LARGE,
                                               BERT_TINY, BertEncoder,
                                               mlm_loss)
    from horovod_tpu_torch.ops.attention import make_attention_fn

    cfg = {"base": BERT_BASE, "large": BERT_LARGE,
           "tiny": BERT_TINY}[model_name]
    attention_fn = (make_attention_fn(causal=False) if attention == "flash"
                    else None)
    model = BertEncoder(cfg, attention_fn=attention_fn, device=device,
                        seed=0)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (batch, seq))).to(model_device(model))
    mask = torch.ones_like(ids, dtype=torch.bool)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = mlm_loss(model(ids, attention_mask=mask, deterministic=True),
                        ids, mask)
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
    seq_s = batch * steps / wall
    print(f"capture b{batch} s{seq}: {seq_s:.1f} seq/s during trace",
          file=sys.stderr)
    return path, seq_s, cfg


def model_device(model) -> torch.device:
    return next(model.parameters()).device


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
    return {"total_ms_per_step": round(total, 2),
            "phases": finalize_buckets(buckets)}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="base",
                    choices=["base", "large", "tiny"])
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-per-chip", type=int, default=128)
    ap.add_argument("--attention", choices=["xla", "flash"], default="xla",
                    help="xla: the plain attention; flash: the kernels")
    ap.add_argument("--peak-tflops", type=float, default=989.0,
                    help="the card's dense bf16 peak for the MFU quote "
                    "(H100 SXM: 989)")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    device = hvd.default_device(args.device)
    trace_dir = args.trace_dir or os.path.join(
        tempfile.gettempdir(),
        f"bert_trace_{args.model}_b{args.batch_per_chip}")
    trace, seq_s, cfg = capture(args.model, args.batch_per_chip,
                                args.seq_len, trace_dir, steps=args.steps,
                                attention=args.attention, device=device)
    table = phase_table(trace, steps=args.steps, dump=args.dump)
    flops = train_flops_per_step(cfg, args.batch_per_chip, args.seq_len)
    steps_per_s = seq_s / args.batch_per_chip
    mfu = flops * steps_per_s / (args.peak_tflops * 1e12)
    out = {"model": args.model, "seq_len": args.seq_len,
           "batch_per_chip": args.batch_per_chip,
           "attention": args.attention,
           "seq_per_s": round(seq_s, 1),
           "flops_per_step": flops,
           "mfu_pct": round(100.0 * mfu, 1),
           "peak_tflops": args.peak_tflops,
           "trace": trace, **table}
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
