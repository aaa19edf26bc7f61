"""BERT masked-LM pretraining on the port — the counterpart of
``examples/jax_bert_pretraining.py``:

    python -m horovod_tpu_torch.examples.bert_pretraining --model base \\
        --seq-len 512 --batch-size 32 --num-iters 10

One process per card; under a launcher environment every rank trains on
its slice of the global batch and ``DistributedOptimizer`` averages the
gradients over NCCL. Attention runs ``make_attention_fn()`` ("auto": the
flash kernels, non-causal with the key mask, from ``FLASH_AUTO_MIN_SEQ``
query rows upward, the plain path below; ``--no-flash``: always plain).
Parameters float32, activations bf16, dropout off
(``deterministic=True``), as in the JAX example; AdamW(1e-4) with optax's
defaults. Synthetic data: token ids and a 15% MLM label mask from
``RandomState(0)``; the labels are the ids. Reports sequences/s.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.bert import (BERT_BASE, BERT_LARGE, BERT_TINY,
                                           BertConfig, BertEncoder, mlm_loss)
from horovod_tpu_torch.ops.attention import make_attention_fn

CONFIGS = {"tiny": BERT_TINY, "base": BERT_BASE, "large": BERT_LARGE}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=list(CONFIGS), default="base")
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--batch-size", type=int, default=32,
                        help="per-card batch")
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--no-flash", action="store_true")
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint each block (long sequences past "
                             "the no-remat memory ceiling)")
    return parser.parse_args(argv)


def make_model(cfg: BertConfig, no_flash: bool = False,
               device=None) -> BertEncoder:
    attention_fn = None if no_flash else make_attention_fn()
    return BertEncoder(cfg, attention_fn=attention_fn, device=device, seed=0)


def make_optimizer(model: BertEncoder) -> torch.optim.Optimizer:
    """``optax.adamw(1e-4)``: betas (0.9, 0.999), eps 1e-8, weight decay
    1e-4 (optax's default), in ``DistributedOptimizer``."""
    return hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=model.named_parameters())


def batch(cfg: BertConfig, batch_size: int, seq_len: int, device):
    """This rank's slice of the global batch, drawn as the JAX example
    draws it: ``(ids, mlm_mask)``."""
    n = batch_size * hvd.size()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (n, seq_len))
    mlm = rng.rand(n, seq_len) < 0.15
    lo, hi = hvd.rank() * batch_size, (hvd.rank() + 1) * batch_size
    return (torch.from_numpy(ids[lo:hi]).to(device),
            torch.from_numpy(mlm[lo:hi]).to(device))


def train_step(model, optimizer, ids, mlm) -> torch.Tensor:
    """One step of the MLM loss (labels = ids), dropout off. Returns the
    local loss, detached, without a sync."""
    optimizer.zero_grad(set_to_none=True)
    loss = mlm_loss(model(ids, deterministic=True), ids, mlm)
    loss.backward()
    optimizer.step()
    return loss.detach()


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init()
    device = hvd.device()
    cfg = CONFIGS[args.model]
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    model = make_model(cfg, args.no_flash, device)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    optimizer = make_optimizer(model)
    ids, mlm = batch(cfg, args.batch_size, args.seq_len, device)

    losses = [train_step(model, optimizer, ids, mlm)]
    float(losses[0])
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        losses.append(train_step(model, optimizer, ids, mlm))
    loss = float(hvd.allreduce(losses[-1]))
    dt = time.perf_counter() - t0
    n = hvd.size()
    seq_per_sec = args.batch_size * n * args.num_iters / dt
    if hvd.rank() == 0:
        print(f"BERT-{args.model} seq={args.seq_len}: "
              f"{seq_per_sec:.1f} sequences/sec ({seq_per_sec / n:.1f}/card), "
              f"loss={loss:.3f}", flush=True)
    return {"sequences_per_s": seq_per_sec,
            "step_ms": dt / args.num_iters * 1e3,
            "losses": [float(x) for x in losses], "loss": loss,
            "model": model, "optimizer": optimizer, "ids": ids, "mlm": mlm}


if __name__ == "__main__":
    main()
