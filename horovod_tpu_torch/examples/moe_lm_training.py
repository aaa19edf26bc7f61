"""MoE causal-LM training throughput (``models.moe_lm.MoeLM``) on the port
— the counterpart of ``examples/jax_moe_lm_training.py``:

    python -m horovod_tpu_torch.examples.moe_lm_training --model small \\
        --seq-len 1024 --batch-size 8 --num-iters 10

The dense twin (every expert on every card): one process per card, and
under a launcher environment ``DistributedOptimizer`` averages the
gradients over NCCL. Attention runs the flash kernels from
``FLASH_AUTO_MIN_SEQ`` upward (``--no-flash``: the plain path); the
objective is the causal LM loss plus ``--aux-weight`` times the routed
layers' balancing losses. For expert parallelism see
``examples/moe_training.py``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples import llama_training
from horovod_tpu_torch.models.llama import causal_lm_loss
from horovod_tpu_torch.models.moe_lm import MOE_SMALL, MOE_TINY, MoeLM
from horovod_tpu_torch.ops.attention import make_attention_fn

CONFIGS = {"tiny": MOE_TINY, "small": MOE_SMALL}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=list(CONFIGS), default="tiny")
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--batch-size", type=int, default=4,
                        help="per-card batch")
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--aux-weight", type=float, default=0.01)
    parser.add_argument("--no-flash", action="store_true")
    return parser.parse_args(argv)


def make_model(cfg, no_flash: bool = False, device=None) -> MoeLM:
    """f32 trainable parameters from seed 0, attention through flash from
    ``FLASH_AUTO_MIN_SEQ`` upward unless ``no_flash``."""
    attention_fn = None if no_flash else make_attention_fn(causal=True)
    return MoeLM(cfg, device=device, seed=0, attention_fn=attention_fn,
                 param_dtype=torch.float32)


def make_loss_fn(aux_weight: float):
    def loss_fn(model, ids):
        logits, aux = model(ids, return_aux=True)
        return causal_lm_loss(logits, ids) + aux_weight * aux
    return loss_fn


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init()
    device = hvd.device()
    cfg = CONFIGS[args.model]
    model = make_model(cfg, args.no_flash, device)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    # optax.adamw(3e-4), as the JAX example, in DistributedOptimizer.
    optimizer = llama_training.make_optimizer("adamw", model)
    loss_fn = make_loss_fn(args.aux_weight)
    ids = llama_training.batch_ids(cfg, args.batch_size, args.seq_len,
                                   device)
    step = llama_training.train_step

    losses = [step(model, optimizer, ids, loss_fn)]
    float(losses[0])
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        losses.append(step(model, optimizer, ids, loss_fn))
    loss = float(hvd.allreduce(losses[-1]))
    dt = time.perf_counter() - t0
    n = hvd.size()
    tok_per_sec = args.batch_size * n * args.seq_len * args.num_iters / dt
    if hvd.rank() == 0:
        print(f"moe-{args.model} seq={args.seq_len}: "
              f"{tok_per_sec:.0f} tokens/sec ({tok_per_sec / n:.0f}/chip), "
              f"loss={loss:.3f}", flush=True)
    return {"tokens_per_s": tok_per_sec, "step_ms": dt / args.num_iters * 1e3,
            "losses": [float(x) for x in losses], "loss": loss,
            "model": model, "optimizer": optimizer, "ids": ids,
            "loss_fn": loss_fn}


if __name__ == "__main__":
    main()
