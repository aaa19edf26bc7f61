"""Decoder-only (Llama-style) LM training on the port — the counterpart
of ``examples/jax_llama_training.py`` (single-sequence path):

    python -m horovod_tpu_torch.examples.llama_training --model 300m \\
        --seq-len 1024 --batch-size 8 --num-iters 10

One process per card. Under a launcher environment (``HOROVOD_RANK``,
``HOROVOD_SIZE``, ``HOROVOD_LOCAL_RANK``, ``HOROVOD_LOCAL_SIZE`` and
``HOROVOD_CONTROLLER_ADDR``) every rank trains on its slice of the batch
and ``DistributedOptimizer`` averages the gradients over NCCL.
Attention runs the flash kernels from ``FLASH_AUTO_MIN_SEQ`` upward
(``--no-flash``: the plain path). Parameters are f32, cast to the
model's bf16 compute dtype at each use. ``--seq-parallel`` and
``--optimizer adafactor`` of the JAX example are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.llama import (LLAMA_1B, LLAMA_8B, LLAMA_300M,
                                            LLAMA_TINY, LlamaConfig, LlamaLM,
                                            causal_lm_loss,
                                            chunked_causal_lm_loss)
from horovod_tpu_torch.ops.attention import make_attention_fn

CONFIGS = {"tiny": LLAMA_TINY, "300m": LLAMA_300M,
           "1b": LLAMA_1B, "8b": LLAMA_8B}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=list(CONFIGS), default="tiny")
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--batch-size", type=int, default=4,
                        help="per-card batch")
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--no-flash", action="store_true")
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint each block: O(1)-layers live "
                             "activations for ~1/3 extra FLOPs")
    parser.add_argument("--optimizer", choices=["adamw", "sgd"],
                        default="adamw")
    parser.add_argument("--chunked-loss", type=int, default=0, metavar="K",
                        help="apply the lm_head + loss in K sequence "
                             "chunks: the (B,S,V) logits never exist whole")
    return parser.parse_args(argv)


def make_model(cfg: LlamaConfig, no_flash: bool = False,
               device=None) -> LlamaLM:
    """f32 trainable parameters, attention through flash from
    ``FLASH_AUTO_MIN_SEQ`` upward unless ``no_flash``."""
    attention_fn = None if no_flash else make_attention_fn(causal=True)
    return LlamaLM(cfg, device=device, seed=0, attention_fn=attention_fn,
                   param_dtype=torch.float32)


def make_optimizer(name: str, model: LlamaLM) -> torch.optim.Optimizer:
    """The JAX example's optax optimizers in torch: ``optax.adamw(3e-4)``
    (whose weight decay defaults to 1e-4) and ``optax.sgd(0.1,
    momentum=0.9)``, wrapped in ``DistributedOptimizer``."""
    params = model.parameters()
    if name == "adamw":
        inner = torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=1e-4)
    elif name == "sgd":
        inner = torch.optim.SGD(params, lr=0.1, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return hvd.DistributedOptimizer(
        inner, named_parameters=model.named_parameters())


def make_loss_fn(chunked_loss: int = 0) -> Callable:
    if chunked_loss:
        def loss_fn(model, ids):
            hidden = model(ids, return_hidden=True)
            return chunked_causal_lm_loss(hidden, model.lm_head, ids,
                                          num_chunks=chunked_loss)
    else:
        def loss_fn(model, ids):
            return causal_lm_loss(model(ids), ids)
    return loss_fn


def train_step(model, optimizer, ids, loss_fn) -> torch.Tensor:
    """One step: loss, backward (gradients reduce as they accumulate),
    optimizer step. Returns the local loss, detached, without a sync."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, ids)
    loss.backward()
    optimizer.step()
    return loss.detach()


def batch_ids(cfg: LlamaConfig, batch: int, seq_len: int,
              device) -> torch.Tensor:
    """This rank's slice of the global batch, drawn as the JAX example
    draws it (``np.random.RandomState(0)``)."""
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch * hvd.size(), seq_len))
    mine = ids[hvd.rank() * batch:(hvd.rank() + 1) * batch]
    return torch.from_numpy(mine).to(device)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init()
    device = hvd.device()
    cfg = CONFIGS[args.model]
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    model = make_model(cfg, args.no_flash, device)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    optimizer = make_optimizer(args.optimizer, model)
    loss_fn = make_loss_fn(args.chunked_loss)
    ids = batch_ids(cfg, args.batch_size, args.seq_len, device)

    losses = [train_step(model, optimizer, ids, loss_fn)]
    float(losses[0])
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        losses.append(train_step(model, optimizer, ids, loss_fn))
    loss = float(hvd.allreduce(losses[-1]))
    dt = time.perf_counter() - t0
    n = hvd.size()
    batch = args.batch_size * n
    tok_per_sec = batch * args.seq_len * args.num_iters / dt
    if hvd.rank() == 0:
        print(f"llama-{args.model} seq={args.seq_len}: "
              f"{tok_per_sec:.0f} tokens/sec ({tok_per_sec / n:.0f}/chip), "
              f"loss={loss:.3f}", flush=True)
    return {"tokens_per_s": tok_per_sec, "step_ms": dt / args.num_iters * 1e3,
            "losses": [float(x) for x in losses], "loss": loss,
            "model": model, "optimizer": optimizer, "ids": ids,
            "loss_fn": loss_fn}


if __name__ == "__main__":
    main()
