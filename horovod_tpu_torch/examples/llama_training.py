"""Decoder-only (Llama-style) LM training on the port — the counterpart
of ``examples/jax_llama_training.py``:

    python -m horovod_tpu_torch.examples.llama_training --model 300m \\
        --seq-len 1024 --batch-size 8 --num-iters 10

One process per card. Launched by ``python -m horovod_tpu_torch.run -np
N`` every rank trains on its slice of the batch and
``DistributedOptimizer`` averages the gradients through the eager-tier
controller (``--spmd``: over the NCCL process group, whose rendezvous is
``HOROVOD_SPMD_COORDINATOR``).
Attention runs the flash kernels from ``FLASH_AUTO_MIN_SEQ`` upward
(``--no-flash``: the plain path). Parameters are f32, cast to the
model's bf16 compute dtype at each use.

``--seq-parallel N`` shards the SEQUENCE over N ranks (a ``data x seq``
mesh, ``data`` = size / N): ring attention rotates K/V blocks over the
``seq`` group, RoPE gets each shard's global positions, and the
next-token loss shift crosses shard boundaries with one exchange
(``sp_causal_lm_loss``). Each seq rank's gradients are its share of the
global loss's: they are summed over ``seq`` after the backward, and
``DistributedOptimizer`` averages over ``data`` only (the two commute).
``--optimizer adafactor`` is ``optax.adafactor(3e-4)`` through the port's
own ``torch.optim.Adafactor`` (``horovod_tpu_torch/torch/optim.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.llama import (LLAMA_1B, LLAMA_8B, LLAMA_300M,
                                            LLAMA_TINY, LlamaConfig, LlamaLM,
                                            causal_lm_loss,
                                            chunked_causal_lm_loss,
                                            sp_causal_lm_loss)
from horovod_tpu_torch.ops.attention import make_attention_fn
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.parallel.sequence import ring_attention
from horovod_tpu_torch.torch.optim import Adafactor

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
    parser.add_argument("--optimizer", choices=["adamw", "sgd", "adafactor"],
                        default="adamw")
    parser.add_argument("--chunked-loss", type=int, default=0, metavar="K",
                        help="apply the lm_head + loss in K sequence "
                             "chunks: the (B,S,V) logits never exist whole")
    parser.add_argument("--seq-parallel", type=int, default=1,
                        help="shard the sequence over this many ranks "
                             "(ring attention + global RoPE positions)")
    return parser.parse_args(argv)


def ring_attention_fn(group, no_flash: bool = False):
    """The ``attention_fn`` of a sequence-parallel model: causal ring
    attention over ``group``, each ring block through the flash kernels
    from ``FLASH_AUTO_MIN_SEQ`` local tokens upward unless ``no_flash``.
    It takes grouped K/V: the ring rotates Hkv-head blocks."""
    use_flash = False if no_flash else "auto"

    def fn(q, k, v, mask):
        return ring_attention(q, k, v, group, causal=True,
                              use_flash=use_flash)

    fn.supports_gqa = True
    return fn


def make_model(cfg: LlamaConfig, no_flash: bool = False,
               device=None, seq_group=None) -> LlamaLM:
    """f32 trainable parameters, attention through flash from
    ``FLASH_AUTO_MIN_SEQ`` upward unless ``no_flash``; ring attention
    over ``seq_group`` when one is given."""
    if seq_group is not None:
        attention_fn = ring_attention_fn(seq_group, no_flash)
    else:
        attention_fn = None if no_flash else make_attention_fn(causal=True)
    return LlamaLM(cfg, device=device, seed=0, attention_fn=attention_fn,
                   param_dtype=torch.float32)


def make_inner_optimizer(name: str, params) -> torch.optim.Optimizer:
    """The JAX example's optax optimizers in torch: ``optax.adamw(3e-4)``
    (whose weight decay defaults to 1e-4), ``optax.sgd(0.1,
    momentum=0.9)`` and ``optax.adafactor(3e-4)``."""
    if name == "adafactor":
        return Adafactor(params, lr=3e-4)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.1, momentum=0.9)
    raise ValueError(f"unknown optimizer {name!r}")


def make_optimizer(name: str, model: LlamaLM,
                   group=None) -> torch.optim.Optimizer:
    """:func:`make_inner_optimizer` wrapped in ``DistributedOptimizer``
    averaging over ``group`` (None: every rank)."""
    return hvd.DistributedOptimizer(
        make_inner_optimizer(name, model.parameters()),
        named_parameters=model.named_parameters(), group=group)


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


def make_sp_loss_fn(seq_group) -> Callable:
    """The sequence-parallel loss: this rank's shard runs at its global
    positions, and ``sp_causal_lm_loss`` gives the global mean."""
    n = dist.get_world_size(seq_group)
    idx = dist.get_rank(seq_group)

    def loss_fn(model, ids):
        s_local = ids.shape[1]
        positions = idx * s_local + torch.arange(s_local, device=ids.device)
        return sp_causal_lm_loss(model(ids, positions=positions), ids,
                                 seq_group)

    loss_fn.seq_parallel = n
    return loss_fn


def sum_gradients(model, group) -> None:
    """Sum every gradient over ``group``, in place, in parameter order
    (the same on every rank: the ranks of a ring do different work, so
    their gradients become ready in different orders)."""
    for p in model.parameters():
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)


def train_step(model, optimizer, ids, loss_fn,
               seq_group=None) -> torch.Tensor:
    """One step: loss, backward (gradients reduce as they accumulate),
    optimizer step. With ``seq_group``, the gradients are summed over it
    once the data-group averages have landed. Returns the local loss,
    detached, without a sync."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, ids)
    loss.backward()
    if seq_group is not None:
        optimizer.synchronize()
        sum_gradients(model, seq_group)
    optimizer.step()
    return loss.detach()


def batch_ids(cfg: LlamaConfig, batch: int, seq_len: int, device,
              mesh=None) -> torch.Tensor:
    """This rank's slice of the global batch, drawn as the JAX example
    draws it (``np.random.RandomState(0)``): its rows by its ``data``
    coordinate, and with a ``seq`` axis its columns by its ``seq``
    coordinate."""
    dp, di, sp, si = hvd.size(), hvd.rank(), 1, 0
    if mesh is not None:
        dp, di = mesh.axis_size("data"), mesh.axis_index("data")
        sp, si = mesh.axis_size("seq"), mesh.axis_index("seq")
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch * dp, seq_len))
    s_local = seq_len // sp
    mine = ids[di * batch:(di + 1) * batch, si * s_local:(si + 1) * s_local]
    return torch.from_numpy(np.ascontiguousarray(mine)).to(device)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init()
    device = hvd.device()
    n = hvd.size()
    cfg = CONFIGS[args.model]
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    sp = args.seq_parallel
    if sp < 1 or n % sp or args.seq_len % sp:
        raise SystemExit(f"--seq-parallel {sp} must be >= 1 and divide both "
                         f"the rank count ({n}) and --seq-len "
                         f"({args.seq_len})")
    if args.chunked_loss and sp > 1:
        raise SystemExit("--chunked-loss applies to the single-sequence "
                         "path; under --seq-parallel the logits are already "
                         "sequence-sharded")
    mesh = seq_group = data_group = None
    if sp > 1:
        mesh = make_mesh({"data": n // sp, "seq": sp})
        seq_group, data_group = mesh.group("seq"), mesh.group("data")
    model = make_model(cfg, args.no_flash, device, seq_group)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    optimizer = make_optimizer(args.optimizer, model, data_group)
    loss_fn = (make_sp_loss_fn(seq_group) if sp > 1
               else make_loss_fn(args.chunked_loss))
    ids = batch_ids(cfg, args.batch_size, args.seq_len, device, mesh)

    def step():
        return train_step(model, optimizer, ids, loss_fn, seq_group)

    losses = [step()]
    float(losses[0])
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        losses.append(step())
    loss = float(hvd.allreduce(losses[-1]))
    dt = time.perf_counter() - t0
    batch = args.batch_size * (n // sp)
    tok_per_sec = batch * args.seq_len * args.num_iters / dt
    if hvd.rank() == 0:
        print(f"llama-{args.model} seq={args.seq_len}: "
              f"{tok_per_sec:.0f} tokens/sec ({tok_per_sec / n:.0f}/chip), "
              f"loss={loss:.3f}", flush=True)
    return {"tokens_per_s": tok_per_sec, "step_ms": dt / args.num_iters * 1e3,
            "losses": [float(x) for x in losses], "loss": loss,
            "model": model, "optimizer": optimizer, "ids": ids,
            "loss_fn": loss_fn, "step": step, "mesh": mesh}


if __name__ == "__main__":
    main()
