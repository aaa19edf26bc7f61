"""FSDP (ZeRO-3) Llama training on the port — the counterpart of
``examples/jax_llama_fsdp_training.py``, the BASELINE "Llama-3-8B
(PyTorch FSDP + hvd.allreduce)" workload pattern:

    python -m horovod_tpu_torch.examples.llama_fsdp_training --model 300m \\
        --seq-len 1024 --batch-per-shard 8 --num-iters 5

One process per card under a launcher environment. Parameters, gradients
and Adam moments are sharded 1/N over the ``data`` group
(``horovod_tpu_torch.torch.fsdp``): each block's shards are all-gathered
just before it runs (and again for its recompute in the backward), and
its gradients reduce-scattered back to their owners. Attention runs the
flash kernels (``make_attention_fn(causal=True)``). ``--tensor-parallel
T`` composes the tensor-parallel ``LlamaLM(mesh=, tp_axis="model")`` on a
``data x model`` mesh, its layout the base spec (``llama_tp_param_specs``).
``--device cpu`` runs the ranks on the CPU (gloo); the default binds the
card. See ``examples/fsdp_hbm_budget.py`` for what each config needs a
rank.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.llama import (LLAMA_1B, LLAMA_8B, LLAMA_300M,
                                            LLAMA_TINY, LlamaConfig, LlamaLM,
                                            causal_lm_loss,
                                            llama_tp_param_specs)
from horovod_tpu_torch.ops.attention import make_attention_fn
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.torch.fsdp import fsdp_param_specs, fully_shard

CONFIGS = {"tiny": LLAMA_TINY, "300m": LLAMA_300M,
           "1b": LLAMA_1B, "8b": LLAMA_8B}
MIN_LEAF_ELEMS = 1024


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=list(CONFIGS), default="tiny")
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--batch-per-shard", type=int, default=1)
    parser.add_argument("--num-iters", type=int, default=5)
    parser.add_argument("--tensor-parallel", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="cpu: run the ranks on the CPU (gloo)")
    return parser.parse_args(argv)


def full_shapes(cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The unsharded model's parameters as ``meta`` tensors: the shapes
    the specs are computed on, at no memory."""
    with torch.device("meta"):
        model = LlamaLM(cfg, device="meta", param_dtype=torch.float32)
    return dict(model.named_parameters())


def make_specs(cfg: LlamaConfig, dp: int, tp: int = 1):
    """FSDP specs over ``data`` (``min_leaf_elems=1024``), on the
    tensor-parallel layout when ``tp > 1``."""
    shapes = full_shapes(cfg)
    base = llama_tp_param_specs(shapes, axis="model") if tp > 1 else None
    return fsdp_param_specs(shapes, num_shards=dp, base_specs=base,
                            min_leaf_elems=MIN_LEAF_ELEMS)


def make_model(cfg: LlamaConfig, specs, device, mesh=None,
               data_group=None) -> LlamaLM:
    """The model from seed 0 in f32 (every rank draws the same weights),
    attention through flash, tensor-parallel on ``mesh``'s ``model``
    axis when it has one, then sharded over ``data_group``."""
    model = LlamaLM(cfg, device=device, seed=0,
                    attention_fn=make_attention_fn(causal=True),
                    param_dtype=torch.float32, mesh=mesh, tp_axis="model")
    return fully_shard(model, specs, data_group)


def batch_ids(cfg: LlamaConfig, batch_per_shard: int, seq_len: int, dp: int,
              data_index: int, device) -> torch.Tensor:
    """This rank's rows of the global batch, drawn as the JAX example
    draws it (``np.random.RandomState(0)``)."""
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch_per_shard * dp, seq_len))
    mine = ids[data_index * batch_per_shard:
               (data_index + 1) * batch_per_shard]
    return torch.from_numpy(np.ascontiguousarray(mine)).to(device)


def train_step(model, optimizer, ids) -> torch.Tensor:
    """Loss, backward (gradients reduce-scatter as each block's backward
    ends), optimizer step on the shards. Returns the local loss,
    detached, without a sync."""
    optimizer.zero_grad(set_to_none=True)
    loss = causal_lm_loss(model(ids), ids)
    loss.backward()
    optimizer.step()
    return loss.detach()


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init(device=args.device)
    device = hvd.device()
    n, tp = hvd.size(), args.tensor_parallel
    dp = n // tp
    if tp < 1 or dp * tp != n:
        raise SystemExit(f"{n} ranks not divisible by tp={tp}")
    mesh = make_mesh({"data": dp, "model": tp})
    cfg = CONFIGS[args.model]
    specs = make_specs(cfg, dp, tp)
    model = make_model(cfg, specs, device, mesh if tp > 1 else None,
                       mesh.group("data"))
    optimizer = torch.optim.Adam(model.named_parameters(), lr=3e-4)
    ids = batch_ids(cfg, args.batch_per_shard, args.seq_len, dp,
                    mesh.axis_index("data"), device)

    losses = [train_step(model, optimizer, ids)]
    float(losses[0])
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        losses.append(train_step(model, optimizer, ids))
    loss = float(hvd.allreduce(losses[-1]))
    dt = time.perf_counter() - t0
    batch = args.batch_per_shard * dp
    tok = batch * args.seq_len * args.num_iters / dt
    full = full_shapes(cfg)
    biggest = max(full, key=lambda k: full[k].numel())
    held = dict(model.named_parameters())[biggest].numel()
    if hvd.rank() == 0:
        print(f"fsdp llama-{args.model} dp={dp} tp={tp} seq={args.seq_len}: "
              f"{tok:.0f} tokens/sec, loss={loss:.3f}, "
              f"param shard fraction=1/{full[biggest].numel() // held}",
              flush=True)
    return {"tokens_per_s": tok, "step_ms": dt / args.num_iters * 1e3,
            "losses": [float(x) for x in losses], "loss": loss,
            "model": model, "optimizer": optimizer, "ids": ids}


if __name__ == "__main__":
    main()
