"""Mixture-of-experts training over a data x expert layout of ranks — the
counterpart of ``examples/jax_moe_training.py``:

    python -m horovod_tpu_torch.examples.moe_training --steps 100

A two-layer MLP whose hidden layer is a top-k MoE: one expert per rank of
an expert group (``parallel.moe.moe_apply``, tokens exchanged with
``alltoall``), the Switch load-balancing loss in the objective, Adam.
With n ranks, ep = 4, 2 or 1 (the largest that divides n) ranks form
each expert group and dp = n / ep groups split the data; the process
groups come from ``torch.distributed.new_group``. Ranks d*ep .. d*ep +
ep - 1 form expert group d and share its data rows; rank d*ep + e holds
expert e.

The objective is the mean over ranks of each rank's loss. Its gradient:
a replicated parameter (gate, head) sums every rank's gradient; an
expert's already holds its expert group's contributions (the
``alltoall`` backward brings them) and sums over the data groups; both
then divide by n. Under a launcher environment (``HOROVOD_RANK``, ...)
on the card the groups run over NCCL; ``init(device="cpu")`` first runs
them over gloo.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel.moe import moe_apply, moe_apply_dense


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--tokens-per-device", type=int, default=1024)
    parser.add_argument("--d-model", type=int, default=128)
    parser.add_argument("--d-hidden", type=int, default=256)
    parser.add_argument("--num-selected", type=int, default=2)
    parser.add_argument("--capacity-factor", type=float, default=1.25)
    parser.add_argument("--aux-weight", type=float, default=0.01)
    parser.add_argument("--lr", type=float, default=1e-3)
    return parser.parse_args(argv)


def layout(n: int):
    """(ep, dp) as the JAX example picks them from the device count."""
    ep = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return ep, n // ep


def make_groups(ep: int, dp: int):
    """This rank's (expert group, data group). Every rank creates every
    group, in one order, as ``new_group`` requires."""
    rank = hvd.rank()
    expert = data = None
    for d in range(dp):
        g = dist.new_group(list(range(d * ep, (d + 1) * ep)))
        if rank // ep == d:
            expert = g
    for e in range(ep):
        g = dist.new_group(list(range(e, dp * ep, ep)))
        if rank % ep == e:
            data = g
    return expert, data


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init()
    device = hvd.device()
    n, rank = hvd.size(), hvd.rank()
    ep, dp = layout(n)
    if rank == 0:
        print(f"layout: data={dp} x expert={ep} "
              f"({ep} experts, one per rank)", flush=True)
    expert_group = data_group = None
    if n > 1:
        expert_group, data_group = make_groups(ep, dp)

    # The JAX example's draws, in its order.
    rng = np.random.RandomState(0)
    d, h = args.d_model, args.d_hidden
    wi = rng.randn(ep, d, h) / np.sqrt(d)
    wo = rng.randn(ep, h, d) / np.sqrt(h)
    gate = rng.randn(d, ep) * 0.02
    head = rng.randn(d, d) / np.sqrt(d)
    tokens = dp * args.tokens_per_device
    x_all = rng.randn(tokens, d)
    w_true = rng.randn(d, d) / np.sqrt(d)

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    mine = slice(rank % ep, rank % ep + 1) if ep > 1 else slice(None)
    params = {"wi": tensor(wi[mine]), "wo": tensor(wo[mine]),
              "gate": tensor(gate), "head": tensor(head)}
    for p in params.values():
        p.requires_grad_(True)
    row = rank // ep
    rows = slice(row * args.tokens_per_device,
                 (row + 1) * args.tokens_per_device)
    x = tensor(x_all[rows])
    y = x @ tensor(w_true)

    def expert_fn(p, t):
        return torch.bmm(F.gelu(torch.bmm(t, p["wi"]), approximate="tanh"),
                         p["wo"])

    kwargs = dict(capacity_factor=args.capacity_factor,
                  num_selected=args.num_selected)

    def local_loss():
        experts = {"wi": params["wi"], "wo": params["wo"]}
        if expert_group is None:
            moe_out, aux = moe_apply_dense(expert_fn, experts, x,
                                           x @ params["gate"], **kwargs)
        else:
            moe_out, aux = moe_apply(expert_fn, experts, x,
                                     x @ params["gate"], group=expert_group,
                                     **kwargs)
        pred = (x + moe_out) @ params["head"]
        return torch.mean((pred - y) ** 2) + args.aux_weight * aux

    opt = torch.optim.Adam(list(params.values()), lr=args.lr)

    def step() -> float:
        opt.zero_grad(set_to_none=True)
        loss = local_loss()
        loss.backward()
        with torch.no_grad():
            if n > 1:
                for name, p in sorted(params.items()):
                    group = data_group if name in ("wi", "wo") else None
                    dist.all_reduce(p.grad, group=group)
                    p.grad.div_(n)
                total = loss.detach().clone()
                dist.all_reduce(total)
                loss = total / n
        opt.step()
        return float(loss)

    losses = [step()]
    t0 = time.perf_counter()
    for i in range(1, args.steps):
        losses.append(step())
        if i % 20 == 0 and rank == 0:
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    elapsed = time.perf_counter() - t0
    rate = tokens * (args.steps - 1) / elapsed if args.steps > 1 else 0.0
    if rank == 0:
        print(f"final loss {losses[-1]:.4f}; "
              f"{rate:,.0f} tokens/sec through {ep} experts", flush=True)
    return {"losses": losses, "tokens_per_s": rate, "ep": ep, "dp": dp}


if __name__ == "__main__":
    main()
