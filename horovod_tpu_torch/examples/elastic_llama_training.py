"""Elastic Llama training: data-parallel ``DistributedOptimizer`` steps
under ``hvd.elastic.run`` through a kill and a respawn::

    python -m horovod_tpu_torch.run --elastic -np 2 --min-ranks 1 \\
        --max-ranks 2 --elastic-respawns 1 \\
        python -m horovod_tpu_torch.examples.elastic_llama_training \\
        --model 300m --out /tmp/elastic

Every rank trains float32 Llama (f32 weights and compute, AdamW) on its
own batch, drawn from ``(seed, step, rank)``, and commits
``hvd.elastic.State(step=, model=, optimizer=)`` after every step. Rank
``KILL_RANK`` SIGKILLs itself in step ``KILL_STEP`` (0-based), after
its backward has enqueued the gradient allreduces and before
``optimizer.step()``, unless it is a respawned joiner
(``HOROVOD_ELASTIC_JOIN``), so the joiner does not repeat the kill. The
coordinator re-forms the world without it (epoch 2); rank 0's in-flight
allreduces fail with ``RanksChangedError`` and ``run`` rolls it back to
its last commit. Alone, rank 0 paces each step with a bounded wait for a
joiner (``--pace-seconds``) from its second step on: a world of one
takes the local identity for
every allreduce and would otherwise run away from the joiner, which
spends its start-up importing torch and building the model. The
launcher respawns the slot, the coordinator admits the joiner (epoch 3)
and ``restore()`` takes the p2p path: rank 0 keeps its commit, the
joiner fetches every shard. Both ranks then train ``STEPS_AFTER_GROW``
more steps and stop together. After the grow each rank hashes its commit
under rank 0's layout, for the digests to be held against rank 0's.

Each process writes ``<out>/<role>.json`` (``rank0``, ``rank1``,
``joiner``): its committed schedule (the world size of every committed
step), timings, restores, digest passes, peak memory and flash kernel
launches. Rank 0 also writes its final parameters to ``<out>/final.pt``.
:func:`replay` retrains the schedule in one process, the same batches
through the same arithmetic (gradients summed on the host in rank order,
divided on the device, as the controller does), for the final weights to
be held against.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import config
from horovod_tpu_torch.common.reduction import average
from horovod_tpu_torch.examples import llama_training as lx
from horovod_tpu_torch.ops import attention as flash_ops
from horovod_tpu_torch.utils import checkpoint as ckpt

# The epoch of the grow: epoch 2 is the shrink.
GROW_EPOCH = 3
# The fault: rank KILL_RANK dies in its step KILL_STEP (0-based), after
# two commits.
KILL_RANK = 1
KILL_STEP = 2
# Steps both ranks train after the grow.
STEPS_AFTER_GROW = 2


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=list(lx.CONFIGS), default="300m")
    parser.add_argument("--seq-len", type=int, default=1024)
    parser.add_argument("--batch-size", type=int, default=2,
                        help="per-rank batch")
    parser.add_argument("--device", default=None,
                        help="the card to bind (default cuda:{local rank}); "
                             "'cpu' runs on the CPU")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pace-seconds", type=float, default=4.0,
                        help="bounded wait for a joiner before each step "
                             "of a world of one")
    parser.add_argument("--deadline", type=float, default=200.0,
                        help="wall-clock bound on the whole run")
    parser.add_argument("--out", required=True)
    return parser.parse_args(argv)


def model_config(name: str):
    """The configuration at float32 (weights and compute)."""
    return dataclasses.replace(lx.CONFIGS[name], dtype=torch.float32)


def batch_ids(cfg, step: int, rank: int, batch: int, seq_len: int,
              seed: int, device) -> torch.Tensor:
    """Rank ``rank``'s batch of step ``step``: a pure function of them,
    so a joiner draws the batch its slot would have drawn and a replay
    draws every participant's."""
    rng = np.random.RandomState([seed, step, rank])
    ids = rng.randint(0, cfg.vocab_size, (batch, seq_len))
    return torch.from_numpy(ids).to(device)


def _write(path: str, record: dict) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, path)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    t_start = time.time()
    hvd.init(device=args.device)
    device = hvd.device()
    joiner = config.elastic_join()
    role = "joiner" if joiner else f"rank{hvd.rank()}"
    fragile = not joiner and hvd.rank() == KILL_RANK
    os.makedirs(args.out, exist_ok=True)
    cfg = model_config(args.model)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    t_init = time.time()
    model = lx.make_model(cfg, device=device)
    opt = lx.make_optimizer("adamw", model)
    loss_fn = lx.make_loss_fn(0)
    flash_ops.reset_launch_counts()
    t_model = time.time()
    state = hvd.elastic.State(step=0, model=model, optimizer=opt)
    record = {"role": role, "schedule": {}, "steps": [], "restores": [],
              "started": 0, "t_start": t_start,
              "startup_s": {"init": t_init - t_start,
                            "model": t_model - t_init,
                            "state": time.time() - t_model}}
    grow_entry = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @hvd.elastic.run
    def train(state):
        record["restores"].append(dict(state.last_restore,
                                       t=time.time()))
        if hvd.elastic.epoch() >= GROW_EPOCH:
            grow_entry.setdefault("step", state.step)
            if "digests" not in grow_entry:
                # This rank's commit hashed from its device under rank
                # 0's layout (the digest pass the restore started).
                meta = state.last_restore.get("authority")
                grow_entry["digests"] = state._digests_for(
                    meta["layout"]) if meta else None
                grow_entry["authority"] = meta["digests"] if meta else None
        while True:
            if time.time() - t_start > args.deadline:
                raise RuntimeError(
                    f"{role}: no grow to epoch {GROW_EPOCH} within "
                    f"{args.deadline} s (epoch {hvd.elastic.epoch()}, size "
                    f"{hvd.size()})")
            if hvd.size() == 1 and record["steps"] and \
                    record["steps"][-1]["size"] == 1:
                # A world of one after a step alone: wait for a joiner.
                waited = time.monotonic() + args.pace_seconds
                while hvd.size() == 1 and time.monotonic() < waited:
                    time.sleep(0.05)
            n, epoch = hvd.size(), hvd.elastic.epoch()
            if "step" in grow_entry and epoch >= GROW_EPOCH and \
                    state.step >= grow_entry["step"] + STEPS_AFTER_GROW:
                return state.step
            record["started"] += 1
            t0 = time.perf_counter()
            ids = batch_ids(cfg, state.step, hvd.rank(), args.batch_size,
                            args.seq_len, args.seed, device)
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model, ids)
            loss.backward()
            if fragile and state.step == KILL_STEP:
                sync()
                _write(os.path.join(args.out, "kill.json"), {
                    "t_kill": time.time(), "step": state.step,
                    "launches": dict(flash_ops.LAUNCHES)})
                os.kill(os.getpid(), signal.SIGKILL)
            opt.step()
            sync()
            state.step += 1
            state.commit()
            record["schedule"][state.step - 1] = n
            record["steps"].append({
                "step": state.step - 1, "size": n, "epoch": epoch,
                "loss": float(loss.detach()), "seconds": time.perf_counter() - t0,
                "t_done": time.time()})

    final_step = train(state)
    ctl = basics.controller()
    record.update({
        "final_step": final_step, "epoch": hvd.elastic.epoch(),
        "size": hvd.size(), "rank": hvd.rank(),
        "schedule": [record["schedule"].get(s) for s in range(final_step)],
        "launches": dict(flash_ops.LAUNCHES),
        "digest_seconds": [s for _, s in state.digest_seconds],
        "grow_entry": grow_entry,
        "reshapes": list(getattr(ctl, "reshapes", [])),
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
        "commit_bytes": sum(ckpt.leaf_nbytes(x)
                            for x in state._flat_commit()[0]
                            if ckpt.is_array(x)),
    })
    if hvd.rank() == 0:
        torch.save({k: v.detach().cpu() for k, v in
                    model.named_parameters()},
                   os.path.join(args.out, "final.pt"))
    _write(os.path.join(args.out, f"{role}.json"), record)
    state.close()
    hvd.shutdown()
    return record


def replay(model_name: str, schedule: List[int], batch: int, seq_len: int,
           seed: int, device) -> Dict[str, torch.Tensor]:
    """One process retrains ``schedule`` (the world size of each
    committed step): the participants' gradients summed on the host in
    rank order and divided on the device, as the controller reduces
    them, then the same AdamW step. Returns the final parameters."""
    cfg = model_config(model_name)
    model = lx.make_model(cfg, device=device)
    params = list(model.parameters())
    # lx.make_optimizer's AdamW, without the DistributedOptimizer wrapper.
    opt = lx.make_inner_optimizer("adamw", params)
    loss_fn = lx.make_loss_fn(0)
    for step, n in enumerate(schedule):
        grads = []
        for rank in range(n):
            for p in params:
                p.grad = None
            ids = batch_ids(cfg, step, rank, batch, seq_len, seed, device)
            loss_fn(model, ids).backward()
            grads.append([p.grad.detach().clone() for p in params])
        for i, p in enumerate(params):
            # The host's float32 sum in rank order: the same additions,
            # so the same bits, wherever they run.
            acc = grads[0][i]
            for peer in grads[1:]:
                acc = acc + peer[i]
            p.grad = average(acc, n) if n > 1 else acc
        del grads
        opt.step()
    return {k: v.detach().cpu() for k, v in model.named_parameters()}


if __name__ == "__main__":
    main()
