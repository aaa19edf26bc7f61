"""Seeded open-loop load generator for the port's serving tier — the
counterpart of ``examples/serving_loadgen.py``, with the same flags
(plus ``--device``) and the same JSON record:

    python -m horovod_tpu_torch.examples.serving_loadgen --model tiny \
        --requests 320 --seed 11 --rate 30 --prefix-share 8 \
        --prefix-len 192 --min-prompt 200 --max-prompt 224 --min-new 16 \
        --max-new 32 --max-seq-len 256 --replicas 3 --chaos-kill

The workload is a pure function of its arguments (``build_trace``, the
JAX example's, number for number): exponential inter-arrival gaps at
``--rate`` requests/sec (0 = one burst at t=0), prompt lengths uniform
over ``[--min-prompt, --max-prompt]``, output budgets uniform over
``[--min-new, --max-new]``; with ``--prefix-share K``, each prompt is one
of K seeded shared prefixes plus a unique tail, and the record splits
TTFT warm vs cold and carries a no-sharing baseline measured on the same
trace. ``--replicas N`` drives a fleet router over N engines (one model,
its weights on the card once); ``--chaos-kill`` hard-kills the busiest
replica once half the trace is submitted, and the bar is ``failed ==
0``. An unmeasured warm-up pass over the whole trace comes first (the
kernels build and the allocator warms there) unless ``--no-warmup``.

The record's ``substrate`` is the device the model ran on (``cuda`` or
``cpu``), and ``path``/``path_reason`` the engine's ``DecodePath``.
``health`` is the cluster doctor's summary over the measured run
(``hvd.doctor.summary()``), as in the JAX record.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np

from horovod_tpu_torch import doctor, metrics
from horovod_tpu_torch.serving import (RejectedError, Router, RouterConfig,
                                       ServingConfig, ServingEngine)
from horovod_tpu_torch.serving.engine import _pctl as exact_percentile


def build_trace(seed: int, requests: int, rate: float, min_prompt: int,
                max_prompt: int, min_new: int, max_new: int,
                vocab_size: int, prefix_share: int = 0,
                prefix_len: int = 32):
    """The deterministic workload: [(arrival_s, prompt_ids, new_tokens)].
    Pure function of the arguments (the fixed arrival trace). With
    ``prefix_share`` K > 0, each prompt is one of K seeded shared prefixes (``prefix_len`` tokens, page-aligned by default)
    plus a unique tail; total lengths still land in
    ``[min_prompt, max_prompt]`` (floored at ``prefix_len + 1`` so every
    prompt has a tail)."""
    rng = np.random.RandomState(seed)
    shared = [rng.randint(0, vocab_size, (prefix_len,)).astype(np.int32)
              for _ in range(prefix_share)]
    t = 0.0
    trace = []
    for i in range(requests):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        plen = int(rng.randint(min_prompt, max_prompt + 1))
        new = int(rng.randint(min_new, max_new + 1))
        if shared:
            plen = max(plen, prefix_len + 1)
            tail = rng.randint(0, vocab_size,
                               (plen - prefix_len,)).astype(np.int32)
            prompt = np.concatenate([shared[i % prefix_share], tail])
        else:
            prompt = rng.randint(0, vocab_size, (plen,)).astype(np.int32)
        trace.append((t, prompt, new))
    return trace


def run_workload(engine, trace, timeout_s: float = 600.0,
                 kill_after: int = 0, kill_fn=None):
    """Replay the trace open-loop against a started engine or router.
    Returns ``(handles, rejected, failed, wall_seconds)`` — rejected
    submissions are counted, not retried (open loop: the client does not
    slow down); ``failed`` counts requests that never produced a full
    result (the fleet acceptance bar is failed == 0). ``kill_fn`` (chaos)
    runs once, right after the ``kill_after``-th successful
    submission."""
    handles = []
    rejected = 0
    failed = 0
    t0 = time.monotonic()
    for arrival, prompt, new in trace:
        now = time.monotonic() - t0
        if arrival > now:
            time.sleep(arrival - now)
        try:
            handles.append(engine.submit(prompt, new))
        except RejectedError:
            rejected += 1
        if kill_fn is not None and len(handles) == kill_after:
            kill_fn()
            kill_fn = None
    for handle in handles:
        try:
            handle.result(timeout=timeout_s)
        except (RuntimeError, TimeoutError):
            failed += 1   # counted honestly; the record stays loud
    return handles, rejected, failed, time.monotonic() - t0


def _pctl(values, q):
    """The repo's exact-list percentile (one 'p99' definition)."""
    est = exact_percentile(sorted(values), q)
    return round(est, 6) if est is not None else None


def _ttft_split(handles):
    """(warm, cold) TTFT lists from finished handles — warm = the
    request's last admission mapped at least one page from the prefix
    cache."""
    warm, cold = [], []
    for handle in handles:
        ttft = handle.ttft_seconds()
        if ttft is None:
            continue
        (warm if handle.warm_pages > 0 else cold).append(ttft)
    return warm, cold


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny",
                    choices=["tiny", "300m", "1b"])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="mean arrivals/sec (0 = burst at t=0)")
    ap.add_argument("--min-prompt", type=int, default=16)
    ap.add_argument("--max-prompt", type=int, default=64)
    ap.add_argument("--min-new", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="0 = fully provisioned")
    ap.add_argument("--queue-depth", type=int, default=128)
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--prefix-share", type=int, default=0,
                    help="K shared system prompts x unique tails "
                         "(0 = every prompt unique)")
    ap.add_argument("--prefix-len", type=int, default=32,
                    help="shared prefix length in tokens "
                         "(page-aligned by default)")
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1 = drive a fleet router over N replicas")
    ap.add_argument("--chaos-kill", action="store_true",
                    help="hard-kill one replica at half the trace "
                         "(needs --replicas >= 2)")
    ap.add_argument("--f32", action="store_true",
                    help="run the model in f32 (exact cross-path parity)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the unmeasured warm-up pass")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="also write the JSON record here")
    args = ap.parse_args(argv)
    if args.chaos_kill and args.replicas < 2:
        ap.error("--chaos-kill needs --replicas >= 2")
    return args


def main(argv: Optional[List[str]] = None) -> Dict:
    import torch

    from horovod_tpu_torch.models.llama import (LLAMA_1B, LLAMA_300M,
                                                LLAMA_TINY, LlamaLM)

    args = parse_args(argv)
    cfg = {"tiny": LLAMA_TINY, "300m": LLAMA_300M,
           "1b": LLAMA_1B}[args.model]
    if args.f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = LlamaLM(cfg, device=args.device, seed=0)
    scfg = ServingConfig(
        max_batch=args.max_batch, block_size=args.block_size,
        num_blocks=args.num_blocks, queue_depth=args.queue_depth,
        max_seq_len=args.max_seq_len)

    trace = build_trace(args.seed, args.requests, args.rate,
                        args.min_prompt, args.max_prompt, args.min_new,
                        args.max_new, cfg.vocab_size,
                        prefix_share=args.prefix_share,
                        prefix_len=args.prefix_len)

    def make_backend(serving_config):
        """One started engine, or a router over N of them (all over the
        one model)."""
        if args.replicas > 1:
            engines = [ServingEngine(model, config=serving_config)
                       for _ in range(args.replicas)]
            router = Router(engines, RouterConfig(
                replicas=args.replicas))
            for engine in engines:
                engine.start()
            return router
        return ServingEngine(model, config=serving_config).start()

    if not args.no_warmup:
        # Unmeasured pass over the same trace (kernel build, allocator,
        # cuBLAS handles). Metrics stay off here and the backend is gone
        # before the measured one exists: the record describes the
        # measured run only.
        warm = make_backend(scfg)
        run_workload(warm, trace)
        warm.shutdown()
        del warm

    baseline = None
    if args.prefix_share > 0:
        # The no-sharing control on the SAME trace, before metrics turn
        # on: peak blocks and TTFT if every prompt prefilled cold.
        off = make_backend(dataclasses.replace(scfg, prefix_cache=False))
        off_handles, _, _, off_wall = run_workload(off, trace)
        off_stats = off.stats()
        off.shutdown()
        baseline = {
            "blocks_peak": off_stats["blocks_peak"],
            "blocks_live_peak": off_stats["blocks_live_peak"],
            "ttft_p50_s": off_stats["ttft_p50_seconds"],
            "ttft_p99_s": off_stats["ttft_p99_seconds"],
            "wall_s": round(off_wall, 3),
        }
        del off, off_handles

    metrics.enable()  # the gauges feed the doctor's serving verdict
    backend = make_backend(scfg)
    if args.replicas > 1:
        path = backend.engines()[0].decode_path
    else:
        path = backend.decode_path

    kill_fn = None
    killed_replica = None
    if args.chaos_kill:
        def kill_fn():
            nonlocal killed_replica
            # Hard-kill (engine shutdown, not a router drain): the
            # busiest replica, so the replay path actually runs.
            health = backend.health()
            live = [rid for rid, h in sorted(health.items())
                    if h["alive"]]
            victim = max(live, key=lambda rid:
                         health[rid]["active_sequences"])
            killed_replica = victim
            backend.engine(victim).shutdown()

    handles, rejected, failed, wall = run_workload(
        backend, trace, kill_after=max(1, len(trace) // 2),
        kill_fn=kill_fn)
    stats = backend.stats()
    health = doctor.summary()
    warm_ttfts, cold_ttfts = _ttft_split(handles)
    backend.shutdown()

    contiguous_blocks = args.replicas * scfg.max_batch * (
        (scfg.max_seq_len + scfg.block_size - 1) // scfg.block_size)
    record = {
        "metric": "serving_loadgen",
        "value": (round(stats["tokens_generated"] / wall, 1)
                  if wall > 0 else None),
        "unit": "decode tok/s",
        "model": args.model, "requests": args.requests,
        "seed": args.seed, "rate_per_s": args.rate,
        "prompt_lens": [args.min_prompt, args.max_prompt],
        "new_tokens": [args.min_new, args.max_new],
        "prefix_share": args.prefix_share,
        "prefix_len": args.prefix_len if args.prefix_share else None,
        "replicas": args.replicas,
        "chaos_kill": bool(args.chaos_kill),
        "killed_replica": killed_replica,
        "substrate": model.device.type,
        "path": path.path, "path_reason": path.reason,
        "wall_s": round(wall, 3),
        "ttft_p50_s": stats["ttft_p50_seconds"],
        "ttft_p99_s": stats["ttft_p99_seconds"],
        "ttft_warm_p50_s": _pctl(warm_ttfts, 0.5),
        "ttft_warm_p99_s": _pctl(warm_ttfts, 0.99),
        "ttft_cold_p50_s": _pctl(cold_ttfts, 0.5),
        "ttft_cold_p99_s": _pctl(cold_ttfts, 0.99),
        "warm_requests": len(warm_ttfts),
        "cold_requests": len(cold_ttfts),
        "tpot_p50_s": stats["tpot_p50_seconds"],
        "tpot_p99_s": stats["tpot_p99_seconds"],
        # Client truth (a router aggregate only sums LIVE replicas, so
        # after a chaos kill the engine-side count would undercount).
        "finished": len(handles) - failed,
        "rejected": rejected,
        "failed": failed,
        "preemptions": stats["preemptions"],
        "steps": stats["steps"],
        "blocks_peak": stats["blocks_peak"],
        "blocks_live_peak": stats["blocks_live_peak"],
        "blocks_total": stats["blocks_total"],
        "blocks_contiguous_equiv": contiguous_blocks,
        "paged_vs_contiguous_peak": (
            round(stats["blocks_peak"] / contiguous_blocks, 4)
            if contiguous_blocks else None),
        "prefix_hits": stats["prefix_hits"],
        "prefix_misses": stats["prefix_misses"],
        "prefix_hit_rate": stats["prefix_hit_rate"],
        "cow_copies": stats["cow_copies"],
        "baseline_no_sharing": baseline,
        "router": ({
            "replicas_live": stats["router_replicas"],
            "requests": stats["router_requests"],
            "reroutes": stats["router_reroutes"],
            "departures": stats["router_replica_departures"],
        } if args.replicas > 1 else None),
        "health": health,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
