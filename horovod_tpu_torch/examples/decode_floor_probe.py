"""The decode floor probe on the card — the port's counterpart of
``examples/decode_floor_probe.py``.

What bounds small-batch decode when the weights and the cache are far
from the memory roofline? The JAX probe pinned the while loop's fixed
per-iteration cost. On a card the fixed cost of a step is the host's:
each decode step of ``generate()`` launches every layer's kernels from
Python. This probe measures it:

1. **The empty loop** at the decode loop's iteration count
   (``--max-new-tokens`` - 1): one (batch,) float32 add a step, (a) as
   an eager loop (one launch a step, synchronized at the end) and (b) the
   same body captured as one CUDA graph and replayed. (a) is the host's
   floor per launch, (b) the card's per node.
2. **Decode** through ``generate(..., unroll=k)`` for each k of
   ``--unrolls``: k = 1 is the eager loop; k > 1 replays each
   iteration's k steps as one CUDA graph (``models/llama.py``), so the
   host's launches fall away. The first call captures, as a compiled
   program is built; the median of ``--reps`` timed calls after it is
   kept. Tokens are held equal across k.

Each decode rate stands beside the weights-plus-cache roofline: a step
must read every weight it multiplies (the embedding's B rows only) and
every cached K/V row its queries attend, so at the H100 SXM5's HBM3
bandwidth (datasheet, ``utils/timing.H100_SXM_HBM_BYTES_PER_S``) B
tokens take at least (weight bytes + mean cache bytes) / bandwidth.

    python -m horovod_tpu_torch.examples.decode_floor_probe \\
        --model 300m --batch-size 8 [--out PATH] [--serving]

One JSON line per measurement, then the record as the last line;
``--out`` writes it too. ``--serving`` adds the same requests through
the serving engine (its decode step one CUDA graph).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import List, Optional

import numpy as np
import torch

from horovod_tpu_torch.models.llama import (LLAMA_1B, LLAMA_300M,
                                            LLAMA_TINY, LlamaLM, generate)
from horovod_tpu_torch.ops import decode_attention as decode_ops
from horovod_tpu_torch.utils.timing import (H100_SXM_HBM_BYTES_PER_S,
                                            device_label, probe_device,
                                            sync, wall_s)

MODELS = {"tiny": LLAMA_TINY, "300m": LLAMA_300M, "1b": LLAMA_1B}


def measure_empty_loop(iters: int, batch: int, device, reps: int = 5):
    """Median wall seconds of ``iters`` steps of one (batch,) add: the
    eager loop, and (on a card) the same body as one CUDA graph."""
    x = torch.zeros((batch,), dtype=torch.float32, device=device)

    def eager():
        y = x
        for _ in range(iters):
            y = y + 1.0
        return y

    eager()
    out = {"eager_s": statistics.median(
        wall_s(eager, device) for _ in range(reps))}
    if device.type == "cuda":
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            eager()
        torch.cuda.current_stream(device).wait_stream(stream)
        graph.replay()
        out["graph_s"] = statistics.median(
            wall_s(graph.replay, device) for _ in range(reps))
    return out


def measure_decode(model, prompt, new_tokens: int, unroll: int,
                   reps: int = 3, temperature: float = 0.0, seed: int = 1):
    """Median decode rate (tok/s) of ``generate`` at ``unroll``, its
    tokens (from the last call) and the contiguous decode kernel's
    launches over the timed calls."""
    device = prompt.device
    b = prompt.shape[0]

    def call():
        gen = (torch.Generator(device=device).manual_seed(seed)
               if temperature > 0 else None)
        return generate(model, prompt, new_tokens, temperature=temperature,
                        generator=gen, unroll=unroll)

    call()                     # captures the graphs (unroll > 1)
    sync(device)
    before = decode_ops.LAUNCHES["decode_attention"]
    rates, out = [], None
    for _ in range(reps):
        holder = {}
        secs = wall_s(lambda: holder.setdefault("out", call()), device)
        out = holder["out"]
        rates.append(b * new_tokens / secs)
    launches = decode_ops.LAUNCHES["decode_attention"] - before
    return statistics.median(rates), out, launches


def roofline(model, batch: int, prompt_len: int, new_tokens: int):
    """(bytes a decode step must read, tok/s at the HBM bandwidth): the
    weights (the embedding's B rows only) plus the mean K/V rows a step
    attends, over the ``new_tokens`` - 1 decode steps."""
    cfg = model.config
    weights = 0
    for name, p in model.named_parameters():
        if name == "tok_embeddings":
            weights += batch * p.shape[1] * p.element_size()
        else:
            weights += p.numel() * p.element_size()
    head_dim = cfg.dim // cfg.num_heads
    row = 2 * cfg.num_kv_heads * head_dim * torch.tensor(
        [], dtype=cfg.dtype).element_size()          # one K and V row
    steps = max(new_tokens - 1, 1)
    mean_keys = prompt_len + 1 + (steps - 1) / 2     # positions <= index
    cache = batch * cfg.num_layers * row * mean_keys
    per_step = weights + cache
    return per_step, batch / (per_step / H100_SXM_HBM_BYTES_PER_S)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="300m", choices=sorted(MODELS))
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--unrolls", default="1,2,4,8")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--serving", action="store_true",
                    help="also run the batch as requests through the "
                    "serving engine and record its rate beside the bare "
                    "rows")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    device = probe_device(args.device)
    label = device_label(device)
    cfg = MODELS[args.model]
    model = LlamaLM(cfg, device=device, seed=0)
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (args.batch_size, args.prompt_len))).to(device)

    iters = args.max_new_tokens - 1
    floor = measure_empty_loop(iters, args.batch_size, device)
    floor_rec = {"metric": "empty_loop", "iters": iters,
                 "eager_ms_total": floor["eager_s"] * 1e3,
                 "eager_us_per_iter": 1e6 * floor["eager_s"] / iters,
                 "device": label}
    if "graph_s" in floor:
        floor_rec.update(graph_ms_total=floor["graph_s"] * 1e3,
                         graph_us_per_iter=1e6 * floor["graph_s"] / iters)
    print(json.dumps(floor_rec), flush=True)

    step_bytes, roof_tok_s = roofline(model, args.batch_size,
                                      args.prompt_len, args.max_new_tokens)
    rows, launches, baseline, equal = {}, {}, None, True
    for unroll in [int(u) for u in args.unrolls.split(",")]:
        rate, out, n = measure_decode(model, prompt, args.max_new_tokens,
                                      unroll, args.reps)
        if baseline is None:
            baseline = out
        elif not torch.equal(baseline, out):
            equal = False
            print(f"WARNING: unroll={unroll} changed "
                  f"{int((baseline != out).sum())} greedy tokens",
                  file=sys.stderr)
        rows[f"unroll{unroll}"] = rate
        launches[f"unroll{unroll}"] = n
        print(json.dumps({"metric": "decode_tok_s", "unroll": unroll,
                          "tok_s": rate, "pct_of_roofline":
                          100 * rate / roof_tok_s, "decode_launches": n,
                          "device": label}), flush=True)

    record = {
        "what": ("decode floor probe: the empty loop at the decode "
                 "iteration count, eager and as one CUDA graph; "
                 "generate(unroll=k) replays k steps an iteration as a "
                 "graph"),
        "model": args.model, "dtype": str(cfg.dtype).rpartition(".")[2],
        "batch": args.batch_size, "prompt_len": args.prompt_len,
        "max_new_tokens": args.max_new_tokens, "device": label,
        "empty_loop": floor_rec,
        "decode_tok_s": rows, "decode_launches": launches,
        "tokens_equal": equal,
        "roofline_bytes_per_step": step_bytes,
        "roofline_tok_s": roof_tok_s,
        "hbm_bytes_per_s": H100_SXM_HBM_BYTES_PER_S,
        "pct_of_roofline": {k: 100 * v / roof_tok_s
                            for k, v in sorted(rows.items())},
    }
    if args.serving:
        record["serving"] = serving_rate(model, prompt, args, baseline,
                                         rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return {**record, "tokens": baseline}


def serving_rate(model, prompt, args, baseline, rows) -> dict:
    """The probe's batch as ``batch-size`` requests through the serving
    engine (a warm pass, then a timed one)."""
    import time

    from horovod_tpu_torch.serving import ServingConfig
    from horovod_tpu_torch.serving.engine import ServingEngine

    scfg = ServingConfig(
        max_batch=args.batch_size, block_size=16, num_blocks=0,
        queue_depth=max(2 * args.batch_size, 8),
        max_seq_len=args.prompt_len + args.max_new_tokens + 1)
    prompts = prompt.cpu().numpy()
    result = None
    for timed in (False, True):
        engine = ServingEngine(model, config=scfg)
        t0 = time.perf_counter()
        handles = [engine.submit(prompts[i], args.max_new_tokens)
                   for i in range(args.batch_size)]
        engine.run_until_idle()
        secs = time.perf_counter() - t0
        outs = [h.result(timeout=0) for h in handles]
        stats = engine.stats()
        engine.shutdown()
        if timed:
            rate = args.batch_size * args.max_new_tokens / secs
            first = next(iter(rows))
            result = {
                "tok_s": rate, "steps": stats["steps"],
                "preemptions": stats["preemptions"],
                f"vs_bare_{first}": rate / rows[first],
                "tokens_equal_bare": all(
                    list(o) == baseline[i, args.prompt_len:].tolist()
                    for i, o in enumerate(outs))}
    return result


if __name__ == "__main__":
    main()
