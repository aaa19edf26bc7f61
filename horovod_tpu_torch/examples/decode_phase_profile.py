"""KV-cache decode per-phase time accounting — the port's counterpart of
``examples/decode_phase_profile.py``.

Profiles ``generate()`` (one prefill, then a Python loop of single-token
steps: the JAX package's ``lax.scan``) under ``hvd.profiler.trace`` and
buckets every kernel (every op on the CPU) by its provenance, the
profiler labels the model carries (``utils/hlo_phases.kernel_rows``):
the decode steps' work, divided by the step count, apart from the
prefill. Attention time buckets per decode path through the
``hvd.decode.*`` labels, so the trace shows which path ran.

``--engine`` profiles the serving engine's paged decode step instead, at
``--batch-size`` slots: an eager step (labelled, so it buckets by
provenance and gives the decode-path markers) and, on a card, the step
the engine captured as a CUDA graph (a replay carries no labels: its
kernels bucket by name; its step time against its device time is the
graph's gain).

Run: python -m horovod_tpu_torch.examples.decode_phase_profile \\
         --model 300m --batch-size 8 [--engine] [--device cpu]

Keys the port names differently from the JAX table, listed beside its
PHASES below: the cache writes run in a ``cache_update`` scope (JAX:
``dynamic_update_slice``), a decode step's body is the ``decode_step``
scope (JAX: ``while``/``scan``), the paged paths ``hvd.decode.paged[_tp]``
bucket with the kernel paths, the MoE routing is the ``router`` scope and
the aten names (``topk``, ``bmm``), sampling is ``multinomial``.
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
from horovod_tpu_torch.utils.comm_accounting import decode_path_markers
from horovod_tpu_torch.utils.hlo_phases import (Timeline, add_to_bucket,
                                                finalize_buckets,
                                                kernel_rows, newest_trace)

# Ordered; first hit wins (the JAX table, with the port's keys beside).
PHASES = (
    ("cache_update", ("cache_update", "dynamic_update_slice")),
    ("qkvo_proj", ("/wq/", "/wk/", "/wv/", "/wo/")),
    ("attention_kernel_tp", ("hvd.decode.kernel_tp",
                             "hvd.decode.paged_tp")),
    ("attention_kernel", ("hvd.decode.kernel", "hvd.decode.paged")),
    ("attention_einsum", ("hvd.decode.einsum",)),
    ("attention_prefill", ("hvd.decode.prefill",)),
    ("attention_cache", ("/attention/", "flash", "rotary", "dynamic_slice")),
    ("norm", ("attention_norm", "ffn_norm", "final_norm", "norm")),
    ("ffn", ("/w_gate/", "/w_up/", "/w_down/", "silu")),
    ("lm_head_embed", ("lm_head", "embed", "one_hot")),
    ("sampling", ("argmax", "categorical", "random", "threefry",
                  "reduce_max", "pick", "multinomial")),
)

# Routed-FFN sub-buckets (everything under the moe_ffn scope).
MOE_SUB = (
    ("moe_route", ("router", "cumsum", "sort", "one_hot", "top_k", "topk",
                   "argmax", "softmax", "iota", "arange")),
    ("moe_expert", ("dot_general", "aten::bmm", "silu")),
)

# Kernel-name buckets of a graph replay, whose kernels carry no labels.
KERNEL_SPLIT = (
    ("decode_kernel", lambda n: "decode_kernel" in n),
    ("matmul", lambda n: any(t in n for t in ("nvjet", "gemm", "gemv",
                                              "cutlass", "xmma"))))


def classify(tf_op_name: str) -> str:
    if "moe_ffn" in tf_op_name:
        for phase, keys in MOE_SUB:
            if any(k in tf_op_name for k in keys):
                return phase
        return "moe_dispatch_combine"
    for phase, keys in PHASES:
        if any(k in tf_op_name for k in keys):
            return phase
    return "other"


def _model(name: str, device):
    from horovod_tpu_torch.models.llama import (LLAMA_1B, LLAMA_300M,
                                                LLAMA_TINY, LlamaLM)
    from horovod_tpu_torch.models.moe_lm import MOE_SMALL, MOE_TINY, MoeLM

    cfg = {"tiny": LLAMA_TINY, "300m": LLAMA_300M, "1b": LLAMA_1B,
           "moe_tiny": MOE_TINY, "moe_small": MOE_SMALL}[name]
    cls = MoeLM if name.startswith("moe") else LlamaLM
    return cls(cfg, device=device, seed=0)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def capture(model_name: str, batch: int, prompt_len: int, new_tokens: int,
            trace_dir: str, device=None) -> str:
    from horovod_tpu_torch.models.llama import generate

    model = _model(model_name, device)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, model.config.vocab_size,
                                       (batch, prompt_len)))
    out = generate(model, ids, max_new_tokens=new_tokens)   # warm
    int(out[0, -1])
    t0 = time.perf_counter()
    with hvd.profiler.trace(trace_dir) as path:
        out = generate(model, ids, max_new_tokens=new_tokens)
        int(out[0, -1])
    wall = time.perf_counter() - t0
    print(f"capture b{batch} p{prompt_len} n{new_tokens}: "
          f"{batch * new_tokens / wall:.0f} tok/s during trace",
          file=sys.stderr)
    return path


def phase_table(trace, new_tokens: int, dump: bool = False) -> dict:
    """Two tables: the decode steps' ops (per-token work, over the
    ``new_tokens - 1`` steps) and everything else (the prefill and the
    once-per-call work)."""
    body, prefill = {}, {}
    body_total = other_total = 0.0
    iters = max(new_tokens - 1, 1)
    for row in kernel_rows(trace):
        op = row["tf_op_name"]
        in_body = "decode_step" in op
        phase = classify(op)
        t_ms = row["self_ms"]
        if in_body:
            t_ms /= iters
            body_total += t_ms
        else:
            other_total += t_ms
        add_to_bucket(body if in_body else prefill, phase, t_ms, row)
        if dump and t_ms > (0.01 if in_body else 0.3):
            where = "BODY" if in_body else "pre "
            print(f"{where} {phase:16s} {t_ms:7.3f}ms {op[-100:]}",
                  file=sys.stderr)
    return {
        "decode_ms_per_step": round(body_total, 4),
        "prefill_plus_once_ms": round(other_total, 2),
        "decode_phases": finalize_buckets(body),
        "prefill_phases": finalize_buckets(prefill),
    }


def _engine_steps(model, batch: int, prompt_len: int, steps: int,
                  trace_dir: str, eager: bool) -> dict:
    """Fill ``batch`` slots, then time ``steps`` decode steps without the
    profiler and ``steps`` more under it."""
    from horovod_tpu_torch import serving
    from horovod_tpu_torch.serving import engine as engine_mod

    device = model.device
    scfg = serving.ServingConfig(
        max_batch=batch, block_size=16, num_blocks=0, queue_depth=batch,
        max_seq_len=prompt_len + 2 * steps + 24)
    if eager:
        with engine_mod._eager_decode():
            engine = serving.ServingEngine(model, scfg)
    else:
        engine = serving.ServingEngine(model, scfg)
    rng = np.random.RandomState(3)
    for _ in range(batch):
        engine.submit(rng.randint(0, model.config.vocab_size, prompt_len),
                      2 * steps + 16)
    for _ in range(3):                       # prefill all, then decode
        engine.step()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    _sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with hvd.profiler.trace(trace_dir) as path:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        _sync(device)
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    graphed = engine._graphs is not None
    engine.shutdown()
    return {"trace": path, "step_ms": step_ms, "profiled_ms": profiled_ms,
            "graphed": graphed}


def engine_profile(model_name: str, batch: int, prompt_len: int,
                   steps: int, trace_dir: str, device=None,
                   dump: bool = False, model=None) -> dict:
    """The engine's decode step, eager (labelled: buckets and markers)
    and, on a card, as its CUDA graph (kernel names only). ``model``: a
    model already built (else ``model_name``'s, from seed 0)."""
    from horovod_tpu_torch.utils.hlo_phases import step_split

    model = model if model is not None else _model(model_name, device)
    eager = _engine_steps(model, batch, prompt_len, steps, trace_dir, True)
    tl = Timeline(eager["trace"])
    table = phase_table(tl, steps + 1, dump=dump)
    rows = list(kernel_rows(tl))
    out = {"eager": {
        **step_split(rows, steps, KERNEL_SPLIT, eager["step_ms"],
                     eager["profiled_ms"]),
        "launches_per_step": _launches(rows) / steps,
        "decode_ms_per_step": table["decode_ms_per_step"],
        "decode_phases": table["decode_phases"],
        "markers": decode_path_markers(tl)}}
    if model.device.type == "cuda":
        graph = _engine_steps(model, batch, prompt_len, steps, trace_dir,
                              False)
        if not graph["graphed"]:
            raise RuntimeError("the engine did not capture its decode step")
        grows = list(kernel_rows(graph["trace"]))
        out["graph"] = {
            **step_split(grows, steps, KERNEL_SPLIT, graph["step_ms"],
                         graph["profiled_ms"]),
            "launches_per_step": _launches(grows) / steps}
    return out


def _launches(rows) -> int:
    """Kernel launches (copies and fills left out)."""
    return sum(r["occurrences"] for r in rows
               if not r["hlo_op_name"].startswith(("Memcpy", "Memset")))


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="300m",
                    choices=["tiny", "300m", "1b", "moe_tiny",
                             "moe_small"])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=256,
                    help="tokens generated in the capture; ALSO the "
                    "per-step divisor of the decode steps' times — when "
                    "analyzing an existing --trace, pass the value the "
                    "trace was captured with")
    ap.add_argument("--engine", action="store_true",
                    help="profile the serving engine's paged decode step "
                    "(eager and, on a card, its CUDA graph)")
    ap.add_argument("--steps", type=int, default=20,
                    help="--engine: decode steps timed and profiled")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--trace", default=None,
                    help="analyze this torch.profiler trace (a JSON file "
                    "or a directory: its newest trace) instead of "
                    "capturing one")
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    device = hvd.default_device(args.device)
    trace_dir = args.trace_dir or os.path.join(
        tempfile.gettempdir(),
        f"decode_trace_{args.model}_b{args.batch_size}")
    out = {"model": args.model, "batch": args.batch_size,
           "prompt_len": args.prompt_len}
    if args.engine:
        out.update(steps=args.steps, **engine_profile(
            args.model, args.batch_size, args.prompt_len, args.steps,
            trace_dir, device, args.dump))
    else:
        trace = args.trace
        if trace and os.path.isdir(trace):
            trace = newest_trace(trace)
        trace = trace or capture(args.model, args.batch_size,
                                 args.prompt_len, args.max_new_tokens,
                                 trace_dir, device)
        tl = Timeline(trace)
        out.update(max_new_tokens=args.max_new_tokens, trace=trace,
                   markers=decode_path_markers(tl),
                   **phase_table(tl, args.max_new_tokens, dump=args.dump))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(_summary(out)))
    return out


def _summary(out: dict) -> dict:
    """The record with each phase table reduced to its ms."""
    def walk(d: dict) -> dict:
        # hvdlint: disable=HVD002 (a printed summary, no rank walks it)
        return {k: ({p: b["ms"] for p, b in v.items()}
                    if k.endswith("phases") else
                    walk(v) if isinstance(v, dict) else v)
                # hvdlint: disable=HVD002 (a printed summary, no rank walks it)
                for k, v in d.items()}

    # hvdlint: disable=HVD002 (a printed summary, no rank walks it)
    return walk({k: v for k, v in out.items() if k != "trace"})


if __name__ == "__main__":
    main()
    sys.exit(0)
