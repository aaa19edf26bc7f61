#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` with
``nvcc`` and runs every phase on ``cuda``; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``) and the build time;
2. each decode kernel against its plain torch version, in float32 and
   bfloat16, at the serving slice's attention shape (Llama-300M: H=16,
   Hkv=8, D=64, b=8, window 256, paged block 16) and at Llama-8B's
   (H=32, Hkv=8, D=128, b=8, window 4096), plus a scrambled block table
   against the identity table, bitwise. Times (CUDA events, median over
   launches, L2 flushed before each) of the kernel, the plain version and
   ``scaled_dot_product_attention`` on the gathered window (a yardstick
   only; the port never calls it), beside the memory/compute bound;
3. ``generate()`` at Llama-300M full width and depth in float32
   (TF32 off), b=8, prompt 128, 32 new tokens: tokens equal those of
   ``decode_kernel_disabled()``, and the contiguous kernel launched
   16 layers x 31 steps times;
4. ``ServingEngine`` at Llama-300M in float32 over 12 mixed requests:
   each request's tokens equal ``generate()`` alone, and the paged
   kernel launched 16 x steps times;
5. the same engine in bfloat16, timed: tokens/s, TTFT p50, TPOT p50.

The line before the last is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}
SOURCE = "horovod_tpu_torch/csrc/decode_attention.cu"
REPLACES = {
    "decode_attention": "horovod_tpu/ops/decode_attention.py:47",
    "paged_decode_attention": "horovod_tpu/ops/decode_attention.py:217",
}
LAYERS = 16                          # Llama-300M


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing


def time_ms(fn, flush, repeats: int = 25) -> float:
    """Median device time of ``fn()`` over ``repeats`` calls, each timed
    alone with CUDA events after the L2 was flushed (a decode step finds
    each layer's cache cold)."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, ops: int, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, dtype: str, what: str):
    """Max abs/rel error; raise if outside the stated tolerance."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = TOL[dtype]
    limit = tol["atol"] + tol["rtol"] * want.abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    if not bool(torch.isfinite(got).all()) or bool((err > limit).any()):
        raise AssertionError(
            f"{what}: kernel disagrees with plain (max abs {max_abs:.3g}, "
            f"max rel {max_rel:.3g}, tolerance {tol})")
    return max_abs, max_rel


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions


def kernel_cases():
    """Yield (label, dtype, shape dict): the serving slice's attention
    shape, and Llama-8B's attention width at a 4096 window."""
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        yield ("llama300m", dtype,
               dict(b=8, h=16, hkv=8, d=64, window=256, bs=16,
                    lens=[0, 15, 16, 47, 100, 191, 240, 255]))
        yield ("llama8b", dtype,
               dict(b=8, h=32, hkv=8, d=128, window=4096, bs=16,
                    lens=[0, 15, 511, 1023, 2047, 3000, 4000, 4095]))


def check_kernels(device, flush):
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import decode_attention as ops

    results = {}
    for label, dtype, s in kernel_cases():
        dname = str(dtype).replace("torch.", "")
        itemsize = torch.tensor([], dtype=dtype).element_size()
        b, h, hkv, d, window, bs = (s["b"], s["h"], s["hkv"], s["d"],
                                    s["window"], s["bs"])
        f = hkv * d
        gen = torch.Generator(device=device).manual_seed(0)

        def randn(*shape):
            return (torch.randn(*shape, generator=gen, device=device)
                    * 0.5).to(dtype)

        q = randn(b, 1, h, d)
        k = randn(b, window, f)
        v = randn(b, window, f)
        scale = d ** -0.5

        # Contiguous kernel at a mid index and at the last row.
        for idx in (window // 2 + 3, window - 1):
            got = ops.decode_attention(q, k, v, idx, hkv)
            want = ops.decode_attention_plain(q, k, v, idx, hkv)
            torch.cuda.synchronize()
            err = compare(got, want, dname,
                          f"decode_attention {label} {dname} idx={idx}")
        idx = window - 1
        k_win = k.view(b, window, hkv, d).transpose(1, 2)
        v_win = v.view(b, window, hkv, d).transpose(1, 2)
        q_sdpa = q.transpose(1, 2)
        n_rows = b * (idx + 1)
        c_bytes = (2 * n_rows * f + 2 * b * h * d) * itemsize
        c_ops = 4 * n_rows * h * d
        c_bound, c_by = bound(c_bytes, c_ops, dname)
        row = dict(
            name="decode_attention", shape=label, dtype=dname,
            max_abs_err=err[0], max_rel_err=err[1],
            tolerance=TOL[dname],
            ms=time_ms(lambda: ops.decode_attention(q, k, v, idx, hkv),
                       flush),
            plain_ms=time_ms(
                lambda: ops.decode_attention_plain(q, k, v, idx, hkv),
                flush),
            bound_ms=c_bound, bound_by=c_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q_sdpa, k_win, v_win, scale=scale, enable_gqa=True),
                flush))
        log(f"kernel {json.dumps(row)}")
        results[("decode_attention", label, dname)] = row

        # Paged kernel over a scrambled pool, against the identity table.
        slots = window // bs
        lens = torch.tensor(s["lens"], dtype=torch.int32, device=device)
        n_phys = b * slots
        order = torch.randperm(n_phys, generator=gen, device=device) + 1
        tables = order.view(b, slots).to(torch.int32)
        ident = (torch.arange(n_phys, device=device) + 1).view(
            b, slots).to(torch.int32)
        pools = []
        for tbl in (tables, ident):
            kp = torch.full((n_phys + 1, bs, f), 9.0, dtype=dtype,
                            device=device)      # garbage null block
            vp = torch.full_like(kp, -9.0)
            kp[tbl.view(-1).long()] = k.view(b * slots, bs, f)
            vp[tbl.view(-1).long()] = v.view(b * slots, bs, f)
            pools.append((kp, vp))
        (kp, vp), (kp_i, vp_i) = pools
        got = ops.paged_decode_attention(q, kp, vp, tables, lens, hkv)
        want = ops.paged_decode_attention_plain(q, kp, vp, tables, lens, hkv)
        got_i = ops.paged_decode_attention(q, kp_i, vp_i, ident, lens, hkv)
        torch.cuda.synchronize()
        err = compare(got, want, dname, f"paged_decode_attention {label} "
                                        f"{dname}")
        if not torch.equal(got, got_i):
            raise AssertionError(
                f"paged {label} {dname}: scrambled table differs from the "
                "identity table")
        n_rows = int((lens.long() + 1).sum())
        p_bytes = ((2 * n_rows * f + 2 * b * h * d) * itemsize
                   + tables.numel() * 4 + lens.numel() * 4)
        p_ops = 4 * n_rows * h * d
        p_bound, p_by = bound(p_bytes, p_ops, dname)
        k_g = kp[tables.long()].view(b, window, hkv, d).transpose(1, 2)
        v_g = vp[tables.long()].view(b, window, hkv, d).transpose(1, 2)
        mask = (torch.arange(window, device=device)[None, :]
                <= lens[:, None].long())[:, None, None, :]
        row = dict(
            name="paged_decode_attention", shape=label, dtype=dname,
            max_abs_err=err[0], max_rel_err=err[1],
            tolerance=TOL[dname],
            ms=time_ms(lambda: ops.paged_decode_attention(
                q, kp, vp, tables, lens, hkv), flush),
            plain_ms=time_ms(lambda: ops.paged_decode_attention_plain(
                q, kp, vp, tables, lens, hkv), flush),
            bound_ms=p_bound, bound_by=p_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q_sdpa, k_g, v_g, attn_mask=mask, scale=scale,
                enable_gqa=True), flush))
        log(f"kernel {json.dumps(row)}")
        results[("paged_decode_attention", label, dname)] = row
    return results


# ---------------------------------------------------------------------------
# Phases 3-5: the main path


def random_prompts(rng, n, vocab, lo, hi):
    return [rng.randint(0, vocab, (int(rng.randint(lo, hi + 1)),))
            .astype(np.int32) for _ in range(n)]


def run_generate(cfg):
    import torch

    from horovod_tpu_torch.models.llama import (
        LlamaLM, decode_kernel_disabled, generate)
    from horovod_tpu_torch.ops import decode_attention as ops

    model = LlamaLM(cfg, seed=0)
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (8, 128)))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(model, prompt, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["decode_attention"]
    paged = ops.LAUNCHES["paged_decode_attention"]
    with decode_kernel_disabled():
        tokens_einsum = generate(model, prompt, max_new_tokens=32)
    if tokens.shape != (8, 160) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generate: bad output {tuple(tokens.shape)}")
    if not torch.equal(tokens, tokens_einsum):
        diff = (tokens != tokens_einsum).nonzero()[:4].tolist()
        raise AssertionError(
            f"generate: kernel tokens differ from decode_kernel_disabled() "
            f"at {diff}")
    if launches != LAYERS * 31 or paged != 0:
        raise AssertionError(
            f"generate: decode kernel launched {launches} times (paged "
            f"{paged}); expected {LAYERS * 31}")
    with torch.inference_mode():
        logits = model(prompt[:1, :16].to(model.device))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("forward logits are not finite")
    log(f"generate: llama300m f32 b=8 p=128 n=32 tokens equal einsum path; "
        f"decode_attention launches {launches}; wall {wall:.3f} s "
        f"(first call, {8 * 32 / wall:.1f} tok/s)")
    return model, launches


def run_engine_parity(model, cfg):
    import torch

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models.llama import generate
    from horovod_tpu_torch.ops import decode_attention as ops

    rng = np.random.RandomState(1)
    prompts = random_prompts(rng, 12, cfg.vocab_size, 32, 128)
    news = [int(rng.randint(16, 65)) for _ in prompts]
    scfg = serving.ServingConfig(max_batch=8, block_size=16, num_blocks=0,
                                 queue_depth=64, max_seq_len=256)
    engine = serving.serve(model, scfg, start=False)
    handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
    ops.reset_launch_counts()
    engine.run_until_idle()
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["paged_decode_attention"]
    contiguous = ops.LAUNCHES["decode_attention"]
    stats = engine.stats()
    if launches != LAYERS * stats["steps"] or contiguous != 0:
        raise AssertionError(
            f"engine: paged kernel launched {launches} times (contiguous "
            f"{contiguous}) over {stats['steps']} steps")
    for i, (p, n, handle) in enumerate(zip(prompts, news, handles)):
        got = handle.result(timeout=0)
        ref = generate(model, torch.from_numpy(p[None]), max_new_tokens=n)
        want = ref[0, len(p):].tolist()
        if got != want:
            raise AssertionError(
                f"engine request {i} (prompt {len(p)}, {n} new) differs "
                f"from generate():\n got={got}\nwant={want}")
    engine.shutdown()
    log(f"engine: llama300m f32 12 requests equal generate(); steps "
        f"{stats['steps']}, paged_decode_attention launches {launches}, "
        f"preemptions {stats['preemptions']}")
    return launches


def run_engine_timing(card: str):
    import torch

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM

    model = LlamaLM(LLAMA_300M, seed=0)          # bfloat16
    scfg = serving.ServingConfig(max_batch=8, block_size=16, num_blocks=0,
                                 queue_depth=128, max_seq_len=256)
    warm = serving.ServingEngine(model, scfg)
    warm.submit(np.arange(40, dtype=np.int32), 8)
    warm.run_until_idle()
    warm.shutdown()
    rng = np.random.RandomState(9)
    prompts = random_prompts(rng, 32, LLAMA_300M.vocab_size, 32, 128)
    news = [int(rng.randint(32, 129)) for _ in prompts]
    engine = serving.serve(model, scfg, start=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
    for handle in handles:
        handle.result(timeout=600)
    wall = time.perf_counter() - t0
    stats = engine.stats()
    engine.shutdown()
    tok_s = stats["tokens_generated"] / wall
    log(f"serving bf16 llama300m 32 requests (prompts 32-128, new 32-128, "
        f"max_batch 8): {stats['tokens_generated']} tokens in {wall:.3f} s "
        f"= {tok_s:.1f} tok/s; TTFT p50 {stats['ttft_p50_seconds']} s; "
        f"TPOT p50 {stats['tpot_p50_seconds']} s; steps {stats['steps']} "
        f"[{card}]")
    numbers = dict(tokens_per_s=tok_s, ttft_p50_s=stats["ttft_p50_seconds"],
                   tpot_p50_s=stats["tpot_p50_seconds"],
                   steps=stats["steps"], tokens=stats["tokens_generated"],
                   wall_s=wall)
    numbers["decode_step_profile"] = profile_decode_steps(model, scfg)
    return numbers


def profile_decode_steps(model, scfg, steps: int = 20):
    """Where a full-batch bf16 decode step's time goes: host wall per
    step (timed without the profiler) against the device time
    ``torch.profiler`` attributes to kernels (the paged decode kernel,
    matrix products, the rest) over as many further steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch import serving

    engine = serving.ServingEngine(model, scfg)
    rng = np.random.RandomState(3)
    for p in random_prompts(rng, 8, model.config.vocab_size, 128, 128):
        engine.submit(p, 2 * steps + 8)
    for _ in range(3):                       # prefill all 8, then decode
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) * 1e6 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        profiled_us = (time.perf_counter() - t0) * 1e6 / steps
    engine.shutdown()
    split = {"decode_kernel": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = 0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue                      # host-side op: its kernels count
        kernels += ev.count
        name = ev.key.lower()
        if "decode_kernel" in name:
            key = "decode_kernel"
        elif any(t in name for t in ("nvjet", "gemm", "gemv", "cutlass")):
            key = "matmul"
        else:
            key = "other"
        split[key] += ev.self_device_time_total
    busy_us = sum(split.values()) / steps
    out = {"step_ms": step_us / 1e3, "step_ms_profiled": profiled_us / 1e3,
           "kernels_per_step": kernels / steps,
           "device_busy_ms_per_step": busy_us / 1e3,
           "device_idle_share": (1 - busy_us / step_us) if busy_us
           else None}
    out.update({f"{k}_ms_per_step": v / steps / 1e3
                for k, v in split.items()})
    log(f"decode step profile (bf16, 8 sequences at ~130-170 positions): "
        f"{json.dumps(out)}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from horovod_tpu_torch.models.llama import LLAMA_300M
    from horovod_tpu_torch.ops import _build

    device = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for line in _build.log_path("decode_attention").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # float32 parity runs in full float32: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=device)
    results = check_kernels(device, flush_buf.zero_)
    del flush_buf

    cfg32 = dataclasses.replace(LLAMA_300M, dtype=torch.float32)
    model, gen_launches = run_generate(cfg32)
    paged_launches = run_engine_parity(model, cfg32)
    del model
    torch.cuda.empty_cache()
    serving_numbers = run_engine_timing(card)

    launches = {"decode_attention": gen_launches,
                "paged_decode_attention": paged_launches}
    kernels = []
    for name in ("decode_attention", "paged_decode_attention"):
        row = results[(name, "llama300m", "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    log(f"serving: {json.dumps(serving_numbers)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
