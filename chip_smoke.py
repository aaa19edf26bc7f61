#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` with
``nvcc`` (one process per source, started together) and runs every phase
on ``cuda``; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``), the build time and
   ptxas's register and spill report per kernel instantiation;
2. each decode kernel against its plain torch version, in float32 and
   bfloat16, at the serving slice's attention shape (Llama-300M: H=16,
   Hkv=8, D=64, b=8, window 256, paged block 16) and at Llama-8B's
   (H=32, Hkv=8, D=128, b=8, window 4096), plus a scrambled block table
   against the identity table, bitwise. Times (CUDA events, median over
   launches, L2 flushed before each) of the kernel, the plain version and
   ``scaled_dot_product_attention`` on the gathered window (a yardstick
   only; the port never calls it), beside the memory/compute bound. The
   split window's edges: group 8 at D=128 over a window that is no
   multiple of the chunk, bounds on and around the chunk edges, against
   the plain versions, scrambled against identity tables and a wider
   table against a narrower one, bitwise;
3. ``generate()`` at Llama-300M full width and depth in float32
   (TF32 off), b=8, prompt 128, 32 new tokens: tokens equal those of
   ``decode_kernel_disabled()``, and the contiguous kernel launched
   16 layers x 31 steps times;
4. ``ServingEngine`` at Llama-300M in float32 over 12 mixed requests:
   each request's tokens equal ``generate()`` alone, and the paged
   kernel launched 16 x steps times;
5. the same engine in bfloat16, timed: tokens/s, TTFT p50, TPOT p50;
6. the three flash-attention kernels (forward, dq, dk/dv) against their
   plain versions in float32 and bfloat16 on eight cases: the training
   slice's shape (b=8, S=1024, H=16, Hkv=8, D=64, causal), a key-masked
   causal case at an awkward length with a fully masked row, causal with
   sq=256 < sk=1024, Llama-8B's width (b=1, S=4096, H=32, Hkv=8, D=128),
   the TMA kernels' edges (b=3, sq=197, sk=261: ragged last tiles and
   a diagonal offset of 64, H=16 over Hkv=2, D=128, key mask with a fully
   masked row), and three non-causal cases at group 1: BERT-base's
   (b=32, S=512, H=Hkv=12, D=64, the last quarter of the keys masked in
   every other sequence), the same without the mask, and ViT-B/16's
   (b=8, S=197, no mask). float32 at TOL;
   bfloat16 at SCALED_TOL (each output held to its own magnitude), and
   faults planted in the plain outputs (the last key or query tile
   skipped; causal at the slice, non-causal at BERT's) must fail that
   check. Times as in 2; the yardstick is
   ``scaled_dot_product_attention`` (``is_causal``, or the key mask as
   ``attn_mask``, ``enable_gqa=True``): its forward, and its backward
   alone (``autograd.grad`` on a saved forward), which covers dq and
   dk/dv together;
7. ``init()`` under a launcher environment of size 1: a real NCCL group
   on ``cuda:0``; collectives on card tensors return their inputs;
8. training parity at Llama-300M full size in float32: two SGD steps
   through the kernels equal two through ``use_flash=False`` (loss and
   every weight), with 16 launches per kernel per step;
9. the training example (``horovod_tpu_torch.examples.llama_training``)
   in bfloat16, seq 1024, batch 8, AdamW, 10 timed steps: tokens/s, step
   ms, falling loss, peak memory, and one profiled step's device split;
10. ResNet-50 in float32 (TF32 off), 224², batch 4: two SGD-momentum
   steps on the card (``channels_last``, cuDNN) against the same module,
   weights and batch on the CPU (loss, every weight's change, every
   running statistic, at ``RESNET_TOL``);
11. the synthetic benchmark (``examples.synthetic_benchmark``) at
   ResNet-50, bf16, batch 128, 224²: one warm-up step, 5 windows of 10
   steps (img/s per window and median), step ms, peak memory, the share
   of the bf16 dense peak (FLOPs counted from the model) and one profiled
   step's device split (convolutions, BatchNorm, optimizer, the rest);
   then ResNet-101, Inception V3 (299²) and VGG-16, 3 steps each;
12. BERT-base in float32 at seq 512, batch 4, padded-tail key mask: two
   SGD steps through ``make_attention_fn()`` (the flash kernels,
   non-causal) against ``use_flash=False``, 12 launches per kernel per
   step;
13. the BERT example (``examples.bert_pretraining``), base, bf16, seq
   512, batch 32, AdamW, 10 timed steps: sequences/s, step ms, falling
   loss, peak memory, the dense-peak share and a profiled step's split.

Phases 3-5, 9 and 13 are the main paths: the launch counts in the
kernels' JSON line come from them (the flash kernels' are the sum of 9
and 13, each path's on a line of its own). The line before the last is
that JSON object; the last line is ``{"ok": true, "device": {...}}``.
The whole run logs its wall time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}
# bfloat16 flash outputs (forward and gradients) are far smaller than
# TOL's atol at these shapes, so each is held to its own scale: every
# element within REL of (its own magnitude + the tensor's RMS), and the
# mean error within REL / 2 of the mean magnitude. REL is five bf16 ulps.
SCALED_TOL = dict(rel=2e-2, of="|ref| + rms(ref)", mean_rel=1e-2)
SOURCES = {
    "decode_attention": "horovod_tpu_torch/csrc/decode_attention.cu",
    "paged_decode_attention": "horovod_tpu_torch/csrc/decode_attention.cu",
    "flash_forward": "horovod_tpu_torch/csrc/flash_attention.cu",
    "flash_backward_dq": "horovod_tpu_torch/csrc/flash_attention.cu",
    "flash_backward_dkdv": "horovod_tpu_torch/csrc/flash_attention.cu",
}
REPLACES = {
    "decode_attention": "horovod_tpu/ops/decode_attention.py:47",
    "paged_decode_attention": "horovod_tpu/ops/decode_attention.py:217",
    "flash_forward": "horovod_tpu/ops/attention.py:125",
    "flash_backward_dq": "horovod_tpu/ops/attention.py:296",
    "flash_backward_dkdv": "horovod_tpu/ops/attention.py:343",
}
LAYERS = 16                          # Llama-300M
# Kernel names as ptxas and the profiler report them.
FLASH_KERNELS = r"(?:bf16|f32)_(?:fwd|dq|dkdv)(?:_tma)?_kernel"
DECODE_KERNELS = r"decode_(?:combine_)?kernel"


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


def compare_scaled(got, want, what: str, check: bool = True):
    """``got`` against ``want`` at :data:`SCALED_TOL`. Returns the max abs
    error, the reference's RMS and max, the mean error over the mean
    magnitude, and ``worst``: the largest error over its limit (above 1
    fails). ``check=False`` only measures."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    ref = want.abs()
    rms = float(want.pow(2).mean().sqrt())
    limit = SCALED_TOL["rel"] * (ref + rms)
    stats = {"max_abs": float(err.max()), "ref_rms": rms,
             "ref_max": float(ref.max()),
             "mean_err_over_mean_ref": float(err.mean())
             / max(float(ref.mean()), 1e-30),
             "worst": float((err / limit.clamp_min(1e-30)).max())}
    bad = (not bool(torch.isfinite(got).all()) or stats["worst"] > 1
           or stats["mean_err_over_mean_ref"] > SCALED_TOL["mean_rel"])
    if check and bad:
        raise AssertionError(
            f"{what}: kernel disagrees with plain ({json.dumps(stats)}, "
            f"tolerance {SCALED_TOL})")
    stats["fails"] = bad
    return stats


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


def paged_pool(k, v, tables, bs, slots):
    """Scatter logical windows (B, L, F) into a pool through the first
    ``L / bs`` slots of ``tables``; every other block (the null block 0
    among them) holds garbage that must never reach a sum."""
    import torch

    b, window, f = k.shape
    used = tables[:, :window // bs].reshape(-1).long()
    kp = torch.full((int(tables.max()) + 1, bs, f), 9.0, dtype=k.dtype,
                    device=k.device)
    vp = torch.full_like(kp, -9.0)
    kp[used] = k.reshape(-1, bs, f)
    vp[used] = v.reshape(-1, bs, f)
    return kp, vp


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
        (kp, vp), (kp_i, vp_i) = (paged_pool(k, v, tbl, bs, slots)
                                  for tbl in (tables, ident))
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


def check_chunk_edges(device):
    """The split window at its edges: group 8 at D=128 over a window that
    is no multiple of the chunk, bounds C-1, C, C+1, 2C and window-1 (and a
    sequence of one position), in float32 and bfloat16. Both kernels
    against their plain versions; a scrambled table against the identity
    table, the same rows in a table twice as wide (more chunks), and in a
    table of one chunk (no combine) for the sequences it holds, bitwise."""
    import torch

    from horovod_tpu_torch.ops import decode_attention as ops

    c, bs = ops.DECODE_CHUNK, 16
    b, h, hkv, d = 6, 32, 4, 128
    window = 3 * c + 80
    bounds = [0, c - 1, c, c + 1, 2 * c, window - 1]
    plans = [ops.decode_plan(b, h, d, w) for w in (window, 2 * window)]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=device).manual_seed(4)

        def randn(*shape):
            return (torch.randn(*shape, generator=gen, device=device)
                    * 0.5).to(dtype)

        q = randn(b, 1, h, d)
        k, v = randn(b, window, hkv * d), randn(b, window, hkv * d)
        for idx in bounds:
            got = ops.decode_attention(q, k, v, idx, hkv)
            want = ops.decode_attention_plain(q, k, v, idx, hkv)
            torch.cuda.synchronize()
            compare(got, want, dname, f"decode_attention edge {dname} "
                                      f"idx={idx}")
        slots = window // bs
        lens = torch.tensor(bounds, dtype=torch.int32, device=device)
        # Tables twice as wide: the extra slots point at blocks past the
        # window's, which hold garbage.
        scrambled = (torch.randperm(2 * b * slots, generator=gen,
                                    device=device) + 1).view(b, 2 * slots)
        ident = (torch.arange(2 * b * slots, device=device) + 1).view(
            b, 2 * slots)
        outs = {}
        for name, tbl in (("scrambled", scrambled), ("identity", ident)):
            tbl = tbl.to(torch.int32)
            kp, vp = paged_pool(k, v, tbl, bs, slots)
            for width in (slots, 2 * slots):
                t = tbl[:, :width].contiguous()
                outs[name, width] = ops.paged_decode_attention(
                    q, kp, vp, t, lens, hkv)
                want = ops.paged_decode_attention_plain(q, kp, vp, t, lens,
                                                        hkv)
                torch.cuda.synchronize()
                compare(outs[name, width], want, dname,
                        f"paged edge {dname} {name} width {width * bs}")
        base = outs["identity", slots]
        for key, out in outs.items():
            if not torch.equal(out, base):
                raise AssertionError(
                    f"paged edge {dname}: {key[0]} table of width "
                    f"{key[1] * bs} differs from the identity table of "
                    f"width {window}")
        # A table of one chunk (the block writes the output, no combine)
        # against the wide one, for the sequences it holds whole.
        short = [i for i, n in enumerate(bounds) if n < c]
        narrow = ops.paged_decode_attention(
            q, kp, vp, tbl[:, :c // bs].contiguous(), lens, hkv)
        if not torch.equal(narrow[short], outs["identity", slots][short]):
            raise AssertionError(
                f"paged edge {dname}: a one-chunk table differs from the "
                f"width-{window} table for bounds < {c}")
    log(f"decode chunk edges: H={h} Hkv={hkv} D={d}, window {window} "
        f"(chunk {c}: {plans[0].chunks} chunks, {plans[1].chunks} at twice "
        f"the width), bounds {bounds}: both kernels match plain in float32 "
        f"and bfloat16; scrambled == identity, width {window} == "
        f"{2 * window} == {c} (one chunk, bounds < {c}), bitwise")


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
        if re.search(DECODE_KERNELS, name):
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
    if not out["decode_kernel_ms_per_step"] > 0:
        raise AssertionError(
            "serving profile: no device time matched the decode kernels' "
            f"names: {json.dumps(out)}")
    log(f"decode step profile (bf16, 8 sequences at ~130-170 positions): "
        f"{json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Build report


def ptxas_report(name: str):
    """(kernel instantiation, registers line, spill line) from the ptxas
    output of ``name``'s last build, the instantiation read off the
    mangled entry name (``bf16_fwd_tma_kernel<bf16,64>``)."""
    from horovod_tpu_torch.ops import _build

    rows, label, spill = [], None, ""
    for line in _build.log_path(name).read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            kernel = re.search(f"({FLASH_KERNELS}|{DECODE_KERNELS})I",
                               mangled)
            dtype = "bf16" if "__nv_bfloat16" in mangled else "f32"
            ints = re.findall(r"Li(\d+)E", mangled)
            label = (f"{kernel.group(1) if kernel else mangled}"
                     f"<{','.join([dtype] + ints)}>")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and label:
            rows.append((label, line.split(":", 1)[-1].strip(), spill))
            label, spill = None, ""
    return rows


# ---------------------------------------------------------------------------
# Phase 6: flash-attention kernels against their plain versions


def flash_cases():
    """(label, b, sq, sk, h, hkv, d, mask, causal). ``mask``: None, a
    random key mask with a fully masked row (``"random"``), or BERT's
    padded tails, the last quarter of the keys masked in every other
    sequence (``"tail"``)."""
    return [("slice", 8, 1024, 1024, 16, 8, 64, None, True),
            ("masked", 2, 333, 333, 16, 8, 64, "random", True),
            ("sq256_sk1024", 8, 256, 1024, 16, 8, 64, None, True),
            ("llama8b", 1, 4096, 4096, 32, 8, 128, None, True),
            ("edge", 3, 197, 261, 16, 2, 128, "random", True),
            ("bert", 32, 512, 512, 12, 12, 64, "tail", False),
            # BERT's shape without the mask: what the key mask costs.
            ("bert_nomask", 32, 512, 512, 12, 12, 64, None, False),
            ("vit", 8, 197, 197, 12, 12, 64, None, False)]


def tail_mask(b: int, s: int, device):
    """BERT's padded tails: the last quarter of the keys masked in every
    other sequence."""
    import torch

    mask = torch.ones(b, s, dtype=torch.bool, device=device)
    mask[::2, s - s // 4:] = False
    return mask


def planted_faults(A, label, q, k, v, mask, causal, g, p_lse, delta, got,
                   tile=64):
    """Show that the bf16 check catches a kernel that drops work: out and
    dq from the plain versions with the last key tile skipped (masked
    out), dk and dv with the last query tile skipped (its p zeroed by an
    lse of +1e30). Each must fail :func:`compare_scaled` against the true
    plain output; returns each fault's ``worst`` (above 1 fails)."""
    import torch

    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    drop_keys = torch.ones(b, sk, dtype=torch.bool, device=q.device)
    drop_keys[:, sk - tile:] = False
    if mask is not None:
        drop_keys &= mask
    f_out, _ = A.flash_attention_forward_plain(q, k, v, drop_keys, causal)
    f_dq = A.flash_backward_dq_plain(q, k, v, drop_keys, g, p_lse, delta,
                                     causal)
    lse_f = p_lse.clone()
    lse_f[..., sq - tile:] = 1e30
    f_dk, f_dv = A.flash_backward_dkdv_plain(q, k, v, mask, g, lse_f, delta,
                                             causal)
    worst = {}
    for key, faulty in (("out", f_out), ("dq", f_dq), ("dk", f_dk),
                        ("dv", f_dv)):
        stats = compare_scaled(faulty, got[key][1], "planted", check=False)
        if not stats["fails"]:
            raise AssertionError(
                f"planted fault in {key} (last {tile}-row tile skipped, "
                f"{label}) passes the bf16 check: {json.dumps(stats)}")
        worst[key] = stats["worst"]
    log(f"planted faults (last {tile}-row tile skipped, bf16 {label} shape, "
        f"{'causal' if causal else 'non-causal'}) fail the check: worst "
        f"error/limit {json.dumps(worst)}")
    return worst


def check_flash(device, flush):
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        item = torch.tensor([], dtype=dtype).element_size()
        for label, b, sq, sk, h, hkv, d, mask_kind, causal in flash_cases():
            gen = torch.Generator(device=device).manual_seed(0)

            def randn(*shape):
                return (torch.randn(*shape, generator=gen, device=device)
                        * 0.5).to(dtype)

            q, k, v, g = (randn(b, sq, h, d), randn(b, sk, hkv, d),
                          randn(b, sk, hkv, d), randn(b, sq, h, d))
            mask = None
            if mask_kind == "random":
                mask = torch.rand(b, sk, generator=gen, device=device) > 0.3
                mask[:, 0] = True
                # Query row 0 of batch 0 attends keys <= sk - sq: none.
                mask[0, :sk - sq + 1] = False
            elif mask_kind == "tail":
                mask = tail_mask(b, sk, device)
            what = f"flash {label} {dname}"
            out, lse = A._flash_forward(q, k, v, mask, causal)
            p_out, p_lse = A.flash_attention_forward_plain(q, k, v, mask,
                                                           causal)
            delta = A.flash_delta(p_out, g)
            dq = A.flash_backward_dq(q, k, v, mask, g, p_lse, delta, causal)
            dk, dv = A.flash_backward_dkdv(q, k, v, mask, g, p_lse, delta,
                                           causal)
            p_dq = A.flash_backward_dq_plain(q, k, v, mask, g, p_lse, delta,
                                             causal)
            p_dk, p_dv = A.flash_backward_dkdv_plain(q, k, v, mask, g, p_lse,
                                                     delta, causal)
            torch.cuda.synchronize()
            got = {"out": (out, p_out), "dq": (dq, p_dq), "dk": (dk, p_dk),
                   "dv": (dv, p_dv)}
            if dtype == torch.float32:
                errs = {key: {"max_abs": compare(a, b, dname,
                                                 f"{what} {key}")[0]}
                        for key, (a, b) in got.items()}
            else:
                errs = {key: compare_scaled(a, b, f"{what} {key}")
                        for key, (a, b) in got.items()}
            errs["lse"] = {"max_abs": compare(lse, p_lse, "float32",
                                              f"{what} lse")[0]}
            planted = None
            if label in ("slice", "bert") and dtype == torch.bfloat16:
                planted = planted_faults(A, label, q, k, v, mask, causal, g,
                                         p_lse, delta, got)
            if mask_kind == "random" and (
                    bool(out[0, 0].ne(0).any())
                    or float(lse[0, 0, 0]) > -1e29
                    or bool(dq[0, 0].ne(0).any())):
                raise AssertionError(
                    f"{what}: the fully masked row is not zero "
                    f"(lse {float(lse[0, 0, 0])})")

            # The work this run's data needs: allowed (query, key) pairs.
            allowed = torch.ones(1, sq, sk, dtype=torch.bool, device=device)
            if causal:
                qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
                allowed = (torch.arange(sk, device=device)[None, :]
                           <= qi)[None]
            if mask is not None:
                allowed = allowed & mask[:, None, :]
            pairs = int(allowed.expand(b, sq, sk).sum()) * h
            q_bytes, kv_bytes = q.numel() * item, k.numel() * item
            stats = 4 * b * h * sq
            extra = 0 if mask is None else mask.numel()
            fwd_bound = bound(2 * q_bytes + 2 * kv_bytes + stats + extra,
                              4 * d * pairs, dname)
            dq_bound = bound(3 * q_bytes + 2 * kv_bytes + 2 * stats + extra,
                             6 * d * pairs, dname)
            dkdv_bound = bound(2 * q_bytes + 4 * kv_bytes + 2 * stats
                               + extra, 8 * d * pairs, dname)
            times = {
                "flash_forward": time_ms(
                    lambda: A._flash_forward(q, k, v, mask, causal), flush),
                "flash_backward_dq": time_ms(
                    lambda: A.flash_backward_dq(q, k, v, mask, g, p_lse,
                                                delta, causal), flush),
                "flash_backward_dkdv": time_ms(
                    lambda: A.flash_backward_dkdv(q, k, v, mask, g, p_lse,
                                                  delta, causal), flush)}
            plain = {
                "flash_forward": time_ms(
                    lambda: A.flash_attention_forward_plain(q, k, v, mask,
                                                            causal),
                    flush, repeats=10),
                "flash_backward_dq": time_ms(
                    lambda: A.flash_backward_dq_plain(q, k, v, mask, g,
                                                      p_lse, delta, causal),
                    flush, repeats=10),
                "flash_backward_dkdv": time_ms(
                    lambda: A.flash_backward_dkdv_plain(q, k, v, mask, g,
                                                        p_lse, delta, causal),
                    flush, repeats=10)}
            sdpa_fwd = sdpa_bwd = None
            if mask_kind != "random" and sq == sk:
                # The yardstick (the port never calls it): SDPA on the same
                # inputs in (B, H, S, D), causal or with the key mask as
                # attn_mask: its forward, and its backward alone on one
                # saved forward (dq, dk and dv).
                qt, kt, vt, gt = (x.transpose(1, 2).contiguous()
                                  for x in (q, k, v, g))
                qr, kr, vr = (x.detach().requires_grad_()
                              for x in (qt, kt, vt))
                attn_mask = None if mask is None else mask[:, None, None, :]

                def sdpa(qs=qt, ks=kt, vs=vt):
                    return F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=attn_mask, is_causal=causal,
                        enable_gqa=True)

                o_saved = sdpa(qr, kr, vr)

                def sdpa_bwd_only():
                    return torch.autograd.grad(o_saved, (qr, kr, vr), gt,
                                               retain_graph=True)

                sdpa_fwd = time_ms(sdpa, flush, repeats=10)
                sdpa_bwd = time_ms(sdpa_bwd_only, flush, repeats=10)
                del o_saved
            row = dict(case=label, dtype=dname, shape=[b, sq, sk, h, hkv, d],
                       mask=mask_kind, causal=causal, pairs=pairs,
                       max_abs_err={key: e["max_abs"]
                                    for key, e in errs.items()},
                       errors=errs, planted_faults=planted,
                       tolerance=(TOL[dname] if dtype == torch.float32
                                  else SCALED_TOL), ms=times, plain_ms=plain,
                       bound_ms={"flash_forward": fwd_bound[0],
                                 "flash_backward_dq": dq_bound[0],
                                 "flash_backward_dkdv": dkdv_bound[0]},
                       bound_by={"flash_forward": fwd_bound[1],
                                 "flash_backward_dq": dq_bound[1],
                                 "flash_backward_dkdv": dkdv_bound[1]},
                       sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_ms=sdpa_bwd)
            log(f"flash {json.dumps(row)}")
            results[(label, dname)] = row
            del q, k, v, g, out, lse, p_out, p_lse, dq, dk, dv, got
            torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 7: collectives on the card


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_collectives():
    """``init()`` under a launcher environment of size 1 builds an NCCL
    group on ``cuda:0``; the collectives are the identity there."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    os.environ.update(HOROVOD_RANK="0", HOROVOD_SIZE="1",
                      HOROVOD_LOCAL_RANK="0", HOROVOD_LOCAL_SIZE="1",
                      HOROVOD_CONTROLLER_ADDR=f"127.0.0.1:{free_port()}")
    hvd.init()
    if not dist.is_initialized() or dist.get_backend() != "nccl" \
            or hvd.device() != torch.device("cuda", 0):
        raise AssertionError(
            f"init: no NCCL group on cuda:0 (initialized "
            f"{dist.is_initialized()}, device {hvd.device()})")
    x = torch.arange(1024, dtype=torch.float32, device=hvd.device())
    raw = x.clone()
    dist.all_reduce(raw)                     # the group itself runs
    outs = {"allreduce": hvd.allreduce(x), "allgather": hvd.allgather(x),
            "broadcast": hvd.broadcast(x, 0),
            "allreduce_async": hvd.synchronize(hvd.allreduce_async(x)),
            "nccl all_reduce": raw}
    hvd.barrier()
    torch.cuda.synchronize()
    for name, out in outs.items():
        if not torch.equal(out, x):
            raise AssertionError(f"{name} at size 1 is not the identity")
    log(f"collectives: NCCL group of size 1 on {hvd.device()}; "
        f"{', '.join(outs)} return their inputs")


# ---------------------------------------------------------------------------
# Phases 8-9: training


def run_training_parity(steps: int = 2):
    """Llama-300M f32 at seq 1024, batch 8: ``steps`` SGD steps through
    the flash kernels against as many through ``use_flash=False`` from the
    same weights and batch."""
    import torch

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.models.llama import LLAMA_300M
    from horovod_tpu_torch.ops import attention as A

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32)
    ids = ex.batch_ids(cfg, 8, 1024, "cuda")
    loss_fn = ex.make_loss_fn(0)
    runs = {}
    for use_flash in (True, False):
        model = ex.make_model(cfg, no_flash=not use_flash, device="cuda")
        opt = ex.make_optimizer("sgd", model)
        losses = []
        for step in range(steps):
            A.reset_launch_counts()
            losses.append(float(ex.train_step(model, opt, ids, loss_fn)))
            want = LAYERS if use_flash else 0
            if set(A.LAUNCHES.values()) != {want}:
                raise AssertionError(
                    f"training step {step} (use_flash={use_flash}): flash "
                    f"launches {A.LAUNCHES}, expected {want} each")
        runs[use_flash] = (model, losses)
        del opt
    (kmodel, klosses), (pmodel, plosses) = runs[True], runs[False]
    for a, b in zip(klosses, plosses):
        if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(
                f"training parity: losses {klosses} vs {plosses}")
    worst = 0.0
    with torch.no_grad():
        for (name, p), (_, r) in zip(kmodel.named_parameters(),
                                     pmodel.named_parameters()):
            worst = max(worst, float((p - r).abs().max()))
            compare(p, r, "float32", f"training parity weight {name}")
    log(f"training parity: llama300m f32 seq 1024 b=8, {steps} SGD steps; "
        f"losses kernel {klosses} vs plain {plosses}; every weight within "
        f"{TOL['float32']} (max abs diff {worst:.3g}); flash launches "
        f"{LAYERS} per kernel per step")
    del kmodel, pmodel, runs
    torch.cuda.empty_cache()
    return {"losses_kernel": klosses, "losses_plain": plosses,
            "max_abs_weight_diff": worst}


def run_training_timed(card: str):
    """The training example's main path, bf16, seq 1024, batch 8, AdamW,
    10 timed steps; returns its numbers and the flash launch counts of
    the run."""
    import torch

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.ops import attention as A

    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    out = ex.main(["--model", "300m", "--seq-len", "1024",
                   "--batch-size", "8", "--num-iters", "10"])
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)
    losses = out["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    numbers = {"tokens_per_s": out["tokens_per_s"],
               "step_ms": out["step_ms"], "losses": losses,
               "peak_memory_gib": peak, "flash_launches": launches}
    log(f"training bf16 llama300m seq 1024 b=8 adamw: "
        f"{out['tokens_per_s']:.1f} tokens/s, step {out['step_ms']:.3f} ms, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, peak memory "
        f"{peak:.2f} GiB, flash launches {launches} over 11 steps [{card}]")
    numbers["step_profile"] = profile_step(
        lambda: ex.train_step(out["model"], out["optimizer"], out["ids"],
                              out["loss_fn"]),
        out["step_ms"], TRANSFORMER_SPLIT, "flash", "llama300m")
    return numbers


# Device-time buckets of a profiled step: (bucket, kernel-name test), the
# first that matches wins, the rest is "other" (the elementwise tail).
TRANSFORMER_SPLIT = (
    ("flash", lambda n: re.search(FLASH_KERNELS, n)),
    ("matmul", lambda n: any(t in n for t in ("nvjet", "gemm", "gemv",
                                              "cutlass", "xmma"))))
CONV_SPLIT = (
    ("batchnorm", lambda n: "batch_norm" in n or "batchnorm" in n),
    ("conv", lambda n: any(t in n for t in ("conv", "xmma", "implicit_gemm",
                                            "cudnn", "wgrad", "dgrad",
                                            "fprop", "nhwc", "nchw"))),
    ("optimizer", lambda n: "multi_tensor_apply" in n or "foreach" in n),
    ("matmul", lambda n: any(t in n for t in ("nvjet", "gemm", "gemv",
                                              "cutlass"))))


def profile_step(step, step_ms: float, buckets, required: str, what: str,
                 steps: int = 2):
    """Where a bf16 training step's device time goes, by ``buckets`` plus
    "other" (which must see time in bucket ``required``); the kernel
    count. Two shares: the idle share of the profiled
    window (device busy time against that window's own wall time, which
    the profiler's per-launch host cost stretches), and busy time over
    the step's wall time without the profiler (``step_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    split = {key: 0.0 for key, _ in buckets}
    split["other"] = 0.0
    kernels = 0
    by_name = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        kernels += ev.count
        name = ev.key.lower()
        key = next((k for k, test in buckets if test(name)), "other")
        split[key] += ev.self_device_time_total
        by_name.append((ev.self_device_time_total, key, ev.key))
    busy_ms = sum(split.values()) / steps / 1e3
    result = {"step_ms": step_ms, "step_ms_profiled": profiled_ms,
              "kernels_per_step": kernels / steps,
              "device_busy_ms_per_step": busy_ms,
              "device_idle_share": (1 - busy_ms / profiled_ms) if busy_ms
              else None,
              "device_busy_over_unprofiled_step": busy_ms / step_ms}
    result.update({f"{k}_ms_per_step": v / steps / 1e3
                   for k, v in split.items()})
    # The kernels that take the most device time, with their bucket.
    result["top_kernels"] = [
        [bucket, name[:90], us / steps / 1e3]
        for us, bucket, name in sorted(by_name, reverse=True)[:12]]
    if not result[f"{required}_ms_per_step"] > 0:
        raise AssertionError(
            f"{what} profile: no device time matched the {required} "
            f"kernels' names: {json.dumps(result)}")
    log(f"{what} step profile (bf16, {steps} steps): {json.dumps(result)}")
    return result


# ---------------------------------------------------------------------------
# Phases 10-13: the model zoo (ResNet-50 and BERT-base)

# The card-vs-CPU ResNet-50 check (float32 on both, TF32 off): the loss
# to ``loss_rtol``; each weight's change over the steps and each running
# statistic by its relative L2 error, ||card - cpu|| / ||cpu||, within
# ``update_rel`` / ``stat_rel``. Not element by element: ReLU and max-pool
# route each gradient by a comparison, and where two values tie within
# rounding the two devices route it to different elements, so single
# entries of a weight's gradient may differ by one position's whole term
# while the tensor agrees. How far float32 rounding carries here is
# measured in the same run: a CPU run with float64 activations
# (parameters and head float32) is the reference, and each tensor's limit
# is the larger of ``*_rel`` and 3x the CPU's own float32 error against
# it (two float32 runs each within e of the reference differ by up to 2e;
# 3e allows the card's error to be twice the CPU's, no more).
RESNET_TOL = {"loss_rtol": 1e-4, "update_rel": 1e-3, "stat_rel": 1e-4,
              "of_cpu_f32_error": 3.0}


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    norm = float(want.norm())
    diff = float((got - want).norm())
    return diff / norm if norm else diff


def run_resnet_parity(steps: int = 2, batch: int = 4, lr: float = 0.01):
    """ResNet-50 in float32 at 224², batch 4: ``steps`` SGD-momentum
    steps of the synthetic benchmark's train_step on the card
    (``channels_last``, cuDNN) against the same module, weights and batch
    on the CPU: the losses, every weight's change and every running
    statistic (:data:`RESNET_TOL`), each also against a float64 CPU run.
    ``lr`` is 0.01, not the example's 0.1: at 0.1 one step nearly fits a
    batch of 4, and the second step's gradients shrink to differences
    that float32 does not resolve, so the two devices drift apart by a
    large share of some weights' change. Weights
    whose change stays small at 0.01 too (each block's residual branch
    behind its zero-initialised third norm) are what the float64
    reference's per-tensor limit is for."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import synthetic_benchmark as ex
    from horovod_tpu_torch.models import ResNet50

    runs = {}
    for label, dev, dtype in (("card", "cuda", torch.float32),
                              ("cpu", "cpu", torch.float32),
                              ("cpu_f64", "cpu", torch.float64)):
        model = ResNet50(dtype=dtype, device=dev, seed=0)
        start = {n: p.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9),
            named_parameters=model.named_parameters())
        x, y = ex.batch(224, batch, dev)
        t0 = time.perf_counter()
        losses = [float(ex.train_step(model, opt, x, y))
                  for _ in range(steps)]
        state = {f"{n} change": (p.detach().cpu() - start[n], "update")
                 for n, p in model.named_parameters()}
        state.update({n: (t.cpu(), "stat")
                      for n, t in model.named_buffers()})
        runs[label] = (losses, state, time.perf_counter() - t0)
        if label == "card" and not model.conv_init.weight.is_contiguous(
                memory_format=torch.channels_last):
            raise AssertionError("ResNet-50 on the card is not channels_last")
        del model, opt
    torch.cuda.empty_cache()
    (c_losses, card, c_s), (p_losses, cpu, p_s), (r_losses, ref, _) = (
        runs["card"], runs["cpu"], runs["cpu_f64"])
    worst = {}
    failures = []
    for name, (got, kind) in card.items():
        want = cpu[name][0]
        err = rel_l2(got, want)
        cpu_err = rel_l2(want, ref[name][0])
        limit = max(RESNET_TOL[f"{kind}_rel"],
                    RESNET_TOL["of_cpu_f32_error"] * cpu_err)
        for key, e in ((f"{kind}_card_vs_cpu", err),
                       (f"{kind}_card_vs_f64", rel_l2(got, ref[name][0])),
                       (f"{kind}_cpu_vs_f64", cpu_err),
                       (f"{kind}_card_vs_cpu_over_limit", err / limit)):
            if e > worst.get(key, (-1.0, ""))[0]:
                worst[key] = (e, name)
        if not bool(torch.isfinite(got).all()) or err > limit:
            failures.append((name, err, limit))
    log(f"resnet50 parity: f32 224x224 b={batch}, {steps} SGD-momentum "
        f"(lr {lr}) steps, card (channels_last, cuDNN, TF32 off) vs CPU; losses "
        f"card {c_losses}, CPU {p_losses}, CPU float64 activations "
        f"{r_losses}; worst relative L2 error per tensor (and where): "
        f"{json.dumps(worst)}; card {c_s:.2f} s, CPU {p_s:.2f} s")
    for a, b in zip(c_losses, p_losses):
        if not np.isfinite(a) or abs(a - b) > RESNET_TOL["loss_rtol"] * abs(b):
            raise AssertionError(
                f"resnet50 parity: losses card {c_losses} vs CPU {p_losses}")
    if failures:
        raise AssertionError(
            f"resnet50 parity: {len(failures)} tensors outside {RESNET_TOL}: "
            f"{failures[:6]}")
    return {"losses_card": c_losses, "losses_cpu": p_losses,
            "losses_cpu_f64": r_losses, "worst_rel_l2": worst,
            "tolerance": RESNET_TOL}


def run_synthetic_benchmark(card: str):
    """The synthetic benchmark's main path: ResNet-50 bf16, batch 128,
    224², one warm-up step, then 5 windows of 10 steps; img/s, step ms,
    peak memory, the step's share of the bf16 dense peak (FLOPs counted
    from the model's own convolutions and dense layers) and one profiled
    step's device split. Then ResNet-101, Inception V3 and VGG-16, one
    warm-up and 3 steps each."""
    import torch

    from horovod_tpu_torch.examples import synthetic_benchmark as ex

    torch.cuda.reset_peak_memory_stats()
    out = ex.main(["--model", "resnet50", "--batch-size", "128",
                   "--num-iters", "10", "--num-batches", "5"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"resnet50 benchmark: loss {out['losses']}")
    macs = ex.forward_macs(out["model"], 224)
    flops = 3 * 2 * macs * 128
    bound_ms = flops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    numbers = {"img_per_s": out["img_per_s"],
               "img_per_s_windows": out["img_per_s_windows"],
               "spread": out["spread"], "step_ms": out["step_ms"],
               "peak_memory_gib": peak, "forward_gmac_per_image": macs / 1e9,
               "tflop_per_step": flops / 1e12, "bound_ms": bound_ms,
               "dense_peak_share": bound_ms / out["step_ms"],
               "losses": out["losses"]}
    log(f"synthetic benchmark resnet50 bf16 b=128 224x224 sgd-momentum: "
        f"{out['img_per_s']:.1f} img/s median (windows "
        f"{[round(v, 1) for v in out['img_per_s_windows']]}), step "
        f"{out['step_ms']:.3f} ms, peak memory {peak:.2f} GiB; "
        f"{macs / 1e9:.4f} GMAC/image forward, {flops / 1e12:.3f} TFLOP per "
        f"step, bf16 bound {bound_ms:.3f} ms = "
        f"{bound_ms / out['step_ms']:.3f} of the step [{card}]")
    numbers["step_profile"] = profile_step(
        lambda: ex.train_step(out["model"], out["optimizer"], out["x"],
                              out["y"]),
        out["step_ms"], CONV_SPLIT, "conv", "resnet50")
    del out
    torch.cuda.empty_cache()
    for name in ("resnet101", "inception3", "vgg16"):
        torch.cuda.reset_peak_memory_stats()
        other = ex.main(["--model", name, "--batch-size", "128",
                         "--num-iters", "3", "--num-batches", "1"])
        torch.cuda.synchronize()
        if not all(np.isfinite(other["losses"])):
            raise AssertionError(f"{name} benchmark: loss {other['losses']}")
        numbers[name] = {
            "img_per_s": other["img_per_s"], "step_ms": other["step_ms"],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "image_size": other["image_size"]}
        log(f"synthetic benchmark {name} bf16 b=128 "
            f"{other['image_size']}x{other['image_size']}, 3 steps: "
            f"{json.dumps(numbers[name])} [{card}]")
        del other
        torch.cuda.empty_cache()
    return numbers


def run_bert_parity(steps: int = 2, batch: int = 4, seq: int = 512):
    """BERT-base in float32 at seq 512, batch 4, key mask with padded
    tails: ``steps`` SGD steps through ``make_attention_fn()`` (flash
    from 512 rows up: the three kernels, non-causal, masked, group 1)
    against as many through ``use_flash=False``, from the same weights
    and batch; the loss and every weight at the Llama parity phase's
    tolerances, 12 launches per kernel per step."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import bert_pretraining as ex
    from horovod_tpu_torch.models.bert import BERT_BASE, BertEncoder, mlm_loss
    from horovod_tpu_torch.ops import attention as A

    cfg = dataclasses.replace(BERT_BASE, dtype=torch.float32)
    ids, mlm = ex.batch(cfg, batch, seq, "cuda")
    key_mask = tail_mask(batch, seq, "cuda")
    runs = {}
    for use_flash in ("auto", False):
        model = BertEncoder(cfg, A.make_attention_fn(use_flash=use_flash),
                            device="cuda", seed=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        losses = []
        for step in range(steps):
            A.reset_launch_counts()
            opt.zero_grad(set_to_none=True)
            loss = mlm_loss(model(ids, attention_mask=key_mask), ids, mlm)
            loss.backward()
            opt.step()
            losses.append(float(loss))
            want = cfg.num_layers if use_flash else 0
            if set(A.LAUNCHES.values()) != {want}:
                raise AssertionError(
                    f"bert step {step} (use_flash={use_flash}): flash "
                    f"launches {A.LAUNCHES}, expected {want} each")
        runs[use_flash] = (model, losses)
        del opt
    (kmodel, klosses), (pmodel, plosses) = runs["auto"], runs[False]
    for a, b in zip(klosses, plosses):
        if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"bert parity: losses {klosses} vs {plosses}")
    worst = 0.0
    with torch.no_grad():
        for (name, p), (_, r) in zip(kmodel.named_parameters(),
                                     pmodel.named_parameters()):
            worst = max(worst, float((p - r).abs().max()))
            compare(p, r, "float32", f"bert parity weight {name}")
    log(f"bert parity: bert-base f32 seq {seq} b={batch}, key mask with "
        f"the last quarter masked in every other row, {steps} SGD steps; "
        f"losses flash {klosses} vs plain {plosses}; every weight within "
        f"{TOL['float32']} (max abs diff {worst:.3g}); flash launches "
        f"{cfg.num_layers} per kernel per step")
    del kmodel, pmodel, runs
    torch.cuda.empty_cache()
    return {"losses_flash": klosses, "losses_plain": plosses,
            "max_abs_weight_diff": worst}


def run_bert_timed(card: str):
    """The BERT example's main path: base, bf16, seq 512, batch 32, AdamW,
    10 timed steps; sequences/s, step ms, falling loss, peak memory, the
    step's share of the bf16 dense peak and one profiled step's device
    split. Returns its numbers and the flash launch counts of the run."""
    import torch

    from horovod_tpu_torch.examples import bert_pretraining as ex
    from horovod_tpu_torch.models.layers import Dense
    from horovod_tpu_torch.ops import attention as A

    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    out = ex.main(["--model", "base", "--seq-len", "512", "--batch-size",
                   "32", "--num-iters", "10"])
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)
    losses = out["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bert training: loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg = out["model"].config
    dense = sum(m.weight.numel() for m in out["model"].modules()
                if isinstance(m, Dense))
    b, s = out["ids"].shape
    # 6 FLOPs per dense weight per token; attention's four S x S x hidden
    # products (QK^T, PV and their backward: twelve in all) per layer.
    flops = 6 * dense * b * s + 12 * b * s * s * cfg.hidden_size \
        * cfg.num_layers
    bound_ms = flops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    numbers = {"sequences_per_s": out["sequences_per_s"],
               "step_ms": out["step_ms"], "losses": losses,
               "peak_memory_gib": peak, "flash_launches": launches,
               "dense_params": dense, "tflop_per_step": flops / 1e12,
               "bound_ms": bound_ms,
               "dense_peak_share": bound_ms / out["step_ms"]}
    log(f"bert training bf16 base seq 512 b=32 adamw: "
        f"{out['sequences_per_s']:.1f} sequences/s, step "
        f"{out['step_ms']:.3f} ms, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"peak memory {peak:.2f} GiB, {flops / 1e12:.3f} TFLOP per step "
        f"({dense / 1e6:.1f} M dense weights), bf16 bound {bound_ms:.3f} ms "
        f"= {bound_ms / out['step_ms']:.3f} of the step, flash launches "
        f"{launches} over 11 steps [{card}]")
    numbers["step_profile"] = profile_step(
        lambda: ex.train_step(out["model"], out["optimizer"], out["ids"],
                              out["mlm"]),
        out["step_ms"], TRANSFORMER_SPLIT, "flash", "bert-base")
    del out
    torch.cuda.empty_cache()
    return numbers


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import LLAMA_300M
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import attention as flash_ops

    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build ({len(_build.SOURCES)} sources in parallel): "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for kernel, regs, spill in ptxas_report(name):
            log(f"  ptxas {name}.cu {kernel}: {regs}; {spill}")

    # float32 parity runs in full float32: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=device)
    results = check_kernels(device, flush_buf.zero_)
    check_chunk_edges(device)
    flash_results = check_flash(device, flush_buf.zero_)
    del flush_buf

    run_collectives()

    cfg32 = dataclasses.replace(LLAMA_300M, dtype=torch.float32)
    model, gen_launches = run_generate(cfg32)
    paged_launches = run_engine_parity(model, cfg32)
    del model
    torch.cuda.empty_cache()
    serving_numbers = run_engine_timing(card)
    torch.cuda.empty_cache()

    parity = run_training_parity()
    training = run_training_timed(card)
    torch.cuda.empty_cache()

    zoo = {"resnet50_parity": run_resnet_parity(),
           "synthetic_benchmark": run_synthetic_benchmark(card),
           "bert_parity": run_bert_parity()}
    bert = run_bert_timed(card)
    hvd.shutdown()

    log(f"flash launches by main path: llama300m training "
        f"{json.dumps(training['flash_launches'])}, bert-base training "
        f"{json.dumps(bert['flash_launches'])}")
    launches = {"decode_attention": gen_launches,
                "paged_decode_attention": paged_launches,
                **{name: training["flash_launches"][name]
                   + bert["flash_launches"][name]
                   for name in flash_ops.LAUNCHES}}
    if min(launches.values()) <= 0 or min(
            bert["flash_launches"].values()) <= 0:
        raise AssertionError(f"a kernel of the main paths never ran: "
                             f"{launches}, bert {bert['flash_launches']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main paths never ran: "
                             f"{launches}")
    kernels = []
    for name in ("decode_attention", "paged_decode_attention"):
        row = results[(name, "llama300m", "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    row = flash_results[("slice", "bfloat16")]
    errs = row["max_abs_err"]
    flash_errs = {"flash_forward": errs["out"],
                  "flash_backward_dq": errs["dq"],
                  "flash_backward_dkdv": max(errs["dk"], errs["dv"])}
    for name in flash_ops.LAUNCHES:
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": flash_errs[name], "ms": row["ms"][name],
            "plain_ms": row["plain_ms"][name],
            "bound_ms": row["bound_ms"][name],
            "bound_by": row["bound_by"][name],
            "library_ms": (row["sdpa_fwd_ms"] if name == "flash_forward"
                           else None)})
    log(f"serving: {json.dumps(serving_numbers)}")
    log(f"training: {json.dumps({'parity': parity, **training})}")
    log(f"zoo: {json.dumps({**zoo, 'bert_training': bert})}")
    log(f"wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
