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
   (H=32, Hkv=8, D=128, b=8, window 4096), and at MOE_SMALL's (H=12,
   Hkv=6, D=64, window 384, b=8 and b=32: the MoE generation example's
   shapes), plus a scrambled block table
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
   plain versions in float32 and bfloat16 on ten cases: the training
   slice's shape (b=8, S=1024, H=16, Hkv=8, D=64, causal), a key-masked
   causal case at an awkward length with a fully masked row, causal with
   sq=256 < sk=1024, Llama-8B's width (b=1, S=4096, H=32, Hkv=8, D=128),
   the TMA kernels' edges (b=3, sq=197, sk=261: ragged last tiles and
   a diagonal offset of 64, H=16 over Hkv=2, D=128, key mask with a fully
   masked row), and three non-causal cases at group 1: BERT-base's
   (b=32, S=512, H=Hkv=12, D=64, the last quarter of the keys masked in
   every other sequence), the same without the mask, and ViT-B/16's
   (b=8, S=197, no mask); then the MoE LM's training shape (MOE_SMALL:
   b=8, S=1024, H=12, Hkv=6, D=64, causal) and ViT-S/16's at batch 64
   (S=197, H=Hkv=6, D=64, non-causal). float32 at TOL;
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

14. the kernels' operand range: the decode kernels (contiguous and
   paged) at Llama-tiny's heads (H=4, Hkv=2, D=16), at D=32, at group
   16 (H=16, Hkv=1, D=64), at D=256 and at group 3; the flash kernels at
   D=16, at D=32 (BERT-tiny, non-causal, tail mask), at group 16
   (causal), at D=192 and at D=256, through the wrappers' zero-padding.
   float32 at TOL, bfloat16 at SCALED_TOL,
   timed as 2 and 6. Then ``generate()`` at LLAMA_TINY on the card in
   float32 equals ``decode_kernel_disabled()``;
15. the generation example (``examples.llama_generation``) at the JAX
   bench's two decode rows: Llama-300M bf16, prompt 128, 256 new tokens,
   batch 8 and 32: decode tokens/s and peak memory;
16. the load generator (``examples.serving_loadgen``), one engine, with
   the arguments of the JAX row ``llama_300m_serving_b8_loadgen``: its
   record (tok/s, TTFT and TPOT p50/p99, preemptions, block peak); every
   request finishes;
17. fleet parity: Llama-300M float32, three replicas over one model
   behind the Router, 12 requests on a shared 64-token prefix, the
   replica serving them hard-killed once half are submitted: every
   request (replays included) equals ``generate()`` alone, affinity hits,
   and the ``hvd_serving_tokens_generated_total`` and
   ``hvd_router_requests_total`` totals agree with the engines and the
   handles;
18. the JAX fleet row ``llama_serving_fleet_prefix_loadgen`` through the
   load generator with its arguments (tiny, 320 requests, 3 replicas,
   prefix sharing), then the same trace with ``--chaos-kill`` (and
   ``--no-warmup``: the process is warm by then): no request fails;
   warm and cold TTFT and the live block peak against the no-sharing
   baseline are logged;
19. MoE parity: ``MOE_SMALL`` (249.7M parameters, top-2 of 8 experts on
   every other layer) in float32 at seq 1024, batch 8: two SGD steps
   through the flash kernels equal two through ``use_flash=False`` (loss
   to 1e-4 relative, every weight within TOL, as phase 8), then two AdamW
   steps (the loss held at each; step 0's gradients within TOL and its
   weights within TOL plus AdamW's first-update spread of the two
   gradients; the weights outside TOL after the last step counted, with
   their step-0 gradients); every routing decision of the two runs
   compared, and at every step a flip at the first routed layer with
   flips at a probability gap above ``MOE_FLIP_GAP`` fails;
20. the MoE training example (``examples.moe_lm_training``), moe-small,
   bf16, seq 1024, batch 8, AdamW, 10 timed steps: tokens/s, step ms,
   peak memory, the share of the bf16 dense peak (useful FLOPs, and the
   capacity-padded count beside them) and a profiled pair of steps split
   into flash, matmuls, routing and gathers, and the rest;
21. ``generate()`` at ``MOE_SMALL`` in float32 through the decode kernel
   equals the einsum path, then the generation example at
   ``--model moe-small``, bf16, prompt 128, 256 new, batch 8 and 32, and
   its model's greedy tokens at b=8 against the einsum path's (reported);
22. ``ServingEngine`` at ``MOE_SMALL`` in float32 over 12 requests: each
   equals ``generate()`` alone, through the paged kernel;
23. the ViT example (``examples.vit_training``) at the JAX row
   ``vit_s16_224_b64_adamw_spc8``: ViT-S/16 bf16, batch 64, 8 steps a
   call, ``--attention xla`` and ``flash``: img/s;
24. the ring paths' kernel calls against the plain versions with a
   random cotangent on lse (ring attention's merge gives it one; float32
   at TOL, bf16 at SCALED_TOL), timed as 6: Llama-300M's ring blocks at
   seq 2048 over 2 ranks, b4 (the causal diagonal, a past block, the
   zigzag half-blocks, Ulysses' full sequence at H/2), and the
   long-context example's block. Then, on two processes sharing the card
   as a gloo group (NCCL refuses two ranks on one device): the training
   example ``--seq-parallel 2`` at Llama-300M, seq 2048, float32, two SGD
   steps equal to the single-process run at the same global batch (loss
   to 1e-4 relative, every weight within TOL), then bf16 timed (tok/s);
   ``examples.long_context_ring_attention`` at its defaults (S 8192, H 8,
   D 64), both layouts;
25. tensor parallelism over the two processes: ``generate()`` (b8,
   prompt 128, 32 new) and ``ServingEngine`` (8 requests) at Llama-300M
   float32 give the unsharded model's tokens through both decode kernels
   on each rank's heads (H 8, Hkv 4; phase 2 holds the kernels at that
   shape), then ``examples.tp_decode_profile`` in bf16 (tok/s, two ranks
   sharing one card);
26. GPipe and 1F1B over the two processes (one stage each, residual MLP
   stages of width 1024) equal the sequential stages: outputs, loss and
   gradients within TOL.

Phases 3-5, 9, 13, 15-18 and 20-25 are the main paths: the launch
counts in the kernels' JSON line come from them (the flash kernels' are
the sum of 9, 13, 20, 23's flash run and 24's seq-parallel training,
plus the forward-only long-context runs of 24; the contiguous decode
kernel's of 3, 15, 21 and 25's ``generate()`` and profile, the paged
one's of 4, 16-18, 22 and 25's engine; a two-process path's counts are
its two ranks' sum; each path's on a line of its own). Each phase logs
its wall time. The line before the last is that JSON object; the last line is
``{"ok": true, "device": {...}}``. The whole run logs its wall time.
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
FLASH_KERNELS = r"(?:bf16|fma)_(?:fwd|dq|dkdv)(?:_tma)?_kernel"
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

    got, want = got.detach().float(), want.detach().float()
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
    shape, Llama-8B's attention width at a 4096 window, and MOE_SMALL's
    (H=12, Hkv=6, D=64) at the MoE generation example's window (prompt
    128 + 256 new) and batches."""
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        yield ("llama300m", dtype,
               dict(b=8, h=16, hkv=8, d=64, window=256, bs=16,
                    lens=[0, 15, 16, 47, 100, 191, 240, 255]))
        yield ("llama8b", dtype,
               dict(b=8, h=32, hkv=8, d=128, window=4096, bs=16,
                    lens=[0, 15, 511, 1023, 2047, 3000, 4000, 4095]))
        yield ("moe_small_b8", dtype,
               dict(b=8, h=12, hkv=6, d=64, window=384, bs=16,
                    lens=[0, 15, 16, 127, 128, 200, 300, 383]))
        yield ("moe_small_b32", dtype,
               dict(b=32, h=12, hkv=6, d=64, window=384, bs=16,
                    lens=list(range(0, 372, 12)) + [383]))
        # One rank's heads of Llama-300M under tensor parallelism over 2
        # (phase 25): H 16/2, Hkv 8/2.
        yield ("llama300m_tp2", dtype,
               dict(b=8, h=8, hkv=4, d=64, window=256, bs=16,
                    lens=[0, 15, 16, 47, 100, 191, 240, 255]))


def decode_accuracy(q, k, v, idx: int, hkv: int, got):
    """RMS error of the bf16 contiguous decode kernel's output ``got`` and
    of the model's einsum path (``models.llama``: q.k in bf16, the
    probabilities rounded to bf16, P.V in bf16) against float32 math on
    the same bf16 inputs."""
    import torch

    b, _, h, d = q.shape
    window = k.shape[1]
    scale = d ** -0.5
    qg = q.reshape(b, 1, hkv, h // hkv, d)
    k4, v4 = k.view(b, window, hkv, d), v.view(b, window, hkv, d)
    mask = (torch.arange(window, device=q.device) <= idx)[
        None, None, None, None, :]

    def attend(qx, kx, vx, rounded: bool):
        logits = torch.einsum("bshgd,blhd->bshgl", qx, kx).float() * scale
        probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        if rounded:
            probs = probs.to(qx.dtype)
        return torch.einsum("bshgl,blhd->bshgd", probs, vx).reshape(
            b, 1, h, d).float()

    exact = attend(qg.float(), k4.float(), v4.float(), False)
    einsum = attend(qg, k4, v4, True)
    return {name: float((x.float() - exact).pow(2).mean().sqrt())
            for name, x in (("kernel", got), ("einsum_path", einsum))}


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
        accuracy = None
        if dtype == torch.bfloat16:
            accuracy = decode_accuracy(q, k, v, idx, hkv,
                                       ops.decode_attention(q, k, v, idx,
                                                            hkv))
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
                flush),
            rms_err_vs_float32_math=accuracy)
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


def run_generate(cfg, model_cls=None, what: str = "llama300m"):
    """``generate()`` in float32 at ``cfg`` (``model_cls``, default
    ``LlamaLM``), b=8, prompt 128, 32 new: the kernel's tokens equal the
    einsum path's; returns the model and the decode kernel's launches."""
    import torch

    from horovod_tpu_torch.models.llama import (
        LlamaLM, decode_kernel_disabled, generate)
    from horovod_tpu_torch.ops import decode_attention as ops

    layers = cfg.num_layers
    model = (model_cls or LlamaLM)(cfg, seed=0)
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
    if launches != layers * 31 or paged != 0:
        raise AssertionError(
            f"generate: decode kernel launched {launches} times (paged "
            f"{paged}); expected {layers * 31}")
    with torch.inference_mode():
        logits = model(prompt[:1, :16].to(model.device))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("forward logits are not finite")
    log(f"generate: {what} f32 b=8 p=128 n=32 tokens equal einsum path; "
        f"decode_attention launches {launches}; wall {wall:.3f} s "
        f"(first call, {8 * 32 / wall:.1f} tok/s)")
    return model, launches


def run_engine_parity(model, cfg, what: str = "llama300m"):
    """``ServingEngine`` in float32 over 12 seeded requests: each equals
    ``generate()`` alone; the paged kernel launched once per layer per
    step. Returns its launches."""
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
    if launches != cfg.num_layers * stats["steps"] or contiguous != 0:
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
    log(f"engine: {what} f32 12 requests equal generate(); steps "
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
            ("vit", 8, 197, 197, 12, 12, 64, None, False),
            # The MoE LM's training shape (MOE_SMALL, seq 1024, b8) and
            # ViT-S/16's at the JAX row's batch of 64.
            ("moe_small", 8, 1024, 1024, 12, 6, 64, None, True),
            ("vit_s16", 64, 197, 197, 6, 6, 64, None, False)]


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


def ring_flash_cases():
    """The ring paths' kernel calls (phase 24), in :func:`flash_cases`'
    format: Llama-300M at seq 2048 over 2 ranks, batch 4 — the causal
    diagonal block, a past block (non-causal), the zigzag half-blocks of
    512 (a triangle, and the late half over a whole block) and Ulysses'
    full sequence at H/2, Hkv/2; and the long-context example's
    contiguous block (S 8192 over 2 ranks, H 8, D 64, non-causal)."""
    return [("ring_diag", 4, 1024, 1024, 16, 8, 64, None, True),
            ("ring_past", 4, 1024, 1024, 16, 8, 64, None, False),
            ("ring_zigzag_tri", 4, 512, 512, 16, 8, 64, None, True),
            ("ring_zigzag_hi", 4, 512, 1024, 16, 8, 64, None, False),
            ("ulysses", 4, 2048, 2048, 8, 4, 64, None, True),
            ("long_context", 1, 4096, 4096, 8, 8, 64, None, False)]


def check_flash(device, flush, cases=None, with_dlse: bool = False):
    """The flash kernels against their plain versions on ``cases``
    (default :func:`flash_cases`), timed; returns (label, dtype) -> row.
    ``with_dlse``: the backward gets a random cotangent on lse as well
    (ring attention's merge gives it one), folded into delta."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention as A

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        item = torch.tensor([], dtype=dtype).element_size()
        for label, b, sq, sk, h, hkv, d, mask_kind, causal in (
                cases or flash_cases()):
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
            dlse = (torch.randn(b * h, 1, sq, generator=gen, device=device)
                    if with_dlse else None)
            delta = A.flash_delta(p_out, g, dlse)
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
            if mask_kind != "random" and (sq == sk or not causal):
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
                       dlse=with_dlse,
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
# Phase 14: the kernels' operand range


def operand_decode_cases():
    """(label, shape dict): Llama-tiny's attention (H=4, Hkv=2, D=16), a
    D=32 case, group 16 (H=16, Hkv=1, D=64), D=256 and group 3, at the
    serving window."""
    lens = [0, 15, 16, 47, 100, 191, 240, 255]
    return [("llama_tiny_d16", dict(b=8, h=4, hkv=2, d=16, window=256,
                                    bs=16, lens=lens)),
            ("d32", dict(b=8, h=8, hkv=4, d=32, window=256, bs=16,
                         lens=lens)),
            ("group16", dict(b=8, h=16, hkv=1, d=64, window=256, bs=16,
                             lens=lens)),
            # head_dim 256 (two 16-byte pieces a lane in
            # float32), and group 3, which no block width equals (one
            # query head a block).
            ("d256", dict(b=8, h=8, hkv=4, d=256, window=256, bs=16,
                          lens=lens)),
            ("group3", dict(b=8, h=12, hkv=4, d=64, window=256, bs=16,
                            lens=lens))]


def operand_flash_cases():
    """Flash cases outside the kernels' first instantiations: Llama-tiny's
    D=16 (causal), BERT-tiny's D=32 (non-causal, the padded-tail mask),
    group 16 (H=16 over Hkv=1, causal), D=192 and D=256."""
    return [("llama_tiny_d16", 8, 256, 256, 4, 2, 16, None, True),
            ("bert_tiny_d32", 8, 128, 128, 2, 2, 32, "tail", False),
            ("group16", 2, 1024, 1024, 16, 1, 64, None, True),
            # head_dim 192 (padded to 256) and 256, the FMA
            # family at 32 rows a block, causal and with a tail mask.
            ("d192", 2, 512, 512, 8, 4, 192, None, True),
            ("d256", 2, 512, 512, 8, 2, 256, "tail", False)]


def check_operand_range(device, flush):
    """The decode kernels (contiguous and paged) and the flash kernels at
    operands outside the widths and groups they were first built for,
    float32 at TOL and bfloat16 at SCALED_TOL against the plain versions,
    timed as phases 2 and 6; then ``generate()`` at LLAMA_TINY on the card
    in float32 gives the tokens of ``decode_kernel_disabled()``."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models.llama import (LLAMA_TINY, LlamaLM,
                                                decode_kernel_disabled,
                                                generate)
    from horovod_tpu_torch.ops import decode_attention as ops

    rows = []
    for label, s in operand_decode_cases():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            item = torch.tensor([], dtype=dtype).element_size()
            b, h, hkv, d, window, bs = (s["b"], s["h"], s["hkv"], s["d"],
                                        s["window"], s["bs"])
            f = hkv * d
            gen = torch.Generator(device=device).manual_seed(5)

            def randn(*shape):
                return (torch.randn(*shape, generator=gen, device=device)
                        * 0.5).to(dtype)

            q, k, v = randn(b, 1, h, d), randn(b, window, f), \
                randn(b, window, f)
            slots = window // bs
            lens = torch.tensor(s["lens"], dtype=torch.int32, device=device)
            tables = (torch.randperm(b * slots, generator=gen,
                                     device=device) + 1).view(
                b, slots).to(torch.int32)
            kp, vp = paged_pool(k, v, tables, bs, slots)
            idx = window - 1
            calls = {
                "decode_attention": (
                    lambda: ops.decode_attention(q, k, v, idx, hkv),
                    lambda: ops.decode_attention_plain(q, k, v, idx, hkv),
                    b * (idx + 1)),
                "paged_decode_attention": (
                    lambda: ops.paged_decode_attention(q, kp, vp, tables,
                                                       lens, hkv),
                    lambda: ops.paged_decode_attention_plain(
                        q, kp, vp, tables, lens, hkv),
                    int((lens.long() + 1).sum()))}
            for name, (kernel, plain, n_rows) in calls.items():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                what = f"{name} {label} {dname}"
                if dtype == torch.float32:
                    err = {"max_abs": compare(got, want, dname, what)[0]}
                else:
                    err = compare_scaled(got, want, what)
                nbytes = (2 * n_rows * f + 2 * b * h * d) * item
                if name == "paged_decode_attention":
                    nbytes += tables.numel() * 4 + lens.numel() * 4
                    k_g = kp[tables.long()].view(b, window, hkv, d)
                    v_g = vp[tables.long()].view(b, window, hkv, d)
                    mask = (torch.arange(window, device=device)[None, :]
                            <= lens[:, None].long())[:, None, None, :]
                else:
                    k_g = k.view(b, window, hkv, d)
                    v_g = v.view(b, window, hkv, d)
                    mask = None
                k_g, v_g = k_g.transpose(1, 2), v_g.transpose(1, 2)
                q_sdpa = q.transpose(1, 2)
                t_bound, by = bound(nbytes, 4 * n_rows * h * d, dname)
                row = dict(
                    name=name, shape=label, dtype=dname,
                    dims=dict(b=b, h=h, hkv=hkv, d=d, window=window),
                    errors=err, tolerance=(TOL[dname] if dname == "float32"
                                           else SCALED_TOL),
                    ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
                    bound_ms=t_bound, bound_by=by,
                    library_ms=time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q_sdpa, k_g, v_g, attn_mask=mask,
                            scale=d ** -0.5, enable_gqa=True), flush))
                log(f"operand range {json.dumps(row)}")
                rows.append(row)
    flash_rows = check_flash(device, flush, operand_flash_cases())

    cfg = dataclasses.replace(LLAMA_TINY, dtype=torch.float32)
    model = LlamaLM(cfg, seed=0)
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (8, 40)))
    ops.reset_launch_counts()
    tokens = generate(model, prompt, max_new_tokens=24)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["decode_attention"]
    with decode_kernel_disabled():
        einsum = generate(model, prompt, max_new_tokens=24)
    if not torch.equal(tokens, einsum) or launches != cfg.num_layers * 23:
        raise AssertionError(
            f"generate at LLAMA_TINY on the card: kernel tokens equal "
            f"einsum: {bool(torch.equal(tokens, einsum))}; decode "
            f"launches {launches}, expected {cfg.num_layers * 23}")
    log(f"generate: llama-tiny (H=4, Hkv=2, D=16) f32 b=8 p=40 n=24 on the "
        f"card: tokens equal decode_kernel_disabled(); decode_attention "
        f"launches {launches}")
    return {"decode": rows, "flash": {f"{k[0]} {k[1]}": v
                                      for k, v in flash_rows.items()},
            "generate_llama_tiny_launches": launches}


# ---------------------------------------------------------------------------
# Phases 15-18: the serving fleet and its examples


def release_serving():
    """Drop the serving module's default engine and fleet (``serve()`` and
    ``fleet()`` register them), and with them their models and pools."""
    from horovod_tpu_torch import serving

    serving._default_engine = serving._default_router = None


def run_generation_example(card: str):
    """The generation example at the JAX bench's two decode rows:
    Llama-300M bf16, prompt 128, 256 new tokens, batch 8 then 32. Returns
    the numbers and the contiguous decode kernel's launches over both
    runs (each run: one unmeasured call, one timed)."""
    import torch

    from horovod_tpu_torch.examples import llama_generation
    from horovod_tpu_torch.ops import decode_attention as ops

    rows = {}
    ops.reset_launch_counts()
    for batch in (8, 32):
        out = llama_generation.main([
            "--model", "300m", "--prompt-len", "128", "--max-new-tokens",
            "256", "--batch-size", str(batch)])
        tokens = out["out"]
        if tuple(tokens.shape) != (batch, 384) or not bool(
                ((tokens >= 0) & (tokens < 32000)).all()):
            raise AssertionError(
                f"generation example b={batch}: bad output "
                f"{tuple(tokens.shape)}")
        rows[f"b{batch}"] = {
            "tokens_per_s": out["tokens_per_s"], "seconds": out["seconds"],
            "peak_memory_gib": out["peak_memory_bytes"] / 2 ** 30}
        log(f"generation example llama-300m bf16 p=128 n=256 b={batch}: "
            f"{out['tokens_per_s']:.1f} decode tokens/s "
            f"({out['seconds']:.3f} s), peak memory "
            f"{rows[f'b{batch}']['peak_memory_gib']:.3f} GiB [{card}]")
        del out, tokens
        torch.cuda.empty_cache()
    launches = ops.LAUNCHES["decode_attention"]
    if launches != 2 * 2 * LAYERS * 255:
        raise AssertionError(f"generation example: decode_attention "
                             f"launched {launches} times, expected "
                             f"{2 * 2 * LAYERS * 255}")
    return rows, launches


def run_loadgen(argv, what: str, card: str):
    """One load-generator run; fails unless every request finished.
    Returns its record and the paged decode kernel's launches."""
    import torch

    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.examples import serving_loadgen
    from horovod_tpu_torch.ops import decode_attention as ops

    ops.reset_launch_counts()
    record = serving_loadgen.main(argv)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["paged_decode_attention"]
    metrics.reset_for_tests()
    if record["failed"] != 0 or record["rejected"] != 0 or \
            record["finished"] != record["requests"]:
        raise AssertionError(f"{what}: not every request finished: "
                             f"{json.dumps(record)}")
    if record["substrate"] != "cuda" or record["path"] != "kernel":
        raise AssertionError(f"{what}: ran on {record['substrate']} "
                             f"through the {record['path']} path")
    log(f"loadgen {what}: {record['value']} tok/s, TTFT p50/p99 "
        f"{record['ttft_p50_s']}/{record['ttft_p99_s']} s, TPOT p50/p99 "
        f"{record['tpot_p50_s']}/{record['tpot_p99_s']} s, preemptions "
        f"{record['preemptions']}, blocks peak {record['blocks_peak']}, "
        f"paged_decode_attention launches {launches} [{card}]")
    log(f"loadgen {what} record: {json.dumps(record)}")
    return record, launches


LOADGEN_300M = ["--model", "300m", "--requests", "32", "--seed", "9",
                "--rate", "64", "--min-prompt", "32", "--max-prompt", "128",
                "--min-new", "32", "--max-new", "128", "--max-seq-len",
                "256"]
LOADGEN_FLEET_TINY = ["--model", "tiny", "--requests", "320", "--seed",
                      "11", "--rate", "30", "--prefix-share", "8",
                      "--prefix-len", "192", "--min-prompt", "200",
                      "--max-prompt", "224", "--min-new", "16",
                      "--max-new", "32", "--max-seq-len", "256",
                      "--replicas", "3"]


def run_fleet_parity(model, cfg):
    """Three replicas over one float32 Llama-300M behind the Router, 12
    requests sharing a 64-token prefix with unique tails, the replica
    serving them hard-killed once half are submitted and it has produced
    tokens: every request finishes with the tokens of ``generate()`` of
    its prompt alone (replays included), prefix affinity hit, and the
    metrics' totals agree with the engines and the handles."""
    import torch

    from horovod_tpu_torch import metrics, serving
    from horovod_tpu_torch.models.llama import generate
    from horovod_tpu_torch.ops import decode_attention as ops

    metrics.reset_for_tests()
    metrics.enable()
    rng = np.random.RandomState(12)
    shared = rng.randint(0, cfg.vocab_size, (64,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(
        0, cfg.vocab_size, (int(rng.randint(8, 40)),)).astype(np.int32)])
        for _ in range(12)]
    news = [int(rng.randint(24, 49)) for _ in prompts]
    scfg = serving.ServingConfig(max_batch=8, block_size=16, num_blocks=0,
                                 queue_depth=64, max_seq_len=256)
    router = serving.fleet(model, replicas=3, config=scfg)
    ops.reset_launch_counts()
    handles = [router.submit(p, n) for p, n in zip(prompts[:6], news[:6])]
    victim = handles[0].replica_id
    deadline = time.monotonic() + 300
    while router.engine(victim).stats()["tokens_generated"] < 6:
        if time.monotonic() > deadline:
            raise AssertionError("fleet parity: the victim made no progress")
        time.sleep(0.002)
    victim_engine = router.engine(victim)
    victim_engine.shutdown()
    handles += [router.submit(p, n) for p, n in zip(prompts[6:], news[6:])]
    results = [h.result(timeout=600) for h in handles]
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["paged_decode_attention"]
    rstats = router.router_stats()
    with router._lock:
        affinity_hits = router._affinity_hits
    engines = [router.engine(rid) for rid in range(3)]
    engine_tokens = [e.stats()["tokens_generated"] for e in engines]
    snap = metrics.snapshot()
    router.shutdown()
    for i, (p, n, got) in enumerate(zip(prompts, news, results)):
        want = generate(model, torch.from_numpy(p[None]),
                        max_new_tokens=n)[0, len(p):].tolist()
        if got != want:
            raise AssertionError(
                f"fleet request {i} (replays {handles[i].replays}, replica "
                f"{handles[i].replica_id}) differs from generate():\n"
                f" got={got}\nwant={want}")
    replays = sum(h.replays for h in handles)
    if not (rstats["router_reroutes"] > 0 and replays > 0
            and rstats["router_replica_departures"] == 1
            and affinity_hits > 0):
        raise AssertionError(f"fleet parity: reroutes/replays/departures/"
                             f"affinity {rstats} {replays} {affinity_hits}")
    # Tokens: the counter is every engine's own count, and that is what
    # the handles returned plus what the killed replica made for the
    # requests it lost (their replays start over).
    counter = snap["hvd_serving_tokens_generated_total"]["values"][0][1]
    kept_on_victim = sum(len(r) for h, r in zip(handles, results)
                         if h.replica_id == victim and h.replays == 0)
    lost = victim_engine.stats()["tokens_generated"] - kept_on_victim
    placed = sum(v for _, v in snap["hvd_router_requests_total"]["values"])
    if not (counter == sum(engine_tokens) == sum(news) + lost
            and sum(len(r) for r in results) == sum(news)
            and placed == rstats["router_requests"] == 12 + replays):
        raise AssertionError(
            f"fleet parity: metrics disagree: tokens counter {counter}, "
            f"engines {engine_tokens}, returned {sum(news)} + lost {lost}; "
            f"placements {placed} vs {rstats} (+{replays} replays)")
    metrics.reset_for_tests()
    numbers = {"requests": 12, "victim": victim, "replays": replays,
               "affinity_hits": affinity_hits, "router": rstats,
               "tokens_counter": counter, "tokens_lost_on_victim": lost,
               "paged_launches": launches}
    log(f"fleet parity: llama300m f32, 3 replicas over one model, 12 "
        f"requests on a 64-token prefix, replica {victim} killed mid-run: "
        f"every request equals generate(); {json.dumps(numbers)}")
    return numbers, launches


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
                 steps: int = 2, listed=None):
    """Where a bf16 training step's device time goes, by ``buckets`` plus
    "other" (which must see time in bucket ``required``); the kernel
    count; every kernel of bucket ``listed`` (if given) with its time. Two shares: the idle share of the profiled
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
    if listed:
        result[f"{listed}_kernels"] = [
            [name[:90], us / steps / 1e3]
            for us, bucket, name in sorted(by_name, reverse=True)
            if bucket == listed]
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


# ---------------------------------------------------------------------------
# Phases 19-23: the MoE LM (MOE_SMALL) and the ViT example

# Device-time buckets of the MoE step: flash, matmuls (the experts' bmm,
# the dense projections, the head), routing and the row permutations
# (argmax, the integer cumsum, index/gather kernels), then "other". The
# name match also takes the embedding's lookup and backward and any
# indexing in the loss, so the profile lists every kernel of that bucket.
MOE_SPLIT = (
    ("flash", lambda n: re.search(FLASH_KERNELS, n)),
    ("matmul", lambda n: any(t in n for t in ("nvjet", "gemm", "gemv",
                                              "cutlass", "xmma"))),
    ("routing_gather", lambda n: any(t in n for t in (
        "index", "gather", "scatter", "scan", "cumsum", "argmax",
        "argm", "one_hot", "nonzero"))))


def moe_step_flops(cfg, b: int, s: int):
    """FLOPs of one MoE LM training step (forward and backward, 6 per
    weight per token; attention's QK^T and PV over the causal pairs, 12
    per pair per head width): ``(useful, padded)``. Useful counts the k
    routed assignments of every token; padded every capacity slot the
    experts compute (E x C rows at the training capacity factor)."""
    from horovod_tpu_torch.parallel.moe import _capacity

    d, hd = cfg.dim, cfg.dim // cfg.num_heads
    tokens = b * s
    attn_w = d * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    dense_ffn = 3 * d * cfg.ffn_hidden
    expert = 2 * d * cfg.expert_hidden
    routed = sum(cfg.routed(i) for i in range(cfg.num_layers))
    dense = cfg.num_layers * attn_w + (cfg.num_layers - routed) * dense_ffn \
        + routed * d * cfg.num_experts + d * cfg.vocab_size
    attn = 12 * b * (s * (s + 1) // 2) * cfg.num_heads * hd * cfg.num_layers
    slots = cfg.num_experts * _capacity(tokens, cfg.num_experts,
                                        cfg.capacity_factor,
                                        cfg.num_selected)
    base = 6 * dense * tokens + attn
    return (base + 6 * expert * routed * cfg.num_selected * tokens,
            base + 6 * expert * routed * slots)


class RoutingLog:
    """Each routed layer's decisions in a forward pass, taken from its
    input by a forward hook: the float32 router probabilities and each
    round's expert, as ``parallel.moe._route`` picks them."""

    def __init__(self, model):
        from horovod_tpu_torch.models.moe_lm import MoeFFN
        from horovod_tpu_torch.parallel.moe import _route

        self.calls = []
        cfg = model.config

        def hook(module, args, _out):
            import torch

            with torch.no_grad():
                x = args[0]
                probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                      @ module.gate.float(), -1)
                routing, _ = _route(probs, 1 << 30, cfg.num_selected, True,
                                    torch.float32)
            self.calls.append((probs, torch.stack(routing.expert_idx)))

        self.handles = [m.register_forward_hook(hook)
                        for m in model.modules() if isinstance(m, MoeFFN)]

    def close(self):
        for h in self.handles:
            h.remove()


def routing_flips(kernel_log, plain_log):
    """Per forward call of a routed layer, in order (steps x routed
    layers): ``(flips, decisions, smallest gap, largest gap)``, a flip
    being a decision (token, round) whose expert differs between the two
    runs and its gap the two experts' probability difference in the
    kernel run."""
    if len(kernel_log.calls) != len(plain_log.calls):
        raise AssertionError("routing logs of unequal length")
    rows = []
    for (pk, ek), (_, ep) in zip(kernel_log.calls, plain_log.calls):
        diff = (ek != ep).nonzero().tolist()
        gaps = [float((pk[t, ek[r, t]] - pk[t, ep[r, t]]).abs())
                for r, t in diff]
        rows.append((len(diff), ek.numel(), min(gaps) if gaps else None,
                     max(gaps) if gaps else None))
    return rows


# A routing flip at a larger probability gap fails. Held at the first
# routed layer of a step that has flips: a flip changes its token's
# output, and a capacity drop its neighbours', so the later layers' inputs
# differ by more than rounding and their flips follow from the first.
MOE_FLIP_GAP = 1e-5


def adamw_first_update(grad, eps: float):
    """AdamW's first step, bias-corrected, per unit of lr: g / (|g| + eps)
    (the sign of g wherever |g| >> eps)."""
    return grad / (grad.abs() + eps)


def run_moe_parity(steps: int = 2, batch: int = 8, seq: int = 1024):
    """MOE_SMALL float32 (TF32 off) at seq 1024, batch 8: ``steps`` steps
    through the flash kernels against as many through ``use_flash=False``
    from the same weights and batch, first with SGD (the loss to 1e-4
    relative and every weight within TOL, as phase 8), then with AdamW:
    the loss to 1e-4 relative at every step; at step 0, where both runs
    start from the same weights, every gradient within TOL, and every
    weight after the update within TOL plus AdamW's own spread of the
    two gradients, lr * |u_k - u_p| with u = g / (|g| + eps) (AdamW's first
    update is lr * u, the sign of g: a gradient element within rounding
    of zero can take either sign in the two runs and so moves its weight
    by up to 2 lr either way). After the last step the weights outside
    TOL are counted, by parameter, and their step-0 |g| and relative
    gradient difference reported beside every element's. Every routing decision of both
    runs is compared: at every step, a flip at the first routed layer
    with flips whose probability gap exceeds MOE_FLIP_GAP fails."""
    import torch

    from horovod_tpu_torch.examples import llama_training, moe_lm_training
    from horovod_tpu_torch.models.moe_lm import MOE_SMALL
    from horovod_tpu_torch.ops import attention as A

    cfg = dataclasses.replace(MOE_SMALL, dtype=torch.float32)
    ids = llama_training.batch_ids(cfg, batch, seq, "cuda")
    loss_fn = moe_lm_training.make_loss_fn(0.01)
    layers = cfg.num_layers
    tol = TOL["float32"]
    report = {}
    for opt_name in ("sgd", "adamw"):
        runs = {}
        step0, hyper = {}, None
        for use_flash in (True, False):
            model = moe_lm_training.make_model(cfg, no_flash=not use_flash,
                                               device="cuda")
            opt = llama_training.make_optimizer(opt_name, model)
            if opt_name == "adamw":
                hyper = {k: opt.param_groups[0][k] for k in ("lr", "eps")}
            routing = RoutingLog(model)
            losses = []
            for step in range(steps):
                A.reset_launch_counts()
                losses.append(float(llama_training.train_step(
                    model, opt, ids, loss_fn)))
                want = layers if use_flash else 0
                if set(A.LAUNCHES.values()) != {want}:
                    raise AssertionError(
                        f"moe parity step {step} (use_flash={use_flash}): "
                        f"flash launches {A.LAUNCHES}, expected {want}")
                if step == 0 and opt_name == "adamw":
                    # Both runs' gradients and weights after step 0.
                    step0[use_flash] = [
                        (name, p.grad.detach().clone(), p.detach().clone())
                        for name, p in model.named_parameters()]
            routing.close()
            runs[use_flash] = (model, losses, routing)
            del opt
        (kmodel, klosses, klog), (pmodel, plosses, plog) = (runs[True],
                                                            runs[False])
        rows = routing_flips(klog, plog)
        routed = len(rows) // steps
        first_flips = []
        for step in range(steps):
            hit = [r for r in rows[step * routed:(step + 1) * routed] if r[0]]
            first_flips.append(hit[0] if hit else None)
            if hit and hit[0][3] > MOE_FLIP_GAP:
                raise AssertionError(
                    f"moe parity ({opt_name}) step {step}: {hit[0][0]} "
                    f"routing flips at the first routed layer with any, "
                    f"the largest at a probability gap of {hit[0][3]:.3g} "
                    f"(> {MOE_FLIP_GAP})")
        flips = sum(r[0] for r in rows)
        decisions = sum(r[1] for r in rows)
        gaps = [g for r in rows for g in r[2:] if g is not None]
        gap_min = min(gaps) if gaps else None
        gap_max = max(gaps) if gaps else None
        for a, b in zip(klosses, plosses):
            if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
                raise AssertionError(
                    f"moe parity ({opt_name}): losses {klosses} vs {plosses}")
        adamw = None
        if opt_name == "adamw":
            adamw = check_adamw_step0(step0, kmodel, pmodel, **hyper)
        del step0
        worst, outside, total = 0.0, 0, 0
        with torch.no_grad():
            for (name, p), (_, r) in zip(kmodel.named_parameters(),
                                         pmodel.named_parameters()):
                worst = max(worst, float((p - r).abs().max()))
                bad = (p - r).abs() > tol["atol"] + tol["rtol"] * r.abs()
                outside += int(bad.sum())
                total += p.numel()
                if opt_name == "sgd":
                    compare(p, r, "float32", f"moe parity weight {name}")
        report[opt_name] = {
            "losses_kernel": klosses, "losses_plain": plosses,
            "max_abs_weight_diff": worst,
            "weights_outside_tol": outside, "weights": total,
            "routing_decisions": decisions, "routing_flips": flips,
            "flip_gap_min": gap_min, "flip_gap_max": gap_max,
            "routing_by_layer": rows,
            "first_flipping_layer_by_step": first_flips, "adamw": adamw}
        log(f"moe parity: moe-small f32 seq {seq} b={batch}, {steps} "
            f"{opt_name} steps; losses kernel {klosses} vs plain {plosses}; "
            f"max abs weight diff {worst:.3g}, {outside} of {total} weights "
            f"outside {TOL['float32']} after the last step"
            f"{' (held: 0 allowed)' if opt_name == 'sgd' else ''}"
            f"; routing: {flips} of {decisions} decisions differ (gap "
            f"min {gap_min}, max {gap_max}; per step, the first routed "
            f"layer with flips: {first_flips}); flash launches {layers} "
            f"per kernel per step")
        if adamw is not None:
            log(f"moe parity adamw: {json.dumps(adamw)}")
        del kmodel, pmodel, runs, klog, plog
        torch.cuda.empty_cache()
    return report


def check_adamw_step0(step0, kmodel, pmodel, lr: float, eps: float):
    """Phase 19's AdamW holds (see :func:`run_moe_parity`): step 0's
    gradients within TOL, and step 0's weights within TOL plus
    lr * |u_k - u_p|. Then, for the weights outside TOL after the last
    step, their step-0 |g| (kernel run) and the two runs' relative
    gradient difference there, against every element's."""
    import torch

    tol = TOL["float32"]
    grad_diff = spread_excess = 0.0
    outside0 = 0
    by_param0, by_param = {}, {}
    g_abs, g_out, rel, rel_out = [], [], [], []
    with torch.no_grad():
        for (name, gk, wk), (_, gp, wp), (_, p), (_, r) in zip(
                step0[True], step0[False], kmodel.named_parameters(),
                pmodel.named_parameters()):
            compare(gk, gp, "float32", f"moe parity adamw step-0 gradient "
                                       f"{name}")
            grad_diff = max(grad_diff, float((gk - gp).abs().max()))
            limit = tol["atol"] + tol["rtol"] * wp.abs()
            spread = lr * (adamw_first_update(gk, eps)
                           - adamw_first_update(gp, eps)).abs()
            err = (wk - wp).abs()
            n0 = int((err > limit).sum())
            outside0 += n0
            if n0:
                by_param0[name] = n0
            spread_excess = max(spread_excess,
                                float((err - limit - spread).max()))
            # |g_k - g_p| / |g_k|: above 1 where the two signs may differ.
            ratio = ((gk - gp).abs() / gk.abs().clamp_min(1e-30)).flatten()
            bad = ((p - r).abs()
                   > tol["atol"] + tol["rtol"] * r.abs()).flatten()
            if bool(bad.any()):
                by_param[name] = [int(bad.sum()), p.numel()]
            g_abs.append(gk.abs().flatten())
            g_out.append(gk.abs().flatten()[bad])
            rel.append(ratio)
            rel_out.append(ratio[bad])
        if spread_excess > 0:
            raise AssertionError(
                f"moe parity adamw step 0: a weight differs by "
                f"{spread_excess:.3g} beyond TOL + lr |u_k - u_p|")
        g_abs, g_out = torch.cat(g_abs), torch.cat(g_out)
        rel, rel_out = torch.cat(rel), torch.cat(rel_out)

        def spread(t):
            return None if not t.numel() else {
                "median": float(t.median()), "max": float(t.max())}

        return {
            "lr": lr, "eps": eps,
            "step0_max_abs_grad_diff": grad_diff,
            "step0_grads_outside_tol": 0,
            "step0_weights_outside_tol": outside0,
            "step0_weights_beyond_tol_plus_lr_spread": 0,
            "step0_outside_by_param": by_param0,
            "last_step_weights_outside_tol": int(g_out.numel()),
            # [outside, size] of the 12 parameters with the most.
            "last_step_outside_by_param": dict(sorted(
                by_param.items(), key=lambda kv: -kv[1][0])[:12]),
            "last_step_params_with_outside": len(by_param),
            "step0_abs_grad": {"all": spread(g_abs), "at_outside":
                               spread(g_out)},
            "step0_rel_grad_diff": {"all": spread(rel),
                                    "at_outside": spread(rel_out)}}


def run_moe_training_timed(card: str):
    """The MoE training example's main path: moe-small, bf16, seq 1024,
    batch 8, AdamW, 10 timed steps: tokens/s, step ms, falling loss, peak
    memory, the share of the bf16 dense peak (useful FLOPs: the routed
    assignments; the capacity-padded count beside it) and a profiled pair
    of steps split into flash, matmuls, routing and gathers, and the rest.
    Returns its numbers and the flash launch counts of the run."""
    import torch

    from horovod_tpu_torch.examples import llama_training
    from horovod_tpu_torch.examples import moe_lm_training as ex
    from horovod_tpu_torch.ops import attention as A

    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    out = ex.main(["--model", "small", "--seq-len", "1024",
                   "--batch-size", "8", "--num-iters", "10"])
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)
    losses = out["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"moe training: loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    useful, padded = moe_step_flops(out["model"].config, 8, 1024)
    bound_ms = useful / PEAK_OPS_PER_S["bfloat16"] * 1e3
    numbers = {"tokens_per_s": out["tokens_per_s"],
               "step_ms": out["step_ms"], "losses": losses,
               "peak_memory_gib": peak, "flash_launches": launches,
               "tflop_per_step_useful": useful / 1e12,
               "tflop_per_step_capacity_padded": padded / 1e12,
               "bound_ms": bound_ms,
               "dense_peak_share": bound_ms / out["step_ms"],
               "dense_peak_share_padded": padded / useful * bound_ms
               / out["step_ms"]}
    log(f"moe training bf16 moe-small seq 1024 b=8 adamw: "
        f"{out['tokens_per_s']:.1f} tokens/s, step {out['step_ms']:.3f} ms, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, peak memory "
        f"{peak:.2f} GiB, {useful / 1e12:.3f} TFLOP per step useful "
        f"({padded / 1e12:.3f} capacity-padded), bf16 bound "
        f"{bound_ms:.3f} ms = {numbers['dense_peak_share']:.4f} of the step "
        f"({numbers['dense_peak_share_padded']:.4f} padded), flash launches "
        f"{launches} over 11 steps [{card}]")
    numbers["step_profile"] = profile_step(
        lambda: llama_training.train_step(out["model"], out["optimizer"],
                                          out["ids"], out["loss_fn"]),
        out["step_ms"], MOE_SPLIT, "flash", "moe-small",
        listed="routing_gather")
    del out
    torch.cuda.empty_cache()
    return numbers


def run_moe_generation(card: str):
    """``generate()`` at MOE_SMALL in float32 through the decode kernel
    (tokens equal the einsum path's), then the generation example at
    ``--model moe-small``, bf16, prompt 128, 256 new, batch 8 and 32:
    tokens/s and peak memory. Returns the numbers and the contiguous
    decode kernel's launches of the example's runs and of generate()."""
    import torch

    from horovod_tpu_torch.examples import llama_generation
    from horovod_tpu_torch.models.moe_lm import MOE_SMALL, MoeLM
    from horovod_tpu_torch.ops import decode_attention as ops

    cfg = dataclasses.replace(MOE_SMALL, dtype=torch.float32)
    model, gen_launches = run_generate(cfg, MoeLM, "moe-small")
    rows = {}
    ops.reset_launch_counts()
    for batch in (8, 32):
        out = llama_generation.main([
            "--model", "moe-small", "--prompt-len", "128",
            "--max-new-tokens", "256", "--batch-size", str(batch)])
        tokens = out["out"]
        if tuple(tokens.shape) != (batch, 384) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise AssertionError(f"moe generation example b={batch}: bad "
                                 f"output {tuple(tokens.shape)}")
        rows[f"b{batch}"] = {
            "tokens_per_s": out["tokens_per_s"], "seconds": out["seconds"],
            "peak_memory_gib": out["peak_memory_bytes"] / 2 ** 30}
        log(f"generation example moe-small bf16 p=128 n=256 b={batch}: "
            f"{out['tokens_per_s']:.1f} decode tokens/s "
            f"({out['seconds']:.3f} s), peak memory "
            f"{rows[f'b{batch}']['peak_memory_gib']:.3f} GiB [{card}]")
        del out, tokens
        torch.cuda.empty_cache()
    launches = ops.LAUNCHES["decode_attention"]
    want = 2 * 2 * cfg.num_layers * 255
    if launches != want:
        raise AssertionError(f"moe generation example: decode_attention "
                             f"launched {launches} times, expected {want}")
    rows["bf16_tokens_vs_einsum"] = bf16_token_agreement()
    return model, rows, gen_launches, launches


def bf16_token_agreement(batch: int = 8, new: int = 32):
    """The generation example's bf16 model and prompt (MOE_SMALL, seed 0,
    prompt 128), ``new`` greedy tokens through the decode kernel and
    through ``decode_kernel_disabled()``: how many rows agree, and where
    each other row first differs. Reported, not held: in bf16 two
    logits within rounding of each other pick either token, and the rows
    part from there (the kernel itself is held at this shape in phase 2,
    ``moe_small_b8``)."""
    import torch

    from horovod_tpu_torch.examples.llama_generation import CONFIGS
    from horovod_tpu_torch.models.llama import (decode_kernel_disabled,
                                                generate)

    model_cls, cfg = CONFIGS["moe-small"]
    model = model_cls(cfg, device="cuda", seed=0)
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, 128)))
    got = generate(model, prompt, max_new_tokens=new)[:, 128:]
    with decode_kernel_disabled():
        want = generate(model, prompt, max_new_tokens=new)[:, 128:]
    first = [None if torch.equal(g, w) else int((g != w).nonzero()[0])
             for g, w in zip(got, want)]
    # The first decode step's logits (a full forward over the prompt and
    # the first token, which both paths take from the same prefill): each
    # row's top-two gap in bf16 spacings at the top logit.
    with torch.inference_mode():
        logits = model(torch.cat([prompt.to(model.device), want[:, :1]],
                                 1))[:, -1]
    top2 = logits.float().topk(2, dim=-1).values
    _, exp = torch.frexp(top2[:, 0])
    spacing = torch.ldexp(torch.full_like(top2[:, 0], torch.finfo(
        logits.dtype).eps), exp - 1)
    out = {"dtype": str(cfg.dtype).replace("torch.", ""),
           "logits_dtype": str(logits.dtype).replace("torch.", ""),
           "batch": batch, "new_tokens": new,
           "rows_equal": first.count(None),
           "first_difference_by_row": first,
           "first_decode_top2_gap_in_spacings": (
               (top2[:, 0] - top2[:, 1]) / spacing).tolist(),
           "first_decode_step_vs_float32": first_step_against_float32(
               model)}
    log(f"moe-small bf16 greedy tokens, kernel vs einsum path: "
        f"{json.dumps(out)}")
    del model
    torch.cuda.empty_cache()
    return out


def first_step_against_float32(model, batch: int = 64, prompt_len=128):
    """One decode step of the bf16 ``model`` (``batch`` seeded prompts,
    then one seeded token each) through the decode kernel and through
    the einsum path, each against a float32 copy of the same weights
    (einsum path): the logits' max and RMS difference, the rows whose
    argmax agrees, the routing decisions of the new token that differ
    (of batch x top-k x routed layers), and layer 0's attention output,
    whose inputs the two bf16 paths share."""
    import torch

    from horovod_tpu_torch.models.llama import (decode_kernel_disabled,
                                                init_kv_cache)

    cfg32 = dataclasses.replace(model.config, dtype=torch.float32)
    ref = type(model)(cfg32, device="cuda", seed=0)
    ref.load_state_dict(model.state_dict())
    draw = np.random.RandomState(1).randint(
        0, cfg32.vocab_size, (batch, prompt_len + 1))
    ids = torch.from_numpy(draw[:, :-1]).to(model.device)
    token = torch.from_numpy(draw[:, -1]).to(model.device)
    s = prompt_len

    def step(m, kernel: bool):
        log_ = RoutingLog(m)
        # Layer 0's attention output: both bf16 paths share its inputs.
        seen = []
        hook = m.layers[0].attention.register_forward_hook(
            lambda _m, _a, o: seen.append(o.float()))
        with torch.inference_mode():
            cache = init_kv_cache(m.config, ids.shape[0], s + 1,
                                  device=m.device)
            m(ids, cache=cache, cache_index=0)
            log_.calls.clear()
            if kernel:
                logits, _ = m(token[:, None], cache=cache, cache_index=s)
            else:
                with decode_kernel_disabled():
                    logits, _ = m(token[:, None], cache=cache,
                                  cache_index=s)
        log_.close()
        hook.remove()
        return (logits[:, -1].float(), [e for _, e in log_.calls],
                seen[-1])

    want, want_routes, want_attn = step(ref, False)
    out = {"batch": batch, "routing_decisions": sum(
        r.numel() for r in want_routes)}
    for path in ("kernel", "einsum"):
        got, routes, attn = step(model, path == "kernel")
        err = got - want
        out[path] = {
            "layer0_attention_rms_diff": float(
                (attn - want_attn).pow(2).mean().sqrt()),
            "logits_max_abs_diff": float(err.abs().max()),
            "logits_rms_diff": float(err.pow(2).mean().sqrt()),
            "argmax_rows_equal": int((got.argmax(-1)
                                      == want.argmax(-1)).sum()),
            "routing_decisions_differing": int(sum(
                int((a != b).sum()) for a, b in zip(routes, want_routes)))}
    del ref
    torch.cuda.empty_cache()
    return out


def run_vit_timed(card: str):
    """The ViT example at the JAX row ``vit_s16_224_b64_adamw_spc8``:
    ViT-S/16, bf16, batch 64, 8 steps per call, one warm-up call and 3
    timed, with ``--attention xla`` then ``flash`` (non-causal at S=197):
    img/s each, and the flash kernels' launches of the flash run."""
    import torch

    from horovod_tpu_torch.examples import vit_training as ex
    from horovod_tpu_torch.ops import attention as A

    rows = {}
    for attention in ("xla", "flash"):
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        out = ex.main(["--model", "s16", "--batch-per-chip", "64",
                       "--steps", "4", "--warmup-steps", "1",
                       "--steps-per-call", "8", "--attention", attention])
        torch.cuda.synchronize()
        launches = dict(A.LAUNCHES)
        if not all(np.isfinite(out["losses"])):
            raise AssertionError(f"vit {attention}: loss {out['losses']}")
        want = 12 * 4 * 8 if attention == "flash" else 0
        if set(launches.values()) != {want}:
            raise AssertionError(f"vit {attention}: flash launches "
                                 f"{launches}, expected {want} each")
        rows[attention] = {
            "images_per_s": out["images_per_s"], "step_ms": out["step_ms"],
            "losses": out["losses"], "flash_launches": launches,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        log(f"vit example s16 224px bf16 b=64 spc=8 --attention "
            f"{attention}: {out['images_per_s']:.1f} img/s, step "
            f"{out['step_ms']:.3f} ms, loss {out['losses'][0]:.4f} -> "
            f"{out['losses'][-1]:.4f}, peak memory "
            f"{rows[attention]['peak_memory_gib']:.2f} GiB, flash launches "
            f"{launches} [{card}]")
        del out
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phases 24-26: the parallel modes, on two ranks sharing the card
#
# NCCL refuses two ranks on one device, so the two worker processes form
# a gloo group on cuda:0 themselves (init_process_group before hvd.init,
# which then adopts it; HOROVOD_LOCAL_RANK=0 binds both to cuda:0). gloo
# carries CUDA tensors for allreduce, allgather, broadcast and alltoall;
# the neighbour exchange stages them through host memory (see
# horovod_tpu_torch/parallel/exchange.py).

PARALLEL_SP = ["--model", "300m", "--seq-len", "2048", "--seq-parallel",
               "2"]
PARALLEL_TP_PROFILE = ["--model", "300m", "--tp", "2", "--batch-size", "8",
                       "--prompt-len", "128", "--max-new-tokens", "64"]


def _counts():
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import decode_attention as D

    return {**A.LAUNCHES, **D.LAUNCHES}


def _reset_counts():
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import decode_attention as D

    A.reset_launch_counts()
    D.reset_launch_counts()


def _path(fn):
    """Run one main path with every launch count set to 0 just before
    and read just after; returns (its result, the counts)."""
    import torch

    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, _counts()


def worker_sp_parity(rank: int, batch: int = 2, steps: int = 2):
    """Phase 24 parity: the pieces of ``llama_training --seq-parallel
    2`` (``make_model`` with ring attention over ``seq``,
    ``make_sp_loss_fn``, ``batch_ids`` and ``train_step``) in float32,
    SGD, ``steps`` steps, against the single-process run at the same
    global batch (rank 0 runs it after, on the full sequence): the loss
    to 1e-4 relative at every step, every weight within TOL."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.models.llama import LLAMA_300M
    from horovod_tpu_torch.parallel import make_mesh

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32)
    seq_len = int(PARALLEL_SP[PARALLEL_SP.index("--seq-len") + 1])
    mesh = make_mesh({"data": 1, "seq": 2})
    seq = mesh.group("seq")
    ring = ex.make_model(cfg, device="cuda", seq_group=seq)
    ring_opt = ex.make_optimizer("sgd", ring, mesh.group("data"))
    sp_loss = ex.make_sp_loss_fn(seq)
    ids = ex.batch_ids(cfg, batch, seq_len, "cuda", mesh)
    losses, counts = _path(lambda: [
        float(ex.train_step(ring, ring_opt, ids, sp_loss, seq))
        for _ in range(steps)])
    row = {"losses_ring": losses, "launches": counts}
    if rank == 0:
        model = ex.make_model(cfg, device="cuda")
        opt = ex.make_optimizer("sgd", model, mesh.group("data"))
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (batch, seq_len))).cuda()
        loss_fn = ex.make_loss_fn(0)
        ref = [float(ex.train_step(model, opt, ids, loss_fn))
               for _ in range(steps)]
        for a, b in zip(losses, ref):
            if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
                raise AssertionError(f"seq-parallel parity: losses "
                                     f"{losses} vs {ref}")
        worst = 0.0
        with torch.no_grad():
            for (name, p), (_, r) in zip(ring.named_parameters(),
                                         model.named_parameters()):
                worst = max(worst, float((p - r).abs().max()))
                compare(p, r, "float32", f"seq-parallel parity weight {name}")
        row.update(losses_single=ref, max_abs_weight_diff=worst)
        del model, opt
    del ring, ring_opt
    dist.barrier()
    torch.cuda.empty_cache()
    return row


def _wall_ms(fn, repeats: int = 3) -> float:
    """Median host wall time of ``fn()`` with the card synchronised
    around it."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def sp_step_split(out):
    """Where a seq-parallel step's wall time goes: the forward alone,
    the gradient sum over ``seq`` alone (a float32 allreduce per
    parameter over gloo), and one K/V hop of a layer (host-staged), each timed apart
    on this rank."""
    import torch

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.parallel.exchange import ring_exchange

    model, ids, group = out["model"], out["ids"], out["mesh"].group("seq")
    cfg = model.config
    kv = torch.zeros(ids.shape[0], ids.shape[1], cfg.num_kv_heads,
                     cfg.dim // cfg.num_heads, dtype=cfg.dtype,
                     device=ids.device)
    with torch.no_grad():
        forward = _wall_ms(lambda: out["loss_fn"](model, ids))
    return {"forward": forward,
            "gradient_sum": _wall_ms(lambda: ex.sum_gradients(model,
                                                              group)),
            "kv_hop": _wall_ms(lambda: ring_exchange([kv, kv], group))}


def worker_sp_timed(steps: int = 3, batch: int = 4):
    """Phase 24 timing: the seq-parallel example in bf16 (two ranks on
    one card), and the long-context example at its defaults, both
    layouts; the flash launches of each path."""
    import torch

    from horovod_tpu_torch.examples import llama_training as ex
    from horovod_tpu_torch.examples import long_context_ring_attention as lc

    out, counts = _path(lambda: ex.main(
        PARALLEL_SP + ["--batch-size", str(batch), "--num-iters",
                       str(steps)]))
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"seq-parallel bf16: losses {out['losses']}")
    row = {"tokens_per_s": out["tokens_per_s"], "step_ms": out["step_ms"],
           "losses": out["losses"], "batch": batch, "launches": counts,
           "split_ms": sp_step_split(out)}
    del out
    torch.cuda.empty_cache()
    for layout in ("contiguous", "zigzag"):
        rec, counts = _path(lambda: lc.main(["--layout", layout]))
        if not rec["finite"] or rec["out_shape"] != [1, 8192, 8, 64]:
            raise AssertionError(f"long context {layout}: {rec}")
        row[f"long_context_{layout}"] = {**rec, "launches": counts}
    return row


def tp_step_split(mesh, batch: int = 8, prompt_len: int = 128):
    """Where a TP token step's wall time goes: one bf16 Llama-300M token
    step over ``mesh``'s ``model`` axis (b8, after a 128-token prefill),
    and the collectives that step issues, recorded during one step and
    replayed alone on the same tensors (gloo, CUDA tensors)."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM

    model = LlamaLM(LLAMA_300M, seed=0, mesh=mesh)
    cfg = model.config
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, prompt_len))).to(model.device)
    token = prompt[:, -1:]
    real = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}
    calls = []

    def recording(name):
        def fn(*args, **kwargs):
            calls.append((name, args, kwargs))
            return real[name](*args, **kwargs)
        return fn

    def step():
        model(token, cache=cache, cache_index=prompt_len)

    def collectives():
        for name, args, kwargs in calls:
            real[name](*args, **kwargs)

    with torch.inference_mode(), llama.decode_path_context("kernel_tp"):
        cache = llama.init_kv_cache(cfg, batch, prompt_len + 1,
                                    device=model.device,
                                    kv_heads=model.kv_heads)
        model(prompt, cache=cache, cache_index=0)
        step()
        for name in real:
            setattr(dist, name, recording(name))
        try:
            step()
        finally:
            for name, fn in real.items():
                setattr(dist, name, fn)
        issued = len(calls)
        step_ms = _wall_ms(step, repeats=9)
        collectives_ms = _wall_ms(collectives, repeats=9)
    del model, cache, calls[:]
    torch.cuda.empty_cache()
    return {"batch": batch, "step_ms": step_ms,
            "collectives_ms": collectives_ms, "collectives": issued}


def worker_tp(rank: int):
    """Phase 25: Llama-300M float32 with tensor parallelism over the two
    ranks: ``generate()`` (b8, prompt 128, 32 new) and the engine (8
    requests) give the unsharded model's tokens, through both decode
    kernels on each rank's heads; then ``tp_decode_profile`` in bf16."""
    import torch

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.examples import tp_decode_profile
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM
    from horovod_tpu_torch.parallel import make_mesh

    cfg = dataclasses.replace(LLAMA_300M, dtype=torch.float32)
    mesh = make_mesh({"data": 1, "model": 2})
    base = LlamaLM(cfg, seed=0)
    tp = LlamaLM(cfg, seed=0, mesh=mesh)
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 128)))
    want = llama.generate(base, prompt, 32)
    got, gen_counts = _path(lambda: llama.generate(tp, prompt, 32))
    info = llama.LAST_DECODE_PATH
    if info.path != "kernel_tp" or not torch.equal(got, want):
        raise AssertionError(f"tp generate: path {info.path}; tokens equal "
                             f"{torch.equal(got, want)}")
    if gen_counts["decode_attention"] != cfg.num_layers * 31:
        raise AssertionError(f"tp generate: launches {gen_counts}")
    rng = np.random.RandomState(1)
    prompts = random_prompts(rng, 8, cfg.vocab_size, 32, 128)
    news = [int(rng.randint(8, 33)) for _ in prompts]
    scfg = serving.ServingConfig(max_batch=4, block_size=16, num_blocks=0,
                                 queue_depth=64, max_seq_len=256)
    engine = serving.ServingEngine(tp, scfg)
    handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
    _, engine_counts = _path(engine.run_until_idle)
    steps = engine.stats()["steps"]
    if engine.decode_path.path != "kernel_tp" or \
            engine_counts["paged_decode_attention"] != cfg.num_layers * steps:
        raise AssertionError(f"tp engine: path {engine.decode_path.path}, "
                             f"launches {engine_counts} over {steps} steps")
    for i, (p, n, h) in enumerate(zip(prompts, news, handles)):
        ref = llama.generate(base, torch.from_numpy(p[None]), n)
        if h.result(timeout=0) != ref[0, len(p):].tolist():
            raise AssertionError(f"tp engine request {i} differs from the "
                                 "unsharded generate()")
    engine.shutdown()
    del base, tp, engine
    torch.cuda.empty_cache()
    profile, profile_counts = _path(
        lambda: tp_decode_profile.main(PARALLEL_TP_PROFILE))
    if profile["path"] != "kernel_tp":
        raise AssertionError(f"tp_decode_profile: {profile}")
    # One of the ~35 collectives of a TP decode step, alone: the sum
    # after a block's attention at b8 in bf16 (gloo, CUDA tensors).
    x = torch.ones(8, 1, cfg.dim, dtype=torch.bfloat16, device="cuda")
    profile["allreduce_ms"] = _wall_ms(
        lambda: torch.distributed.all_reduce(x, group=mesh.group("model")),
        repeats=25)
    profile["step_split"] = tp_step_split(mesh)
    return {"generate": {"path": info.path, "reason": info.reason,
                         "launches": gen_counts},
            "engine": {"requests": len(prompts), "steps": steps,
                       "launches": engine_counts},
            "profile": {**profile, "launches": profile_counts}}


def worker_pipeline(rank: int, features: int = 1024, layers: int = 2,
                    microbatches: int = 8, rows: int = 32):
    """Phase 26: GPipe and 1F1B over the two ranks (one stage each) equal
    the sequential stages on one rank: outputs, loss and every gradient
    in float32 within TOL."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.examples.pipeline_parallel import (make_stages,
                                                              stage_fn)
    from horovod_tpu_torch.parallel import make_mesh
    from horovod_tpu_torch.parallel.pipeline import (collect_from_last_stage,
                                                     pipeline_apply,
                                                     pipeline_loss)

    mesh = make_mesh({"pipe": 2})
    pipe, stage = mesh.group("pipe"), mesh.axis_index("pipe")
    rng = np.random.RandomState(0)
    stages = [{k: v.cuda() for k, v in s.items()}
              for s in make_stages(rng, 2, layers, features)]
    x = torch.from_numpy(rng.randn(microbatches, rows, features).astype(
        np.float32)).cuda()

    def mine():
        return {k: v.clone().requires_grad_() for k, v in stages[stage].items()}

    p = mine()
    out = pipeline_apply(stage_fn, p, x, group=pipe)
    full = collect_from_last_stage(out, pipe)
    loss = pipeline_loss((out ** 2).mean(dim=(1, 2)), pipe)
    loss.backward()
    gpipe_grads = {k: v.grad for k, v in p.items()}
    f1b_loss, f1b_grads = pipeline_apply(
        stage_fn, mine(), x, group=pipe, schedule="1f1b",
        loss_fn=lambda y: (y ** 2).mean())
    # The sequential reference, on every rank.
    ref_p = [{k: v.clone().requires_grad_() for k, v in s.items()}
             for s in stages]
    h = x
    for sp in ref_p:
        h = stage_fn(sp, h)
    ref_loss = (h ** 2).mean()
    ref_loss.backward()
    compare(full.detach(), h.detach(), "float32", "gpipe outputs")
    ref = float(ref_loss.detach())
    for what, got in (("gpipe", float(loss.detach())),
                      ("1f1b", float(f1b_loss))):
        if abs(got - ref) > 1e-6 * abs(ref):
            raise AssertionError(f"{what} loss {got} vs sequential {ref}")
    for k in ("w", "b"):
        compare(gpipe_grads[k], ref_p[stage][k].grad, "float32",
                f"gpipe grad {k} stage {stage}")
        compare(f1b_grads[k], ref_p[stage][k].grad, "float32",
                f"1f1b grad {k} stage {stage}")
    dist.barrier()
    return {"stages": 2, "features": features, "layers_per_stage": layers,
            "microbatches": microbatches, "rows": rows,
            "loss": ref}


def parallel_worker(rank: int, port: int, out_path: str) -> int:
    """One of the two ranks of phases 24-26 (``chip_smoke.py
    --parallel-worker RANK PORT OUT``); rank 0 writes the JSON."""
    import datetime

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=600))
    hvd.init()
    if hvd.device() != torch.device("cuda", 0) or hvd.size() != 2:
        raise AssertionError(f"worker {rank}: device {hvd.device()}, "
                             f"size {hvd.size()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for label, fn in (("24 sp parity", lambda: worker_sp_parity(rank)),
                      ("24 sp timed", worker_sp_timed),
                      ("25 tp", lambda: worker_tp(rank)),
                      ("26 pipeline", lambda: worker_pipeline(rank))):
        t = time.perf_counter()
        results[label] = fn()
        results[label]["wall_s"] = time.perf_counter() - t
        log(f"rank {rank} phase {label}: "
            f"{results[label]['wall_s']:.1f} s")
    # Every rank's launch counts, per path.
    results["counts_by_rank"] = hvd.allgather_object(
        {label: _launch_rows(row) for label, row in results.items()})
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
    log(f"rank {rank}: worker ok")
    return 0


def _launch_rows(row):
    """Every ``launches`` dict in a phase's result, by key path."""
    found = {}
    if isinstance(row, dict):
        for key, value in row.items():
            if key == "launches":
                found[""] = value
            else:
                for sub, counts in _launch_rows(value).items():
                    found[f"{key}/{sub}".rstrip("/")] = counts
    return found


def run_parallel_phases(card: str):
    """Phases 24-26 on two ranks sharing the card (see above): returns
    the workers' results."""
    import tempfile

    import torch

    torch.cuda.empty_cache()
    port = free_port()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    out_path = os.path.join(out_dir, "parallel.json")
    procs = []
    try:
        for rank in range(2):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
            env.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                       HOROVOD_LOCAL_RANK="0", HOROVOD_LOCAL_SIZE="1",
                       PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--parallel-worker", str(rank), str(port), out_path],
                env=env))
        codes = [proc.wait(timeout=900) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if codes != [0, 0]:
        raise AssertionError(f"parallel workers exited {codes}")
    with open(out_path) as f:
        results = json.load(f)
    sp = results["24 sp parity"]
    log(f"seq-parallel parity: llama300m f32 seq 2048 sp 2 b=2, 2 SGD "
        f"steps; losses ring {sp['losses_ring']} vs single process "
        f"{sp['losses_single']}; every weight within {TOL['float32']} "
        f"(max abs diff {sp['max_abs_weight_diff']:.3g})")
    timed = results["24 sp timed"]
    log(f"seq-parallel training bf16 llama300m seq 2048 sp 2 b=4 (two "
        f"ranks sharing one card): {timed['tokens_per_s']:.1f} tokens/s, "
        f"step {timed['step_ms']:.1f} ms, losses {timed['losses']}; rank 0 "
        f"split (ms): {json.dumps(timed['split_ms'])} [{card}]")
    for layout in ("contiguous", "zigzag"):
        rec = timed[f"long_context_{layout}"]
        log(f"long context ring S=8192 H=8 D=64 bf16 {layout} (two ranks "
            f"sharing one card): {rec['ms_per_iter']:.2f} ms/iter, "
            f"{rec['tflops']:.2f} TFLOP/s [{card}]")
    tp = results["25 tp"]
    log(f"tp: llama300m f32 tp 2 generate and engine ({tp['engine']['requests']} "
        f"requests, {tp['engine']['steps']} steps) equal the unsharded "
        f"model; path {tp['generate']['path']} ({tp['generate']['reason']})")
    prof = tp["profile"]
    log(f"tp_decode_profile bf16 llama300m b8 p128 n64, two ranks sharing "
        f"one card: tp {prof['tok_s_tp']:.1f} tok/s, unsharded "
        f"{prof['tok_s_single_device']:.1f} tok/s per rank, parity "
        f"mismatches {prof['token_parity_mismatches']}; one gloo allreduce "
        f"of (8, 1, 1024) bf16 {prof['allreduce_ms']:.3f} ms; rank 0 token "
        f"step split: {json.dumps(prof['step_split'])} [{card}]")
    log(f"pipeline: {json.dumps(results['26 pipeline'])}")
    return results


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

    def phase(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"phase {label}: {time.perf_counter() - t:.1f} s")
        return out

    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=device)
    results = phase("2 decode kernels", check_kernels, device,
                    flush_buf.zero_)
    phase("2 decode chunk edges", check_chunk_edges, device)
    flash_results = phase("6 flash kernels", check_flash, device,
                          flush_buf.zero_)
    operand = phase("14 operand range", check_operand_range, device,
                    flush_buf.zero_)
    ring_flash = phase("24 ring kernels (dlse)", check_flash, device,
                       flush_buf.zero_, ring_flash_cases(), True)
    del flush_buf

    phase("7 collectives", run_collectives)

    cfg32 = dataclasses.replace(LLAMA_300M, dtype=torch.float32)
    model, gen_launches = phase("3 generate", run_generate, cfg32)
    paged_launches = phase("4 engine parity", run_engine_parity, model,
                           cfg32)
    fleet_parity, fleet_launches = phase("17 fleet parity",
                                         run_fleet_parity, model, cfg32)
    release_serving()
    del model
    torch.cuda.empty_cache()
    serving_numbers = phase("5 engine timing", run_engine_timing, card)
    release_serving()
    torch.cuda.empty_cache()
    generation, example_launches = phase(
        "15 generation example", run_generation_example, card)
    loadgen_300m, loadgen_launches = phase(
        "16 loadgen llama-300m", run_loadgen, LOADGEN_300M,
        "llama_300m_serving_b8_loadgen", card)
    fleet_rows = {}
    # The chaos pass reruns the same trace in the same (warm) process.
    for label, extra in (("fleet", []),
                         ("fleet_chaos", ["--chaos-kill", "--no-warmup"])):
        fleet_rows[label] = phase(
            f"18 loadgen tiny {label}", run_loadgen,
            LOADGEN_FLEET_TINY + extra,
            f"llama_serving_fleet_prefix_loadgen {label}", card)
    for label, (rec, _) in fleet_rows.items():
        base = rec["baseline_no_sharing"]
        log(f"fleet row {label}: TTFT p50 warm {rec['ttft_warm_p50_s']} s "
            f"vs cold {rec['ttft_cold_p50_s']} s; blocks_live_peak "
            f"{rec['blocks_live_peak']} vs {base['blocks_live_peak']} "
            f"without sharing; reroutes {rec['router']['reroutes']}")
    torch.cuda.empty_cache()

    parity = phase("8 training parity", run_training_parity)
    training = phase("9 training example", run_training_timed, card)
    torch.cuda.empty_cache()

    moe_parity = phase("19 moe parity", run_moe_parity)
    moe_training = phase("20 moe training example", run_moe_training_timed,
                         card)
    moe_model, moe_generation, moe_gen_launches, moe_example_launches = \
        phase("21 moe generation", run_moe_generation, card)
    moe_paged_launches = phase("22 moe engine", run_engine_parity,
                               moe_model, moe_model.config, "moe-small")
    release_serving()
    del moe_model
    torch.cuda.empty_cache()
    vit = phase("23 vit example", run_vit_timed, card)

    zoo = {"resnet50_parity": phase("10 resnet parity", run_resnet_parity),
           "synthetic_benchmark": phase("11 synthetic benchmark",
                                        run_synthetic_benchmark, card),
           "bert_parity": phase("12 bert parity", run_bert_parity)}
    bert = phase("13 bert example", run_bert_timed, card)
    torch.cuda.empty_cache()
    parallel = phase("24-26 parallel modes (two ranks)", run_parallel_phases,
                     card)
    hvd.shutdown()

    # The two ranks' counts of each parallel path, summed.
    by_rank = parallel["counts_by_rank"]

    def both(phase_label, key, name):
        return sum(rank[phase_label][key][name] for rank in by_rank)

    flash_names = list(flash_ops.LAUNCHES)
    flash_paths = {"llama300m training (9)": training["flash_launches"],
                   "bert-base training (13)": bert["flash_launches"],
                   "moe-small training (20)": moe_training["flash_launches"],
                   "vit-s16 --attention flash (23)":
                       vit["flash"]["flash_launches"],
                   "llama300m seq-parallel training (24)": {
                       n: both("24 sp timed", "", n) for n in flash_names}}
    forward_only = {f"long context ring {layout} (24)": both(
        "24 sp timed", f"long_context_{layout}", "flash_forward")
        for layout in ("contiguous", "zigzag")}
    log(f"flash launches by main path: {json.dumps(flash_paths)}")
    decode_paths = {"generate (3)": gen_launches,
                    "generation example (15)": example_launches,
                    "moe-small generate (21)": moe_gen_launches,
                    "moe-small generation example (21)":
                        moe_example_launches,
                    "tp generate, both ranks (25)": both(
                        "25 tp", "generate", "decode_attention"),
                    "tp_decode_profile, both ranks (25)": both(
                        "25 tp", "profile", "decode_attention")}
    paged_paths = {"engine parity (4)": paged_launches,
                   "fleet parity (17)": fleet_launches,
                   "loadgen llama-300m (16)": loadgen_launches,
                   **{f"loadgen tiny {k} (18)": v[1]
                      for k, v in fleet_rows.items()},
                   "moe-small engine parity (22)": moe_paged_launches,
                   "tp engine, both ranks (25)": both(
                       "25 tp", "engine", "paged_decode_attention")}
    log(f"decode_attention launches by main path: "
        f"{json.dumps(decode_paths)}")
    log(f"paged_decode_attention launches by main path: "
        f"{json.dumps(paged_paths)}")
    log(f"flash_forward launches of the forward-only ring paths: "
        f"{json.dumps(forward_only)}")
    if min(list(decode_paths.values()) + list(paged_paths.values())
           + list(forward_only.values())) <= 0:
        raise AssertionError(f"a main path never ran its kernel: "
                             f"{decode_paths} {paged_paths} {forward_only}")
    launches = {"decode_attention": sum(decode_paths.values()),
                "paged_decode_attention": sum(paged_paths.values()),
                **{name: sum(path[name] for path in flash_paths.values())
                   for name in flash_names}}
    launches["flash_forward"] += sum(forward_only.values())
    never = [f"{path}: {name}" for path, counts in flash_paths.items()
             for name, n in counts.items() if n <= 0]
    if min(launches.values()) <= 0 or never:
        raise AssertionError(f"a kernel of the main paths never ran: "
                             f"{launches}; {never}")
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
    log(f"operand range: {json.dumps(operand)}")
    log(f"fleet: {json.dumps({'parity': fleet_parity, 'generation': generation, 'loadgen_300m': loadgen_300m, 'fleet_tiny': {k: v[0] for k, v in fleet_rows.items()}})}")
    log(f"training: {json.dumps({'parity': parity, **training})}")
    log(f"zoo: {json.dumps({**zoo, 'bert_training': bert})}")
    log(f"moe: {json.dumps({'parity': moe_parity, 'training': moe_training, 'generation': moe_generation})}")
    log(f"vit: {json.dumps(vit)}")
    log(f"parallel: {json.dumps(parallel)}")
    log(f"ring kernels: {json.dumps({f'{k[0]} {k[1]}': v for k, v in ring_flash.items()})}")
    log(f"wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--parallel-worker":
        sys.exit(parallel_worker(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4]))
    sys.exit(main())
