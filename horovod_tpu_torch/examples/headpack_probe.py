"""Tensor-core granule probe for head_dim=64 attention (the "head
packing" question) on the card — the port's counterpart of
``examples/headpack_probe.py``.

The question: is a K=64 contraction charged like a K=128 one, so that
packing two d=64 heads into one 128-wide pass could pay? The frame on
Hopper: ``wgmma`` issues m64nNk16 — 64 rows of A by N columns of B (N a
multiple of 8, up to 256) per instruction, consuming K in steps of 16 —
so a d=64 contraction is four k16 steps and no part of the instruction
is padding; the tensor cores charge dense MACs, and neither
block-diagonal packing (density 1/2) nor the sum/difference packing (two
dense K=128 passes to recover two heads) does fewer of them. What a
short K does change is the bytes per MAC: a (M, 64) x (64, N) product
writes as many output bytes as a (M, 128) x (128, N) one for half the
MACs, so it can be bound by memory where the long one is not. The probe
measures which:

  A. contraction sweep — (M,K)@(K,N) bf16, M=N=4096, K in
     {64,128,256,512};
  B. output-width sweep — M=K=4096, N in {64,128,256,512};
  C. flash QK shapes — batched (512,64)@(64,1024) at 2x the batch of
     (512,128)@(128,1024): equal useful FLOPs;
  D. flash PV shapes — batched (512,1024)@(1024,64) vs ...x128;
  E. the sum/difference packed QK against two native d=64 products;
  F. the port's flash kernels (``csrc/flash_attention.cu``) at H8/D64
     against H4/D128, B4 S2048 causal (equal FLOPs and model width
     512), forward and forward + backward, with the launches of kernels
     1-3;
  G. the PV product transposed (out^T = v^T p^T), as in the JAX probe.

A-E and G time the library's GEMM (``torch.matmul``/``bmm`` into a
preallocated output, bf16 in and out); they measure cuBLAS, not a kernel
of the port. Timing: CUDA events around each call, alone, after an L2
flush, the median of ``--iters`` calls (``utils/timing.median_ms``).
``pct_peak`` is of the H100 SXM5's dense bf16 peak (datasheet,
``utils/timing.H100_SXM_BF16_FLOPS``).

    python -m horovod_tpu_torch.examples.headpack_probe [--parts AF]
        [--json-out PATH]

One JSON line per measurement, then a summary line: the K=64 / K=128
time ratio of A and F's D64 / D128 ratios.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from horovod_tpu_torch.ops import attention as flash_ops
from horovod_tpu_torch.utils.timing import (H100_SXM_BF16_FLOPS, L2Flush,
                                            device_label, median_ms,
                                            probe_device)


def _rand(shape, device, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.3).to(
        device=device, dtype=torch.bfloat16)


def tfs(flops: float, ms: float) -> float:
    return flops / (ms * 1e-3) / 1e12 if ms > 0 else float("inf")


class Probe:
    def __init__(self, device, iters: int):
        self.device, self.iters = device, iters
        self.flush = L2Flush(device)
        self.label = device_label(device)
        self.rows: List[dict] = []

    def median(self, fn) -> float:
        return median_ms(fn, self.device, self.iters, self.flush)

    def emit(self, rec: dict, flops: Optional[float] = None) -> None:
        if flops is not None:
            rec["tfs"] = tfs(flops, rec["ms"])
            rec["pct_peak"] = 100 * rec["tfs"] * 1e12 / H100_SXM_BF16_FLOPS
        rec["device"] = self.label
        print(json.dumps(rec), flush=True)
        self.rows.append(rec)

    def matmul_ms(self, a, b) -> float:
        out = torch.empty(a.shape[:-1] + b.shape[-1:], dtype=a.dtype,
                          device=a.device)
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return self.median(lambda: mm(a, b, out=out))


def part_a_contraction(p: Probe):
    m = n = 4096
    for k in (64, 128, 256, 512):
        a, b = _rand((m, k), p.device), _rand((k, n), p.device, 1)
        p.emit({"part": "A_contraction", "M": m, "K": k, "N": n,
                "ms": p.matmul_ms(a, b)}, 2 * m * n * k)


def part_b_output(p: Probe):
    m = k = 4096
    for n in (64, 128, 256, 512):
        a, b = _rand((m, k), p.device), _rand((k, n), p.device, 1)
        p.emit({"part": "B_output_width", "M": m, "K": k, "N": n,
                "ms": p.matmul_ms(a, b)}, 2 * m * k * n)


def part_c_qk_shapes(p: Probe):
    # Equal useful FLOPs: 32 heads at d=64 vs 16 heads at d=128.
    for bh, d in ((32, 64), (16, 128)):
        q, k = _rand((bh, 512, d), p.device), _rand((bh, d, 1024), p.device, 1)
        p.emit({"part": "C_flash_qk", "bh": bh, "d": d,
                "ms": p.matmul_ms(q, k)}, 2 * bh * 512 * d * 1024)


def part_d_pv_shapes(p: Probe):
    for bh, d in ((32, 64), (16, 128)):
        pr, v = (_rand((bh, 512, 1024), p.device),
                 _rand((bh, 1024, d), p.device, 1))
        p.emit({"part": "D_flash_pv", "bh": bh, "d": d,
                "ms": p.matmul_ms(pr, v)}, 2 * bh * 512 * 1024 * d)


def part_e_sumdiff(p: Probe):
    # Two native d=64 QK products against the sum/difference packing that
    # recovers the same two score matrices: a = [q1 q2]@[k1;k2],
    # b = [q1 -q2]@[k1;k2], s1 = (a+b)/2, s2 = (a-b)/2.
    bh = 16  # pairs
    q1, q2 = _rand((bh, 512, 64), p.device), _rand((bh, 512, 64), p.device, 1)
    k1, k2 = (_rand((bh, 64, 1024), p.device, 2),
              _rand((bh, 64, 1024), p.device, 3))

    def native():
        return torch.bmm(q1, k1), torch.bmm(q2, k2)

    def sumdiff():
        qa = torch.cat([q1, q2], dim=2)
        qb = torch.cat([q1, -q2], dim=2)
        kp = torch.cat([k1, k2], dim=1)
        a, b = torch.bmm(qa, kp), torch.bmm(qb, kp)
        return 0.5 * (a + b), 0.5 * (a - b)

    flops = 2 * (2 * bh) * 512 * 64 * 1024  # useful, both variants
    p.emit({"part": "E_sumdiff_pack", "variant": "native_2x_d64",
            "ms": p.median(native)}, flops)
    p.emit({"part": "E_sumdiff_pack", "variant": "packed_dense128",
            "ms": p.median(sumdiff)}, flops)


def part_g_pv_transposed(p: Probe):
    for bh, d in ((32, 64), (16, 128)):
        vt, pt = (_rand((bh, d, 1024), p.device),
                  _rand((bh, 1024, 512), p.device, 1))
        p.emit({"part": "G_pv_transposed", "bh": bh, "d": d,
                "ms": p.matmul_ms(vt, pt)}, 2 * bh * 512 * 1024 * d)


def part_f_flash_e2e(p: Probe):
    b, s = 4, 2048
    for h, d in ((8, 64), (4, 128)):
        q, k, v = (_rand((b, s, h, d), p.device, seed) for seed in (0, 1, 2))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

        def fwd():
            with torch.no_grad():
                flash_ops.flash_attention(q, k, v, causal=True)

        def train():
            out = flash_ops.flash_attention(*leaves, causal=True)
            torch.autograd.grad((out.float() ** 2).sum(), leaves)

        before = dict(flash_ops.LAUNCHES)
        ms_f, ms_t = p.median(fwd), p.median(train)
        # Causal useful flops: half of the full S^2 (QK and PV).
        fl_fwd = 2 * (2 * b * h * s * s * d) / 2
        p.emit({"part": "F_flash_e2e", "H": h, "D": d, "B": b, "S": s,
                "fwd_ms": ms_f, "train_ms": ms_t, "ms": ms_f,
                "fwd_tfs_useful": tfs(fl_fwd, ms_f),
                "fwd_pct_peak": 100 * tfs(fl_fwd, ms_f) * 1e12
                / H100_SXM_BF16_FLOPS,
                "launches": {n: flash_ops.LAUNCHES[n] - before[n]
                             for n in before}})


PARTS = {"A": part_a_contraction, "B": part_b_output, "C": part_c_qk_shapes,
         "D": part_d_pv_shapes, "E": part_e_sumdiff, "F": part_f_flash_e2e,
         "G": part_g_pv_transposed}


def summary(rows: List[dict]) -> dict:
    out = {"metric": "headpack_probe", "measurements": len(rows)}
    a = {r["K"]: r["ms"] for r in rows if r["part"] == "A_contraction"}
    if 64 in a and 128 in a:
        out["A_k64_over_k128_ms"] = a[64] / a[128]
    f = {r["D"]: r for r in rows if r["part"] == "F_flash_e2e"}
    if 64 in f and 128 in f:
        out["F_d64_over_d128_fwd"] = f[64]["fwd_ms"] / f[128]["fwd_ms"]
        out["F_d64_over_d128_train"] = (f[64]["train_ms"]
                                        / f[128]["train_ms"])
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--parts", default="ABCDEFG")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    p = Probe(probe_device(args.device), args.iters)
    for part in args.parts:
        PARTS[part](p)
    result = {**summary(p.rows), "device": p.label}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"what": "d=64 tensor-core granule / head-packing "
                       "probe", "method": "CUDA events, L2 flushed, median "
                       f"of {args.iters} calls",
                       "peak_bf16_flops": H100_SXM_BF16_FLOPS,
                       "rows": p.rows, "summary": result}, f, indent=1)
    print(json.dumps(result), flush=True)
    return {"rows": p.rows, **result}


if __name__ == "__main__":
    main()
