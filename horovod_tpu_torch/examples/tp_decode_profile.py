"""TP decode profile: which decode path a tensor-parallel ``generate()``
runs, and what it costs — the port's counterpart of
``examples/tp_decode_profile.py``.

Every rank of the job runs it. The ranks form a ``data x model`` mesh
(``model`` = ``--tp``); ``LlamaLM(mesh=...)`` holds this rank's heads,
FFN slice and vocabulary slice, and ``generate()`` runs the decode
kernels on those heads (the ``kernel_tp`` path). It reports

* the classifier verdict (``models.llama.LAST_DECODE_PATH``),
* the decode kernels' launch counters over the TP run, and beside them
  the ``hvd.decode.*`` markers of a short profiled TP ``generate()``
  (``utils/comm_accounting.decode_path_markers``, the JAX harness's
  reading of its HLO scope markers): ``kernel_tp`` > 0 and ``einsum``
  == 0 when the shard-local kernel ran,
* greedy-token parity against the unsharded model, run on every rank,
* decode tok/s of both (the whole job's tokens over rank 0's time).

    python -m horovod_tpu_torch.examples.tp_decode_profile --model 300m \\
        --tp 2 --f32

``--f32`` makes greedy tokens exactly reproducible across paths (bf16
reduction order can flip argmax ties; parity is reported but not
enforced without it). ``--device cpu`` runs on gloo ranks on the CPU.
The last line is the JSON record; the exit code is 1 when ``--f32``
parity fails or the ``auto`` path is not ``kernel_tp`` (by the verdict
and by the markers).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
import horovod_tpu_torch.models.llama as llama_mod
from horovod_tpu_torch.models.llama import (LLAMA_1B, LLAMA_300M, LLAMA_TINY,
                                            LlamaLM, decode_kernel_disabled,
                                            generate)
from horovod_tpu_torch.ops import decode_attention as decode_ops
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.utils.comm_accounting import decode_path_markers

CONFIGS = {"tiny": LLAMA_TINY, "300m": LLAMA_300M, "1b": LLAMA_1B}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny", choices=sorted(CONFIGS))
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--tp", type=int, default=2,
                    help="model-axis size (must divide num_kv_heads)")
    ap.add_argument("--path", choices=["auto", "einsum"], default="auto",
                    help="einsum = force the plain path for an A/B")
    ap.add_argument("--skip-parity", action="store_true",
                    help="skip the unsharded baseline run")
    ap.add_argument("--f32", action="store_true",
                    help="run the model in f32: greedy tokens are then "
                    "exactly reproducible across paths")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init(device=args.device)
    device = hvd.device()
    n = hvd.size()
    if args.tp < 2 or n % args.tp:
        raise SystemExit(f"need a rank count divisible by --tp >= 2; have "
                         f"{n} ranks, tp={args.tp}")
    dp = n // args.tp
    mesh = make_mesh({"data": dp, "model": args.tp})
    cfg = CONFIGS[args.model]
    if args.f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    b, p, new = args.batch_size, args.prompt_len, args.max_new_tokens
    if b % dp:
        raise SystemExit(f"batch {b} not divisible by dp={dp}")
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (b, p))
    rows = b // dp
    di = mesh.axis_index("data")
    prompt = torch.from_numpy(prompt[di * rows:(di + 1) * rows])

    def timed(model):
        def run():
            out = generate(model, prompt, max_new_tokens=new)
            int(out[0, -1])          # the barrier: fetch a token
            return out
        run()
        t0 = time.perf_counter()
        out = run()
        return out, time.perf_counter() - t0

    base = base_rate = None
    if not args.skip_parity:
        model = LlamaLM(cfg, device=device, seed=0)
        base, dt = timed(model)
        base_rate = b * new / dt
        del model
    model = LlamaLM(cfg, device=device, seed=0, mesh=mesh, tp_axis="model")
    decode_ops.reset_launch_counts()
    if args.path == "einsum":
        with decode_kernel_disabled():
            tp_out, dt = timed(model)
    else:
        tp_out, dt = timed(model)
    launches = dict(decode_ops.LAUNCHES)
    tp_rate = b * new / dt
    # The labels of a short profiled run (the timed one runs unprofiled).
    with hvd.profiler.trace(os.path.join(
            tempfile.gettempdir(),
            f"tp_decode_trace_rank{hvd.rank()}")) as path:
        if args.path == "einsum":
            with decode_kernel_disabled():
                generate(model, prompt, max_new_tokens=3)
        else:
            generate(model, prompt, max_new_tokens=3)
    markers = decode_path_markers(path)
    os.remove(path)
    info = llama_mod.LAST_DECODE_PATH
    parity = None
    if base is not None:
        parity = int((base.cpu() != tp_out.cpu()).sum())
    record = {
        "model": args.model, "batch": b, "prompt_len": p,
        "max_new_tokens": new, "mesh": {"data": dp, "model": args.tp},
        "dtype": "f32" if args.f32 else "bf16", "device": str(device),
        "path": info.path, "path_reason": info.reason,
        "decode_launches": launches, "decode_path_markers": markers,
        "tok_s_tp": tp_rate, "tok_s_single_device": base_rate,
        "token_parity_mismatches": parity,
    }
    record["ok"] = not ((args.f32 and parity not in (None, 0))
                        or (args.path == "auto"
                            and (info.path != "kernel_tp"
                                 or markers["hvd.decode.kernel_tp"] == 0
                                 or markers["hvd.decode.einsum"] != 0)))
    if args.out and hvd.rank() == 0:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    if hvd.rank() == 0:
        print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
