#!/usr/bin/env python3
"""Time one path of two checkouts in turns on one card.

    python3 chip_compare.py OTHER_ROOT [--rounds N] [--path PATH]

OTHER_ROOT is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory ``.gitignore``
lists). Each round runs the path in a fresh process from each tree, in
the order other, this, this, other, so that drift of the card's clocks
hits both alike. ``training`` (the default) is
``chip_smoke.run_training_timed`` (Llama-300M, bf16, seq 1024, batch 8,
AdamW, 10 timed steps and one profiled step); ``decode`` is
``chip_smoke.check_kernels`` (both decode kernels against their plain
versions at the serving slice's and Llama-8B's shapes, each kernel's
median time with the L2 flushed); ``flash`` is ``chip_smoke.check_flash``
(the three flash kernels on its eight cases, in both dtypes, each
kernel's median time); ``serving`` is the serving engine's decode step
at Llama-300M bf16, 8 slots at ~130-170 positions, 40 steps timed
without the profiler: the eager step, and where the tree has one the
step the engine captured as a CUDA graph. Each process builds its own tree's
kernels. Prints one JSON line per run, then the medians per tree and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

_RUN = """
import json, chip_smoke
out = chip_smoke.run_training_timed(chip_smoke.card_line())
prof = out["step_profile"]
print("RESULT " + json.dumps({
    "tokens_per_s": out["tokens_per_s"], "step_ms": out["step_ms"],
    "peak_memory_gib": out["peak_memory_gib"],
    "flash_ms_per_step": prof["flash_ms_per_step"],
    "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
    "loss_first_last": [out["losses"][0], out["losses"][-1]]}))
"""


_RUN_DECODE = """
import json, torch, chip_smoke
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
rows = chip_smoke.check_kernels(torch.device("cuda"), flush.zero_)
print("RESULT " + json.dumps({" ".join(key) + " ms": row["ms"]
                              for key, row in rows.items()}))
"""
_RUN_FLASH = """
import json, torch, chip_smoke
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
rows = chip_smoke.check_flash(torch.device("cuda"), flush.zero_)
print("RESULT " + json.dumps({" ".join(key) + " " + name: ms
                              for key, row in rows.items()
                              for name, ms in row["ms"].items()}))
"""
_RUN_SERVING = """
import contextlib, json, time
import numpy as np, torch
from horovod_tpu_torch import serving
from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM
from horovod_tpu_torch.serving import engine as engine_mod

model = LlamaLM(LLAMA_300M, seed=0)
scfg = serving.ServingConfig(max_batch=8, block_size=16, num_blocks=0,
                             queue_depth=8, max_seq_len=256)
modes = {"eager": getattr(engine_mod, "_eager_decode",
                          contextlib.nullcontext)}
if hasattr(engine_mod, "_eager_decode"):
    modes["graph"] = contextlib.nullcontext
out = {}
for mode, ctx in modes.items():
    with ctx():
        engine = serving.ServingEngine(model, scfg)
    rng = np.random.RandomState(3)
    for _ in range(8):
        engine.submit(rng.randint(0, LLAMA_300M.vocab_size, 128), 60)
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(40):
        engine.step()
    torch.cuda.synchronize()
    out[mode + "_step_ms"] = (time.perf_counter() - t0) * 1e3 / 40
    engine.shutdown()
print("RESULT " + json.dumps(out))
"""
RUNS = {"training": _RUN, "decode": _RUN_DECODE, "flash": _RUN_FLASH,
        "serving": _RUN_SERVING}


def run(tree: Path, path: str = "training") -> dict:
    proc = subprocess.run([sys.executable, "-c", RUNS[path]], cwd=tree,
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{tree}: no result (exit {proc.returncode})\n"
                       f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--path", choices=sorted(RUNS), default="training")
    args = parser.parse_args(argv)
    here = Path(__file__).resolve().parent
    trees = {"other": args.other.resolve(), "this": here}
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            result = run(trees[name], args.path)
            runs[name].append(result)
            print(json.dumps({"tree": name, **result}), flush=True)
    medians = {name: {key: statistics.median(r[key] for r in rs)
                      for key in rs[0] if key != "loss_first_last"}
               for name, rs in runs.items()}
    print(json.dumps({"medians": medians}))
    sys.path.insert(0, str(here))
    import chip_smoke
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
