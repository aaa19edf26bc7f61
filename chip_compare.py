#!/usr/bin/env python3
"""Time the bf16 training example of two checkouts in turns on one card.

    python3 chip_compare.py OTHER_ROOT [--rounds N]

OTHER_ROOT is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory ``.gitignore``
lists). Each round runs ``chip_smoke.run_training_timed`` (Llama-300M,
bf16, seq 1024, batch 8, AdamW, 10 timed steps and one profiled step) in a
fresh process from each tree, in the order other, this, this, other, so
that drift of the card's clocks hits both alike. Each process builds its
own tree's kernels. Prints one JSON line per run, then the medians per
tree and the card's name and power limit.
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


def run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=tree,
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
    args = parser.parse_args(argv)
    here = Path(__file__).resolve().parent
    trees = {"other": args.other.resolve(), "this": here}
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            result = run(trees[name])
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
