"""Control-plane cost vs world size on the port's simulated cluster —
the counterpart of ``examples/simcluster_probe.py``:

    python -m horovod_tpu_torch.examples.simcluster_probe --out rec.json

Runs ``horovod_tpu_torch.sim.measure.measure_control_plane`` at
``--sizes`` logical ranks (negotiation step, reshape and heartbeat
fanout, each fitted linear in N) and the bucket-scheduler overlap check
at ``--overlap-sizes``, writes the record to ``--out`` and prints a JSON
summary. Loopback TCP, one shared GIL: the coordinator's per-rank walk
costs, not NIC latency.
"""

import argparse
import json
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="control-plane cost vs world size on the sim")
    parser.add_argument("--sizes", default="8,16,32,64",
                        help="comma-separated logical world sizes")
    parser.add_argument("--cycles", type=int, default=30,
                        help="measured steps per world size")
    parser.add_argument("--overlap-sizes", default="8,32",
                        help="world sizes for the overlap model check "
                             "('' to skip)")
    parser.add_argument("--out", default=None,
                        help="write the full JSON record here")
    args = parser.parse_args(argv)

    from horovod_tpu_torch.sim.measure import (
        measure_control_plane,
        run_overlap_probe,
    )

    sizes = [int(s) for s in args.sizes.split(",") if s.strip()]
    record = measure_control_plane(sizes, cycles=args.cycles)
    record["substrate"] = (
        "simcluster: in-process loopback TCP, multiplexed logical ranks, "
        "shared GIL - calibrates coordinator per-rank walk costs, not "
        "NIC latency")
    record["overlap"] = {}
    overlap_sizes = [int(s) for s in args.overlap_sizes.split(",")
                     if s.strip()]
    for n in overlap_sizes:
        record["overlap"][str(n)] = run_overlap_probe(n)

    if args.out:
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(record, f, indent=1, sort_keys=True)
            f.write("\n")

    cal = record["calibration"]
    largest = str(max(sizes))
    summary = {
        "unit": "seconds",
        "world_sizes": record["world_sizes"],
        "negotiate_per_rank_us": round(
            cal["negotiation_per_rank_s"] * 1e6, 2),
        "reshape_per_rank_us": round(cal["reshape_per_rank_s"] * 1e6, 2),
        "heartbeat_per_rank_us": round(
            cal["heartbeat_per_rank_s"] * 1e6, 2),
        "negotiate_step_seconds_at_max": record["control_plane"][
            largest]["negotiate_step_seconds"],
        "overlap_model_diff": {
            n: row["model_vs_measured_diff"]
            for n, row in sorted(record["overlap"].items())},
        "artifact": args.out,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
