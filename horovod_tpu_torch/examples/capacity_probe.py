"""Capacity-planner calibration probe on the port — the counterpart of
``examples/capacity_probe.py``:

    python -m horovod_tpu_torch.examples.capacity_probe \
        --sizes 8,16,32,64,128,256,512 --threaded-sizes '' \
        --driver-check 128,256,512 --repeats 5 \
        --out horovod_tpu_torch/calibration/capacity_port.json
    python -m horovod_tpu_torch.examples.capacity_probe --sizes 8,16 \
        --threaded-sizes '' --cycles 10 --repeats 2  # quick, serial only

Measures the control-plane curves of the port's coordinator on its
simulated cluster (``horovod_tpu_torch.sim``): the serial sizes (8-64
logical ranks) plus threaded-driver sizes (default 128/256/512 ranks
across 8 named shard threads), the wire-conformance monitor armed at
every size (the summed zero-violation verdict is recorded in each
threaded row). Every size is measured ``--repeats`` times in round-robin
order and the committed row is the median across repeats, so a drift of
the host's speed spreads over every size. The fitted calibration
(relative-error weighted), the per-size model residuals and the
planner's own forward plan at ``--plan-ranks`` go to ``--out``;
the record's ``measured_on`` names the host, the card beside it
(``--card``), the date and the command, and ``settings`` the sweep.
The port's committed calibration (``horovod_tpu_torch/calibration/``)
is the default input of
``python -m horovod_tpu_torch.tools.capacity``.

The flags and defaults are the JAX probe's, but the committed
calibration runs every size on the serial driver (the first command
above): the threaded driver prices a rank differently from the serial
one at the same world size (its shard threads and the coordinator's
thread take turns on one GIL around every socket call), so a sweep that
changes driver mid-curve puts a step into the curve it fits.
``--driver-check`` measures sizes again on the threaded driver after the
sweep and records them under ``threaded_driver``, each cost beside the
serial fit's prediction, outside the fit.

The restore and overlap planes have no measured input here (the plan
says they are absent). Loopback TCP, one shared GIL: these numbers price
the coordinator's per-rank walk costs (recv + HMAC + dispatch per wire),
not NIC latency; the record says so.
"""

import argparse
import json
import os
import platform
import shlex
import sys
import time
from typing import List, Optional


def host_line() -> str:
    """This host's name, CPU model and core count."""
    model = platform.processor() or "unknown CPU"
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{platform.node()}: {model}, {os.cpu_count()} cores"


def threaded_check(cal, check: dict) -> dict:
    """The threaded driver's rows (``check``, a record of
    ``measure_control_plane``) held against the sweep's fit ``cal``: each
    measured cost, the fit's prediction and measured / predicted."""
    vs_fit = {}
    for n in check["world_sizes"]:
        row = check["control_plane"][str(n)]
        vs_fit[str(n)] = {
            key: {"measured": round(row[key], 6),
                  "predicted": round(predict(n), 6),
                  "ratio": round(row[key] / predict(n), 4)}
            for key, predict in (
                ("negotiate_step_seconds", cal.negotiation_seconds),
                ("reshape_seconds", cal.reshape_seconds),
                ("heartbeat_fanout_seconds", cal.heartbeat_fanout_seconds))}
    return {"control_plane": check["control_plane"],
            "vs_fit": vs_fit}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="measure the port's control-plane calibration")
    parser.add_argument("--sizes", default="8,16,32,64",
                        help="comma-separated serial-driver world sizes")
    parser.add_argument("--threaded-sizes", default="128,256,512",
                        help="extra world sizes run on the threaded "
                             "driver with protocheck armed ('' to skip)")
    parser.add_argument("--driver-threads", type=int, default=8,
                        help="shard threads for the threaded sizes")
    parser.add_argument("--driver-check", default="",
                        help="world sizes measured again on the threaded "
                             "driver after the sweep, held against its "
                             "fit and recorded under threaded_driver, "
                             "not fitted ('' to skip)")
    parser.add_argument("--cycles", type=int, default=15,
                        help="measured steps per world size per repeat")
    parser.add_argument("--repeats", type=int, default=7,
                        help="round-robin sweep repeats (each row is the "
                             "median across repeats — drift insurance on "
                             "a timeshared substrate)")
    parser.add_argument("--plan-ranks", type=int, default=4096,
                        help="world size for the embedded forward plan")
    parser.add_argument("--model-bytes", type=int, default=1 << 30,
                        help="model size for the plan's restore plane")
    parser.add_argument("--out", default=None,
                        help="write the full JSON record here")
    parser.add_argument("--card", default=None,
                        help="the card beside this host, as nvidia-smi "
                             "--query-gpu=name,power.limit "
                             "--format=csv,noheader gives it (stored in "
                             "the record's measured_on)")
    args = parser.parse_args(argv)

    from horovod_tpu_torch.sim.measure import measure_control_plane
    from horovod_tpu_torch.utils.scaling_model import (
        capacity_plan,
        control_plane_from_artifact,
    )

    sizes = [int(s) for s in args.sizes.split(",") if s.strip()]
    threads = {}
    protocheck_sizes = []
    for s in args.threaded_sizes.split(","):
        if s.strip():
            n = int(s)
            sizes.append(n)
            threads[n] = args.driver_threads
            protocheck_sizes.append(n)

    # Protocheck armed at EVERY size, not just the threaded ones: the
    # conformance proof then covers the whole curve, and any per-frame
    # monitor overhead is uniform across sizes instead of a systematic
    # serial-vs-threaded bias in the fit.
    record = measure_control_plane(
        sizes, cycles=args.cycles, driver_threads=threads,
        protocheck_sizes=sizes, repeats=args.repeats,
        relative_fit=True)
    record["substrate"] = (
        "simcluster: in-process loopback TCP, multiplexed logical ranks, "
        "shared GIL - calibrates coordinator per-rank walk costs, not "
        "NIC latency")
    check = [int(s) for s in args.driver_check.split(",") if s.strip()]
    if check:
        record["threaded_driver"] = threaded_check(
            control_plane_from_artifact(record),
            measure_control_plane(
                check, cycles=args.cycles,
                driver_threads={n: args.driver_threads for n in check},
                protocheck_sizes=check, repeats=args.repeats,
                relative_fit=True))
    record["settings"] = {
        "sizes": sizes, "threaded_sizes": sorted(threads),
        "driver_threads": args.driver_threads, "cycles": args.cycles,
        "repeats": args.repeats, "driver_check": check}
    record["measured_on"] = {
        "host": host_line(), "card": args.card,
        "date": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "command": "python -m horovod_tpu_torch.examples.capacity_probe "
                   + shlex.join(sys.argv[1:] if argv is None else argv)}

    # The probe's own artifact is the planner's calibration input; embed
    # the forward plan it implies so the record is self-describing.
    record["plan"] = capacity_plan(
        ranks=args.plan_ranks, model_bytes=args.model_bytes,
        control_plane_data=record)

    if args.out:
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(record, f, indent=1, sort_keys=True)
            f.write("\n")

    cal = record["calibration"]
    rel_errs = {
        str(n): max(row["rel_err"] for _, row in sorted(
            record["model_vs_measured"][str(n)].items())
            if row.get("rel_err") is not None)
        for n in record["world_sizes"]}
    threaded_rows = {
        str(n): {"protocheck_violations":
                 record["control_plane"][str(n)].get(
                     "protocheck_violations"),
                 "driver_threads":
                 record["control_plane"][str(n)]["driver_threads"]}
        for n in sorted(threads)}
    bottleneck = record["plan"]["first_bottleneck"]
    summary = {
        "unit": "seconds",
        "world_sizes": record["world_sizes"],
        "negotiate_per_rank_us": round(
            cal["negotiation_per_rank_s"] * 1e6, 2),
        "max_rel_err_by_size": rel_errs,
        "threaded": threaded_rows,
        "driver_check_ratio": {
            n: {key: row["ratio"] for key, row in sorted(keys.items())}
            for n, keys in sorted(record.get(
                "threaded_driver", {}).get("vs_fit", {}).items())},
        "first_bottleneck_at_plan_ranks": (
            bottleneck["plane"] if bottleneck else None),
        "artifact": args.out,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
