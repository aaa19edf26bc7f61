"""``python -m horovod_tpu_torch.tools.capacity`` — the capacity planner
CLI, the JAX package's ``tools/capacity.py`` over the port's own
``utils/scaling_model.capacity_plan``.

Answers the operator's forward question — "what saturates first if I
scale this job to N ranks?" — by extrapolating a control-plane
calibration (and, when the directory holds them, a restore curve and an
overlap stall split) through ``capacity_plan``. Every prediction carries
its fit residual as explicit uncertainty, and the first bottleneck is
named with an operator hint.

``--artifacts`` defaults to the port's own calibration in its package
data (``horovod_tpu_torch/calibration/``, written by
``examples/capacity_probe.py`` against the port's coordinator). Pointed
at another directory it reads the same file names the JAX tool reads
there, so both tools give the same plan from the same files.

Exit status: 0 on a produced plan, 2 when the control-plane calibration
is unreachable or unreadable (there is nothing to extrapolate from
without measured points).

Examples::

    python -m horovod_tpu_torch.tools.capacity --ranks 4096 \\
        --model-bytes 1073741824
    python -m horovod_tpu_torch.tools.capacity --ranks 4096 --json
    # from a live job's in-flight re-fit (capacity_live.json, persisted
    # by the rank-0 window roller under HOROVOD_CAPACITY_LIVE_DIR)
    python -m horovod_tpu_torch.tools.capacity --ranks 4096 \\
        --live "$HOROVOD_CAPACITY_LIVE_DIR"

The calibrations are loopback-TCP, shared-GIL measurements: they price
the coordinator's per-rank walk costs, not NIC latency. The plan stamps
its calibration source.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..utils.live_calibration import LIVE_ARTIFACT_NAME
from ..utils.scaling_model import capacity_plan

#: The port's committed calibration: its package data.
DEFAULT_ARTIFACTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "calibration")
# Control-plane calibration candidates, in order: the port's own probe
# record, then the JAX tool's names (read only where --artifacts points
# at a directory that holds them).
CONTROL_PLANE_ARTIFACTS = ("capacity_port.json", "capacity_r17.json",
                           "simcluster_r13.json")
RESTORE_ARTIFACT = "elastic_restore_r15.json"
OVERLAP_ARTIFACT = "overlap_r16.json"


def _load_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _load_optional(path: str):
    try:
        return _load_json(path)
    except (OSError, ValueError):
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.capacity",
        description="extrapolate calibrated control-plane curves to a "
                    "target world size and name the first bottleneck")
    parser.add_argument("--ranks", type=int, required=True,
                        help="target world size to plan for")
    parser.add_argument("--model-bytes", type=int, default=0,
                        help="model size in bytes (restore-plane shard "
                             "cost; default 0)")
    parser.add_argument("--artifacts", default=DEFAULT_ARTIFACTS,
                        help="directory holding the calibration "
                             "artifacts (default: the port's own, "
                             f"{DEFAULT_ARTIFACTS})")
    parser.add_argument("--live", default=None, metavar="DIR",
                        help="plan from a live job's rolling re-fit "
                             "instead of the committed calibration: DIR "
                             "is the job's HOROVOD_CAPACITY_LIVE_DIR "
                             "holding its capacity_live.json")
    parser.add_argument("--step-time", type=float, default=None,
                        help="override the backward compute window in "
                             "seconds (default: the overlap artifact's "
                             "measured window)")
    parser.add_argument("--json", action="store_true",
                        help="emit the full plan as JSON")
    args = parser.parse_args(argv)
    if args.ranks < 1:
        parser.error("--ranks must be >= 1")

    control = None
    control_path = None
    if args.live is not None:
        # Live mode: the ONLY source is the job's persisted rolling
        # re-fit — falling back to a committed artifact here would
        # silently answer a different question than the operator asked.
        path = os.path.join(args.live, LIVE_ARTIFACT_NAME)
        control = _load_optional(path)
        control_path = path
        if control is None or not control.get("control_plane"):
            sys.stderr.write(
                f"capacity: no live re-fit at {path!r} — the job has not "
                "completed a telemetry window yet (or was launched "
                "without HOROVOD_CAPACITY_LIVE_DIR); windows roll every "
                "HOROVOD_METRICS_WINDOW_SECONDS (30s default) and the "
                "artifact lands every HOROVOD_CAPACITY_REFIT_WINDOWS "
                "windows and at shutdown. For a committed-calibration "
                "plan, drop --live.\n")
            return 2
    else:
        for name in CONTROL_PLANE_ARTIFACTS:
            path = os.path.join(args.artifacts, name)
            try:
                control = _load_json(path)
                control_path = path
                break
            except (OSError, ValueError):
                continue
        if control is None or not control.get("control_plane"):
            sys.stderr.write(
                "capacity: no readable control-plane calibration under "
                f"{args.artifacts!r} (looked for "
                f"{', '.join(CONTROL_PLANE_ARTIFACTS)}); run "
                "python -m horovod_tpu_torch.examples.capacity_probe to "
                "measure one\n")
            return 2

    restore = _load_optional(os.path.join(args.artifacts, RESTORE_ARTIFACT))
    overlap = _load_optional(os.path.join(args.artifacts, OVERLAP_ARTIFACT))

    plan = capacity_plan(
        ranks=args.ranks, model_bytes=args.model_bytes,
        control_plane_data=control, restore_data=restore,
        overlap_data=overlap, step_window_s=args.step_time)
    plan["artifacts"] = {
        "control_plane": control_path,
        "restore": (os.path.join(args.artifacts, RESTORE_ARTIFACT)
                    if restore is not None else None),
        "overlap": (os.path.join(args.artifacts, OVERLAP_ARTIFACT)
                    if overlap is not None else None),
    }

    if args.json:
        print(json.dumps(plan, indent=1, sort_keys=True))
        return 0

    print(f"capacity plan @ {args.ranks} ranks "
          f"(model {args.model_bytes} bytes)")
    print(f"  calibration: {plan['calibration_source']}")
    for name, entry in plan["planes"].items():
        sat = entry["saturation_ranks"]
        unc = entry["uncertainty_seconds"]
        print(f"  {name:>16}: {entry['predicted_seconds']:.6f}s"
              + (f" ±{unc:.6f}s" if unc is not None else "")
              + (f"  budget {entry['budget_seconds']}s"
                 f" ({entry['budget']})"
                 if entry["budget_seconds"] is not None else "")
              + (f"  saturates ~{sat} ranks" if sat is not None else ""))
    bottleneck = plan["first_bottleneck"]
    if bottleneck is not None:
        print(f"  first bottleneck: {bottleneck['plane']} — "
              f"{bottleneck['summary']}")
        print(f"    hint: {bottleneck['hint']}")
    else:
        print("  first bottleneck: none of the modeled planes saturate "
              "their budget (check the per-plane residuals before "
              "trusting the headroom)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
