"""``python -m horovod_tpu_torch.tools.simcluster`` — seeded cluster-scale
scenario runner on the port's simulated cluster (``horovod_tpu_torch.sim``).

Runs N logical ranks (1 real coordinator + N-1 multiplexed workers)
through a seeded FaultPlan for K steps with the wire-protocol
conformance monitor armed, then judges the run: consistent collectives
at every settled membership, zero off-spec wire transitions, and the
live doctor naming every injected fault the plan promises is
diagnosable. Exit status is the contract — 0 clean, 1 any conformance
violation or undiagnosed fault — so a CI job can gate on a
hundred-rank chaos scenario the way it gates on a unit test.

Examples::

    # 64-rank smoke: no faults, conformance + consistency only
    python -m horovod_tpu_torch.tools.simcluster --ranks 64 --steps 30

    # storm from a plan file (same JSON schema as HOROVOD_FAULT_PLAN)
    python -m horovod_tpu_torch.tools.simcluster --ranks 64 --steps 40 \\
        --plan @storm.json

    # machine-readable verdict
    python -m horovod_tpu_torch.tools.simcluster --ranks 32 \\
        --plan @p.json --json
"""

from __future__ import annotations

import argparse
import json
import sys

from ..sim.faults import SimFaultDriver, load_rules
from ..sim.scenario import run_scenario


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.simcluster",
        description="multiplexed N-logical-rank chaos/conformance runner")
    parser.add_argument("--ranks", type=int, default=64,
                        help="logical world size (default 64)")
    parser.add_argument("--steps", type=int, default=40,
                        help="collective steps to drive (default 40)")
    parser.add_argument("--plan", default=None,
                        help="FaultPlan JSON (inline, or @/path/to/file) — "
                             "the HOROVOD_FAULT_PLAN schema, cycle-site "
                             "rules only")
    parser.add_argument("--retries", type=int, default=16,
                        help="reshape retries per step before giving up")
    parser.add_argument("--driver-threads", type=int, default=1,
                        help="shard the lockstep phases across this many "
                             "named driver threads (1024-rank storms; "
                             "default 1 = serial)")
    parser.add_argument("--json", action="store_true",
                        help="emit the full verdict as JSON")
    args = parser.parse_args(argv)

    driver = None
    if args.plan:
        raw = args.plan
        if raw.startswith("@"):
            with open(raw[1:], encoding="utf-8") as f:
                raw = f.read()
        rules, seed = load_rules(raw)
        driver = SimFaultDriver(rules, seed=seed)

    result = run_scenario(args.ranks, driver, steps=args.steps,
                          retries=args.retries,
                          driver_threads=args.driver_threads)
    if args.json:
        print(json.dumps(result.to_dict(), indent=1, sort_keys=True))
    else:
        print(f"simcluster: {result.ranks} logical ranks, {result.steps} "
              f"steps -> epoch {result.final_epoch}, size "
              f"{result.final_size}; {result.transitions} conformant wire "
              f"transitions, {len(result.violations)} violation(s), "
              f"{len(result.findings)} doctor finding(s)")
        for finding in result.findings:
            rank = finding.get("rank")
            where = f" rank {rank}" if rank is not None else ""
            print(f"  doctor[{finding['severity']}] {finding['rule']}"
                  f"{where}: {finding['summary']}")
        for problem in result.problems:
            print(f"  FAIL: {problem}")
    if not result.ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
