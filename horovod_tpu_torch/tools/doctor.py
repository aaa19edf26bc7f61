"""``python -m horovod_tpu_torch.tools.doctor`` — offline cluster diagnosis.

Given an artifact directory (a traced job's ``HOROVOD_TRACE_DIR``,
ideally also holding its flight-recorder JSONL dumps), collects whatever
evidence survives there — ``straggler_report.json`` (attributed in
memory from the per-rank traces when the file is missing),
``clock_offsets.json``, postmortem dumps — runs the full rule catalog
(``horovod_tpu_torch.doctor``), and prints the diagnosis.

Read-only by design: a doctor pass never rewrites artifacts (use
``horovod_tpu_torch.trace.merge_trace_dir`` to rebuild a merge).
Exit codes: 0 = ran (healthy or not; parse the report for verdicts with
``--format json``), 2 = nothing diagnosable under the path. Pass
``--fail-on-findings`` to exit 1 when any finding fires (CI gates).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.doctor",
        description="Diagnose a job from its observability artifacts "
                    ".")
    parser.add_argument(
        "path",
        help="artifact directory: a traced run's HOROVOD_TRACE_DIR "
             "(trace.rank*.json / straggler_report.json / "
             "clock_offsets.json) and/or flight-recorder *.jsonl dumps")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument(
        "--fail-on-findings", action="store_true",
        help="exit 1 when any rule produces a finding (for CI gates)")
    args = parser.parse_args(argv)

    if not os.path.isdir(args.path):
        sys.stderr.write(f"not a directory: {args.path!r}\n")
        return 2

    from ..doctor import Evidence, render_text, report

    evidence = Evidence.from_artifacts(args.path)
    if (evidence.straggler_report is None and evidence.clock is None
            and not evidence.postmortems and not evidence.snapshots):
        sys.stderr.write(
            f"nothing diagnosable under {args.path!r} — expected a traced "
            "run's artifacts (trace.rank*.json / straggler_report.json / "
            "clock_offsets.json) or flight-recorder *.jsonl dumps\n")
        return 2
    rep = report(evidence)
    if args.format == "json":
        json.dump(rep, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_text(rep))
    if args.fail_on_findings and rep["findings"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
