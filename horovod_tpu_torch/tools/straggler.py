"""``python -m horovod_tpu_torch.tools.straggler`` — offline straggler
analysis, the JAX package's tool over the port's ``trace`` modules.

Given a trace directory (``HOROVOD_TRACE_DIR`` of a traced run) or a
``merged_trace.json``, (re)merges the per-rank trace files through the
recorded clock offsets and prints the straggler-attribution report
(also written as ``straggler_report.json`` next to the merged trace).

Works after a crash: the controller leaves valid per-rank files and the
offset table behind even when the shutdown trace exchange never ran, so
the evidence survives the job. See ``docs/tracing.md`` for how to read
the report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.straggler",
        description="Merge per-rank traces and attribute stragglers.")
    parser.add_argument(
        "path",
        help="trace directory (with trace.rank*.json) or a "
             "merged_trace.json")
    parser.add_argument(
        "--remerge", action="store_true",
        help="rebuild merged_trace.json even if one already exists")
    parser.add_argument(
        "--epsilon", type=float, default=None,
        help="slack below this (seconds) is clock noise, not a straggler "
             "(default 1e-4)")
    parser.add_argument(
        "--no-report-file", action="store_true",
        help="print the report only; do not write straggler_report.json")
    args = parser.parse_args(argv)

    from ..trace import (
        MERGED_TRACE_FILE,
        REPORT_FILE,
        attribute,
        merge_trace_dir,
        rank_trace_files,
    )
    from ..trace.straggler import DEFAULT_SLACK_EPSILON_SECONDS

    path = args.path
    if os.path.isdir(path):
        trace_dir = path
        merged_path = os.path.join(trace_dir, MERGED_TRACE_FILE)
        if args.remerge or not os.path.exists(merged_path):
            if not rank_trace_files(trace_dir):
                sys.stderr.write(
                    f"no trace.rank*.json files under {trace_dir!r} — was "
                    "the job run with HOROVOD_TRACE_DIR/--trace?\n")
                return 2
            merge_trace_dir(trace_dir)
            sys.stderr.write(f"merged trace written to {merged_path}\n")
    else:
        merged_path = path
        trace_dir = os.path.dirname(os.path.abspath(path))

    with open(merged_path) as f:
        events = json.load(f)
    epsilon = (args.epsilon if args.epsilon is not None
               else DEFAULT_SLACK_EPSILON_SECONDS)
    # feed=False: a CLI run must not require (or mutate) a live metrics
    # registry — the report itself is the artifact here.
    report = attribute(events, epsilon=epsilon, feed=False)
    if not args.no_report_file:
        report_path = os.path.join(trace_dir, REPORT_FILE)
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        sys.stderr.write(f"report written to {report_path}\n")
    json.dump(report, sys.stdout, indent=1, sort_keys=True)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
