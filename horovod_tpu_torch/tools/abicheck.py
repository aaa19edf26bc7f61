"""``python -m horovod_tpu_torch.tools.abicheck`` — hvdabi over the port.

Static ABI/counter/frame-kind conformance of the port's C++ core against
its Python planes (``analysis/cpp.py``). No compiler, no rebuild: the
``extern "C"`` signatures, counter-slot enum, frame-kind anchors and
mutex regions are parsed out of ``core/src/{engine.cc,ring.cc,shm.cc,
timeline.h}`` and ``tensorflow/src/tf_ops.cc`` and joined with
``core/bindings.py``, the TF op library's ``CoreApi`` fn-pointer table,
the metrics mirror (``metrics/__init__.py``) and the known-series pin
(``tests/test_torch_metrics_lint.py``).

* default run — all checkers (ABI bijection, counter/metrics parity,
  native frame-kind coverage, C++ lock-graph acyclicity) plus a diff of
  the live manifest against the committed pin
  (``horovod_tpu_torch/core/hvdabi-manifest.json``). **Exit 1 on any
  finding.**
* ``--dump-manifest`` — print the deterministic manifest (sorted JSON,
  no line numbers) and exit; the golden test diffs this against the
  pin.
* ``--write-manifest`` — regenerate the committed pin after an
  intentional ABI change (edit C++ → run abicheck → update bindings →
  re-pin).
* ``--format json`` — the full report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..analysis import cpp

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_DIR = os.path.dirname(_PKG_DIR)
DEFAULT_MANIFEST = os.path.join(_REPO_DIR, cpp.MANIFEST_PATH)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.abicheck",
        description="hvdabi: static Python<->C++ ABI/counter/frame-kind "
                    "conformance of the port. Exit 1 on any finding.")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--dump-manifest", action="store_true",
                        help="print the deterministic ABI manifest and "
                             "exit")
    parser.add_argument("--write-manifest", action="store_true",
                        help=f"regenerate the pin ({DEFAULT_MANIFEST}) "
                             "after an intentional ABI change")
    parser.add_argument("--manifest", default=DEFAULT_MANIFEST,
                        help="pin location (default: %(default)s)")
    args = parser.parse_args(argv)

    if args.dump_manifest:
        sys.stdout.write(cpp.render_manifest(cpp.build_manifest()))
        return 0
    if args.write_manifest:
        manifest = cpp.build_manifest()
        with open(args.manifest, "w", encoding="utf-8") as f:
            f.write(cpp.render_manifest(manifest))
        print(f"abicheck: wrote {args.manifest} "
              f"({len(manifest['exports'])} exports, "
              f"{manifest['counters']['n_slots']} counter slots)")
        return 0

    report = cpp.run_checks()
    findings = report["findings"]
    rc = 1 if findings else 0
    if args.format == "json":
        out = {
            "findings": findings,
            "frame_coverage": report["coverage"],
            "lock_graph": report["lock_graph"],
            "exports": len(report["manifest"]["exports"]),
            "counter_slots": report["manifest"]["counters"]["n_slots"],
            "core_api": len(report["manifest"]["core_api"]),
            "absent": report["absent"],
        }
        sys.stdout.write(json.dumps(out, indent=1, sort_keys=True) + "\n")
        return rc
    for f in findings:
        print(f"{f['path']}:{f['line']}: [{f['check']}] {f['message']}")
    by_check = {}
    for f in findings:
        by_check[f["check"]] = by_check.get(f["check"], 0) + 1
    detail = ", ".join(f"{k}={v}" for k, v in sorted(by_check.items())) \
        or "abi, counters, native-frames, locks, manifest all clean"
    absent = (f"; absent: {', '.join(report['absent'])}"
              if report["absent"] else "")
    print(f"abicheck: {len(findings)} finding(s) "
          f"({detail}; {len(report['manifest']['exports'])} exports, "
          f"{len(report['manifest']['core_api'])} tf_ops.cc CoreApi "
          f"field(s), {report['manifest']['counters']['n_slots']} counter "
          f"slots, {len(report['lock_graph']['edges'])} C++ lock "
          f"edge(s){absent})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
