"""``python -m horovod_tpu_torch.tools.check`` — the port's aggregate
static gate.

One command, one exit code, one summary line per tool. Runs, in-process:

1. **hvdlint** — the package scan (``horovod_tpu_torch/`` minus
   ``examples/``) against ``tools/hvdlint-baseline.json``, parse errors
   counted as findings;
2. **aux lint** — the aux rule-set over ``horovod_tpu_torch/examples/``
   and the port's tests against ``tools/hvdlint-aux-baseline.json``;
3. **protocheck** — spec self-check + handler↔spec bijection, *plus*
   the ``--native`` frame-kind coverage of the C++ engine;
4. **lock graph** — the whole-process static acyclicity gate (Python
   ``make_lock`` sites ∪ the C++ mutex graph);
5. **hvdabi** — the full cross-language ABI/counter/manifest pass
   (``tools/abicheck.py``).

Exit 0 iff every tool is clean; it runs in seconds. ``--format json``
emits one machine-readable object on one line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_hvdlint() -> dict:
    from ..analysis import load_baseline
    from .lint import DEFAULT_BASELINE, lint_package

    result = lint_package(baseline=load_baseline(DEFAULT_BASELINE))
    n = len(result.findings) + len(result.parse_errors)
    return {"ok": n == 0, "findings": n,
            "detail": [f.render() for f in result.findings]
            + [f"{p}: PARSE-ERROR {e}" for p, e in result.parse_errors],
            "files_scanned": result.files_scanned}


def _run_aux() -> dict:
    from ..analysis import load_baseline
    from .lint import AUX_BASELINE, lint_aux

    result = lint_aux(baseline=load_baseline(AUX_BASELINE))
    n = len(result.findings) + len(result.parse_errors)
    return {"ok": n == 0, "findings": n,
            "detail": [f.render() for f in result.findings]
            + [f"{p}: PARSE-ERROR {e}" for p, e in result.parse_errors],
            "files_scanned": result.files_scanned}


def _run_protocheck() -> dict:
    from ..analysis import cpp, protocol

    findings = [{"path": "analysis/protocol.py", "line": 0,
                 "message": f"spec inconsistency: {p}"}
                for p in protocol.check_spec()]
    findings.extend(protocol.check_handlers(_PKG_DIR))
    engine = cpp.load_sources().get("engine")
    if engine is None:
        native = {"findings": [{"path": dict(cpp.CPP_SOURCES)["engine"],
                                "line": 0, "message": "engine.cc not found"}],
                  "coverage": {}}
    else:
        anchors = cpp.parse_frame_anchors(engine["comments"])
        nf, coverage = cpp.check_native_frames(
            engine["functions"], anchors, protocol.KINDS,
            engine["relpath"])
        native = {"findings": nf, "coverage": coverage}
    n = len(findings) + len(native["findings"])
    return {"ok": n == 0, "findings": n,
            "detail": [f"{f['path']}:{f['line']}: {f['message']}"
                       for f in findings + native["findings"]],
            "native_coverage": native["coverage"]}


def _run_lockgraph() -> dict:
    from ..analysis import lockorder

    rep = lockorder.static_graph()
    cycles = [c["locks"] for c in rep["cycles"]]
    return {"ok": rep["acyclic"] and bool(rep["locks"]),
            "findings": len(cycles),
            "detail": [" -> ".join(c) for c in cycles],
            "locks": len(rep["locks"]), "edges": len(rep["edges"])}


def _run_hvdabi() -> dict:
    from ..analysis import cpp

    report = cpp.run_checks()
    findings = report["findings"]
    return {"ok": not findings, "findings": len(findings),
            "detail": [f"{f['path']}:{f['line']}: [{f['check']}] "
                       f"{f['message']}" for f in findings],
            "exports": len(report["manifest"]["exports"])}


TOOLS = (
    ("hvdlint", _run_hvdlint),
    ("aux-lint", _run_aux),
    ("protocheck", _run_protocheck),
    ("lock-graph", _run_lockgraph),
    ("hvdabi", _run_hvdabi),
)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.check",
        description="the port's aggregate static gate: hvdlint + aux "
                    "lint + protocheck (incl. --native) + whole-process "
                    "lock graph + hvdabi; exit 0 iff all clean.")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--verbose", action="store_true",
                        help="print every finding, not just summaries")
    args = parser.parse_args(argv)

    results = {}
    ok = True
    for name, fn in TOOLS:
        try:
            results[name] = fn()
        except Exception as exc:  # a crashed tool is a failed gate
            results[name] = {"ok": False, "findings": 1,
                             "detail": [f"tool crashed: {exc!r}"]}
        ok = ok and results[name]["ok"]

    if args.format == "json":
        out = {"ok": ok}
        for name, res in results.items():
            kept = {k: v for k, v in res.items() if k != "detail"}
            if not res["ok"]:
                kept["detail"] = res["detail"]
            out[name] = kept
        # One line on purpose: a caller reads the last line of stdout.
        sys.stdout.write(json.dumps(out, sort_keys=True) + "\n")
        return 0 if ok else 1

    for name, res in results.items():
        status = "ok" if res["ok"] else f"{res['findings']} finding(s)"
        extras = []
        for key in ("files_scanned", "locks", "edges", "exports"):
            if key in res:
                extras.append(f"{key}={res[key]}")
        suffix = f" ({', '.join(extras)})" if extras else ""
        print(f"check: {name:<10} ... {status}{suffix}")
        if res["detail"] and (args.verbose or not res["ok"]):
            for line in res["detail"]:
                print(f"    {line}")
    print(f"check: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
