"""``python -m horovod_tpu_torch.tools.protocheck`` — protocol
conformance CLI over the port.

The static side of the wire/epoch protocol spec
(``horovod_tpu_torch/analysis/protocol.py``):

* default run — spec self-check (every role covers every frame kind,
  guards known, states reachable) + handler↔spec bijection against the
  port's ``common/wire.py``, ``controller/service.py``,
  ``controller/controller.py``, ``controller/native.py`` and
  ``elastic/shards.py``. **Exit 1 on any drift**
  (``tests/test_torch_protocol.py`` gates it).
* ``--runtime PATH...`` — also validate ``protocheck.json`` artifacts
  from monitored runs (``HOROVOD_PROTOCHECK=1``): exit 1 if any recorded
  an off-spec transition or cannot be read.
* ``--lockgraph PATH...`` — the static×runtime lock-graph join: build
  the potential lock-order graph from the port's source, merge the
  runtime ``lockgraph.json`` dumps, and report (a) runtime edges the
  static graph misses (a bug in the static pass — it must be a superset)
  and (b) statically-possible cycles no run has ever exhibited; exit 1
  when either exists.
* ``--native`` — frame-kind coverage of the port's C++ engine
  (``core/src/engine.cc``) against the same 7-kind SPEC, via the hvdabi
  extractor (``analysis/cpp.py``): every kind must carry a
  ``hvdabi:frame-kind`` anchor declaring it handled (with a real
  function) or explicitly unsupported — a kind with neither is a frame
  the native engine would silently drop (exit 1).
* ``--dump-spec`` — render the three role state tables as markdown.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..analysis import lockorder, protocol

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _static_findings() -> List[dict]:
    findings = [{"path": "analysis/protocol.py", "line": 0,
                 "message": f"spec inconsistency: {p}"}
                for p in protocol.check_spec()]
    findings.extend(protocol.check_handlers(_PKG_DIR))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.protocheck",
        description="wire/epoch protocol conformance of the port: spec "
                    "self-check + handler bijection (exit 1 on drift), "
                    "runtime artifact validation, static x runtime "
                    "lock-graph join")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--dump-spec", action="store_true",
                        help="print the role state tables as markdown "
                             "and exit")
    parser.add_argument("--runtime", nargs="*", default=None,
                        metavar="PROTOCHECK_JSON",
                        help="validate runtime protocheck.json artifacts "
                             "(exit 1 on recorded violations)")
    parser.add_argument("--native", action="store_true",
                        help="also check the C++ engine's frame-kind "
                             "coverage against the SPEC (hvdabi static "
                             "anchors; exit 1 on silent drops)")
    parser.add_argument("--lockgraph", nargs="*", default=None,
                        metavar="LOCKGRAPH_JSON",
                        help="join the static lock-order graph with "
                             "runtime lockgraph.json dumps; exit 1 on "
                             "unobserved static cycles or a broken "
                             "superset")
    args = parser.parse_args(argv)

    if args.dump_spec:
        sys.stdout.write(protocol.render_state_tables())
        return 0

    report = {"static_findings": _static_findings()}
    rc = 1 if report["static_findings"] else 0

    if args.native:
        from ..analysis import cpp

        sources = cpp.load_sources()
        engine = sources.get("engine")
        if engine is None:
            report["native"] = {
                "findings": [{"path": dict(cpp.CPP_SOURCES)["engine"],
                              "line": 0,
                              "message": "engine.cc not found"}],
                "coverage": {}}
            rc = 1
        else:
            anchors = cpp.parse_frame_anchors(engine["comments"])
            findings, coverage = cpp.check_native_frames(
                engine["functions"], anchors, protocol.KINDS,
                engine["relpath"])
            report["native"] = {"findings": findings, "coverage": coverage}
            if findings:
                rc = 1

    if args.runtime is not None:
        runtime = {"artifacts": [], "violations": []}
        for path in args.runtime:
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
            except (OSError, ValueError) as exc:
                runtime["artifacts"].append(
                    {"path": path, "error": str(exc)})
                rc = 1
                continue
            runtime["artifacts"].append(
                {"path": path,
                 "transitions": data.get("transitions", 0),
                 "violations": len(data.get("violations", []))})
            for v in data.get("violations", []):
                runtime["violations"].append({"artifact": path, **v})
        if runtime["violations"]:
            rc = 1
        report["runtime"] = runtime

    if args.lockgraph is not None:
        static = lockorder.static_graph()
        reports = []
        for path in args.lockgraph:
            try:
                with open(path, encoding="utf-8") as f:
                    reports.append(json.load(f))
            except (OSError, ValueError) as exc:
                report.setdefault("lockgraph_errors", []).append(
                    {"path": path, "error": str(exc)})
                rc = 1
        join = lockorder.join_reports(static, reports)
        report["lock_join"] = join
        if not join["superset"] or join["unobserved_cycles"]:
            rc = 1

    if args.format == "json":
        sys.stdout.write(json.dumps(report, indent=1, sort_keys=True)
                         + "\n")
        return rc

    for f in report["static_findings"]:
        print(f"{f['path']}:{f['line']}: {f['message']}")
    print(f"protocheck: {len(report['static_findings'])} static "
          "finding(s)")
    if "native" in report:
        for f in report["native"]["findings"]:
            print(f"{f['path']}:{f['line']}: {f['message']}")
        cov = report["native"]["coverage"]
        handled = sorted(k for k, v in cov.items()
                         if v["status"] == "handled")
        unsupported = sorted(k for k, v in cov.items()
                             if v["status"] == "unsupported")
        print(f"protocheck --native: "
              f"{len(report['native']['findings'])} finding(s); "
              f"handled: {', '.join(handled) or '-'}; "
              f"declared unsupported: {', '.join(unsupported) or '-'}")
    if "runtime" in report:
        for v in report["runtime"]["violations"]:
            print(f"{v['artifact']}: OFF-SPEC {v['role']}.{v['state']} "
                  f"{v['direction']} {v['kind']}: {v['detail']}")
        total = sum(a.get("transitions", 0)
                    for a in report["runtime"]["artifacts"])
        print(f"protocheck: {len(report['runtime']['violations'])} "
              f"runtime violation(s) over {total} transition(s) in "
              f"{len(report['runtime']['artifacts'])} artifact(s)")
    if "lock_join" in report:
        join = report["lock_join"]
        for edge in join["uncovered_runtime_edges"]:
            print(f"lockgraph: runtime edge {edge[0]} -> {edge[1]} is "
                  "MISSING from the static graph (static pass bug)")
        for cyc in join["unobserved_cycles"]:
            print("lockgraph: statically-possible cycle never observed "
                  "at runtime: " + " -> ".join(cyc))
        print(f"lockgraph: {join['static_edges']} static edge(s), "
              f"{join['runtime_edges']} runtime edge(s), superset="
              f"{join['superset']}, "
              f"{len(join['unobserved_cycles'])} unobserved cycle(s)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
