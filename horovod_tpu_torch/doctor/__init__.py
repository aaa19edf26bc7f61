"""Cluster doctor: rule-based diagnosis over the observability stack,
the port's own copy of the JAX package's ``doctor``.

The evidence is per-rank metrics with a rank-0 cluster view,
flight-recorder postmortems, and clock-synced traces with straggler
attribution. This layer reads all of it end to end: a fixed catalog
of rules (``doctor/rules.py``) turns raw series and reports into
structured :class:`~horovod_tpu_torch.doctor.rules.Diagnosis` records —
severity, subject rank, the evidence numbers, and a human remediation
hint ("rank 1 is persistently ≥50ms late at negotiation across 200
collectives; suspect its NIC or a co-tenant").

Three surfaces, one engine:

* **Live HTTP** — rank 0's metrics endpoint also serves ``GET /doctor``
  (JSON report over the cluster view), so the same scrape target that
  answers "what are the numbers" answers "what is wrong".
* **Periodic log line** — the coordinator runs a sweep every
  ``HOROVOD_DOCTOR_CYCLES`` cycles, logs one summary line, and mirrors
  per-rule finding counts into the ``hvd_doctor_*`` gauges.
* **Offline CLI** — ``python -m horovod_tpu_torch.tools.doctor <dir>``
  diagnoses a dead job from what it left on disk (straggler report,
  clock offsets, flight-recorder JSONL), attributing the trace in
  memory when the report file is missing.

Everything here is read-only over the evidence and inert unless called;
nothing registers metrics at import time.
"""

from __future__ import annotations

from typing import Optional

from .evidence import Evidence  # noqa: F401
from .rules import (  # noqa: F401
    ALL_RULES,
    RULE_SLUGS,
    Diagnosis,
    diagnose,
)

__all__ = [
    "Evidence", "Diagnosis", "ALL_RULES", "RULE_SLUGS", "diagnose",
    "report", "render_text", "summary", "periodic_line", "http_body",
]

_m = None


def _doctor_metrics():
    """Lazy registration (tests/test_metrics_lint.py: never at import
    time)."""
    global _m
    if _m is None:
        from types import SimpleNamespace

        from .. import metrics

        _m = SimpleNamespace(
            runs=metrics.counter(
                "hvd_doctor_runs_total",
                "Completed cluster-doctor sweeps on this rank."),
            findings=metrics.gauge(
                "hvd_doctor_findings",
                "Findings per rule in the most recent doctor sweep "
                "(0 once a finding heals).", ("rule",)))
    return _m


def report(evidence: Optional[Evidence] = None) -> dict:
    """Run the full rule catalog and return the JSON-clean report served
    by ``GET /doctor`` and printed by the offline CLI. With no evidence
    given, diagnoses the live process (rank-0 cluster view when the
    worker snapshots have been piggybacked). A live sweep also mirrors
    per-rule counts into the ``hvd_doctor_*`` series."""
    ev = evidence if evidence is not None else Evidence.live()
    findings = diagnose(ev)
    counts = {severity: 0 for severity in ("critical", "warning", "info")}
    for finding in findings:
        counts[finding.severity] += 1
    if ev.source == "live":
        from .. import metrics

        if metrics.on():
            m = _doctor_metrics()
            m.runs.inc()
            per_rule = {slug: 0 for slug in RULE_SLUGS}
            for finding in findings:
                per_rule[finding.rule] = per_rule.get(finding.rule, 0) + 1
            for slug in sorted(per_rule):
                m.findings.labels(slug).set(per_rule[slug])
    return {
        "source": ev.source,
        "ranks_observed": ev.ranks_observed(),
        "healthy": not findings,
        "counts": counts,
        "findings": [finding.to_dict() for finding in findings],
    }


def summary(rep: Optional[dict] = None) -> dict:
    """Compact verdict for the load generator's ``"health"`` field:
    how many rules hit and the worst finding's hint. All-empty on a
    healthy run — honest emptiness beats invented detail."""
    rep = rep if rep is not None else report()
    findings = rep.get("findings", [])
    worst = findings[0] if findings else None
    return {
        "findings": len(findings),
        "rules_hit": sorted({f["rule"] for f in findings}),
        "worst_rank": worst.get("rank") if worst else None,
        "worst_hint": worst.get("hint") if worst else None,
    }


def render_text(rep: dict) -> str:
    """Human rendering of a report (CLI default output)."""
    lines = [f"cluster doctor — source: {rep.get('source', '?')}, "
             f"ranks observed: {rep.get('ranks_observed', [])}"]
    findings = rep.get("findings", [])
    if not findings:
        lines.append("healthy: no rule produced a finding")
    for finding in findings:
        where = (f" rank {finding['rank']}"
                 if finding.get("rank") is not None else "")
        lines.append(
            f"[{finding['severity']}] {finding['rule']}{where}: "
            f"{finding['summary']}")
        lines.append(f"    hint: {finding['hint']}")
        if finding.get("evidence"):
            lines.append(f"    evidence: {finding['evidence']}")
    return "\n".join(lines) + "\n"


def periodic_line(evidence: Optional[Evidence] = None,
                  rep: Optional[dict] = None) -> str:
    """One log line for the coordinator's periodic sweep. Pass ``rep``
    to render a report already produced by :func:`report` — calling
    :func:`report` twice would double-count the sweep gauges."""
    if rep is None:
        rep = report(evidence)
    if rep["healthy"]:
        return (f"healthy ({len(rep['ranks_observed'])} rank(s) "
                "observed)")
    parts = []
    for finding in rep["findings"][:3]:
        where = (f"rank {finding['rank']} "
                 if finding.get("rank") is not None else "")
        parts.append(f"{where}{finding['rule']} [{finding['severity']}]")
    more = len(rep["findings"]) - 3
    if more > 0:
        parts.append(f"+{more} more")
    return (f"{len(rep['findings'])} finding(s): " + "; ".join(parts)
            + f" — full report at /doctor; worst hint: "
              f"{rep['findings'][0]['hint']}")


def http_body() -> "tuple[str, str]":
    """(content type, body) for the exporter's ``GET /doctor`` route."""
    import json

    return ("application/json; charset=utf-8",
            json.dumps(report(), indent=1, sort_keys=True) + "\n")
