"""Seeded chaos scenarios: plan in, verdict out.

One loop shared by the 64/256-rank storm tests and the
``python -m horovod_tpu_torch.tools.simcluster`` CLI: drive a
:class:`SimCluster` for K steps under a FaultPlan interpreted by
:class:`SimFaultDriver`, one training-shaped allreduce per step, with
every membership transition settled through the elastic retry contract.
The verdict compares three things against the plan:

* **consistency** — every completed step's allreduce sums to the live
  world size (each member contributes 1.0), and membership epochs
  settle (final steps complete without tearing);
* **conformance** — the protocol monitor recorded zero off-spec
  transitions across every wire of every epoch;
* **diagnosis** — the live doctor names every injected fault the plan
  promises is diagnosable (:func:`expected_diagnoses`): the straggler
  rank(s) by tick lateness, and the most-departed rank via the
  membership-churn rule.

An empty verdict list means the scenario passed; each entry is one
human-readable failure (the CLI prints them and exits non-zero).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .cluster import SimCluster, allreduce_spec
from .faults import SimFaultDriver, expected_diagnoses


@dataclasses.dataclass
class ScenarioResult:
    ranks: int
    steps: int
    final_epoch: int
    final_size: int
    transitions: int           # protocheck-observed wire transitions
    violations: List[dict]
    findings: List[dict]       # doctor findings (rule/rank/severity/...)
    expected: Dict[str, object]
    problems: List[str]        # empty == scenario passed

    @property
    def ok(self) -> bool:
        return not self.problems

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def run_scenario(ranks: int, driver: Optional[SimFaultDriver],
                 steps: int = 40, retries: int = 16,
                 driver_threads: int = 1) -> ScenarioResult:
    """Run ``steps`` collective steps under the plan; settle; judge.
    ``driver_threads > 1`` shards the lockstep phases across the named
    pool (1024-rank storms; protocheck stays armed per wire)."""
    problems: List[str] = []
    findings: List[dict] = []
    expected: Dict[str, object] = expected_diagnoses(
        driver.rules if driver is not None else [], steps)
    final_epoch, final_size = 1, ranks
    cluster = SimCluster(ranks=ranks, elastic=True, protocheck=True,
                         enable_metrics=True,
                         driver_threads=driver_threads)
    cluster.start()
    try:
        for cycle in range(1, steps + 1):
            faults = (driver.faults_for_cycle(cycle,
                                              cluster.alive_worker_ranks)
                      if driver is not None else None)
            if faults is not None:
                for rank in sorted(faults.kills):
                    if rank in cluster.workers:
                        cluster.kill(rank)
                for rank in sorted(faults.leaves - faults.kills):
                    if rank in cluster.workers:
                        cluster.leave(rank)
                for _ in range(faults.joins):
                    cluster.spawn_joiner()
            delays = {rank: seconds
                      for rank, seconds in sorted(
                          (faults.delays if faults else {}).items())
                      if rank in cluster.workers
                      and cluster.workers[rank].alive}
            name = f"storm.{cycle}"
            res = cluster.run_step(
                [allreduce_spec(name,
                                lambda r: np.ones(2, np.float32))],
                retries=retries, delays=delays)
            if res.error0 is not None:
                problems.append(
                    f"step {cycle}: rank 0 collective failed: "
                    f"{res.error0}")
                break
            if name not in res.results0:
                problems.append(
                    f"step {cycle}: collective {name!r} never resolved "
                    f"(aborted={res.aborted}, world size {cluster.size})")
                break
            got = float(res.results0[name][0])
            expect = float(cluster.size)
            if got != expect:
                problems.append(
                    f"step {cycle}: allreduce sum {got} != live world "
                    f"size {expect} — membership and data plane disagree")
        findings = cluster.doctor_report()["findings"]
        _judge_diagnoses(findings, expected, problems)
        final_epoch = cluster.epoch
        final_size = cluster.size
    finally:
        cluster.stop()
    report = cluster.protocheck_report or {}
    violations = list(report.get("violations", []))
    if violations:
        problems.append(
            f"{len(violations)} protocol violation(s) recorded — "
            "first: " + str(violations[0]))
    if not report.get("transitions"):
        problems.append("protocol monitor observed zero transitions — "
                        "the conformance check went vacuous")
    return ScenarioResult(
        ranks=ranks, steps=steps, final_epoch=final_epoch,
        final_size=final_size,
        transitions=int(report.get("transitions", 0)),
        violations=violations, findings=findings, expected=expected,
        problems=problems)


def _judge_diagnoses(findings: List[dict], expected: Dict[str, object],
                     problems: List[str]) -> None:
    """Every fault the plan injected must be named by the doctor."""
    by_rule: Dict[str, List[dict]] = {}
    for finding in findings:
        by_rule.setdefault(finding["rule"], []).append(finding)
    for rank in expected["straggler_ranks"]:
        named = [f for f in by_rule.get("persistent_straggler", [])
                 if f.get("rank") == rank]
        if not named:
            problems.append(
                f"undiagnosed fault: injected straggler rank {rank} not "
                "named by persistent_straggler "
                f"(doctor found: {sorted(by_rule)})")
    if expected["churn"]:
        churn = by_rule.get("membership_churn", [])
        if not churn:
            problems.append(
                "undiagnosed fault: injected membership churn not "
                f"reported (doctor found: {sorted(by_rule)})")
        elif expected["most_departed"] is not None:
            named = {f.get("rank") for f in churn}
            if expected["most_departed"] not in named:
                problems.append(
                    "membership_churn fired but named rank(s) "
                    f"{sorted(named)} instead of the most-departed rank "
                    f"{expected['most_departed']}")
