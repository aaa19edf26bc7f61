"""FaultPlan at fleet scale: the sim-side interpreter.

A real rank consults its :class:`~horovod_tpu_torch.fault.plan.FaultPlan`
in-process and executes the actions on *itself* (``os.kill``,
``os._exit``, fork a joiner clone). In the sim every logical rank lives
in the driver's process, so executing a plan verbatim would kill the
test runner. This module re-reads the same JSON schema (validated by
the same :class:`FaultRule` constructor — one schema, two executors)
and turns each cycle's firing rules into a :class:`CycleFaults` bundle
the driver applies to its logical ranks:

* ``kill`` / ``exit`` — close the rank's wire abruptly (what a SIGKILL
  looks like from the coordinator's side).
* ``leave`` — close it too; the exit-code distinction is a process-tier
  concept with no wire-level footprint.
* ``group_kill`` — close EVERY wire in ``ranks`` before the same cycle's
  ticks: a correlated rack failure, which drives the coordinator's
  reform() straight into its drop-and-retry mid-handshake path.
* ``join`` — dial one new logical joiner per matching rank (the mp
  semantics: each matching process spawns one clone).
* ``delay`` — the rank's tick goes out late by ``seconds`` (± seeded
  jitter), which the coordinator measures as tick lateness and the
  doctor must attribute: the flapping-NIC / straggler burst.

Counting fidelity: the mp plan counts cycle events per *process*; the
sim counts the cluster's global step index, which the lockstep protocol
keeps equal to every live rank's own count. (A joiner admitted mid-run
starts its private count late in the mp world; the sim keeps the global
index — recorded as a caveat in the JAX package's docs/simcluster.md.)

:func:`expected_diagnoses` derives, from the same plan, what the doctor
must find afterwards — the contract `tools/simcluster` enforces: every
*injected* fault named, or exit non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, List, Optional, Tuple

from ..fault.plan import FaultRule

# Actions the sim can express on a logical rank. "drop"/"raise"/"wedge"
# act inside a real process (wire hooks, init path) that a SimWorker
# deliberately does not have — rejected loudly, never silently skipped.
SIM_ACTIONS = ("kill", "exit", "leave", "join", "delay", "group_kill")


def load_rules(text: str) -> Tuple[List[FaultRule], int]:
    """Parse plan JSON through the real FaultRule validator, WITHOUT the
    per-process rank filter ``FaultPlan.__init__`` applies (the sim
    drives every rank, so it needs every rule)."""
    spec = json.loads(text)
    if isinstance(spec, list):
        spec = {"faults": spec}
    rules = [FaultRule(**entry) for entry in spec.get("faults", [])]
    return rules, int(spec.get("seed", 0))


def sim_supported_plan(rules: List[FaultRule]) -> None:
    """Reject plans the sim cannot express — a chaos run that silently
    skipped its faults would pass every assertion forever."""
    for rule in rules:
        if rule.site != "cycle":
            raise ValueError(
                f"simcluster drives faults at cycle granularity only; "
                f"rule {rule.action!r} uses site {rule.site!r} (run the "
                "process-per-rank harness for wire/init sites)")
        if rule.action not in SIM_ACTIONS:
            raise ValueError(
                f"simcluster cannot express action {rule.action!r} "
                f"(supported: {SIM_ACTIONS})")


@dataclasses.dataclass
class CycleFaults:
    """What one cycle's firing rules do to the logical ranks."""

    kills: set = dataclasses.field(default_factory=set)
    leaves: set = dataclasses.field(default_factory=set)
    joins: int = 0
    delays: Dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def departures(self) -> set:
        return self.kills | self.leaves

    def any(self) -> bool:
        return bool(self.kills or self.leaves or self.joins or self.delays)


class SimFaultDriver:
    """Seeded, deterministic: the same plan JSON produces the same fault
    schedule every run, jitter included (same contract as FaultPlan)."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        sim_supported_plan(rules)
        self.rules = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)

    @classmethod
    def from_json(cls, text: str) -> "SimFaultDriver":
        rules, seed = load_rules(text)
        return cls(rules, seed=seed)

    def faults_for_cycle(self, cycle: int,
                         alive_ranks: List[int]) -> CycleFaults:
        """The fault bundle for the ``cycle``-th step (1-based), scoped
        to the ranks currently alive."""
        out = CycleFaults()
        alive = set(alive_ranks)
        for rule in self.rules:
            if not rule.fires_at(cycle):
                continue
            targets = (sorted(alive) if rule.rank is None
                       else [rule.rank] if rule.rank in alive else [])
            if rule.action in ("kill", "exit"):
                out.kills.update(targets)
            elif rule.action == "group_kill":
                out.kills.update(r for r in rule.ranks if r in alive)
            elif rule.action == "leave":
                out.leaves.update(targets)
            elif rule.action == "join":
                out.joins += len(targets) if rule.rank is None else 1
            elif rule.action == "delay":
                for rank in targets:
                    seconds = rule.seconds
                    if rule.jitter:
                        seconds *= 1.0 + rule.jitter * self._rng.uniform(
                            -1, 1)
                    out.delays[rank] = max(out.delays.get(rank, 0.0),
                                           seconds)
        return out


def expected_diagnoses(rules: List[FaultRule],
                       cycles: int) -> Dict[str, object]:
    """What the doctor must name after running ``rules`` for ``cycles``
    steps — derived from the plan alone, so the scenario runner cannot
    accidentally weaken its own assertions.

    * ``straggler_ranks``: ranks whose injected tick delay meets the
      live persistent-straggler rule's floors (>= 10 ms lateness over
      >= 20 observed cycles).
    * ``churn``: whether enough membership events fire for the
      membership_churn rule (>= 3 transitions).
    * ``most_departed``: the rank that departs most often, which the
      churn rule's hint must name (ties break low, like the rule).
    """
    from ..doctor.rules import (
        MEMBERSHIP_CHURN_MIN,
        STRAGGLER_MIN_LATENESS,
        STRAGGLER_MIN_SAMPLES,
    )

    delay_cycles: Dict[int, int] = {}
    departures: Dict[int, int] = {}
    transitions = 0
    wildcard_departures = False
    for cycle in range(1, cycles + 1):
        departed_this: set = set()
        wildcard_this = False
        joined_this = 0
        for rule in rules:
            if not rule.fires_at(cycle):
                continue
            if rule.action in ("kill", "exit", "leave"):
                if rule.rank is not None:
                    departed_this.add(rule.rank)
                else:
                    # rank=None departs EVERY alive rank (the driver's
                    # semantics): victims can't be named from the plan
                    # alone, but the churn they cause can be counted.
                    wildcard_this = True
                    wildcard_departures = True
            elif rule.action == "group_kill":
                departed_this.update(rule.ranks)
            elif rule.action == "join":
                joined_this += 1
            elif (rule.action == "delay" and rule.rank is not None
                  and rule.seconds >= STRAGGLER_MIN_LATENESS):
                delay_cycles[rule.rank] = delay_cycles.get(rule.rank, 0) + 1
        for rank in sorted(departed_this):
            departures[rank] = departures.get(rank, 0) + 1
        # One reshape absorbs a whole cycle's departures (and another
        # one its joins): transitions count reform events, not victims —
        # the same arithmetic hvd_membership_transitions_total records.
        if departed_this or wildcard_this:
            transitions += 1
        if joined_this:
            transitions += 1
    straggler = [rank for rank in sorted(delay_cycles)
                 if delay_cycles[rank] >= STRAGGLER_MIN_SAMPLES]
    # With wildcard departures in play the per-rank tally is incomplete,
    # so no single rank can honestly be promised as "most departed".
    most_departed: Optional[int] = None
    if departures and not wildcard_departures:
        most_departed = max(sorted(departures),
                            key=lambda r: departures[r])
    return {
        "straggler_ranks": straggler,
        "churn": transitions >= MEMBERSHIP_CHURN_MIN,
        "most_departed": most_departed,
        "departures": dict(sorted(departures.items())),
    }
