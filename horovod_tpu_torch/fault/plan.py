"""Seeded, deterministic fault injection for the control plane — the
port's copy of ``horovod_tpu/fault/plan.py``, rule for rule.

Elastic/fault-tolerant behavior is only trustworthy if every failure mode
is reproducible in CPU-only tests: "kill rank 1 at cycle 20", "drop the
next tick frame", "wedge backend init twice" must mean the same thing on
every run. A :class:`FaultPlan` is a list of rules loaded once per process
from ``HOROVOD_FAULT_PLAN`` (inline JSON, or ``@/path/to/plan.json``);
hooks in ``Wire.send/recv`` (sites ``wire_send``/``wire_recv``), the
controller cycle loop (``cycle``), and backend/distributed init (``init``)
consult it. All counting is per-site and deterministic; the only use of
randomness is optional delay jitter, drawn from a ``random.Random(seed)``
so two runs with the same plan sleep the same amounts.

Rule fields (JSON object per rule):

    site     "wire_send" | "wire_recv" | "cycle" | "init" (the card's
             acquisition in ``hvd.init``) | "init_distributed" (the
             ``torch.distributed`` process group's join) —
             the two init paths count separately so a plan's "at"/"times"
             don't shift with the launch mode — | "ckpt_save" (inside the
             async hvd-ckpt-writer thread, before the shard's atomic
             rename swing: kill/exit/delay tear the write exactly where
             a preempted rank would; "raise" exercises the writer's
             never-fail-the-job error path)
    action   "kill"  — SIGKILL this process (a real crash, no cleanup)
             "exit"  — os._exit(1) (a crash that still reports non-zero)
             "delay" — sleep ``seconds`` (± ``jitter`` fraction, seeded)
             "drop"  — wire_send only: silently skip sending the frame
             "raise" — raise FaultInjected(``message``)
             "wedge" — init only: raise InitWedged for the first ``times``
                       attempts, succeed afterwards
             "leave" — cycle only: gracefully retire this worker
                       (os._exit(0) — a clean departure, the membership-
                       churn half of elastic chaos; the coordinator sees
                       the closed wire and re-forms without it)
             "join"  — cycle only: spawn a CLONE of this process (same
                       argv/cwd) as an elastic joiner — the clone gets
                       HOROVOD_ELASTIC_JOIN=1 and a scrubbed fault plan
                       (it must not replay this rule, or a join storm
                       becomes a fork bomb) and is admitted at the next
                       membership epoch boundary
             "group_kill" — cycle only: SIGKILL every process whose
                       rank is in ``ranks`` at the SAME cycle count — a
                       correlated failure (a whole rack / power domain),
                       not N independent ones. The lockstep protocol
                       keeps cycle counts aligned across ranks, so the
                       deaths land together
    at       fire on the at-th event at this site (1-based); "wedge"
             ignores it (always the first ``times`` attempts)
    times    how many consecutive events fire (default 1)
    rank     only apply in the process with this HOROVOD_RANK (default all)
    ranks    "group_kill" only: the ranks that die together (required)
    seconds  delay duration (action "delay")
    jitter   ± fraction of ``seconds`` (seeded; default 0 = deterministic)
    message  error text for action "raise"

The hot path (``fault.hook(site)``) is a no-op returning ``None`` when no
plan is configured — one module-global read and a ``None`` check — so the
wire fast path pays nothing in production.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import time
from typing import Dict, List, Optional

from ..analysis.lockorder import make_lock

VALID_SITES = ("wire_send", "wire_recv", "cycle", "init",
               "init_distributed", "ckpt_save")
_INIT_SITES = ("init", "init_distributed")
VALID_ACTIONS = ("kill", "exit", "delay", "drop", "raise", "wedge",
                 "join", "leave", "group_kill")
# Membership-churn actions fire at controller-cycle granularity only: a
# join/leave mid-frame would tear a wire stream rather than exercise the
# elastic reshape path it exists to test.
_MEMBERSHIP_ACTIONS = ("join", "leave", "group_kill")


def _graceful_leave() -> None:
    """Action "leave": retire this worker cleanly (exit code 0 — the
    launcher must NOT respawn it, and chaos harnesses asserting on exit
    codes see an intentional departure). Module-level so tests can stub
    it."""
    os._exit(0)


def _spawn_joiner() -> None:
    """Action "join": fork-and-exec a clone of this process as an elastic
    joiner. Detached — the plan only guarantees a joiner ARRIVES; its
    admission is the coordinator's job. Module-level so tests can stub."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["HOROVOD_ELASTIC_JOIN"] = "1"
    env.pop("HOROVOD_FAULT_PLAN", None)  # clones must not replay the plan
    subprocess.Popen([sys.executable] + sys.argv, env=env,
                     start_new_session=True)


class FaultInjected(RuntimeError):
    """Raised by an action "raise" rule (and the base of InitWedged)."""


class InitWedged(FaultInjected):
    """Injected init failure (action "wedge"): the shape of a device
    backend that errors K times before coming healthy — retried by
    ``common/retry.py``."""


@dataclasses.dataclass
class FaultRule:
    site: str
    action: str
    at: Optional[int] = None
    times: int = 1
    rank: Optional[int] = None
    ranks: Optional[List[int]] = None  # "group_kill": correlated victims
    seconds: float = 0.0
    jitter: float = 0.0
    message: str = ""

    def __post_init__(self):
        if self.site not in VALID_SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(valid: {VALID_SITES})")
        if self.action not in VALID_ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(valid: {VALID_ACTIONS})")
        if self.action == "wedge" and self.site not in _INIT_SITES:
            raise ValueError('action "wedge" only applies to the init '
                             f'sites {_INIT_SITES}')
        if self.action == "drop" and self.site != "wire_send":
            raise ValueError('action "drop" only applies to site '
                             '"wire_send"')
        if self.action in _MEMBERSHIP_ACTIONS and self.site != "cycle":
            raise ValueError(
                f'action "{self.action}" only applies to site "cycle" '
                "(membership churn is an epoch-boundary event)")
        if self.action == "group_kill":
            if not self.ranks:
                # Without victims the rule is a silent no-op — a chaos
                # run that tests nothing. Fail at load, like the "at"
                # check below.
                raise ValueError(
                    'action "group_kill" needs "ranks" (the list of '
                    "ranks that die together)")
            self.ranks = sorted(int(r) for r in self.ranks)
        elif self.ranks is not None:
            raise ValueError(
                f'"ranks" only applies to action "group_kill" '
                f'(got action {self.action!r}); use "rank" to scope a '
                "single-process rule")
        if self.action != "wedge" and self.at is None:
            # Without "at" the rule would never fire — a chaos run that
            # silently tests nothing. Fail at load, not at runtime.
            raise ValueError(
                f'rule {self.site}/{self.action} needs "at" (the 1-based '
                'event number to fire on); only "wedge" may omit it')

    def fires_at(self, count: int) -> bool:
        """Whether this rule fires on the ``count``-th event (1-based)."""
        if self.action == "wedge":
            return count <= self.times
        if self.at is None:
            return False
        return self.at <= count < self.at + self.times


class FaultPlan:
    """The rules that apply to THIS process, with per-site event counters."""

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 rank: Optional[int] = None):
        self.seed = seed
        self.rank = rank
        # group_kill scopes by membership in its victim list — a rule
        # with ranks=[4,5,6,7] must load in exactly those processes (all
        # of which then die at the same lockstep cycle count); every
        # other action keeps the single-rank / all-ranks scoping. That
        # scoping NEEDS a rank identity: with HOROVOD_RANK unset or
        # unparseable the victim test would silently drop every
        # group_kill rule — a chaos run that tests nothing, the exact
        # failure mode this module fails loudly on.
        if rank is None and any(r.ranks is not None for r in rules):
            raise ValueError(
                "a group_kill rule needs this process's rank to scope "
                "its victim list, but HOROVOD_RANK is unset/unparseable")
        self.rules = [r for r in rules
                      if (rank in r.ranks if r.ranks is not None
                          else r.rank is None or r.rank == rank)]
        self._counts: Dict[str, int] = {}
        self._rng = random.Random(seed)
        # Port-only tracked lock: the static lock graph finds it held
        # across metrics.registry (the injected-fault counter).
        self._lock = make_lock("fault.plan")

    @classmethod
    def from_json(cls, text: str,
                  rank: Optional[int] = None) -> "FaultPlan":
        spec = json.loads(text)
        if isinstance(spec, list):  # bare rule list shorthand
            spec = {"faults": spec}
        rules = [FaultRule(**entry) for entry in spec.get("faults", [])]
        return cls(rules, seed=int(spec.get("seed", 0)), rank=rank)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        from ..common.config import env_rank, fault_plan_raw

        raw = fault_plan_raw()
        if raw is None:
            return None
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        return cls.from_json(raw, rank=env_rank())

    def count(self, site: str) -> int:
        """Events seen so far at ``site`` (for tests/introspection)."""
        with self._lock:
            return self._counts.get(site, 0)

    def fire(self, site: str) -> Optional[str]:
        """Record one event at ``site`` and execute any matching rule.

        Returns ``"drop"`` when the caller must skip the operation;
        executes delay/kill/exit inline; raises for "raise"/"wedge".
        """
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
            fired = [r for r in self.rules
                     if r.site == site and r.fires_at(count)]
            delays = [r.seconds * (1.0 + r.jitter * self._rng.uniform(-1, 1)
                                   if r.jitter else 1.0)
                      for r in fired if r.action == "delay"]
        result: Optional[str] = None
        for delay in delays:  # sleep outside the lock
            if delay > 0:
                time.sleep(delay)
        for rule in fired:
            if rule.action in ("kill", "group_kill"):
                # group_kill reaches here only in processes whose rank is
                # in the victim list (the constructor filter): each dies
                # at the same cycle count — the correlated failure.
                os.kill(os.getpid(), signal.SIGKILL)
            elif rule.action == "exit":
                os._exit(1)
            elif rule.action == "leave":
                _graceful_leave()
            elif rule.action == "join":
                _spawn_joiner()
            elif rule.action == "drop":
                result = "drop"
            elif rule.action == "wedge":
                raise InitWedged(
                    rule.message
                    or f"fault injection: init wedged (attempt {count} of "
                       f"{rule.times} injected failures)")
            elif rule.action == "raise":
                raise FaultInjected(
                    rule.message
                    or f"fault injection: raise at {site} event {count}")
        return result
