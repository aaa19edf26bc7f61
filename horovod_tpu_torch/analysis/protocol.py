"""Machine-readable wire/epoch protocol: one declarative spec, two
checkers — the port's copy of ``horovod_tpu/analysis/protocol.py``.

The control plane's authenticated DATA/HEARTBEAT/ABORT frames, the
elastic JOIN/RESHAPE frames with membership epochs, ack drains and the
reshape fence, and the p2p shard frames are one protocol. The port's
wire (``common/wire.py``) frames it byte for byte like the JAX package's,
so :data:`SPEC` here equals the JAX ``SPEC`` as data (a test holds the
two together); a behaviour of the port that the spec does not allow is a
fault of the port, never a reason to widen the spec.

* :data:`SPEC` — ONE declarative structure (plain dicts/strings, no
  code) describing, per wire-peer role (``coordinator`` side of a worker
  connection, ``worker`` client side, parked ``joiner``), which frame
  kinds are legal in which state, in which direction, with which epoch
  guard, and what state each one leads to.
* **Static conformance** — :func:`check_handlers` parses the port's own
  ``common/wire.py``, ``controller/service.py``,
  ``controller/controller.py``, ``controller/native.py`` (the star the
  native engine opens when traced) and ``elastic/shards.py`` and proves
  every frame-kind dispatch branch maps to a spec entry and every spec
  entry has a handler branch. Surfaced as hvdlint rule HVD008 and
  ``python -m horovod_tpu_torch.tools.protocheck`` (exit 1 on drift).
* **Runtime conformance** — :class:`ProtocolMonitor`, an opt-in
  (``HOROVOD_PROTOCHECK=1``) per-wire monitor fed by ``Wire`` send/recv.
  Every frame is checked against the spec transition for the wire's role
  and current state; an off-spec transition is recorded (and the whole
  table dumped to ``protocheck.json`` at exit, with the flight
  recorder's ``{rank}``/``.rankN`` path expansion) or raised immediately
  under ``HOROVOD_PROTOCHECK=raise``.

Epoch discipline: membership epochs are compared ONLY through
:func:`epoch_advances` / :func:`epoch_is_stale` — the sanctioned
monotonic helpers (hvdlint HVD009 flags raw ``<``/``>`` on epochs in
protocol-surface code).

Stdlib-only by contract: ``common/wire.py`` imports this at module load
(same constraint as :mod:`.lockorder`).
"""

from __future__ import annotations

import ast
import atexit
import json
import os
import sys
import threading
from typing import Dict, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Epoch helpers — THE sanctioned monotonic comparisons (hvdlint HVD009).


def epoch_advances(new: int, current: int) -> bool:
    """True when ``new`` is a legal successor epoch: membership epochs
    only ever move forward, so any reshape/assignment carrying
    ``new <= current`` is protocol drift, not a rewind."""
    return new > current  # hvdlint: disable=HVD009 (the sanctioned helper)


def epoch_is_stale(seen: int, current: int) -> bool:
    """True when ``seen`` belongs to a superseded epoch (an ack from a
    reshape attempt that failed mid-handshake and was retried at a
    fresh epoch). Stale acks are drained, never errors."""
    return seen < current  # hvdlint: disable=HVD009 (the sanctioned helper)


# ---------------------------------------------------------------------------
# The spec. Data, not code: dict literals all the way down, consumed by
# the static checker (check_handlers), the runtime monitor
# (ProtocolMonitor), the docs renderer (render_state_tables), and
# hvdlint HVD008.
#
# Keys: SPEC[role]["states"][state][(direction, kind)] -> transition dict:
#   {"next": <state>}                  legal; move to <state>
#   {"next": <state>, "guard": <name>} legal iff the named guard holds
#   {"violation": <why>}               a branch the handlers must HAVE,
#                                      whose firing is itself the finding
#                                      (e.g. JOIN in the data stream)
# Guards (interpreted by the monitor, documented for the port):
#   epoch_advances   the frame's epoch must be > the wire's committed one
#   ack_commits      JOIN ack epoch == the pending reshape epoch (commit)
#                    or stale (< pending: superseded attempt, stay put);
#                    an ack from the future is a violation
#   ack_matches      worker's outbound ack must equal the assignment epoch

KINDS = ("data", "heartbeat", "abort", "join", "reshape", "shard_fetch",
         "shard_data")

# Heartbeats are liveness riding a background thread; they are legal in
# every state, both directions, and never change state. Spelling that
# out per state would bury the interesting transitions, so the monitor
# and checker treat heartbeat as implicitly self-looping everywhere;
# the constant records the decision as data.
HEARTBEAT_ALWAYS_LEGAL = True

SPEC = {
    "coordinator": {
        # Rank 0's side of ONE worker/joiner connection (the service holds
        # an independent machine per wire).
        "initial": "handshake",
        "states": {
            "handshake": {
                ("recv", "data"): {"next": "steady",
                                   "note": "rendezvous hello"},
                ("recv", "join"): {"next": "parked",
                                   "note": "elastic join hello"},
                ("recv", "abort"): {"violation":
                                    "abort frame during a hello"},
                ("recv", "reshape"): {"violation":
                                      "reshape frame during a hello"},
                ("recv", "shard_fetch"): {"violation":
                                          "shard frame during a hello"},
                ("recv", "shard_data"): {"violation":
                                         "shard frame during a hello"},
            },
            "steady": {
                ("recv", "data"): {"next": "steady",
                                   "note": "tick / tensor payload"},
                ("recv", "abort"): {"violation":
                                    "workers never originate aborts"},
                ("recv", "reshape"): {"violation":
                                      "workers never originate reshapes"},
                ("recv", "join"): {"violation":
                                   "join frame in the data stream"},
                ("recv", "shard_fetch"): {"next": "steady",
                                          "note": "shard request to relay "
                                                  "(or serve, owner 0)"},
                ("recv", "shard_data"): {"next": "steady",
                                         "note": "shard reply to relay "
                                                 "(or consume, req 0)"},
                ("send", "data"): {"next": "steady",
                                   "note": "cycle reply / tensor payload"},
                ("send", "abort"): {"next": "dead",
                                    "note": "coordinated abort broadcast"},
                ("send", "reshape"): {"next": "draining",
                                      "guard": "epoch_advances",
                                      "note": "membership assignment"},
                ("send", "join"): {"violation":
                                   "the coordinator never sends join "
                                   "frames"},
                ("send", "shard_fetch"): {"next": "steady",
                                          "note": "relayed shard request "
                                                  "(rank 0 requester or "
                                                  "star hop)"},
                ("send", "shard_data"): {"next": "steady",
                                         "note": "relayed or locally "
                                                 "served shard reply"},
            },
            "parked": {
                # A validated joiner waiting for an epoch boundary. Only
                # heartbeats flow until the admission RESHAPE.
                ("send", "reshape"): {"next": "draining",
                                      "guard": "epoch_advances",
                                      "note": "admission assignment"},
                ("send", "abort"): {"next": "dead",
                                    "note": "job failed while parked"},
                ("recv", "data"): {"violation":
                                   "parked joiner sent data"},
                ("recv", "join"): {"violation":
                                   "parked joiner re-sent its hello"},
                ("recv", "abort"): {"violation":
                                    "workers never originate aborts"},
                ("recv", "reshape"): {"violation":
                                      "workers never originate reshapes"},
                ("recv", "shard_fetch"): {"violation":
                                          "parked joiner has no shard "
                                          "plane until admission"},
                ("recv", "shard_data"): {"violation":
                                         "parked joiner has no shard "
                                         "plane until admission"},
                ("send", "shard_fetch"): {"violation":
                                          "no shard relay to a parked "
                                          "joiner"},
                ("send", "shard_data"): {"violation":
                                         "no shard relay to a parked "
                                         "joiner"},
            },
            "draining": {
                # After send(reshape): drain the member's wire to its ack.
                ("recv", "data"): {"next": "draining",
                                   "note": "dead-epoch traffic, discarded"},
                ("recv", "join"): {"next": "steady", "guard": "ack_commits",
                                   "note": "reshape ack (stale acks stay "
                                           "draining)"},
                ("recv", "abort"): {"next": "dead",
                                    "note": "defensive: recv_reshape_ack "
                                            "surfaces a remote abort"},
                ("recv", "reshape"): {"violation":
                                      "workers never originate reshapes"},
                ("recv", "shard_fetch"): {"next": "draining",
                                          "note": "dead-epoch shard "
                                                  "traffic, discarded"},
                ("recv", "shard_data"): {"next": "draining",
                                         "note": "dead-epoch shard "
                                                 "traffic, discarded"},
                ("send", "reshape"): {"next": "draining",
                                      "guard": "epoch_advances",
                                      "note": "retry at a fresh epoch after "
                                              "a member failed mid-"
                                              "handshake"},
                ("send", "abort"): {"next": "dead",
                                    "note": "job failed mid-reshape"},
                ("send", "shard_fetch"): {"next": "draining",
                                          "note": "defensive: a relay "
                                                  "racing the reshape; "
                                                  "the member's torn "
                                                  "restore ignores it"},
                ("send", "shard_data"): {"next": "draining",
                                         "note": "defensive: a relayed "
                                                 "reply racing the "
                                                 "reshape"},
            },
            "dead": {
                # Terminal: the job is failing; only stray heartbeats may
                # still cross before the close.
            },
        },
    },
    "worker": {
        # A non-zero rank's client side: one persistent wire.
        "initial": "init",
        "states": {
            "init": {
                ("send", "data"): {"next": "steady",
                                   "note": "rendezvous hello"},
            },
            "steady": {
                ("send", "data"): {"next": "steady",
                                   "note": "tick / tensor payload"},
                ("recv", "data"): {"next": "steady",
                                   "note": "cycle reply / tensor payload"},
                ("recv", "abort"): {"next": "dead",
                                    "note": "coordinated abort"},
                ("recv", "reshape"): {"next": "reshaping",
                                      "guard": "epoch_advances",
                                      "note": "membership changed"},
                ("recv", "join"): {"violation":
                                   "join frame in the data stream"},
                ("recv", "shard_fetch"): {"next": "steady",
                                          "note": "relayed shard request "
                                                  "(this rank owns a "
                                                  "matching copy)"},
                ("recv", "shard_data"): {"next": "steady",
                                         "note": "shard reply for this "
                                                 "rank's restore"},
                ("send", "abort"): {"violation":
                                    "workers never originate aborts"},
                ("send", "reshape"): {"violation":
                                      "workers never originate reshapes"},
                ("send", "join"): {"violation":
                                   "reshape ack without a reshape"},
                ("send", "shard_fetch"): {"next": "steady",
                                          "note": "shard request toward "
                                                  "the coordinator star"},
                ("send", "shard_data"): {"next": "steady",
                                         "note": "served shard reply "
                                                 "(this rank is the "
                                                 "owner)"},
            },
            "reshaping": {
                # Between the RESHAPE tearing out of a recv and this
                # side's acknowledgement: the epoch drain runs locally,
                # nothing but the ack may go out.
                ("send", "join"): {"next": "steady", "guard": "ack_matches",
                                   "note": "reshape acknowledgement"},
                ("send", "data"): {"violation":
                                   "data before the reshape was acked"},
                # The restore thread may race the RESHAPE by a frame: a
                # fetch (or a served reply) already leaving when the
                # assignment lands is LATE traffic the coordinator's
                # drain discards — legal, unlike data, which would
                # desync the negotiated stream.
                ("send", "shard_fetch"): {"next": "reshaping",
                                          "note": "late fetch from a "
                                                  "restore the reshape "
                                                  "is tearing; the "
                                                  "drain discards it"},
                ("send", "shard_data"): {"next": "reshaping",
                                         "note": "late served reply; "
                                                 "the drain discards "
                                                 "it"},
                ("recv", "abort"): {"next": "dead",
                                    "note": "job failed mid-reshape"},
                ("recv", "reshape"): {"next": "reshaping",
                                      "guard": "epoch_advances",
                                      "note": "superseded by a fresher "
                                              "reshape"},
            },
            "dead": {},
        },
    },
    "joiner": {
        # A late worker dialing a live elastic job; becomes an ordinary
        # worker the moment its admission commits.
        "initial": "init",
        "states": {
            "init": {
                ("send", "join"): {"next": "parked",
                                   "note": "join hello"},
            },
            "parked": {
                ("recv", "reshape"): {"next": "reshaping",
                                      "guard": "epoch_advances",
                                      "note": "admission assignment"},
                ("recv", "abort"): {"next": "dead",
                                    "note": "job failed while parked"},
                ("recv", "data"): {"violation":
                                   "coordinator is not elastic (data "
                                   "instead of an assignment)"},
                ("recv", "join"): {"violation":
                                   "join frame echoed back"},
                ("recv", "shard_fetch"): {"violation":
                                          "parked joiner has no shard "
                                          "plane until admission"},
                ("recv", "shard_data"): {"violation":
                                         "parked joiner has no shard "
                                         "plane until admission"},
                ("send", "data"): {"violation":
                                   "parked joiner sent data"},
                ("send", "shard_fetch"): {"violation":
                                          "parked joiner sent shard "
                                          "traffic"},
                ("send", "shard_data"): {"violation":
                                         "parked joiner sent shard "
                                         "traffic"},
            },
            # Admitted: from here on the wire behaves exactly like a
            # worker's (same transitions, stated once via the post-build
            # aliases below so the two roles cannot drift apart).
            "reshaping": {},
            "steady": {},
            "dead": {},
        },
    },
}

# An admitted joiner IS a worker: alias the steady/reshaping row sets
# after admission. The aliases are part of the declarative structure
# (shared references, established once here, data either way).
SPEC["joiner"]["states"]["steady"] = SPEC["worker"]["states"]["steady"]
SPEC["joiner"]["states"]["reshaping"] = SPEC["worker"]["states"]["reshaping"]

ROLES = tuple(sorted(SPEC))

# Which membership epoch a fresh wire is at, per role. Workers/coordinator
# wires exist from rendezvous (epoch 1); a joiner has no epoch until its
# admission assignment commits one.
INITIAL_EPOCH = {"coordinator": 1, "worker": 1, "joiner": 0}

# Documented invariants the monitor cannot see at the wire layer (they
# live above it), recorded here so the spec is the one contract document:
INVARIANTS = (
    {"name": "ack_before_commit",
     "where": "controller/service.py::CoordinatorService.reform",
     "statement": "a membership epoch is committed (wires dict swapped) "
                  "only after EVERY member acked exactly that epoch; a "
                  "member failing mid-handshake restarts the whole "
                  "handshake at a fresh epoch"},
    {"name": "fence_before_enqueue",
     "where": "controller/controller.py::Controller._enqueue + "
              "_drain_epoch",
     "statement": "between a reshape's epoch drain and the user-level "
                  "acknowledgement (hvd.elastic.run clearing the fence), "
                  "every new enqueue fails with the same retryable "
                  "RanksChangedError its drained siblings got — a lone "
                  "post-drain enqueue would negotiate a tensor no peer "
                  "knows and hang the new epoch"},
    {"name": "epoch_monotonicity",
     "where": "analysis/protocol.py::epoch_advances / epoch_is_stale",
     "statement": "membership epochs only move forward; stale acks are "
                  "drained, assignments must advance the epoch"},
)


# ---------------------------------------------------------------------------
# Spec self-checks (consumed by tools/protocheck and tests).


def check_spec() -> List[str]:
    """Internal consistency of :data:`SPEC`: every role covers every
    frame kind in both directions (transition or declared violation —
    the bijection's spec half), next-states exist, guards are known,
    and every non-terminal state is reachable. Returns problem strings
    (empty == consistent)."""
    problems: List[str] = []
    known_guards = {"epoch_advances", "ack_commits", "ack_matches"}
    for role in ROLES:
        states = SPEC[role]["states"]
        initial = SPEC[role]["initial"]
        if initial not in states:
            problems.append(f"{role}: initial state {initial!r} undefined")
        reachable = {initial}
        frontier = [initial]
        while frontier:
            state = frontier.pop()
            for key in sorted(states.get(state, {})):
                entry = states[state][key]
                nxt = entry.get("next")
                if nxt is not None and nxt not in reachable:
                    reachable.add(nxt)
                    frontier.append(nxt)
        covered: Dict[Tuple[str, str], bool] = {}
        for state in sorted(states):
            if state not in reachable and states[state]:
                problems.append(f"{role}: state {state!r} unreachable")
            for (direction, kind), entry in sorted(states[state].items()):
                if kind not in KINDS:
                    problems.append(
                        f"{role}.{state}: unknown kind {kind!r}")
                if direction not in ("send", "recv"):
                    problems.append(
                        f"{role}.{state}: unknown direction {direction!r}")
                if "next" in entry and entry["next"] not in states:
                    problems.append(
                        f"{role}.{state}: next state {entry['next']!r} "
                        "undefined")
                if "next" not in entry and "violation" not in entry:
                    problems.append(
                        f"{role}.{state}.{direction}.{kind}: entry is "
                        "neither a transition nor a declared violation")
                guard = entry.get("guard")
                if guard is not None and guard not in known_guards:
                    problems.append(
                        f"{role}.{state}: unknown guard {guard!r}")
                covered[(direction, kind)] = True
        for direction in ("send", "recv"):
            for kind in KINDS:
                if kind == "heartbeat":
                    continue  # implicitly legal everywhere (see above)
                if not covered.get((direction, kind)):
                    problems.append(
                        f"{role}: kind {kind!r} ({direction}) appears in "
                        "no state — the spec does not cover it")
    return problems


# ---------------------------------------------------------------------------
# Runtime monitor.

ENV_KNOB = "HOROVOD_PROTOCHECK"
ENV_OUTPUT = "HOROVOD_PROTOCHECK_OUTPUT"
DEFAULT_OUTPUT = "protocheck.json"

_mode: Optional[str] = None


def _invalidate_in_child() -> None:
    global _mode
    _mode = None


os.register_at_fork(after_in_child=_invalidate_in_child)


def _protocheck_mode() -> str:
    """"" (off), "record", or "raise". Cached like lockcheck_enabled;
    read directly (not via common/config.py) because wire.py loads this
    module before the package and it must stay import-cycle-free."""
    global _mode
    if _mode is None:
        # hvdlint: disable=HVD003 (pre-package module, see docstring)
        val = (os.environ.get(ENV_KNOB) or "").strip().lower()
        if val in ("", "0", "false", "no", "off"):
            _mode = ""
        elif val == "raise":
            _mode = "raise"
        else:
            _mode = "record"
    return _mode


def protocheck_enabled() -> bool:
    return bool(_protocheck_mode())


def refresh_mode() -> None:
    """Drop the cached HOROVOD_PROTOCHECK mode so the next check re-reads
    the environment. Real ranks only ever set the knob before launch (the
    cache is correct for them); an in-process harness that toggles it
    around a cluster's lifetime must re-resolve on both edges."""
    global _mode
    _mode = None


class ProtocolViolationError(RuntimeError):
    """An off-spec wire transition under ``HOROVOD_PROTOCHECK=raise``."""


class _Recorder:
    """Process-global violation/transition tally shared by every wire's
    monitor; dumped to ``protocheck.json`` at exit (and on demand)."""

    def __init__(self):
        self._mu = threading.Lock()
        self.transitions = 0
        self.violations: List[dict] = []

    def note_ok(self) -> None:
        with self._mu:
            self.transitions += 1

    def note_violation(self, entry: dict) -> None:
        with self._mu:
            self.transitions += 1
            if len(self.violations) < 1000:  # bounded artifact
                self.violations.append(entry)
        sys.stderr.write(
            "protocheck: OFF-SPEC wire transition: "
            f"{entry['role']}.{entry['state']} {entry['direction']} "
            f"{entry['kind']}: {entry['detail']}\n")

    def report(self) -> dict:
        with self._mu:
            return {
                "enabled": protocheck_enabled(),
                "transitions": self.transitions,
                "violations": list(self.violations),
                "ok": not self.violations,
            }

    def clear(self) -> None:
        with self._mu:
            self.transitions = 0
            self.violations.clear()


_recorder = _Recorder()


def recorder() -> _Recorder:
    return _recorder


def output_path() -> str:
    """Artifact path with the flight recorder's ``{rank}``/``.rankN``
    expansion so ranks never clobber each other."""
    # hvdlint: disable=HVD003 (pre-package module, import-cycle-free)
    path = (os.environ.get(ENV_OUTPUT) or "").strip() or DEFAULT_OUTPUT
    rank = (os.environ.get("HOROVOD_RANK") or "").strip() or None  # hvdlint: disable=HVD003
    if "{rank}" in path:
        return path.replace("{rank}", rank if rank is not None else "0")
    if rank is not None:
        return f"{path}.rank{rank}"
    return path


def write_report(path: Optional[str] = None) -> Optional[str]:
    """Dump the conformance tally. Returns the path, or None when the
    monitor is off or the dump fails (never raises — the monitor must
    not fail the job it observes)."""
    if not protocheck_enabled():
        return None
    out = path or output_path()
    try:
        tmp = f"{out}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(_recorder.report(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, out)
    except OSError as exc:
        sys.stderr.write(f"protocheck: cannot write report: {exc}\n")
        return None
    return out


def _atexit_dump() -> None:
    if protocheck_enabled():
        write_report()


atexit.register(_atexit_dump)


class ProtocolMonitor:
    """One wire's conformance state machine: role, current state, and
    committed/pending membership epochs, advanced by every frame the
    wire sends or receives. Thread-safe (the heartbeat thread sends on
    the same wire the controller thread receives on)."""

    __slots__ = ("role", "state", "epoch", "pending_epoch", "_mu", "_rec")

    def __init__(self, role: str, recorder_: Optional[_Recorder] = None):
        if role not in SPEC:
            raise ValueError(f"unknown protocol role {role!r}")
        self.role = role
        self.state = SPEC[role]["initial"]
        self.epoch = INITIAL_EPOCH[role]
        # The epoch of the reshape currently in flight on this wire
        # (coordinator: sent, awaiting ack; worker/joiner: received,
        # awaiting our ack).
        self.pending_epoch: Optional[int] = None
        self._mu = threading.Lock()
        self._rec = recorder_ if recorder_ is not None else _recorder

    # -- guard evaluation ---------------------------------------------------

    def _guard_holds(self, guard: str, info: Optional[dict]
                     ) -> Tuple[bool, str]:
        if guard == "epoch_advances":
            new = (info or {}).get("epoch")
            if not isinstance(new, int):
                return False, f"reshape without an integer epoch: {info!r}"
            if not epoch_advances(new, self.epoch):
                return False, (f"epoch must advance: got {new}, committed "
                               f"epoch is {self.epoch}")
            return True, ""
        if guard == "ack_commits":
            ack = (info or {}).get("ack")
            if not isinstance(ack, int):
                # A join payload with no ack in the drain is a join hello
                # where an ack belongs.
                return False, f"expected a reshape ack, got {info!r}"
            pending = self.pending_epoch
            if pending is not None and ack == pending:
                return True, ""
            if pending is not None and epoch_is_stale(ack, pending):
                return True, ""  # superseded attempt's ack: drained
            return False, (f"ack for epoch {ack} but the pending reshape "
                           f"is epoch {pending}")
        if guard == "ack_matches":
            ack = (info or {}).get("ack")
            if not isinstance(ack, int):
                return False, f"expected a reshape ack, got {info!r}"
            if ack != self.pending_epoch:
                return False, (f"acked epoch {ack} but the assignment was "
                               f"epoch {self.pending_epoch}")
            return True, ""
        return False, f"unknown guard {guard!r}"

    def _commit(self, key: Tuple[str, str], entry: dict,
                info: Optional[dict]) -> None:
        """Apply the transition's epoch effects (mutates under _mu)."""
        direction, kind = key
        if kind == "reshape":
            self.pending_epoch = (info or {}).get("epoch")
        elif kind == "join" and entry.get("guard") in ("ack_commits",
                                                       "ack_matches"):
            ack = (info or {}).get("ack")
            if isinstance(ack, int) and ack == self.pending_epoch:
                self.epoch = ack
                self.pending_epoch = None
        self.state = entry["next"]

    # -- the one entry point ------------------------------------------------

    def observe(self, direction: str, kind_name: str,
                info: Optional[dict] = None) -> None:
        """Check one frame against the spec and advance the machine.
        Records (or raises, under ``HOROVOD_PROTOCHECK=raise``) on any
        off-spec transition; never blocks the wire otherwise."""
        if kind_name == "heartbeat":
            self._rec.note_ok()  # legal everywhere, state unchanged
            return
        with self._mu:
            states = SPEC[self.role]["states"]
            entry = states.get(self.state, {}).get((direction, kind_name))
            if entry is None:
                detail = (f"kind {kind_name!r} ({direction}) has no spec "
                          f"entry in state {self.state!r}")
            elif "violation" in entry:
                detail = entry["violation"]
            else:
                guard = entry.get("guard")
                if guard is not None:
                    ok, why = self._guard_holds(guard, info)
                    if not ok:
                        detail = f"guard {guard} failed: {why}"
                    else:
                        detail = None
                else:
                    detail = None
                if detail is None:
                    # ack_commits with a STALE ack stays in place (the
                    # drain keeps reading); everything else transitions.
                    if (entry.get("guard") == "ack_commits"
                            and isinstance((info or {}).get("ack"), int)
                            and (info or {})["ack"] != self.pending_epoch):
                        pass  # stale ack: drained, no state change
                    else:
                        self._commit((direction, kind_name), entry, info)
                    self._rec.note_ok()
                    return
            violation = {
                "role": self.role,
                "state": self.state,
                "direction": direction,
                "kind": kind_name,
                "epoch": self.epoch,
                "pending_epoch": self.pending_epoch,
                "detail": detail,
            }
        self._rec.note_violation(violation)
        if _protocheck_mode() == "raise":
            raise ProtocolViolationError(
                f"protocol violation: {self.role}.{violation['state']} "
                f"{direction} {kind_name}: {detail}")


def make_monitor(role: str) -> Optional[ProtocolMonitor]:
    """Factory the wire layer calls when a role is assigned: a live
    monitor under ``HOROVOD_PROTOCHECK``, None (zero cost) otherwise."""
    if not protocheck_enabled():
        return None
    return ProtocolMonitor(role)


# ---------------------------------------------------------------------------
# Static conformance: handler dispatch <-> spec bijection.
#
# HANDLERS maps each real dispatch site (file suffix + function qualname)
# to the (role, state, direction) combinations it serves. The checker
# parses the file, extracts the set of FRAME_* kinds the function
# branches on, and compares it against the union of kinds the spec
# declares (transition or violation) for those combinations:
#   * a spec kind the handler never branches on  -> "missing transition"
#   * a handler branch for a kind the spec bans  -> "unreachable transition"
# Any FRAME_* dispatch outside a declared handler is "handler drift".

HANDLERS = {
    # recv_bytes serves the lockstep data stream on both star sides and
    # the joiner's await_assignment (first real frame).
    "common/wire.py::Wire.recv_bytes": (
        ("worker", "steady", "recv"),
        ("coordinator", "steady", "recv"),
        ("joiner", "parked", "recv"),
    ),
    # recv_hello serves rendezvous + the elastic join listener.
    "common/wire.py::Wire.recv_hello": (
        ("coordinator", "handshake", "recv"),
    ),
    # recv_reshape_ack drains a member's wire to its ack.
    "common/wire.py::Wire.recv_reshape_ack": (
        ("coordinator", "draining", "recv"),
    ),
}

# FRAME_* mentions that are definitions/plumbing, not dispatch: listed so
# the drift scan can prove the handler table above is complete.
_NON_DISPATCH_ALLOWED = {
    "common/wire.py": {
        # Frame constructors (senders) and the frame-layer plumbing.
        "Wire.send_bytes", "Wire.send_heartbeat", "Wire.send_abort",
        "Wire.send_join", "Wire.send_reshape", "Wire.try_send_heartbeat",
        "Wire.send_clock_ping", "Wire._handle_clock_payload",
        "Wire.send_shard_fetch", "Wire.send_shard_data",
        "Wire._handle_shard_frame",
        "Wire._send_frame", "Wire._try_send_frame", "Wire._recv_frame",
        "<module>",  # FRAME_* constant definitions, _KNOWN_KINDS, names
    },
    "controller/service.py": {
        # The join listener compares the recv_hello RESULT kind — the
        # dispatch itself lives in recv_hello; this is admission
        # validation on top of it.
        "CoordinatorService.start_join_listener",
        "<module>",  # import
    },
    "controller/controller.py": {
        "<module>",
    },
    # Port-only surface. The native engine's data plane is the C++ ring;
    # when traced it also opens the launcher's TCP star through
    # CoordinatorService/WorkerClient (roles assigned there), and no
    # frame-kind dispatch of its own may appear here.
    "controller/native.py": {
        "<module>",
    },
    # The shard plane splits a restore into 256 MiB parts, each one
    # SHARD_FETCH/SHARD_DATA pair through Wire.send_shard_*; it never
    # branches on a frame kind itself.
    "elastic/shards.py": {
        "<module>",
    },
}

_KIND_CONST_TO_NAME = {
    "FRAME_DATA": "data", "FRAME_HEARTBEAT": "heartbeat",
    "FRAME_ABORT": "abort", "FRAME_JOIN": "join",
    "FRAME_RESHAPE": "reshape", "FRAME_SHARD_FETCH": "shard_fetch",
    "FRAME_SHARD_DATA": "shard_data",
}


def _function_index(tree: ast.AST) -> Dict[str, ast.AST]:
    """{"Class.method" / "func" / "<module>": node} for one module."""
    index: Dict[str, ast.AST] = {"<module>": tree}

    def walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}{child.name}"
                index[name] = child
                walk(child, f"{name}.")
            elif isinstance(child, ast.ClassDef):
                walk(child, f"{prefix}{child.name}.")
            else:
                walk(child, prefix)

    walk(tree, "")
    return index


def _kinds_referenced(node: ast.AST) -> "set[str]":
    """FRAME_* constant names referenced under ``node``, as kind names."""
    out = set()
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name in _KIND_CONST_TO_NAME:
            out.add(_KIND_CONST_TO_NAME[name])
    return out


def _owning_function(index: Dict[str, ast.AST], lineno: int) -> str:
    """Innermost indexed function containing ``lineno`` (else <module>)."""
    best = "<module>"
    best_span = None
    for qualname, node in index.items():
        if qualname == "<module>":
            continue
        end = getattr(node, "end_lineno", node.lineno)
        if node.lineno <= lineno <= end:
            span = end - node.lineno
            if best_span is None or span < best_span:
                best, best_span = qualname, span
    return best


def spec_kinds_for(combos) -> "set[str]":
    """Union of kinds with ANY spec entry (transition or declared
    violation) across ``(role, state, direction)`` combos — plus
    heartbeat, which is implicitly legal everywhere."""
    kinds = {"heartbeat"}
    for role, state, direction in combos:
        for (d, kind) in SPEC[role]["states"][state]:
            if d == direction:
                kinds.add(kind)
    return kinds


PROTOCOL_SURFACE = tuple(sorted({k.split("::")[0] for k in HANDLERS}
                                | set(_NON_DISPATCH_ALLOWED)))


def check_module(relsuffix: str, tree: ast.AST) -> List[dict]:
    """Handler↔spec bijection for ONE protocol-surface module (used by
    hvdlint HVD008 per file and by :func:`check_handlers` for the whole
    surface). Returns finding dicts with path/line/message."""
    findings: List[dict] = []
    index = _function_index(tree)
    declared = {k.split("::")[1]: combos
                for k, combos in HANDLERS.items()
                if k.split("::")[0] == relsuffix}
    # 1. Declared handlers: branch set == spec set.
    for qualname, combos in sorted(declared.items()):
        node = index.get(qualname)
        if node is None:
            findings.append({
                "path": relsuffix, "line": 0,
                "message": f"declared handler {qualname} no longer "
                           "exists (update protocol.HANDLERS)"})
            continue
        handled = _kinds_referenced(node)
        expected = spec_kinds_for(combos)
        for kind in sorted(expected - handled):
            findings.append({
                "path": relsuffix, "line": node.lineno,
                "message": f"handler {qualname} has no branch for "
                           f"frame kind {kind!r}, which the spec "
                           f"declares for {sorted(combos)} (missing "
                           "transition)"})
        for kind in sorted(handled - expected):
            findings.append({
                "path": relsuffix, "line": node.lineno,
                "message": f"handler {qualname} branches on frame "
                           f"kind {kind!r}, which the spec declares "
                           f"in none of {sorted(combos)} (unreachable "
                           "transition — extend the spec or delete "
                           "the branch)"})
    # 2. Drift: FRAME_* dispatch outside declared handlers/senders.
    allowed = set(declared) | _NON_DISPATCH_ALLOWED.get(relsuffix, set())
    seen_owners = set()
    for sub in ast.walk(tree):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name not in _KIND_CONST_TO_NAME:
            continue
        owner = _owning_function(index, sub.lineno)
        # Attribute the mention to the outermost declared/allowed
        # scope: nested helpers inside an allowed function inherit.
        top = owner
        while top and top not in allowed and "." in top:
            top = top.rsplit(".", 1)[0]
        if owner in allowed or top in allowed:
            continue
        if owner not in seen_owners:
            seen_owners.add(owner)
            findings.append({
                "path": relsuffix, "line": sub.lineno,
                "message": f"frame-kind dispatch in {owner} is not "
                           "declared in protocol.HANDLERS (handler "
                           "drift): map it to spec states or list it "
                           "as a non-dispatch site"})
    return findings


def check_handlers(pkg_dir: str) -> List[dict]:
    """The static half of conformance: parse the whole protocol surface
    and prove handler↔spec bijection. Returns finding dicts (empty ==
    the code and the spec agree); each carries path/line/message so
    hvdlint (HVD008) and tools/protocheck can render them."""
    findings: List[dict] = []
    for relsuffix in PROTOCOL_SURFACE:
        path = os.path.join(pkg_dir, *relsuffix.split("/"))
        try:
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError) as exc:
            findings.append({"path": relsuffix, "line": 0,
                             "message": f"cannot parse: {exc}"})
            continue
        findings.extend(check_module(relsuffix, tree))
    return findings


# ---------------------------------------------------------------------------
# Docs renderer (tools/protocheck --dump-spec).


def render_state_tables() -> str:
    lines: List[str] = []
    for role in ROLES:
        lines.append(f"### role `{role}` (initial: "
                     f"`{SPEC[role]['initial']}`, epoch "
                     f"{INITIAL_EPOCH[role]})")
        lines.append("")
        lines.append("| state | event | outcome |")
        lines.append("| --- | --- | --- |")
        states = SPEC[role]["states"]
        for state in sorted(states):
            for (direction, kind), entry in sorted(states[state].items()):
                event = f"{direction} {kind}"
                if "violation" in entry:
                    outcome = f"VIOLATION — {entry['violation']}"
                else:
                    outcome = f"→ `{entry['next']}`"
                    if entry.get("guard"):
                        outcome += f" (guard: {entry['guard']})"
                    if entry.get("note"):
                        outcome += f" — {entry['note']}"
                lines.append(f"| `{state}` | {event} | {outcome} |")
            if not states[state]:
                lines.append(f"| `{state}` | — | terminal; only "
                             "heartbeats may still cross |")
        lines.append("")
    lines.append("(heartbeats are legal in every state, both directions, "
                 "and never change state — liveness rides below the "
                 "protocol.)")
    return "\n".join(lines) + "\n"


def iter_spec_entries() -> Iterator[Tuple[str, str, str, str, dict]]:
    """(role, state, direction, kind, entry) over the whole spec."""
    for role in ROLES:
        states = SPEC[role]["states"]
        for state in sorted(states):
            for (direction, kind), entry in sorted(states[state].items()):
                yield role, state, direction, kind, entry
