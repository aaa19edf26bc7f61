"""hvdlint distributed-correctness rules (HVD001..HVD011).

Each rule encodes one invariant the runtime depends on but cannot check
until a job is already hung:

* HVD001 — a collective call lexically inside a rank-conditional branch.
  Every rank must issue the same collectives in the same order (the
  coordinator's negotiation assumes it; SURVEY §L1); a collective only
  some ranks reach deadlocks the rest. Intentional subgroup collectives
  (e.g. the hierarchical cross-ring on local roots) carry a suppression.
* HVD002 — unordered dict/set iteration in controller/negotiation paths.
  Wire payload construction and response walks must be identical on
  every rank; dict insertion order is process-local history. Wrap the
  walk in ``sorted(...)``.
* HVD003 — ``os.environ`` value reads outside ``common/config.py``.
  Config has exactly one choke point so every rank parses a knob the
  same way; a stray read invents a second, subtly different parser.
  Mutations (``os.environ[...] = v``, ``.pop``, ``.update``) and
  membership tests stay allowed — exporting env to children is the
  launcher's job.
* HVD004 — ``time.time()`` where a duration/deadline is being measured.
  Wall clocks step (NTP) and a stepped deadline fires early or never;
  ``time.monotonic()`` is the duration clock. Wall-clock *anchors*
  (trace clock-sync, event timestamps) are legitimate and carry
  suppressions.
* HVD005 — ``threading.Thread`` without explicit ``name=`` and
  ``daemon=``. An anonymous non-daemon thread is invisible in stack
  dumps and blocks interpreter exit; every spawn site must decide both.
* HVD006 — import-time side effects: metric registration, env value
  reads, or thread spawns at module top level. Importing must be free
  (the zero-overhead-off telemetry contract and fork semantics depend
  on it).
* HVD007 — metric catalog discipline: every literal metric name
  registered via ``counter()``/``gauge()``/``histogram()`` must be
  ``hvd_``-prefixed snake_case and have exactly one owning call site
  (the AST successor of the regex checks in tests/test_torch_metrics_lint.py).
* HVD008 — wire-protocol handler completeness: the frame-kind dispatch
  in ``wire.py`` must stay a bijection with the declarative protocol
  spec (``analysis/protocol.py``) — a missing branch is a frame the
  code cannot handle, an extra branch is a transition the spec does not
  know (drift either way; the C++ port inherits the spec).
* HVD009 — membership epochs compared with raw ``<``/``>`` instead of
  the sanctioned monotonic helpers (``epoch_advances``/
  ``epoch_is_stale``): one auditable definition of "newer epoch" for
  the runtime, the reshape drain, and the conformance monitor.
* HVD010 — cross-language ABI drift: a ctypes declaration in
  ``core/bindings.py`` that disagrees with the ``extern "C"``
  definition in the C++ core (arg count, ctype compatibility, restype)
  — the hvdabi extractor (``analysis/cpp.py``) checks this with a
  parse, not a rebuild. Never baselinable.
* HVD011 — native counter/series mirror drift: the metrics package
  consuming a counter key the C layout does not define, or registering
  a ``hvd_native_*``/``hvd_ring_*`` series with no owning counter slot
  in ``analysis/cpp.NATIVE_SERIES_MAP``. Never baselinable.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Tuple, Type

from .dataflow import (  # noqa: F401  (COLLECTIVE_NAMES/RANK_NAMES/
    COLLECTIVE_NAMES,    # _mentions_rank are part of this module's
    RANK_NAMES,          # historical public surface)
    call_name as _call_name,
    iter_divergent_collectives,
    mentions_rank as _mentions_rank,
)
from .framework import Finding, Rule, SourceFile

CONFIG_MODULE_SUFFIX = "common/config.py"

METRIC_FACTORIES = frozenset({"counter", "gauge", "histogram"})
_METRIC_NAME_RE = re.compile(r"^hvd_[a-z][a-z0-9_]*$")


def _is_os_environ(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name) and node.value.id == "os")


class DivergentCollectiveRule(Rule):
    code = "HVD001"
    name = "divergent-collective"
    description = ("collective call inside a rank-conditional branch — "
                   "directly or reached through module-local helper calls "
                   "(call-graph + rank-taint dataflow): ranks taking the "
                   "other branch never enqueue it and the job deadlocks "
                   "at negotiation")

    def __init__(self, interprocedural: bool = True):
        # interprocedural=False reproduces the round-10 lexical rule
        # exactly; tests pin its blind spots against the upgraded pass.
        self.interprocedural = interprocedural

    def check(self, src: SourceFile) -> Iterator[Finding]:
        def suppressed(line: int) -> bool:
            return src.is_suppressed(self.code, line)

        for node, message in iter_divergent_collectives(
                src.tree, is_suppressed=suppressed,
                interprocedural=self.interprocedural):
            yield self.finding(src, node, message)


class UnorderedIterationRule(Rule):
    code = "HVD002"
    name = "unordered-controller-iteration"
    description = ("unordered dict/set iteration in controller/negotiation "
                   "paths: wire payloads and response walks must be "
                   "identical on every rank — wrap in sorted(...)")

    PATH_MARKERS = ("controller/",)
    METHODS = frozenset({"items", "keys", "values"})

    def __init__(self, all_paths: bool = False):
        # all_paths=True drops the controller/ scoping — the aux gate
        # over tests/ and examples/ uses it (mp scenario bodies run on
        # every rank; a dict-order-dependent expectation is a flake).
        self.all_paths = all_paths

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if not self.all_paths and \
                not any(m in src.relpath for m in self.PATH_MARKERS):
            return
        sorted_args = set()
        for node in ast.walk(src.tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "sorted" and node.args):
                sorted_args.add(id(node.args[0]))
        for node in ast.walk(src.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self.METHODS
                    and not node.args and not node.keywords
                    and id(node) not in sorted_args):
                yield self.finding(
                    src, node,
                    f"unordered '.{node.func.attr}()' walk in a controller "
                    "path; dict order is process-local history — wrap in "
                    "sorted(...) so every rank walks the same order")


class StrayEnvReadRule(Rule):
    code = "HVD003"
    name = "stray-env-read"
    description = ("os.environ value read outside common/config.py: all "
                   "knob parsing goes through the config accessors so "
                   "every rank agrees on malformed values")

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if src.relpath.endswith(CONFIG_MODULE_SUFFIX):
            return
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                func = node.func
                if (isinstance(func, ast.Attribute) and func.attr == "get"
                        and _is_os_environ(func.value)):
                    yield self._found(src, node)
                elif (isinstance(func, ast.Attribute)
                      and func.attr == "getenv"
                      and isinstance(func.value, ast.Name)
                      and func.value.id == "os"):
                    yield self._found(src, node)
            elif (isinstance(node, ast.Subscript)
                  and _is_os_environ(node.value)
                  and isinstance(getattr(node, "ctx", None), ast.Load)):
                # ctx distinguishes reads from writes/deletes on its own:
                # `os.environ["K"] = v` is a Store, `del ...` a Del. Only
                # Load-context subscripts are value reads.
                yield self._found(src, node)

    def _found(self, src: SourceFile, node: ast.AST) -> Finding:
        var = None
        key = None
        if isinstance(node, ast.Call) and node.args:
            key = node.args[0]
        elif isinstance(node, ast.Subscript):
            key = node.slice
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            var = key.value
        what = f" of {var!r}" if var else ""
        return self.finding(
            src, node,
            f"direct os.environ read{what} bypasses common/config.py; "
            "add/use a config accessor so every consumer parses the knob "
            "identically")


class WallClockDeadlineRule(Rule):
    code = "HVD004"
    name = "wall-clock-duration"
    description = ("time.time() used where durations/deadlines are "
                   "measured; wall clocks step under NTP — use "
                   "time.monotonic() (wall-clock anchors carry a "
                   "suppression)")

    def check(self, src: SourceFile) -> Iterator[Finding]:
        bare_time_imported = any(
            isinstance(node, ast.ImportFrom) and node.module == "time"
            and any(a.name == "time" for a in node.names)
            for node in ast.walk(src.tree))
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            hit = (isinstance(func, ast.Attribute) and func.attr == "time"
                   and isinstance(func.value, ast.Name)
                   and func.value.id == "time")
            hit = hit or (bare_time_imported and isinstance(func, ast.Name)
                          and func.id == "time")
            if hit:
                yield self.finding(
                    src, node,
                    "time.time() in runtime code: use time.monotonic() for "
                    "durations/deadlines; a genuine wall-clock anchor "
                    "(trace clock-sync, event timestamps) should carry "
                    "'# hvdlint: disable=HVD004'")


class AnonymousThreadRule(Rule):
    code = "HVD005"
    name = "anonymous-thread"
    description = ("threading.Thread without explicit name= and daemon=: "
                   "anonymous threads are invisible in stack dumps and an "
                   "implicit daemon=False blocks interpreter exit")

    def check(self, src: SourceFile) -> Iterator[Finding]:
        thread_imported = any(
            isinstance(node, ast.ImportFrom) and node.module == "threading"
            and any(a.name == "Thread" for a in node.names)
            for node in ast.walk(src.tree))
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            hit = (isinstance(func, ast.Attribute) and func.attr == "Thread"
                   and isinstance(func.value, ast.Name)
                   and func.value.id == "threading")
            hit = hit or (thread_imported and isinstance(func, ast.Name)
                          and func.id == "Thread")
            if not hit:
                continue
            kwargs = {kw.arg for kw in node.keywords}
            missing = [k for k in ("name", "daemon") if k not in kwargs]
            if missing:
                missing_txt = " and ".join(m + "=" for m in missing)
                yield self.finding(
                    src, node,
                    f"threading.Thread without explicit {missing_txt}; "
                    "name every thread (hvd-*) and state daemon-ness "
                    "explicitly")


class ImportTimeSideEffectRule(Rule):
    code = "HVD006"
    name = "import-time-side-effect"
    description = ("module-top-level side effect (metric registration, env "
                   "value read, thread spawn): importing must be free — "
                   "the zero-overhead telemetry and fork contracts depend "
                   "on it")

    def check(self, src: SourceFile) -> Iterator[Finding]:
        for stmt in self._top_level_statements(src.tree):
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                cname = _call_name(node)
                func = node.func
                if cname in METRIC_FACTORIES and self._is_registration(node):
                    yield self.finding(
                        src, node,
                        f"metric '{cname}(...)' registered at import time; "
                        "registration must be lazy (first use), see the "
                        "_m/SimpleNamespace convention")
                elif (isinstance(func, ast.Attribute) and func.attr == "get"
                      and _is_os_environ(func.value)) or (
                          isinstance(func, ast.Attribute)
                          and func.attr == "getenv"
                          and isinstance(func.value, ast.Name)
                          and func.value.id == "os"):
                    yield self.finding(
                        src, node,
                        "env value read at import time: module constants "
                        "must not freeze the environment before the "
                        "launcher/runtime finished exporting it — read "
                        "lazily through common/config.py")
                elif (isinstance(func, ast.Attribute)
                      and func.attr == "Thread"
                      and isinstance(func.value, ast.Name)
                      and func.value.id == "threading"):
                    yield self.finding(
                        src, node,
                        "thread spawned at import time: threads don't "
                        "survive fork and import order becomes a runtime "
                        "dependency — spawn from init paths")

    @staticmethod
    def _top_level_statements(tree: ast.Module):
        """Module-level statements, descending into top-level if/try
        bodies (the common guard patterns) but never into defs/classes."""
        pending = list(tree.body)
        while pending:
            stmt = pending.pop(0)
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.If, ast.Try)):
                for field in ("body", "orelse", "finalbody"):
                    pending.extend(getattr(stmt, field, []) or [])
                for h in getattr(stmt, "handlers", []) or []:
                    pending.extend(h.body)
                continue
            yield stmt

    @staticmethod
    def _is_registration(node: ast.Call) -> bool:
        """A registration passes a literal metric name first — matching
        HVD007's notion of a catalog entry."""
        return bool(node.args) and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str)


class MetricCatalogRule(Rule):
    code = "HVD007"
    name = "metric-catalog"
    description = ("registered metric names must be unique (one owning "
                   "call site), snake_case, and hvd_-prefixed — the "
                   "telemetry namespace stays coherent as PRs add series")

    def __init__(self):
        # Cross-file state for the duration of one run_lint() pass (a
        # fresh instance per run): first-seen call site per metric name.
        self._seen: Dict[str, str] = {}

    def check(self, src: SourceFile) -> Iterator[Finding]:
        for name, node in self.registrations(src.tree):
            if not _METRIC_NAME_RE.match(name):
                yield self.finding(
                    src, node,
                    f"metric name {name!r} violates the catalog convention "
                    "(want hvd_ + lowercase snake_case)")
            first = self._seen.get(name)
            if first is None:
                self._seen[name] = f"{src.relpath}:{node.lineno}"
            else:
                yield self.finding(
                    src, node,
                    f"metric {name!r} registered at more than one call "
                    f"site (first owner: {first}); each name must have "
                    "exactly one owner")

    @staticmethod
    def registrations(tree: ast.AST) -> Iterator[Tuple[str, ast.Call]]:
        """Every ``counter/gauge/histogram("literal", ...)`` call —
        the shared definition of "a catalog entry" (test_metrics_lint
        builds its name inventory on this)."""
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and _call_name(node) in METRIC_FACTORIES
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                yield node.args[0].value, node


class ProtocolHandlerRule(Rule):
    code = "HVD008"
    name = "protocol-handler-completeness"
    description = ("frame-kind dispatch must stay a bijection with the "
                   "declarative wire-protocol spec "
                   "(analysis/protocol.py): a missing branch is a frame "
                   "the code cannot handle, an extra one is a transition "
                   "the spec does not know — drift either way, and the "
                   "C++ port inherits the spec")

    def check(self, src: SourceFile) -> Iterator[Finding]:
        from . import protocol

        relsuffix = next(
            (s for s in protocol.PROTOCOL_SURFACE
             if src.relpath.endswith(s)), None)
        if relsuffix is None:
            return
        for entry in protocol.check_module(relsuffix, src.tree):
            yield Finding(rule=self.code, path=src.relpath,
                          line=entry["line"], col=0,
                          message=entry["message"])


class RawEpochComparisonRule(Rule):
    code = "HVD009"
    name = "raw-epoch-comparison"
    description = ("membership epoch compared with raw </>: use the "
                   "sanctioned monotonic helpers (epoch_advances / "
                   "epoch_is_stale in analysis/protocol.py) so the "
                   "runtime, the reshape drain, and the conformance "
                   "monitor share ONE definition of \"newer epoch\"")

    # The membership-epoch protocol surface. keras/run training/restart
    # "epoch"s are a different concept and stay out of scope.
    PATH_MARKERS = ("common/wire.py", "controller/", "elastic/")
    _ORDERING_OPS = (ast.Lt, ast.Gt, ast.LtE, ast.GtE)

    @staticmethod
    def _names_epoch(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            name = None
            if isinstance(sub, ast.Name):
                name = sub.id
            elif isinstance(sub, ast.Attribute):
                name = sub.attr
            if name is not None and "epoch" in name.lower():
                return True
        return False

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if not any(m in src.relpath for m in self.PATH_MARKERS):
            return
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Compare):
                continue
            if not any(isinstance(op, self._ORDERING_OPS)
                       for op in node.ops):
                continue  # ==/!= are fine: equality is not an ordering
            if self._names_epoch(node):
                yield self.finding(
                    src, node,
                    "membership epoch compared with a raw ordering "
                    "operator; use epoch_advances()/epoch_is_stale() "
                    "(analysis/protocol.py) — the sanctioned monotonic "
                    "helpers the conformance monitor shares")


class AbiDriftRule(Rule):
    code = "HVD010"
    name = "abi-drift"
    description = ("ctypes declaration in core/bindings.py disagrees "
                   "with the extern \"C\" definition in the C++ core "
                   "(arg count, ctype compatibility, restype) — checked "
                   "statically by hvdabi (analysis/cpp.py), no rebuild")

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if not src.relpath.endswith("core/bindings.py"):
            return
        # The C++ sources are located from the installed package tree
        # (cpp module's own location), NOT from src.abspath: fixture
        # tests hand lint_source() fake paths.
        from . import cpp

        for f in cpp.bindings_source_findings(src.source):
            yield Finding(rule=self.code, path=src.relpath,
                          line=f["line"] or 1, col=0,
                          message=f["message"])


class CounterDriftRule(Rule):
    code = "HVD011"
    name = "counter-series-drift"
    description = ("native counter/series mirror drift: the metrics "
                   "package consumes a counter key the C layout does "
                   "not define, or registers a hvd_native_*/hvd_ring_* "
                   "series with no owning counter slot in "
                   "analysis/cpp.NATIVE_SERIES_MAP")

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if not src.relpath.endswith("metrics/__init__.py"):
            return
        from . import cpp

        for f in cpp.metrics_source_findings(src.source):
            yield Finding(rule=self.code, path=src.relpath,
                          line=f["line"] or 1, col=0,
                          message=f["message"])


ALL_RULES: List[Type[Rule]] = [
    DivergentCollectiveRule,
    UnorderedIterationRule,
    StrayEnvReadRule,
    WallClockDeadlineRule,
    AnonymousThreadRule,
    ImportTimeSideEffectRule,
    MetricCatalogRule,
    ProtocolHandlerRule,
    RawEpochComparisonRule,
    AbiDriftRule,
    CounterDriftRule,
]


def aux_rules() -> List[Rule]:
    """The scoped rule-set for the ``tests/`` + ``examples/`` scan
    (README.md): mp scenario bodies run on every rank, so
    a dict-order-dependent expectation (HVD002, unscoped here) is a
    flake and an anonymous thread (HVD005) hides hangs; example scripts
    are copied into user jobs, so import-time side effects (HVD006)
    propagate. Pre-existing findings live in .hvdlint-aux-baseline.json
    — a ratchet like the package baseline, minus the size cap."""
    return [UnorderedIterationRule(all_paths=True), AnonymousThreadRule(),
            ImportTimeSideEffectRule()]


def get_rule(code: str) -> Type[Rule]:
    for cls in ALL_RULES:
        if cls.code == code.upper():
            return cls
    raise KeyError(f"unknown hvdlint rule {code!r}")
