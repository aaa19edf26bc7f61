"""Runtime lock-order (deadlock-potential) detector — the port's copy of
``horovod_tpu/analysis/lockorder.py``.

The control plane holds its locks across wire/controller/metrics/
heartbeat/timeline threads with no ordering discipline; a deadlock only
manifests when two threads interleave just wrong. This module makes the
ordering observable: with ``HOROVOD_LOCKCHECK=1`` every lock created
through :func:`make_lock` is a :class:`TrackedLock` that records, per
thread, the set of locks already held at each acquisition and folds the
observations into one process-global **acquisition-order graph** (edge
``A -> B``: some thread acquired B while holding A, with both stacks
captured). A cycle in that graph is a potential deadlock even if the run
never hung.

Zero overhead when off: ``make_lock`` returns a plain
``threading.Lock`` unless the knob is set (cached once, invalidated on
fork like ``metrics``).

Artifacts: at interpreter exit (or via :func:`write_graph`) the graph is
written as ``lockgraph.json`` — ``HOROVOD_LOCKCHECK_OUTPUT`` overrides
the path, a ``{rank}`` placeholder expands like the flight recorder's —
and any cycles are logged loudly with the acquisition stacks of every
edge.

:func:`static_graph` scans the port's own sources (``horovod_tpu_torch/``)
and merges the mutex graph of its C++ core (``core/src/``); a C++ source
that does not parse fails the scan instead of dropping the native half.

Stdlib-only on purpose: ``common/wire.py`` imports this at module load.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

ENV_KNOB = "HOROVOD_LOCKCHECK"
ENV_OUTPUT = "HOROVOD_LOCKCHECK_OUTPUT"
DEFAULT_OUTPUT = "lockgraph.json"
GRAPH_FILE = DEFAULT_OUTPUT
_STACK_LIMIT = 12
# The package static_graph() scans by default.
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_enabled: Optional[bool] = None


def _invalidate_in_child() -> None:
    global _enabled
    _enabled = None


os.register_at_fork(after_in_child=_invalidate_in_child)


def lockcheck_enabled() -> bool:
    """Whether ``HOROVOD_LOCKCHECK`` asks for tracked locks (cached; the
    repo-wide knob semantics: "0"/"false"/"off" mean OFF)."""
    global _enabled
    if _enabled is None:
        # Cannot route through common/config.py: this module loads BEFORE
        # the rest of the package (wire/metrics import make_lock at module
        # level) and must stay import-cycle-free. Same _env_bool
        # semantics, read locally. hvdlint: disable=HVD003
        val = (os.environ.get(ENV_KNOB) or "").strip().lower()
        _enabled = val not in ("", "0", "false", "no", "off")
    return _enabled


_HERE = os.path.abspath(__file__)
_OWN_FILE: Dict[str, bool] = {}  # co_filename -> is this module


def _capture_stack() -> List[str]:
    """Compact acquisition stack: 'file:line in func' frames, innermost
    last, with this module's own frames trimmed. The JAX package's copy
    extracts the whole stack with its source lines on every tracked
    acquire; this walks at most ``_STACK_LIMIT`` frames and reads no
    source, for the same strings."""
    out = []
    frame = sys._getframe(1)
    while frame is not None and len(out) < _STACK_LIMIT:
        code = frame.f_code
        own = _OWN_FILE.get(code.co_filename)
        if own is None:
            own = _OWN_FILE[code.co_filename] = \
                os.path.abspath(code.co_filename) == _HERE
        if not own:
            out.append(f"{code.co_filename}:{frame.f_lineno} in "
                       f"{code.co_name}")
        frame = frame.f_back
    out.reverse()
    return out


def find_cycles(edges) -> List[List[str]]:
    """Elementary cycles over ``(from, to)`` edge keys (any mapping or
    iterable of pairs), each reported once with the start repeated at
    the end. Shared by the runtime graph and the static pass."""
    adj: Dict[str, List[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
    for targets in adj.values():
        targets.sort()
    cycles: List[List[str]] = []
    seen_cycles = set()

    def dfs(start: str, node: str, path: List[str], on_path: set) -> None:
        for nxt in adj.get(node, ()):
            if nxt == start:
                # Normalize rotation so each cycle reports once.
                cyc = path[:]
                pivot = cyc.index(min(cyc))
                norm = tuple(cyc[pivot:] + cyc[:pivot])
                if norm not in seen_cycles:
                    seen_cycles.add(norm)
                    cycles.append(list(norm) + [norm[0]])
            elif nxt not in on_path and nxt > start:
                # Only explore nodes > start: every elementary cycle
                # is found from its smallest node exactly once.
                on_path.add(nxt)
                path.append(nxt)
                dfs(start, nxt, path, on_path)
                path.pop()
                on_path.discard(nxt)

    for start in sorted(adj):
        dfs(start, start, [start], {start})
    return cycles


class LockGraph:
    """Process-global acquisition-order graph. Nodes are lock *names*
    (many lock instances may share a name — e.g. every metric's child
    lock — which is exactly the granularity ordering rules are stated
    at). All internal state is guarded by an UNtracked plain lock."""

    def __init__(self):
        self._mu = threading.Lock()
        # (held_name, acquired_name) -> {"count", "stack_held",
        # "stack_acquired", "thread"} — stacks from the FIRST observation.
        self._edges: Dict[Tuple[str, str], dict] = {}
        self._local = threading.local()

    # -- per-thread held stack ---------------------------------------------

    def _held(self) -> List[Tuple[str, List[str]]]:
        held = getattr(self._local, "held", None)
        if held is None:
            held = []
            self._local.held = held
        return held

    def note_acquired(self, name: str) -> None:
        stack = _capture_stack()
        held = self._held()
        with self._mu:
            for held_name, held_stack in held:
                if held_name == name:
                    continue  # re-acquiring a sibling of the same name
                key = (held_name, name)
                entry = self._edges.get(key)
                if entry is None:
                    self._edges[key] = {
                        "count": 1,
                        "thread": threading.current_thread().name,
                        "stack_held": held_stack,
                        "stack_acquired": stack,
                    }
                else:
                    entry["count"] += 1
        held.append((name, stack))

    def note_released(self, name: str) -> None:
        held = self._held()
        # Release order need not be LIFO; drop the most recent entry of
        # this name.
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                del held[i]
                return

    # -- graph queries ------------------------------------------------------

    def edges(self) -> Dict[Tuple[str, str], dict]:
        with self._mu:
            return {k: dict(v) for k, v in self._edges.items()}

    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the order graph (each a name list with
        the start repeated at the end). Any cycle means two threads can
        deadlock by acquiring along different edges of it."""
        return find_cycles(self.edges())

    def report(self) -> dict:
        """JSON-clean graph + cycle report (the ``lockgraph.json``
        payload). Each cycle carries the stacks of every edge on it —
        both where the first lock was held and where the second was
        acquired — so the inversion is actionable from the artifact
        alone."""
        edges = self.edges()
        cycles = self.cycles()
        cycle_details = []
        for cyc in cycles:
            steps = []
            for a, b in zip(cyc, cyc[1:]):
                entry = edges.get((a, b), {})
                steps.append({
                    "from": a, "to": b,
                    "count": entry.get("count", 0),
                    "thread": entry.get("thread"),
                    "stack_held": entry.get("stack_held", []),
                    "stack_acquired": entry.get("stack_acquired", []),
                })
            cycle_details.append({"locks": cyc, "edges": steps})
        return {
            "enabled": lockcheck_enabled(),
            "locks": sorted({n for e in edges for n in e}),
            "edges": [
                {"from": a, "to": b, "count": v["count"],
                 "thread": v["thread"],
                 "stack_held": v["stack_held"],
                 "stack_acquired": v["stack_acquired"]}
                for (a, b), v in sorted(edges.items())
            ],
            "cycles": cycle_details,
            "acyclic": not cycles,
        }

    def write(self, path: str) -> str:
        report = self.report()
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    def clear(self) -> None:
        with self._mu:
            self._edges.clear()


_graph = LockGraph()


def graph() -> LockGraph:
    return _graph


class TrackedLock:
    """Drop-in ``threading.Lock`` wrapper feeding the order graph.

    Supports the full Lock protocol (context manager,
    ``acquire(blocking=, timeout=)``, ``locked()``); only *successful*
    acquisitions are recorded — a failed try-acquire establishes no
    ordering."""

    __slots__ = ("name", "_inner", "_graph")

    def __init__(self, name: str, graph_: Optional[LockGraph] = None,
                 inner=None):
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()
        self._graph = graph_ if graph_ is not None else _graph

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._graph.note_acquired(self.name)
        return got

    def release(self) -> None:
        self._graph.note_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.name!r} {self._inner!r}>"


def make_lock(name: str):
    """THE lock factory for instrumented subsystems: a plain
    ``threading.Lock`` normally, a :class:`TrackedLock` under
    ``HOROVOD_LOCKCHECK=1``. Call sites pay one cached-boolean check at
    *creation* time only — the returned plain lock has zero added
    acquire/release cost."""
    if lockcheck_enabled():
        return TrackedLock(name)
    return threading.Lock()


def output_path() -> str:
    """Where the atexit dump lands: ``HOROVOD_LOCKCHECK_OUTPUT`` (with
    the flight recorder's ``{rank}``/``.rankN`` expansion) or
    ``lockgraph.json`` in the CWD."""
    # Import-cycle-free like lockcheck_enabled. hvdlint: disable=HVD003
    path = (os.environ.get(ENV_OUTPUT) or "").strip() or DEFAULT_OUTPUT
    rank = (os.environ.get("HOROVOD_RANK") or "").strip() or None  # hvdlint: disable=HVD003
    if "{rank}" in path:
        return path.replace("{rank}", rank if rank is not None else "0")
    if rank is not None:
        return f"{path}.rank{rank}"
    return path


def write_graph(path: Optional[str] = None) -> Optional[str]:
    """Dump the current graph (report + cycles). Returns the path, or
    None when lockcheck is off or the dump fails (never raises — the
    detector must not fail the job it observes)."""
    if not lockcheck_enabled():
        return None
    try:
        out = _graph.write(path or output_path())
    except OSError as exc:
        sys.stderr.write(f"lockcheck: cannot write lock graph: {exc}\n")
        return None
    cycles = _graph.cycles()
    if cycles:
        sys.stderr.write(
            "lockcheck: LOCK-ORDER CYCLE(S) detected (potential deadlock): "
            + "; ".join(" -> ".join(c) for c in cycles)
            + f" — full stacks in {out}\n")
    return out


def _atexit_dump() -> None:
    if lockcheck_enabled():
        write_graph()


atexit.register(_atexit_dump)


# ---------------------------------------------------------------------------
# Static lock-order graph (the static half of the static×runtime join).
#
# The runtime detector only knows about interleavings that HAPPENED: a
# cycle it misses on a laptop can still wedge a 256-chip job. This pass
# extracts the *potential* acquisition-order graph from the AST instead:
# every ``make_lock(name)`` site, every region that holds one of those
# locks (``with`` blocks and ``.acquire()`` tails), and — via the
# package-wide call graph (analysis/dataflow.py, bare-name resolution,
# over-approximate by design) — every lock that could be acquired while
# another is held. The result is a SUPERSET of any runtime
# ``lockgraph.json`` (asserted in tests/test_torch_lockorder.py), so
# "statically-possible cycles never observed at runtime" is a meaningful
# report: races we could ever have, not just races we got lucky enough
# to trigger.


def _resolve_lock_assignments(tree):
    """Per-module lock tables: ``{class_name: {attr: lockname}}`` for
    ``self.<attr> = make_lock("name")`` and ``{name: lockname}`` for
    module-level ``<name> = make_lock("name")``."""
    import ast

    class_attrs: Dict[str, Dict[str, str]] = {}
    module_names: Dict[str, str] = {}

    def lockname_of(value) -> Optional[str]:
        if (isinstance(value, ast.Call)
                and ((isinstance(value.func, ast.Name)
                      and value.func.id == "make_lock")
                     or (isinstance(value.func, ast.Attribute)
                         and value.func.attr == "make_lock"))
                and value.args and isinstance(value.args[0], ast.Constant)
                and isinstance(value.args[0].value, str)):
            return value.args[0].value
        return None

    def walk(node, class_name: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name)
                continue
            if isinstance(child, ast.Assign) and len(child.targets) == 1:
                name = lockname_of(child.value)
                if name is not None:
                    target = child.targets[0]
                    if (isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == "self"
                            and class_name is not None):
                        class_attrs.setdefault(class_name, {})[
                            target.attr] = name
                    elif isinstance(target, ast.Name):
                        module_names[target.id] = name
            walk(child, class_name)

    walk(tree, None)
    return class_attrs, module_names


def static_graph(paths: Optional[List[str]] = None,
                 include_native: Optional[bool] = None) -> dict:
    """Extract the potential lock-order graph from source. ``paths``
    defaults to the ``horovod_tpu_torch`` package. Returns a report
    shaped like the runtime one (locks / edges / cycles / acyclic) with
    ``"static": True`` and, per edge, one example ``via`` chain
    (file::function [-> callee]) so a potential inversion is actionable
    without ever reproducing it.

    ``include_native`` merges the C++ core's static mutex graph
    (``analysis.cpp.lock_graph``: ``native.<tu>.<mutex>`` locks) into
    the same report, making this the whole-process acyclicity gate.
    Default: on for the package-default scan, off when explicit
    ``paths`` are given (fixture scans of a tmpdir should not drag the
    repo's C++ edges in)."""
    import ast

    from .dataflow import PackageIndex, call_name, iter_own_nodes
    from .framework import iter_python_files

    if paths is None:
        paths = [_PKG_DIR]

    index = PackageIndex()
    lock_tables: Dict[str, tuple] = {}  # relpath -> (class_attrs, mod_names)
    for abspath, relpath in iter_python_files(paths):
        try:
            with open(abspath, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=relpath)
        except (OSError, SyntaxError):
            continue
        index.add_module(relpath, tree)
        lock_tables[relpath] = _resolve_lock_assignments(tree)

    def resolve_lock(relpath: str, qualname: str, expr) -> List[str]:
        """Lock names an expression may denote. ``self.<attr>`` resolves
        precisely through the enclosing class; an aliased or chained
        attribute (``self._metric._lock``, ``m._lock``) falls back to
        EVERY lock assigned to that attribute name in the same file —
        multi-candidate over-approximation, the superset-safe direction."""
        class_attrs, module_names = lock_tables[relpath]
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            cls = qualname.split(".", 1)[0]
            precise = class_attrs.get(cls, {}).get(expr.attr)
            if precise is not None:
                return [precise]
        if isinstance(expr, ast.Attribute):
            fallback = sorted({attrs[expr.attr]
                               for attrs in class_attrs.values()
                               if expr.attr in attrs})
            return fallback
        if isinstance(expr, ast.Name):
            name = module_names.get(expr.id)
            return [name] if name is not None else []
        return []

    def resolve_call(relpath: str, qualname: str, node):
        """Callee candidates for one call site: a ``self.X()`` call
        prefers the same-file class method; otherwise every function
        with that bare name anywhere in the package (over-approximate —
        the safe direction for a superset graph)."""
        bare = call_name(node)
        if bare is None:
            return []
        if (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"):
            cls = qualname.split(".", 1)[0]
            local = (relpath, f"{cls}.{bare}")
            if local in index.functions:
                return [local]
        return index.resolve(bare)

    # Per function: direct lock acquisitions, call sites with the held
    # set at that point, and direct held->acquired pairs.
    direct_locks: Dict[tuple, set] = {}
    held_calls: Dict[tuple, list] = {}    # key -> [(held, call node)]
    direct_pairs: Dict[tuple, list] = {}  # key -> [(held_name, lockname)]

    _STMT_LISTS = ("body", "orelse", "finalbody", "handlers")

    def own_exprs(stmt):
        """Expression nodes belonging to ONE statement: never descends
        into nested function/class/lambda subtrees (their bodies run on
        their own schedule — a callback's acquire must not be charged to
        the region that merely DEFINED it) nor into compound statements'
        statement lists (the explicit scan_stmts recursion owns those —
        a plain ast.walk here would double-scan them)."""
        stack = [stmt]
        while stack:
            node = stack.pop()
            for field, value in ast.iter_fields(node):
                if field in _STMT_LISTS:
                    continue
                children = value if isinstance(value, list) else [value]
                for child in children:
                    if not isinstance(child, ast.AST):
                        continue
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef, ast.Lambda)):
                        continue
                    yield child
                    stack.append(child)

    def scan_stmts(key, stmts, held):
        relpath, qualname = key
        held = list(held)
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # separate function: analyzed on its own
            if isinstance(stmt, ast.With):
                names = [n for item in stmt.items
                         for n in resolve_lock(relpath, qualname,
                                               item.context_expr)]
                for n in names:
                    direct_locks[key].add(n)
                    for h in held:
                        if h != n:
                            direct_pairs[key].append((h, n))
                scan_stmts(key, stmt.body, held + names)
                continue
            # Any .acquire() on a resolvable lock in this statement opens
            # a held region for the REST of the block (release ignored —
            # over-approximation, the safe direction).
            acquired_here = []
            for sub in own_exprs(stmt):
                if isinstance(sub, ast.Call):
                    if (isinstance(sub.func, ast.Attribute)
                            and sub.func.attr == "acquire"):
                        for n in resolve_lock(relpath, qualname,
                                              sub.func.value):
                            direct_locks[key].add(n)
                            for h in held:
                                if h != n:
                                    direct_pairs[key].append((h, n))
                            acquired_here.append(n)
                    elif held:
                        held_calls[key].append((tuple(held), sub))
            # Compound statements: recurse into bodies with current held.
            for field in ("body", "orelse", "finalbody"):
                sub_stmts = getattr(stmt, field, None)
                if sub_stmts:
                    scan_stmts(key, sub_stmts, held)
            for handler in getattr(stmt, "handlers", []) or []:
                scan_stmts(key, handler.body, held)
            held.extend(acquired_here)

    for key, node in index.functions.items():
        direct_locks[key] = set()
        held_calls[key] = []
        direct_pairs[key] = []
        scan_stmts(key, list(getattr(node, "body", [])), [])
        # Calls outside compound-statement bodies were collected above
        # only when held; nothing else needed for may-acquire beyond the
        # full call list:

    # may_acquire fixpoint over the package call graph.
    calls_of: Dict[tuple, list] = {}
    for key, node in index.functions.items():
        relpath, qualname = key
        sites = []
        for sub in iter_own_nodes(node):
            if isinstance(sub, ast.Call):
                sites.append(sub)
        calls_of[key] = sites
    may: Dict[tuple, set] = {key: set(locks)
                             for key, locks in direct_locks.items()}
    changed = True
    while changed:
        changed = False
        for key in index.functions:
            relpath, qualname = key
            acc = may[key]
            before = len(acc)
            for node in calls_of[key]:
                for callee in resolve_call(relpath, qualname, node):
                    if callee != key:
                        acc |= may.get(callee, set())
            if len(acc) != before:
                changed = True

    # Edges.
    edges: Dict[Tuple[str, str], dict] = {}

    def add_edge(a: str, b: str, via: str) -> None:
        if a == b:
            return  # same-name re-acquisition: no edge, like the runtime
        entry = edges.get((a, b))
        if entry is None:
            edges[(a, b)] = {"via": via, "count": 1}
        else:
            entry["count"] += 1

    for key in sorted(index.functions):
        relpath, qualname = key
        where = f"{relpath}::{qualname}"
        for held_name, lockname in direct_pairs[key]:
            add_edge(held_name, lockname, where)
        for held, node in held_calls[key]:
            bare = call_name(node)
            for callee in resolve_call(relpath, qualname, node):
                for lockname in sorted(may.get(callee, ())):
                    for h in held:
                        add_edge(h, lockname,
                                 f"{where} -> {bare} "
                                 f"({callee[0]}::{callee[1]})")

    lock_names = {name
                  for class_attrs, mod_names in lock_tables.values()
                  for name in list(mod_names.values())
                  + [n for attrs in class_attrs.values()
                     for n in attrs.values()]}
    if include_native is None:
        include_native = paths == [_PKG_DIR]
    if include_native:
        # The C++ half: native.<tu>.<mutex> names can never collide
        # with make_lock names, so the union graph stays one namespace.
        from . import cpp

        native = cpp.lock_graph()
        lock_names |= set(native["locks"])
        for e in native["edges"]:
            entry = edges.get((e["from"], e["to"]))
            if entry is None:
                edges[(e["from"], e["to"])] = {"via": e["via"],
                                               "count": e["count"]}
            else:
                entry["count"] += e["count"]
    all_locks = sorted(lock_names)
    cycles = find_cycles(edges)
    return {
        "static": True,
        "locks": all_locks,
        "edges": [{"from": a, "to": b, "via": v["via"], "count": v["count"]}
                  for (a, b), v in sorted(edges.items())],
        "cycles": [{"locks": c} for c in cycles],
        "acyclic": not cycles,
    }


def join_reports(static: dict, runtime_reports: List[dict]) -> dict:
    """The static×runtime join: which runtime edges the static graph
    covers (``uncovered_runtime_edges`` must be empty — the superset
    contract), and which statically-possible cycles no runtime dump has
    ever exhibited (``unobserved_cycles`` — the races we could have but
    never triggered; the actionable output)."""
    static_edges = {(e["from"], e["to"]) for e in static["edges"]}
    runtime_edges = set()
    observed_cycles = set()
    for rep in runtime_reports:
        for e in rep.get("edges", []):
            runtime_edges.add((e["from"], e["to"]))
        for c in rep.get("cycles", []):
            locks = c["locks"] if isinstance(c, dict) else c
            observed_cycles.add(tuple(locks))
    uncovered = sorted(runtime_edges - static_edges)
    unobserved = [c["locks"] for c in static["cycles"]
                  if tuple(c["locks"]) not in observed_cycles]
    return {
        "static_edges": len(static_edges),
        "runtime_edges": len(runtime_edges),
        "uncovered_runtime_edges": [list(e) for e in uncovered],
        "observed_cycles": sorted(list(c) for c in observed_cycles),
        "unobserved_cycles": unobserved,
        "superset": not uncovered,
    }
