"""Call-graph + dataflow machinery behind the interprocedural lint rules.

The round-10 rules were purely lexical: HVD001 could only see a
collective call *textually* inside a rank-conditional branch, so

    if rank == 0:
        warm_up()          # warm_up() -> _sync() -> hvd.barrier()

slipped straight through — exactly the divergent-collective deadlock the
rule exists to catch, one helper call away. This module adds the two
pieces that close that hole, shared by ``rules.py`` (HVD001) and the
static lock-graph pass (``lockorder.static_graph``):

* **Module call graph** (:class:`ModuleFunctions`): every function and
  method in one module, indexed by qualified and bare name; call sites
  are resolved by the called object's trailing identifier
  (``self._helper(...)`` → every ``_helper`` in the module). Resolution
  is deliberately an over-approximation — for "could this reach a
  collective / acquire a lock" questions a superset answer is the safe
  one, false negatives are the expensive ones.
* **Rank-taint reaching definitions** (:func:`tainted_rank_names`): a
  fixpoint over simple assignments that tracks which locals are derived
  from rank-valued expressions (``is_root = rank == 0`` taints
  ``is_root``), so a conditional on a *renamed* rank value is still
  rank-conditional.
* **Collective reachability** (:func:`collective_reach`): which module
  functions can (transitively) issue a collective, with the discovery
  chain preserved for actionable messages. Collective calls carrying an
  inline ``hvdlint: disable=HVD001`` suppression do not taint the
  closure — a justified subgroup collective stays justified through a
  wrapper.

Scope: one module at a time (the lint framework hands rules one file);
cross-module chains are out of scope here and documented as such in
README.md. :class:`PackageIndex` (used by the lock pass,
which runs as its own whole-package pass) lifts the same machinery to a
set of files.

Stdlib-only like the rest of this package.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

# Names that enqueue a collective on the eager tier (package API surface
# plus the in-place/async variants and ring-backend methods). THE
# canonical set — rules.py re-exports it.
COLLECTIVE_NAMES = frozenset({
    "allreduce", "allreduce_", "allreduce_async",
    "allgather", "allgather_", "allgather_async",
    "broadcast", "broadcast_", "broadcast_async",
    "alltoall", "reducescatter", "barrier",
    "grouped_allreduce", "grouped_allreduce_",
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_object", "allgather_object", "broadcast_variables",
})

# Identifiers whose appearance in an ``if`` test marks it rank-conditional.
RANK_NAMES = frozenset({"rank", "local_rank", "cross_rank", "process_index"})


def call_name(node: ast.Call) -> Optional[str]:
    """Trailing identifier of the called object: ``hvd.allreduce`` ->
    ``allreduce``, ``barrier`` -> ``barrier``."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def mentions_rank(test: ast.AST,
                  tainted: "frozenset[str] | Set[str]" = frozenset()) -> bool:
    """True when the expression references a rank name or a local the
    taint analysis derived from one."""
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and (node.id in RANK_NAMES
                                           or node.id in tainted):
            return True
        if isinstance(node, ast.Attribute) and node.attr in RANK_NAMES:
            return True
    return False


def iter_own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's OWN body: descend everywhere except into nested
    function/class definitions (those execute on their own schedule, not
    as part of this function's control flow) and lambdas (callbacks)."""
    pending = list(ast.iter_child_nodes(fn))
    while pending:
        node = pending.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        pending.extend(ast.iter_child_nodes(node))


def tainted_rank_names(fn: ast.AST) -> Set[str]:
    """Reaching definitions over rank-derived values, flow-insensitively:
    the fixpoint of "assigned from an expression mentioning rank or an
    already-tainted name". Single module-local pass; no kill-set (a
    later clean reassignment does not un-taint — over-approximation,
    consistent with the rest of the analysis)."""
    tainted: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in iter_own_nodes(fn):
            target = None
            value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                target, value = node.targets[0].id, node.value
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.value is not None:
                target, value = node.target.id, node.value
            elif isinstance(node, ast.NamedExpr) \
                    and isinstance(node.target, ast.Name):
                target, value = node.target.id, node.value
            if target is None or target in tainted:
                continue
            if mentions_rank(value, tainted):
                tainted.add(target)
                changed = True
    return tainted


class ModuleFunctions:
    """Index of every function/method in one module tree."""

    def __init__(self, tree: ast.AST):
        self.tree = tree
        self.index: Dict[str, ast.AST] = {}
        self.by_bare: Dict[str, List[str]] = {}

        def walk(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qualname = f"{prefix}{child.name}"
                    self.index[qualname] = child
                    self.by_bare.setdefault(child.name, []).append(qualname)
                    walk(child, f"{qualname}.")
                elif isinstance(child, ast.ClassDef):
                    walk(child, f"{prefix}{child.name}.")
                else:
                    walk(child, prefix)

        walk(tree, "")

    def resolve(self, bare: str) -> List[str]:
        """Every module function a call to ``bare`` might reach
        (over-approximate by design)."""
        return self.by_bare.get(bare, [])


def collective_reach(funcs: ModuleFunctions,
                     is_suppressed: Optional[Callable[[int], bool]] = None,
                     ) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """``{qualname: (collective_name, call_chain)}`` for every module
    function that can transitively issue a collective. ``call_chain`` is
    the discovery path of qualnames from the function down to (but not
    including) the collective call itself. ``is_suppressed(line)``
    filters collective call sites already justified inline — a wrapped
    subgroup collective must not re-flag every caller."""
    suppressed = is_suppressed or (lambda line: False)
    direct: Dict[str, str] = {}
    calls: Dict[str, Set[str]] = {}
    for qualname, node in funcs.index.items():
        called: Set[str] = set()
        for sub in iter_own_nodes(node):
            if not isinstance(sub, ast.Call):
                continue
            cname = call_name(sub)
            if cname is None:
                continue
            if cname in COLLECTIVE_NAMES:
                if not suppressed(sub.lineno) and qualname not in direct:
                    direct[qualname] = cname
            else:
                called.add(cname)
        calls[qualname] = called

    reach: Dict[str, Tuple[str, Tuple[str, ...]]] = {
        qn: (cname, (qn,)) for qn, cname in direct.items()}
    changed = True
    while changed:
        changed = False
        for qualname in sorted(funcs.index):
            if qualname in reach:
                continue
            for bare in sorted(calls[qualname]):
                hit = None
                for callee in sorted(funcs.resolve(bare)):
                    if callee != qualname and callee in reach:
                        hit = callee
                        break
                if hit is not None:
                    cname, chain = reach[hit]
                    reach[qualname] = (cname, (qualname,) + chain)
                    changed = True
                    break
    return reach


def iter_divergent_collectives(
        tree: ast.AST,
        is_suppressed: Optional[Callable[[int], bool]] = None,
        interprocedural: bool = True,
) -> Iterator[Tuple[ast.AST, str]]:
    """The HVD001 engine: yields ``(node, message)`` for every collective
    issued — directly or through module-local helper calls — inside a
    rank-conditional branch. ``interprocedural=False`` reproduces the
    round-10 lexical rule exactly (kept so its blind spots stay pinned
    by tests)."""
    funcs = ModuleFunctions(tree)
    reach = (collective_reach(funcs, is_suppressed)
             if interprocedural else {})
    out: List[Tuple[ast.AST, str]] = []

    def visit(node: ast.AST, inside: bool, tainted: Set[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A new scope: taint is per-function; the body does NOT
            # inherit the caller's conditional context lexically (the
            # interprocedural pass charges call SITES instead).
            fn_tainted = tainted_rank_names(node) if interprocedural \
                else set()
            for child in ast.iter_child_nodes(node):
                visit(child, False, fn_tainted)
            return
        if isinstance(node, ast.If) and mentions_rank(node.test, tainted):
            # The test expression itself runs on every rank.
            visit(node.test, inside, tainted)
            for child in node.body + node.orelse:
                visit(child, True, tainted)
            return
        if isinstance(node, ast.Call) and inside:
            cname = call_name(node)
            if cname in COLLECTIVE_NAMES:
                out.append((node, (
                    f"collective '{cname}' inside a rank-conditional "
                    "branch (divergent-collective deadlock): hoist it "
                    "out, or suppress if the subgroup genuinely "
                    "matches the conditional")))
            elif interprocedural and cname is not None:
                hit = None
                for callee in sorted(funcs.resolve(cname)):
                    if callee in reach:
                        hit = callee
                        break
                if hit is not None:
                    collective, chain = reach[hit]
                    path = " -> ".join(chain) + f" -> {collective}"
                    out.append((node, (
                        f"call to '{cname}' inside a rank-conditional "
                        f"branch reaches collective '{collective}' "
                        f"(via {path}): ranks taking the other branch "
                        "never enqueue it and the job deadlocks — hoist "
                        "the call out, or suppress if every rank "
                        "ultimately issues the same collectives")))
        for child in ast.iter_child_nodes(node):
            visit(child, inside, tainted)

    visit(tree, False, set())
    yield from out


class PackageIndex:
    """Cross-file function index for whole-package passes (the static
    lock graph): the same over-approximate bare-name resolution as
    :class:`ModuleFunctions`, lifted over many modules."""

    def __init__(self):
        # (relpath, qualname) -> node; bare name -> [(relpath, qualname)]
        self.functions: Dict[Tuple[str, str], ast.AST] = {}
        self.by_bare: Dict[str, List[Tuple[str, str]]] = {}
        self.modules: Dict[str, ast.AST] = {}

    def add_module(self, relpath: str, tree: ast.AST) -> None:
        self.modules[relpath] = tree
        funcs = ModuleFunctions(tree)
        for qualname, node in funcs.index.items():
            key = (relpath, qualname)
            self.functions[key] = node
            self.by_bare.setdefault(
                qualname.rsplit(".", 1)[-1], []).append(key)

    def resolve(self, bare: str) -> List[Tuple[str, str]]:
        return self.by_bare.get(bare, [])
