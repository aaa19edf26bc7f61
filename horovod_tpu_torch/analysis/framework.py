"""hvdlint core: findings, rule plugin API, suppressions, baseline, reporters.

Deliberately small and dependency-free (stdlib ``ast`` only). The shape
follows the classic linter architecture — parse each file once, hand the
tree to every registered rule, post-filter through inline suppressions
and the checked-in baseline — but the rules themselves are
project-specific distributed-correctness checks (``rules.py``), which is
the whole point: generic linters cannot know that a collective inside a
rank-conditional branch deadlocks the job.

Suppression syntax (same line or the line directly above the finding)::

    blobs = self._collect()  # hvdlint: disable=HVD002 <reason>
    # hvdlint: disable=HVD001,HVD004
    # hvdlint: disable=all

Baseline workflow: ``python -m horovod_tpu_torch.tools.lint --write-baseline``
records today's findings keyed by ``(rule, path, message)`` — NOT line
numbers, so unrelated edits don't invalidate entries — and subsequent
runs report only NEW findings. The gate test (``tests/test_torch_lint.py``)
fails on any non-baselined finding, keeping the package clean as it
grows.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

# The pragma may sit anywhere inside a comment ("... rationale.
# hvdlint: disable=HVD004"); the code list ends at the first character
# that can't be part of a code, so trailing prose is ignored.
_SUPPRESS_RE = re.compile(
    r"#.*?hvdlint:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding. ``path`` is repo/package-relative for stable
    baselines and readable reports."""

    rule: str          # "HVD001"
    path: str          # "horovod_tpu/controller/controller.py"
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class SourceFile:
    """Parsed view of one source file, shared by every rule."""

    def __init__(self, abspath: str, relpath: str, source: str):
        self.abspath = abspath
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self._suppressed: Optional[Dict[int, set]] = None

    @classmethod
    def read(cls, abspath: str, relpath: Optional[str] = None) -> "SourceFile":
        with open(abspath, encoding="utf-8") as f:
            source = f.read()
        return cls(abspath, relpath or abspath, source)

    # -- suppressions -------------------------------------------------------

    def _suppressions(self) -> Dict[int, set]:
        """{1-based line: {"HVD001", ...} or {"ALL"}} from inline pragmas."""
        if self._suppressed is None:
            table: Dict[int, set] = {}
            for i, text in enumerate(self.lines, start=1):
                m = _SUPPRESS_RE.search(text)
                if m:
                    codes = {c.strip().upper()
                             for c in m.group(1).split(",") if c.strip()}
                    table[i] = codes
            self._suppressed = table
        return self._suppressed

    def is_suppressed(self, rule: str, line: int) -> bool:
        """A finding at ``line`` is suppressed by a pragma on that line or
        on the line directly above it (for wrapped/long statements)."""
        table = self._suppressions()
        for candidate in (line, line - 1):
            codes = table.get(candidate)
            if codes and ("ALL" in codes or rule.upper() in codes):
                return True
        return False


class Rule:
    """Plugin base. Subclasses set ``code``/``name``/``description`` and
    implement :meth:`check` yielding findings. ``finding()`` is the one
    constructor so messages stay uniform."""

    code: str = "HVD000"
    name: str = "base"
    description: str = ""

    def check(self, src: SourceFile) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, src: SourceFile, node: ast.AST, message: str) -> Finding:
        return Finding(rule=self.code, path=src.relpath,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0), message=message)


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]          # new (reported) findings
    baselined: List[Finding]         # matched a baseline entry
    suppressed_count: int
    files_scanned: int
    parse_errors: List[Tuple[str, str]]  # (path, error)


# ---------------------------------------------------------------------------
# Walking + running


def iter_python_files(paths: Sequence[str],
                      root: Optional[str] = None,
                      exclude_dirs: Sequence[str] = ("__pycache__",),
                      ) -> Iterator[Tuple[str, str]]:
    """Yield ``(abspath, relpath)`` for every ``.py`` under ``paths``
    (files accepted directly), skipping directories named in
    ``exclude_dirs`` (``__pycache__`` by default; the aux test/example
    scan also drops ``lint_fixtures`` — fixtures fire by design).
    ``relpath`` is relative to ``root`` (default: each path's parent
    directory), with ``/`` separators so baselines are platform-stable."""
    skip = set(exclude_dirs) | {"__pycache__"}
    for path in paths:
        path = os.path.abspath(path)
        base = os.path.abspath(root) if root else os.path.dirname(path)
        if os.path.isfile(path):
            yield path, os.path.relpath(path, base).replace(os.sep, "/")
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames if d not in skip)
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    ap = os.path.join(dirpath, fname)
                    yield ap, os.path.relpath(ap, base).replace(os.sep, "/")


def run_lint(paths: Sequence[str], rules: Optional[Sequence[Rule]] = None,
             baseline: Optional[Iterable[dict]] = None,
             root: Optional[str] = None,
             select: Optional[Sequence[str]] = None,
             exclude_dirs: Sequence[str] = ("__pycache__",)) -> LintResult:
    """Run ``rules`` over every python file under ``paths``.

    ``baseline`` is an iterable of entry dicts (see :func:`load_baseline`);
    matching findings are moved to ``result.baselined``. ``select``
    restricts to specific rule codes. Unparseable files are reported in
    ``parse_errors`` instead of crashing the whole run (the gate test
    fails on those too — a syntax error in the package is a finding)."""
    if rules is None:
        from .rules import ALL_RULES

        rules = [cls() for cls in ALL_RULES]
    if select:
        wanted = {c.upper() for c in select}
        rules = [r for r in rules if r.code in wanted]
    # MULTISET of baseline keys: each entry absorbs exactly one finding.
    # A plain set would make one grandfathered HVD004 entry silently
    # exempt every future wall-clock violation in that file (messages
    # are file-invariant for several rules).
    baseline_budget: Dict[Tuple[str, str, str], int] = {}
    for e in (baseline or []):
        if str(e.get("rule", "")) in NEVER_BASELINE:
            # ABI/counter drift must never be grandfathered: a baseline
            # entry for these rules (hand-edited in) is simply ignored,
            # so the finding still fails the gate.
            continue
        k = baseline_key(e)
        baseline_budget[k] = baseline_budget.get(k, 0) + 1

    findings: List[Finding] = []
    baselined: List[Finding] = []
    suppressed = 0
    scanned = 0
    errors: List[Tuple[str, str]] = []
    for abspath, relpath in iter_python_files(paths, root=root,
                                              exclude_dirs=exclude_dirs):
        try:
            src = SourceFile.read(abspath, relpath)
        except (SyntaxError, UnicodeDecodeError, OSError) as exc:
            errors.append((relpath, str(exc)))
            continue
        scanned += 1
        for rule in rules:
            for f in rule.check(src):
                if src.is_suppressed(f.rule, f.line):
                    suppressed += 1
                elif baseline_budget.get(baseline_key(f.as_dict()), 0) > 0:
                    baseline_budget[baseline_key(f.as_dict())] -= 1
                    baselined.append(f)
                else:
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    baselined.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintResult(findings=findings, baselined=baselined,
                      suppressed_count=suppressed, files_scanned=scanned,
                      parse_errors=errors)


def lint_source(source: str, relpath: str,
                rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Lint one in-memory source blob (fixture tests, editor plugins).
    ``relpath`` matters: path-scoped rules (HVD002) key on it. Inline
    suppressions apply; no baseline."""
    if rules is None:
        from .rules import ALL_RULES

        rules = [cls() for cls in ALL_RULES]
    src = SourceFile(relpath, relpath, source)
    out: List[Finding] = []
    for rule in rules:
        out.extend(f for f in rule.check(src)
                   if not src.is_suppressed(f.rule, f.line))
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


# ---------------------------------------------------------------------------
# Baseline io


def baseline_key(entry: dict) -> Tuple[str, str, str]:
    """Stable identity for a finding: rule + path + message. Line numbers
    are deliberately excluded — they drift with every unrelated edit."""
    return (str(entry.get("rule", "")), str(entry.get("path", "")),
            str(entry.get("message", "")))


def load_baseline(path: str) -> List[dict]:
    """Entries from a baseline file; a missing file is an empty baseline
    (the common case for new checkouts), malformed JSON raises."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return []
    entries = data.get("findings", []) if isinstance(data, dict) else data
    if not isinstance(entries, list):
        raise ValueError(f"baseline {path}: expected a list of findings")
    return entries


#: Rules whose findings may NEVER be baselined: cross-language ABI and
#: counter/series drift (HVD010/HVD011) describe a contract that is
#: already broken on disk — grandfathering one ships the round-10
#: stack-garbage bug class. ``write_baseline`` refuses them and
#: ``run_lint`` ignores hand-edited baseline entries carrying them.
NEVER_BASELINE = frozenset({"HVD010", "HVD011"})


def write_baseline(path: str, findings: Sequence[Finding]) -> str:
    """Write the grandfather file. Line numbers are recorded for human
    orientation only; matching ignores them (see :func:`baseline_key`).

    Raises ``ValueError`` for findings from :data:`NEVER_BASELINE`
    rules — ABI drift must be fixed, not grandfathered."""
    refused = sorted({f.rule for f in findings if f.rule in NEVER_BASELINE})
    if refused:
        raise ValueError(
            "refusing to baseline %s finding(s): ABI/counter drift must "
            "be fixed, never grandfathered (README.md)"
            % ", ".join(refused))
    entries = [f.as_dict() for f in
               sorted(findings, key=lambda f: (f.path, f.line, f.rule))]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"comment": "hvdlint baseline: grandfathered findings. "
                              "Matching ignores line numbers; shrink this "
                              "file, never grow it (README.md).",
                   "findings": entries}, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


# ---------------------------------------------------------------------------
# Reporters


def render_text(result: LintResult, verbose: bool = False) -> str:
    lines = [f.render() for f in result.findings]
    for path, err in result.parse_errors:
        lines.append(f"{path}:0:0: PARSE-ERROR {err}")
    if verbose and result.baselined:
        lines.append("")
        lines.extend("baselined: " + f.render() for f in result.baselined)
    lines.append(
        f"hvdlint: {len(result.findings)} finding(s), "
        f"{len(result.baselined)} baselined, "
        f"{result.suppressed_count} suppressed, "
        f"{result.files_scanned} file(s) scanned")
    return "\n".join(lines) + "\n"


def render_json(result: LintResult) -> str:
    return json.dumps({
        "findings": [f.as_dict() for f in result.findings],
        "baselined": [f.as_dict() for f in result.baselined],
        "suppressed_count": result.suppressed_count,
        "files_scanned": result.files_scanned,
        "parse_errors": [{"path": p, "error": e}
                         for p, e in result.parse_errors],
    }, indent=1, sort_keys=True) + "\n"
