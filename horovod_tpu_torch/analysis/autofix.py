"""Mechanical autofixes for the hvdlint rules with one obvious repair.

``python -m horovod_tpu_torch.tools.lint --fix`` routes here. Only rules whose
fix is purely mechanical are eligible:

* **HVD002** — wrap the unordered ``.items()``/``.keys()``/``.values()``
  walk in ``sorted(...)``.
* **HVD005** — append the missing ``name=``/``daemon=`` kwargs to a
  ``threading.Thread(...)`` spawn (conservative defaults: the repo's
  ``hvd-`` name prefix and ``daemon=True``, matching every existing
  spawn site; review the diff like any other).

Fixes are pure text insertions at AST-reported positions, applied
bottom-up so earlier edits never shift later offsets, and **idempotent
by construction**: a fixed site no longer fires its rule, so a second
``--fix`` pass is a no-op (pinned by ``tests/test_torch_lint.py``).
Suppressed findings are never "fixed" — a justified site stays as
written.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Tuple

from .framework import lint_source
from .rules import get_rule

FIXABLE_RULES = ("HVD002", "HVD005")

# (line, col, text) single-point insertions, 1-based line / 0-based col.
_Edit = Tuple[int, int, str]


def _thread_kwargs_edit(node: ast.Call, lines: List[str]) -> _Edit:
    present = {kw.arg for kw in node.keywords}
    parts = []
    if "name" not in present:
        parts.append('name="hvd-worker"')
    if "daemon" not in present:
        parts.append("daemon=True")
    text = ", ".join(parts)
    if node.args or node.keywords:
        # A multi-line call may already end with a trailing comma
        # (`Thread(\n    target=f,\n)`); prepending another would write
        # a SyntaxError into the file. Scan back from the closing paren
        # past whitespace to the last real character.
        line, col = node.end_lineno, node.end_col_offset - 1
        prev = ""
        while line >= node.lineno and not prev:
            segment = lines[line - 1][:col].rstrip()
            prev = segment[-1:] if segment else ""
            line -= 1
            col = len(lines[line - 1]) if line >= 1 else 0
        if prev != ",":
            text = ", " + text
    # Insert just before the closing paren of the call.
    return (node.end_lineno, node.end_col_offset - 1, text)


def fix_source(source: str, relpath: str,
               select: Optional[Sequence[str]] = None) -> Tuple[str, int]:
    """Apply every available mechanical fix to one source blob. Returns
    ``(new_source, fixes_applied)``; the input is returned unchanged when
    nothing fires. ``select`` (rule codes) narrows further — a user who
    asked for ``--select HVD002 --fix`` must not get thread edits."""
    codes = [c for c in FIXABLE_RULES
             if select is None or c in {s.upper() for s in select}]
    if not codes:
        return source, 0
    rules = [get_rule(code)() for code in codes]
    findings = lint_source(source, relpath, rules=rules)
    if not findings:
        return source, 0
    tree = ast.parse(source, filename=relpath)
    raw_lines = source.splitlines()
    calls = {(n.lineno, n.col_offset): n
             for n in ast.walk(tree) if isinstance(n, ast.Call)}
    edits: List[_Edit] = []
    fixed = 0
    for f in findings:
        node = calls.get((f.line, f.col))
        if node is None:
            continue
        if f.rule == "HVD002":
            edits.append((node.lineno, node.col_offset, "sorted("))
            edits.append((node.end_lineno, node.end_col_offset, ")"))
            fixed += 1
        elif f.rule == "HVD005":
            edits.append(_thread_kwargs_edit(node, raw_lines))
            fixed += 1
    if not fixed:
        return source, 0
    lines = source.splitlines(keepends=True)
    # Bottom-up (and right-to-left within a line): applied edits never
    # shift the positions of edits still pending.
    for line, col, text in sorted(edits, reverse=True):
        idx = line - 1
        lines[idx] = lines[idx][:col] + text + lines[idx][col:]
    new_source = "".join(lines)
    # A fix that does not parse must never reach the disk: fall back to
    # the untouched source (and report nothing fixed) rather than write
    # a SyntaxError into the tree.
    ast.parse(new_source, filename=relpath)
    return new_source, fixed


def fix_file(abspath: str, relpath: str,
             select: Optional[Sequence[str]] = None) -> int:
    """Fix one file in place; returns the number of fixes applied."""
    with open(abspath, encoding="utf-8") as f:
        source = f.read()
    new_source, fixed = fix_source(source, relpath, select=select)
    if fixed:
        with open(abspath, "w", encoding="utf-8") as f:
            f.write(new_source)
    return fixed
