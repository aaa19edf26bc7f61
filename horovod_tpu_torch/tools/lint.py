"""``python -m horovod_tpu_torch.tools.lint`` — hvdlint CLI over the port.

Runs the AST-based distributed-correctness analyzer
(``horovod_tpu_torch/analysis``) and reports findings as text or JSON.
Exit code 1 on any non-baselined finding or parse error, 0 when clean —
the contract ``tests/test_torch_lint.py`` enforces.

Two scans, each with a baseline file of its own beside this module (both
empty: every finding is fixed or carries a reasoned ``# hvdlint:
disable=RULE`` suppression):

* the default — the package rules (HVD001..HVD011) over
  ``horovod_tpu_torch/`` minus ``examples/``, against
  ``hvdlint-baseline.json``;
* ``--aux`` — the scoped aux rule-set (``rules.aux_rules()``: HVD002
  unscoped, HVD005, HVD006) over ``horovod_tpu_torch/examples/`` and the
  port's tests (``tests/test_torch_*.py``, ``tests/torch_*.py``), against
  ``hvdlint-aux-baseline.json``. Example scripts are copied into user
  jobs and test bodies run on every rank, which is what these rules
  guard; the package rules' HVD003/HVD004 do not apply to them.

Workflows:

* ``... --format json`` — machine-readable report.
* ``... --select HVD003,HVD004`` — run a subset of rules.
* ``... --write-baseline`` — grandfather today's findings; the gate then
  fails only on new ones. Shrink the baseline, never grow it.
* ``... --fix`` — apply the mechanical autofixes (HVD002 ``sorted()``
  wrap, HVD005 thread ``name=``/``daemon=`` kwargs) in place, then report
  whatever remains. Idempotent: a second ``--fix`` is a no-op.
* ``... --list-rules`` — the rule catalog with one-line rationales.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..analysis import (
    ALL_RULES,
    aux_rules,
    load_baseline,
    render_json,
    render_text,
    run_lint,
    write_baseline,
)

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(_HERE)
_REPO_DIR = os.path.dirname(_PKG_DIR)
DEFAULT_BASELINE = os.path.join(_HERE, "hvdlint-baseline.json")
AUX_BASELINE = os.path.join(_HERE, "hvdlint-aux-baseline.json")
# The package scan leaves the examples to the aux rule-set.
PACKAGE_EXCLUDE = ("__pycache__", "examples")
AUX_EXCLUDE = ("__pycache__", "lint_fixtures")


def aux_paths() -> List[str]:
    """What the aux rule-set scans: the port's examples and its tests."""
    tests = os.path.join(_REPO_DIR, "tests")
    files = sorted(os.path.join(tests, f) for f in os.listdir(tests)
                   if f.endswith(".py")
                   and f.startswith(("test_torch_", "torch_"))) \
        if os.path.isdir(tests) else []
    return [os.path.join(_PKG_DIR, "examples"), *files]


def lint_package(baseline=None, select=None):
    """The package scan as ``check`` and the tests run it."""
    return run_lint([_PKG_DIR], baseline=baseline, root=_REPO_DIR,
                    select=select, exclude_dirs=PACKAGE_EXCLUDE)


def lint_aux(baseline=None):
    """The aux scan as ``check`` and the tests run it."""
    return run_lint(aux_paths(), rules=aux_rules(), baseline=baseline,
                    root=_REPO_DIR, exclude_dirs=AUX_EXCLUDE)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.lint",
        description="hvdlint: AST-based distributed-correctness analyzer "
                    "for horovod_tpu_torch")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/directories to lint (default: the "
                             "horovod_tpu_torch package minus examples/)")
    parser.add_argument("--aux", action="store_true",
                        help="run the aux rule-set over the port's "
                             "examples and tests instead")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--baseline", default=None,
                        help="baseline file of grandfathered findings "
                             f"(default: {DEFAULT_BASELINE}, or "
                             f"{AUX_BASELINE} with --aux); 'none' disables")
    parser.add_argument("--write-baseline", action="store_true",
                        help="record the current findings as the new "
                             "baseline and exit 0")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule codes to run "
                             "(default: all)")
    parser.add_argument("--fix", action="store_true",
                        help="apply the mechanical autofixes (HVD002/"
                             "HVD005) in place before reporting")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--verbose", action="store_true",
                        help="also list baselined findings (text format)")
    args = parser.parse_args(argv)

    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.code} [{cls.name}]: {cls.description}")
        return 0

    default_baseline = AUX_BASELINE if args.aux else DEFAULT_BASELINE
    if args.baseline is None:
        args.baseline = default_baseline
    if args.aux:
        paths, rules, exclude = aux_paths(), aux_rules(), AUX_EXCLUDE
    else:
        paths, rules = args.paths or [_PKG_DIR], None
        exclude = AUX_EXCLUDE if args.paths else PACKAGE_EXCLUDE
    select = ([c.strip() for c in args.select.split(",") if c.strip()]
              if args.select else None)
    if args.write_baseline and (select or args.paths) \
            and os.path.abspath(args.baseline) == default_baseline:
        # The default baseline is a whole-scan artifact: rewriting it
        # from a partial scan (rule subset or sub-paths) would silently
        # delete every grandfathered entry outside the scan's scope.
        # Scoped baselines are fine — into an explicitly named file.
        parser.error("--write-baseline on the default baseline requires a "
                     "full default scan (no --select, no explicit paths); "
                     "pass --baseline <file> to write a scoped one")
    if args.fix:
        from ..analysis import iter_python_files
        from ..analysis.autofix import fix_file

        total = files_changed = 0
        # lint_fixtures excluded like the aux scan: rule-proof fixtures
        # fire by design and must never be "repaired" in place.
        for abspath, relpath in iter_python_files(
                paths, root=_REPO_DIR, exclude_dirs=exclude):
            try:
                n = fix_file(abspath, relpath, select=select)
            except (OSError, SyntaxError):
                continue  # the lint run below reports it as a parse error
            if n:
                total += n
                files_changed += 1
        print(f"hvdlint: --fix applied {total} fix(es) in "
              f"{files_changed} file(s)")
    baseline = None
    if args.baseline and args.baseline.lower() != "none" \
            and not args.write_baseline:
        baseline = load_baseline(args.baseline)
    # Paths are reported relative to the repo (parent of the package) so
    # baselines are stable across checkouts.
    result = run_lint(paths, rules=rules, baseline=baseline, root=_REPO_DIR,
                      select=select, exclude_dirs=exclude)

    if args.write_baseline:
        try:
            out = write_baseline(args.baseline, result.findings)
        except ValueError as exc:
            # NEVER_BASELINE rules (HVD010/HVD011): ABI drift is fixed,
            # not grandfathered.
            print(f"hvdlint: {exc}", file=sys.stderr)
            return 2
        print(f"hvdlint: wrote {len(result.findings)} finding(s) to {out}")
        return 0

    sys.stdout.write(render_json(result) if args.format == "json"
                     else render_text(result, verbose=args.verbose))
    return 1 if (result.findings or result.parse_errors) else 0

if __name__ == "__main__":
    sys.exit(main())
