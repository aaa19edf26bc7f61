"""The port's hvdlint (``horovod_tpu_torch/analysis/{framework,dataflow,
rules,autofix}.py`` and ``tools/lint.py``) against the JAX package's:
both rule sets give the same findings (rule, line, column) on every
fixture of ``tests/lint_fixtures/`` and the same ``--fix`` output; the
port's own tree lints clean against its own empty baselines, the
package rules over ``horovod_tpu_torch/`` minus ``examples/`` and the
aux rule-set over the examples and the port's tests; and the CLI's exit
codes."""

import json
import os
import shutil

import pytest

from horovod_tpu.analysis import autofix as jax_autofix
from horovod_tpu.analysis import framework as jax_framework
from horovod_tpu.analysis import rules as jax_rules
from horovod_tpu_torch.analysis import autofix, framework, rules
from horovod_tpu_torch.tools import lint as cli

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "lint_fixtures")

# Path-scoped rules lint their fixtures as the modules they guard (the
# cross-language rules then read each package's own C++ sources).
RELPATHS = {"HVD002": "controller/_fixture.py",
            "HVD008": "common/wire.py",
            "HVD009": "controller/_epochs.py",
            "HVD010": "core/bindings.py",
            "HVD011": "metrics/__init__.py"}
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))


def _read(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return f.read()


def _relpath(pkg, name):
    code = name[:6].upper()
    return f"{pkg}/" + RELPATHS.get(code, f"{name}")


def _findings(framework_mod, rules_mod, source, relpath, **kw):
    found = framework_mod.lint_source(
        source, relpath, rules=[cls() for cls in rules_mod.ALL_RULES], **kw)
    return [(f.rule, f.line, f.col) for f in found]


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_rule_sets_agree_on_fixture(name):
    source = _read(name)
    got = _findings(framework, rules, source,
                    _relpath("horovod_tpu_torch", name))
    want = _findings(jax_framework, jax_rules, source,
                     _relpath("horovod_tpu", name))
    assert got == want
    code = name[:6].upper()
    if name.endswith("_bad.py"):
        assert any(rule == code for rule, _, _ in got), got


@pytest.mark.parametrize("name", ["hvd002_bad.py", "hvd005_bad.py",
                                  "suppressed.py"])
def test_aux_rules_and_autofix_agree(name):
    source = _read(name)
    rel = "tests/" + name
    got = [(f.rule, f.line, f.col) for f in framework.lint_source(
        source, rel, rules=rules.aux_rules())]
    want = [(f.rule, f.line, f.col) for f in jax_framework.lint_source(
        source, rel, rules=jax_rules.aux_rules())]
    assert got == want
    fixed = autofix.fix_source(source, _relpath("horovod_tpu_torch", name))
    assert fixed == jax_autofix.fix_source(
        source, _relpath("horovod_tpu", name))
    again = autofix.fix_source(fixed[0], _relpath("horovod_tpu_torch", name))
    assert again == (fixed[0], 0)


def test_interprocedural_hvd001_and_lexical_mode_agree():
    source = _read("hvd001_interproc_bad.py")
    for interprocedural in (True, False):
        got = framework.lint_source(source, "x.py", rules=[
            rules.DivergentCollectiveRule(interprocedural)])
        want = jax_framework.lint_source(source, "x.py", rules=[
            jax_rules.DivergentCollectiveRule(interprocedural)])
        assert [(f.line, f.col, f.message) for f in got] == \
            [(f.line, f.col, f.message) for f in want]
        assert bool(got) is interprocedural


def test_collective_names_cover_the_port_entry_points():
    from horovod_tpu_torch.analysis.dataflow import COLLECTIVE_NAMES

    assert {"allreduce_", "allgather", "broadcast_", "reducescatter",
            "alltoall", "grouped_allreduce", "broadcast_object"} <= \
        COLLECTIVE_NAMES
    source = ("def step(ring, x, group):\n"
              "    if hvd.rank() == 0:\n"
              "        hvd.allreduce_(x, group=group)\n"
              "        ring.allreduce_(x)\n")
    found = framework.lint_source(source, "x.py", rules=[
        rules.DivergentCollectiveRule()])
    assert [(f.rule, f.line) for f in found] == [("HVD001", 3),
                                                  ("HVD001", 4)]


# ---------------------------------------------------------------------------
# The port's own tree


def test_baselines_are_empty():
    for path in (cli.DEFAULT_BASELINE, cli.AUX_BASELINE):
        assert framework.load_baseline(path) == [], path


def test_package_lints_clean():
    result = cli.lint_package(
        baseline=framework.load_baseline(cli.DEFAULT_BASELINE))
    assert not result.parse_errors, result.parse_errors
    assert result.files_scanned > 80
    assert not result.findings, "\n".join(f.render()
                                          for f in result.findings)
    # The examples are the aux scan's, not the package scan's.
    relpaths = {rel for _, rel in framework.iter_python_files(
        [cli._PKG_DIR], root=cli._REPO_DIR,
        exclude_dirs=cli.PACKAGE_EXCLUDE)}
    assert not any("/examples/" in rel for rel in relpaths)


def test_examples_and_tests_lint_clean_under_the_aux_rules():
    result = cli.lint_aux(
        baseline=framework.load_baseline(cli.AUX_BASELINE))
    assert not result.parse_errors, result.parse_errors
    assert not result.findings, "\n".join(f.render()
                                          for f in result.findings)
    scanned = {rel for _, rel in framework.iter_python_files(
        cli.aux_paths(), root=cli._REPO_DIR, exclude_dirs=cli.AUX_EXCLUDE)}
    assert "horovod_tpu_torch/examples/elastic_llama_training.py" in scanned
    assert "tests/test_torch_lint.py" in scanned
    assert not any("lint_fixtures" in rel or rel.startswith(
        "tests/test_lint") for rel in scanned)


# ---------------------------------------------------------------------------
# The CLI


def test_cli_exit_codes(tmp_path, capsys):
    assert cli.main(["--list-rules"]) == 0
    assert "HVD011" in capsys.readouterr().out
    assert cli.main(["--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == [] and payload["files_scanned"] > 80
    assert cli.main(["--aux"]) == 0
    capsys.readouterr()
    dirty = tmp_path / "dirty.py"
    shutil.copy(os.path.join(FIXTURES, "hvd004_bad.py"), dirty)
    assert cli.main([str(dirty), "--baseline", "none"]) == 1
    assert "HVD004" in capsys.readouterr().out
    scoped = tmp_path / "scoped.json"
    assert cli.main([str(dirty), "--baseline", str(scoped),
                     "--write-baseline"]) == 0
    assert cli.main([str(dirty), "--baseline", str(scoped)]) == 0
    capsys.readouterr()
    # The default baselines are whole-scan artifacts.
    with pytest.raises(SystemExit) as exc:
        cli.main([str(dirty), "--write-baseline"])
    assert exc.value.code == 2
    # ABI drift is never grandfathered.
    core = tmp_path / "core"
    core.mkdir()
    shutil.copy(os.path.join(FIXTURES, "hvd010_bad.py"),
                core / "bindings.py")
    assert cli.main([str(core), "--baseline", "none"]) == 1
    assert "HVD010" in capsys.readouterr().out
    assert cli.main([str(core), "--baseline", str(tmp_path / "abi.json"),
                     "--write-baseline"]) == 2
    assert "never grandfathered" in capsys.readouterr().err


def test_cli_fix_is_idempotent(tmp_path, capsys):
    target = tmp_path / "controller"
    target.mkdir()
    shutil.copy(os.path.join(FIXTURES, "hvd005_bad.py"),
                target / "threads.py")
    shutil.copy(os.path.join(FIXTURES, "hvd002_bad.py"),
                target / "walks.py")
    assert cli.main([str(target), "--baseline", "none", "--fix",
                     "--select", "HVD002,HVD005"]) == 0
    out = capsys.readouterr().out
    assert "applied" in out and "applied 0 fix" not in out
    assert cli.main([str(target), "--baseline", "none", "--fix",
                     "--select", "HVD002,HVD005"]) == 0
    assert "applied 0 fix(es)" in capsys.readouterr().out
