"""hvdabi over the port (``horovod_tpu_torch/analysis/cpp.py``,
``tools/abicheck.py``) and the aggregate gate (``tools/check.py``).

* The port's extractor over the JAX package's C++ sources equals the
  JAX extractor: functions and exports, counter slots, span phases,
  frame anchors, mutexes and the lock graph; its bindings parser reads
  the JAX ``bindings.py`` as the JAX one does, and the port's ``_c(lib,
  "name", restype, *argtypes)`` declarations besides.
* On the port's own tree: no findings, the TF op library's ``CoreApi``
  fn-pointer table (``tensorflow/src/tf_ops.cc``) parsed and matching the
  port's ``engine.cc`` exports, the committed manifest golden, every gate
  of ``check`` passing.
* A seeded-drift matrix in a temporary clone of the port: an arg count,
  a dropped frame anchor, a renamed counter slot, a C++ and a Python
  lock inversion, an off-spec handler and a ``CoreApi`` fn-pointer type
  each fail their gate, and ``check`` exits 1 with all of them
  seeded."""

import json
import os
import shutil

import pytest

from horovod_tpu.analysis import cpp as jax_cpp
from horovod_tpu_torch.analysis import cpp, lockorder
from horovod_tpu_torch.tools import abicheck, check
from horovod_tpu_torch.tools import lint as lint_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "horovod_tpu_torch"


def _tu(mod, path):
    """One translation unit through ``mod``'s load_sources pipeline."""
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    code_nc, code, comments = mod._strip(text)
    code, guarded = mod._preprocess(code)
    code_nc, _ = mod._preprocess(code_nc)
    return {"relpath": path, "text": text, "code_nc": code_nc,
            "code": code, "comments": comments, "guarded_lines": guarded,
            "functions": mod.parse_functions(code_nc, code, guarded)}


JAX_TUS = [(tag, rel) for tag, rel in jax_cpp.CPP_SOURCES
           if tag != "tf_ops"]


@pytest.mark.parametrize("tag,rel", JAX_TUS)
def test_extractor_equals_the_jax_one_on_jax_sources(tag, rel):
    got, want = _tu(cpp, rel), _tu(jax_cpp, rel)
    assert got == want
    assert cpp.parse_mutexes(got["code"]) == \
        jax_cpp.parse_mutexes(want["code"])
    assert cpp.parse_frame_anchors(got["comments"]) == \
        jax_cpp.parse_frame_anchors(want["comments"])
    if tag == "engine":
        assert cpp.extract_counters(got["code"]) == \
            jax_cpp.extract_counters(want["code"])
        assert cpp.extract_span_phases(got["code"]) == \
            jax_cpp.extract_span_phases(want["code"])


def test_exports_and_lock_graph_equal_the_jax_ones():
    got = {tag: _tu(cpp, rel) for tag, rel in JAX_TUS}
    want = {tag: _tu(jax_cpp, rel) for tag, rel in JAX_TUS}
    assert cpp.exports(got) == jax_cpp.exports(want)
    assert cpp.lock_graph(got) == jax_cpp.lock_graph(want)
    engine = got["engine"]
    anchors = cpp.parse_frame_anchors(engine["comments"])
    from horovod_tpu_torch.analysis import protocol

    assert cpp.check_native_frames(
        engine["functions"], anchors, protocol.KINDS, "engine.cc") == \
        jax_cpp.check_native_frames(
            want["engine"]["functions"],
            jax_cpp.parse_frame_anchors(want["engine"]["comments"]),
            protocol.KINDS, "engine.cc")


def test_bindings_parsers_agree_and_read_the_port_form():
    with open(os.path.join(REPO, jax_cpp.BINDINGS_PATH)) as f:
        jax_src = f.read()
    assert cpp.parse_bindings(jax_src) == jax_cpp.parse_bindings(jax_src)
    with open(os.path.join(REPO, cpp.BINDINGS_PATH)) as f:
        port = cpp.parse_bindings(f.read())
    init = port["decls"]["hvd_eng_init"]
    assert len(init["argtypes"]) == 17 and init["restype"] == "c_int"
    assert port["decls"]["hvd_ring_get_wire_stats"]["argtypes"] == [
        "POINTER(c_longlong)", "POINTER(c_longlong)", "POINTER(c_double)"]
    last_error = port["decls"]["hvd_ring_last_error"]
    assert (last_error["argtypes"], last_error["restype"]) == \
        ([], "c_char_p")
    assert port["constants"]["N_NATIVE_COUNTER_SLOTS"] == 65


# ---------------------------------------------------------------------------
# The port's own tree


def test_port_tree_has_no_findings():
    report = cpp.run_checks()
    assert report["findings"] == [], "\n".join(
        "%(path)s:%(line)s [%(check)s] %(message)s" % f
        for f in report["findings"])
    assert report["absent"] == []
    # The CoreApi table: every field resolved by sym("...") to an engine
    # export of the same signature (a mismatch would be a finding above).
    core_api = report["manifest"]["core_api"]
    assert len(core_api) == 10
    assert core_api["enqueue"] == {
        "symbol": "hvd_eng_enqueue", "ret": "long long",
        "args": ["int", "const char *", "void *", "const long long *",
                 "int", "int", "int", "void *", "int"]}
    exports = report["manifest"]["exports"]
    for field, meta in sorted(core_api.items()):
        c = exports[meta["symbol"]]
        assert c["tag"] == "engine", field
        assert [a["type"] for a in c["args"]] == meta["args"], field
        assert c["ret"] == meta["ret"], field
    assert report["coverage"]["data"] == {"status": "handled",
                                          "via": "recv_frame"}
    assert report["manifest"]["counters"]["n_slots"] == 65
    assert {"native.engine.g_engine_mu", "native.engine.mu_"} <= \
        set(report["lock_graph"]["locks"])


def test_manifest_pin_is_golden(capsys):
    with open(os.path.join(REPO, cpp.MANIFEST_PATH)) as f:
        pinned = f.read()
    assert cpp.render_manifest(cpp.build_manifest()) == pinned
    assert abicheck.main(["--dump-manifest"]) == 0
    assert capsys.readouterr().out == pinned
    # The exports and the counter layout are the JAX core's.
    port, jax = json.loads(pinned), jax_cpp.build_manifest()
    for section in ("exports", "counters", "frame_kinds", "span_phases"):
        assert port[section] == jax[section], section


def test_cli_clean_exits_zero(capsys):
    assert abicheck.main([]) == 0
    out = capsys.readouterr().out
    assert "abicheck: 0 finding(s)" in out
    assert "10 tf_ops.cc CoreApi field(s)" in out and "absent" not in out
    assert abicheck.main(["--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == [] and payload["exports"] == 60
    assert payload["core_api"] == 10 and payload["absent"] == []


def test_check_passes_on_the_port(capsys):
    assert check.main(["--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["ok"] is True
    for gate in ("hvdlint", "aux-lint", "protocheck", "lock-graph",
                 "hvdabi"):
        assert payload[gate]["ok"] and payload[gate]["findings"] == 0
    assert payload["lock-graph"]["locks"] >= 20


# ---------------------------------------------------------------------------
# Seeded drift in a clone of the port


@pytest.fixture()
def clone(tmp_path, monkeypatch):
    """The port's Python sources, C++ core, manifests and baselines, and
    its tests, copied under tmp_path; every gate re-pointed at the copy."""
    root = tmp_path / "repo"
    keep = (".py", ".cc", ".h", ".json")
    for dirpath, dirnames, files in os.walk(os.path.join(REPO, PORT)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        rel = os.path.relpath(dirpath, REPO)
        for fname in files:
            if fname.endswith(keep):
                os.makedirs(root / rel, exist_ok=True)
                shutil.copyfile(os.path.join(dirpath, fname),
                                root / rel / fname)
    (root / "tests").mkdir()
    for fname in os.listdir(os.path.join(REPO, "tests")):
        if fname.startswith(("test_torch_", "torch_")) and \
                fname.endswith(".py"):
            shutil.copyfile(os.path.join(REPO, "tests", fname),
                            root / "tests" / fname)
    pkg = str(root / PORT)
    monkeypatch.setattr(check, "_PKG_DIR", pkg)
    monkeypatch.setattr(lint_cli, "_PKG_DIR", pkg)
    monkeypatch.setattr(lint_cli, "_REPO_DIR", str(root))
    monkeypatch.setattr(lockorder, "_PKG_DIR", pkg)
    monkeypatch.setattr(cpp, "_REPO_DIR", str(root))
    return root


def _mutate(root, rel, old, new):
    path = root / rel
    text = path.read_text()
    assert text.count(old) == 1, f"mutation anchor: {old!r}"
    path.write_text(text.replace(old, new))


ENGINE = f"{PORT}/core/src/engine.cc"
TF_OPS = f"{PORT}/tensorflow/src/tf_ops.cc"
DRIFTS = {
    # A stale fn-pointer type in the TF op library's CoreApi table: the
    # kernels would call hvd_eng_wait with the wrong argument.
    "coreapi_pointer": (TF_OPS, "int (*wait)(long long) = nullptr;",
                        "int (*wait)(int) = nullptr;"),
    "argcount": (cpp.BINDINGS_PATH, '_c(lib, "hvd_eng_wait", i, ll)',
                 '_c(lib, "hvd_eng_wait", i, ll, i)'),
    "dropped_anchor": (ENGINE, "// hvdabi:frame-kind kind=heartbeat "
                       "status=unsupported reason=python-engine-only\n", ""),
    "renamed_slot": (ENGINE, "CTR_PIPELINE_STALL_US = 12,",
                     "CTR_PIPELINE_STALL_USEC = 12,"),
}


def _seed_cpp_inversion(root):
    with open(root / ENGINE, "a") as f:
        f.write("\nstatic void seeded_lock_inversion() {\n"
                "  std::lock_guard<std::mutex> a(mu_);\n"
                "  std::lock_guard<std::mutex> b(g_engine_mu);\n"
                "}\n")


def _seed_python_inversion(root):
    with open(root / PORT / "common" / "timeline.py", "a") as f:
        f.write("\n\ndef _seeded_inversion(timeline):\n"
                "    with timeline._drop_lock:\n"
                "        with timeline._lock:\n"
                "            pass\n")


def _seed_off_spec_handler(root):
    _mutate(root, f"{PORT}/common/wire.py",
            "if kind in (FRAME_ABORT, FRAME_RESHAPE, FRAME_SHARD_FETCH,",
            "if kind in (FRAME_ABORT, FRAME_SHARD_FETCH,")


def test_clone_is_clean(clone):
    assert cpp.run_checks()["findings"] == []
    assert lockorder.static_graph()["acyclic"]


@pytest.mark.parametrize("name", sorted(DRIFTS))
def test_seeded_abi_drift_fails_hvdabi(clone, name):
    rel, old, new = DRIFTS[name]
    _mutate(clone, rel, old, new)
    findings = cpp.run_checks(with_manifest=False)["findings"]
    want = {"argcount": ("abi", "hvd_eng_wait argtypes has 2 entries"),
            "coreapi_pointer": ("abi", "CoreApi field wait (-> hvd_eng_wait) "
                                "argument types (int) do not match"),
            "dropped_anchor": ("native-frames", "'heartbeat'"),
            "renamed_slot": ("counters", "pipeline_stall_us")}[name]
    assert findings and all(f["check"] == want[0] for f in findings)
    assert any(want[1] in f["message"] for f in findings), findings


def test_seeded_lock_inversions_fail_the_graphs(clone):
    _seed_cpp_inversion(clone)
    assert any(f["check"] == "locks" and "cycle" in f["message"]
               for f in cpp.run_checks(with_manifest=False)["findings"])
    _seed_python_inversion(clone)
    rep = lockorder.static_graph()
    assert not rep["acyclic"]
    cycles = [c["locks"] for c in rep["cycles"]]
    assert any("timeline.pids" in c and "timeline.drops" in c
               for c in cycles), cycles


def test_check_exits_one_on_every_seeded_drift(clone, capsys):
    for _, (rel, old, new) in sorted(DRIFTS.items()):
        _mutate(clone, rel, old, new)
    _seed_cpp_inversion(clone)
    _seed_python_inversion(clone)
    _seed_off_spec_handler(clone)
    assert check.main(["--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["ok"] is False
    for gate in ("hvdlint", "protocheck", "lock-graph", "hvdabi"):
        assert not payload[gate]["ok"], gate
    assert payload["aux-lint"]["ok"]
    detail = "\n".join(payload["hvdabi"]["detail"])
    for needle in ("hvd_eng_wait argtypes", "CoreApi field wait",
                   "'heartbeat'", "pipeline_stall_us", "lock-order cycle"):
        assert needle in detail, needle
    assert any("recv_hello" in line
               for line in payload["protocheck"]["detail"])
