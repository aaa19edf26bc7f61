"""The port's native engine (``controller/native.py`` over its own
``core/src/engine.cc``) and its Python controller on the ring, against
the JAX package's native engine, on the CPU.

The multi-process scenarios of ``tests/test_torch_controller_mp.py`` run
under the port's ``horovodrun`` on the native engine (the default once
the launcher exports ring addresses) and on the Python controller over
the ring (``HOROVOD_ENGINE=python``), in 2- and 3-rank jobs and in a
4-rank 2x2 job on the two-level plane (``HOROVOD_HIERARCHICAL_*``, no
shared-memory plane). The same scenarios run through
``horovod_tpu.torch`` on the JAX package's native engine under its own
launcher, and every result must be bitwise equal (bfloat16 compared by
its bits).

A 3-rank ring adds each element in an order that depends on where it
lies in the fused buffer, and which tensors share a fused buffer depends
on which cycle each rank enqueued them in. So the 3-rank jobs draw their
floats on a grid of quarters, where every order gives the same sum; the
2-rank and 2x2 jobs make one addition an element and keep the normal
draws (``tests/test_torch_ring.py`` holds the 3-rank order itself).

Each job runs with ``HOROVOD_METRICS=1`` and ends, before shutdown,
with a ``metrics`` scenario returning the rank's ``hvd_native_*`` and
``hvd_ring_*`` series from ``metrics.snapshot()``, the native counters'
mirror: the port's native engine must report the JAX native engine's
tensors, fused bytes and wire bytes by dtype and link class, and
positive cycles, spans and busy seconds.

Also here: the counter-slot layout of ``core/bindings.py`` against the
``enum CounterSlot`` of the port's ``engine.cc``, the port's C ABI
against the JAX package's, the engine choice, and the refusals
(``HOROVOD_ENGINE=native`` without ring addresses, a core that does not
build).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import test_torch_controller_mp as mp
import torch_gloo

PORT_SRC = os.path.join(torch_gloo.REPO, "horovod_tpu_torch", "core", "src")
JAX_SRC = os.path.join(torch_gloo.REPO, "horovod_tpu", "core", "src")

GRID_SRC = '''
import os as _os

_make_inputs_drawn = make_inputs


def make_inputs(rank, size):
    """make_inputs, with floats on a grid of quarters under HVD_TEST_GRID
    (sums exact in any order)."""
    out = _make_inputs_drawn(rank, size)
    if _os.environ.get("HVD_TEST_GRID"):
        for key, value in out.items():
            if value.dtype.kind == "f":
                out[key] = (np.round(value * 4) / 4).astype(value.dtype)
    return out
'''

# The mirrored series as JSON: name -> sorted [labels, value] rows, a
# histogram's value being its count and sum.
METRICS_SRC = '''
def _mirror(snap):
    rows = {}
    for name, entry in sorted(snap.items()):
        if not name.startswith(("hvd_native_", "hvd_ring_")):
            continue
        values = []
        for labels, value in entry["values"]:
            if isinstance(value, dict):
                value = [value["count"], value["sum"]]
            values.append([list(labels), value])
        rows[name] = sorted(values)
    return torch.frombuffer(bytearray(json.dumps(rows).encode()),
                            dtype=torch.uint8)

'''

PLANE_SRC = METRICS_SRC + '''
def scenario_metrics(rank, size, x, out, notes):
    from horovod_tpu_torch import metrics as hvd_metrics

    out["mirror"] = _mirror(hvd_metrics.snapshot())


def scenario_plane(rank, size, x, out, notes):
    ctl = basics.controller()
    notes["engine"] = type(ctl).__name__
    notes["ring"] = getattr(ctl, "_ring", None) is not None
    notes["hier"] = bool(getattr(ctl, "hierarchical_active", False)
                         or getattr(ctl, "_local_ring", None) is not None)

'''

REFERENCE_SRC = METRICS_SRC + '''
def scenario_metrics(rank, size, x, out):
    out["mirror"] = _mirror(hvd.metrics.snapshot())


def scenario_grouped(rank, size, x, out):
    res = thvd.grouped_allreduce([t(x["fuse"][i]) for i in range(6)],
                                 average=False, name="grp")
    for i, r in enumerate(res):
        out[f"grp.{i}"] = r
    res = thvd.grouped_allreduce([t(x["f32"]), t(x["w"])], average=True)
    out["grp.avg.0"], out["grp.avg.1"] = res
    ts = [t(x["fuse"][i]).clone() for i in range(4)]
    thvd.grouped_allreduce_(ts, average=False, name="grp.ip")
    for i, s in enumerate(ts):
        out[f"grp.ip.{i}"] = s


def scenario_allgather(rank, size, x, out):
    out["gather"] = thvd.allgather(t(x["gather"]), name="gather.var")
    out["gather.i32"] = thvd.allgather(t(x["i32"][:rank + 2]),
                                       name="gather.i32")


def scenario_broadcast(rank, size, x, out):
    out["bc.0"] = thvd.broadcast(t(x["f32"]), root_rank=0, name="bc.0")
    out["bc.last"] = thvd.broadcast(t(x["f32"]), root_rank=size - 1,
                                    name="bc.last")
    y = bf(x["bf16"])
    thvd.broadcast_(y, root_rank=1, name="bc.ip")
    out["bc.ip"] = y


def scenario_cache(rank, size, x, out):
    for it in range(6):
        out[f"cache.{it}"] = thvd.allreduce(t(x["f32"]) * (it + 1),
                                            average=False, name="cached.t")
    out["cache.reshaped"] = thvd.allreduce(t(x["fuse"][:2]), average=False,
                                           name="cached.t")


def scenario_error_mismatch(rank, size, x, out):
    out["good.after"] = thvd.allreduce(torch.ones(3), average=False,
                                       name="good.after")


def scenario_duplicate_name(rank, size, x, out):
    h1 = thvd.allreduce_async(torch.ones(4), name="dup", average=False)
    out["dup"] = thvd.synchronize(h1)

'''


def _insert(src, before, extra):
    assert src.count(before) == 1, before
    return src.replace(before, extra + before)


PORT_WORKER = _insert(mp.PORT_WORKER.replace(
    mp.INPUTS_SRC, mp.INPUTS_SRC + GRID_SRC, 1), "\ndef main():", PLANE_SRC)
REFERENCE_WORKER = _insert(mp.REFERENCE_WORKER.replace(
    mp.INPUTS_SRC, mp.INPUTS_SRC + GRID_SRC, 1), "\ndef main():",
    REFERENCE_SRC)

PARITY = ["allreduce", "fusion", "grouped", "allgather", "broadcast",
          "cache", "error_mismatch", "duplicate_name", "torch"]
PARITY_2X2 = ["allreduce", "fusion", "allgather", "broadcast"]
# Run after the mirror is read: the workers' error scenarios and their
# torch-API scenario issue different collectives.
LATE_SCENARIOS = ["torch", "error_mismatch", "duplicate_name"]
LAYOUTS = {
    2: ((), {}),
    3: ((), {"HVD_TEST_GRID": "1"}),
    "2x2": (("-H", "localhost:2,127.0.0.1:2"),
            {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
             "HOROVOD_HIERARCHICAL_ALLGATHER": "1",
             "HOROVOD_SHM_DISABLE": "1"}),
}
ENGINES = {"native": {}, "python": {"HOROVOD_ENGINE": "python"}}


def _ranks(layout):
    return 4 if layout == "2x2" else layout


# Seconds one job may take from its start: a 4-rank job alone takes
# 10-20 s here; the rest covers a machine loaded by the rest of the suite.
JOB_SECONDS = 240


def _start_jax(tmp_path, layout, scenarios):
    """The reference worker under the JAX package's launcher (its default
    engine: native, on the exported ring)."""
    script, inp, out = torch_gloo._prepare(tmp_path, REFERENCE_WORKER, {},
                                           {"scenarios": scenarios})
    args, env = LAYOUTS[layout]
    cmd = [sys.executable, "-m", "horovod_tpu.run", "-np",
           str(_ranks(layout)), *args, sys.executable, script, inp, out]
    proc = subprocess.Popen(
        cmd, cwd=torch_gloo.REPO,
        env=torch_gloo._clean_env(dict(
            env, JAX_PLATFORMS="cpu", HOROVOD_METRICS="1",
            HOROVOD_TRACE_DIR=str(tmp_path / "trace"))),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return torch_gloo.Job([proc], out, _ranks(layout), JOB_SECONDS)


def _start(tmp_path_factory, key):
    engine, layout = key
    # The mirror is read after the scenarios both workers run alike.
    parity = PARITY_2X2 if layout == "2x2" else PARITY
    scenarios = [s for s in parity if s not in LATE_SCENARIOS]
    scenarios += ["metrics"] + [s for s in LATE_SCENARIOS if s in parity]
    if engine == "jax":
        return _start_jax(tmp_path_factory.mktemp(f"jax{layout}"), layout,
                          scenarios)
    args, env = LAYOUTS[layout]
    base = tmp_path_factory.mktemp(f"{engine}{layout}")
    # Traced, so the native engines stamp spans.
    return torch_gloo.start_launched(
        base, _ranks(layout), PORT_WORKER, {},
        {"scenarios": ["plane"] + scenarios}, launcher_args=args,
        env=dict(env, HOROVOD_METRICS="1",
                 HOROVOD_TRACE_DIR=str(base / "trace"), **ENGINES[engine]),
        timeout=JOB_SECONDS)


def _outcome(key, job):
    """The job's arrays per rank, or the text of its failure: its key,
    exit codes and the tail of its log."""
    try:
        return job.wait()[0]
    except AssertionError as exc:
        return f"job {key} failed: {exc}"


# The JAX package's launcher draws its ring ports by binding to port 0,
# from the range where any process's outgoing connection may take one
# before the rank binds it; such a job is started once more.
_PORT_TAKEN = "Address already in use"


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every engine x layout of the port and the JAX package's native
    engine per layout: one layout's three jobs at a time (12 processes at
    most, against the rest of the suite), each under its own deadline.
    A failed job is kept as its failure text, so only the tests that read
    it fail, and they say which job it was."""
    out = {}
    for layout in sorted(LAYOUTS, key=str):
        keys = [(engine, layout) for engine in sorted(ENGINES)] + \
            [("jax", layout)]
        started = {key: _start(tmp_path_factory, key) for key in keys}
        try:
            for key in keys:
                out[key] = _outcome(key, started[key])
                if key[0] == "jax" and isinstance(out[key], str) \
                        and _PORT_TAKEN in out[key]:
                    started[key] = _start(tmp_path_factory, key)
                    out[key] = _outcome(key, started[key])
        finally:
            for key in keys:
                started[key].kill()
    return out


def _job(jobs, key):
    result = jobs[key]
    if isinstance(result, str):
        raise AssertionError(result)
    return result


def _notes(ranks):
    return [json.loads(r["notes"].tobytes()) for r in ranks]


@pytest.mark.parametrize("layout", list(LAYOUTS), ids=str)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_scenarios_pass_on_the_plane_asked_for(jobs, engine, layout):
    for rank, note in enumerate(_notes(_job(jobs, (engine, layout)))):
        for scenario, result in sorted(note.items()):
            if isinstance(result, dict):
                assert result["ok"], (rank, scenario, result.get("error"))
        assert note["plane"]["engine"] == (
            "NativeController" if engine == "native" else "Controller")
        if engine == "python":
            assert note["plane"]["ring"]
        assert note["plane"]["hier"] == (layout == "2x2")
        assert note["pg_tensors"] == 0
        if layout != "2x2":
            assert note["fusion"]["tensors"] == 21
            assert note["fusion"]["responses"] < 21
            assert note["cache"]["hits"] == 5


@pytest.mark.parametrize("layout", list(LAYOUTS), ids=str)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_results_equal_the_jax_native_engine(jobs, engine, layout):
    port, ref = _job(jobs, (engine, layout)), _job(jobs, ("jax", layout))
    scenarios = PARITY_2X2 if layout == "2x2" else PARITY
    for rank in range(_ranks(layout)):
        for scenario in scenarios:
            keys = sorted(k for k in ref[rank]
                          if k.startswith(scenario + "/"))
            assert keys, scenario
            for key in keys:
                got, want = port[rank][key], ref[rank][key]
                assert got.dtype == want.dtype and \
                    got.shape == want.shape, key
                np.testing.assert_array_equal(got, want, err_msg=key)


def _mirror(ranks):
    return [json.loads(r["metrics/mirror"].tobytes()) for r in ranks]


def _series(mirror, name):
    return {tuple(labels): value for labels, value in mirror.get(name, [])}


# The mirror's series that follow from the collectives alone. A 2-rank
# ring (and each 2-rank ring of the 2x2 plane) sends every fused buffer
# once in all, however the tensors were grouped; a 3-rank ring sends two
# of three segments twice, and the segments' rounding follows the
# grouping, which follows cycle timing: there the wire bytes are held
# within 1%.
DETERMINISTIC = ("hvd_native_tensors_total", "hvd_native_fused_bytes_total")
WIRE = "hvd_ring_wire_bytes_total"


@pytest.mark.parametrize("layout", list(LAYOUTS), ids=str)
def test_native_counter_mirror_equals_the_jax_one(jobs, layout):
    port = _mirror(_job(jobs, ("native", layout)))
    ref = _mirror(_job(jobs, ("jax", layout)))
    links = set()
    for rank, (got, want) in enumerate(zip(port, ref)):
        assert sorted(got) == sorted(want), rank
        for name in DETERMINISTIC:
            assert _series(got, name) == _series(want, name), (rank, name)
        wire, ref_wire = _series(got, WIRE), _series(want, WIRE)
        if layout == 3:
            assert sorted(wire) == sorted(ref_wire)
            for labels, value in sorted(wire.items()):
                assert abs(value - ref_wire[labels]) <= \
                    0.01 * ref_wire[labels], (rank, labels)
        else:
            assert wire == ref_wire, rank
        links |= {link for (_, link), value in sorted(wire.items())
                  if value}
        for name in ("hvd_native_cycles_total", "hvd_native_spans_total"):
            assert _series(got, name)[()] > 0, (rank, name)
        count, busy = _series(got, "hvd_native_execute_seconds")[()]
        assert count > 0 and busy > 0, rank
        count, busy = _series(got, "hvd_native_cycle_seconds")[()]
        assert count > 0 and busy > 0, rank
    # The two-level plane's hops read separately (only local roots ride
    # the cross ring).
    assert links == ({"local", "cross"} if layout == "2x2" else {"flat"})


def test_python_controller_mirrors_the_ring_only(jobs):
    for rank_mirror in _mirror(_job(jobs, ("python", 2))):
        assert not any(n.startswith("hvd_native_") for n in rank_mirror)
        assert _series(rank_mirror, "hvd_ring_wire_bytes_total")


@pytest.mark.parametrize("engine", list(ENGINES))
def test_error_texts_agree_across_ranks(jobs, engine):
    for layout in (2, 3):
        notes = _notes(_job(jobs, (engine, layout)))
        for key in ("shape", "dtype", "root", "gather_rank",
                    "gather_shape", "op"):
            assert len({n["error_mismatch"][key] for n in notes}) == 1, key
        assert all("Duplicate tensor name" in n["duplicate_name"]["dup"]
                   for n in notes)


# ------------------------------------------------------- the core's ABI

def _enum(src, name):
    """The values of a C++ enum, by evaluating its initialisers in order
    (constants of the file's ``constexpr int`` lines in scope)."""
    scope = {k: int(v) for k, v in re.findall(
        r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*(\d+)\s*;", src)}
    for k, expr in re.findall(
            r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*([\w\s+*]+);", src):
        scope.setdefault(k, eval(expr, {}, scope))
    body = re.search(r"enum\s+" + name + r"\b[^{]*\{(.*?)\};", src,
                     re.S).group(1)
    values, nxt = {}, 0
    for item in re.sub(r"//[^\n]*", "", body).split(","):
        item = item.strip()
        if not item:
            continue
        key, _, expr = item.partition("=")
        key = key.strip()
        val = eval(expr, {}, {**scope, **values}) if expr else nxt
        values[key] = val
        nxt = val + 1
    return values, scope


def test_counter_slots_match_the_engine_enum():
    from horovod_tpu_torch.core import bindings as b

    with open(os.path.join(PORT_SRC, "engine.cc")) as f:
        slots, scope = _enum(f.read(), "CounterSlot")
    assert scope["kHistBuckets"] == b.NATIVE_HIST_BUCKETS
    for i, name in enumerate(b.NATIVE_COUNTER_SCALARS):
        assert slots["CTR_" + name.upper()] == i, name
    assert slots["CTR_CYCLE_HIST_COUNT"] == b._NATIVE_CYCLE_HIST_BASE
    assert slots["CTR_EXEC_HIST_COUNT"] == b._NATIVE_EXEC_HIST_BASE
    assert slots["CTR_ENGINE_GEN"] == b._NATIVE_ENGINE_GEN
    assert slots["N_COUNTER_SLOTS"] == b.N_NATIVE_COUNTER_SLOTS == 65


def test_dtype_and_wire_codes_match_ring_cc():
    import torch

    from horovod_tpu_torch.core import bindings as b

    with open(os.path.join(PORT_SRC, "ring.cc")) as f:
        src = f.read()
    dtypes, _ = _enum(src, "DType")
    assert sorted(b.DTYPE_CODES.values()) == sorted(dtypes.values())
    assert b.DTYPE_CODES[torch.bfloat16] == 6 and \
        b.DTYPE_CODES[torch.bool] == 10
    wires, _ = _enum(src, "WireDType")
    assert sorted(wires.values()) == sorted(b.WIRE_DTYPE_CODES.values())


def _exports(src_dir):
    """``hvd_*`` functions of the C ABI: name -> argument count."""
    out = {}
    for fname in sorted(os.listdir(src_dir)):
        if not fname.endswith(".cc"):
            continue
        with open(os.path.join(src_dir, fname)) as f:
            src = f.read()
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern', src,
                                re.S) or [src]:
            for name, args in re.findall(
                    r"^[\w\s\*]*?\b(hvd_\w+)\(([^)]*)\)\s*\{", block, re.M):
                out[name] = 0 if not args.strip() or \
                    args.strip() == "void" else args.count(",") + 1
    return out


def test_c_abi_is_the_jax_packages():
    port, jax = _exports(PORT_SRC), _exports(JAX_SRC)
    assert len(port) > 40
    assert port == jax


# ------------------------------------------------------ choice, refusals

@pytest.mark.parametrize("env,want", [
    ({}, "python"),
    ({"HOROVOD_RING_ADDRS": "a:1,b:2"}, "native"),
    ({"HOROVOD_RING_ADDRS": "a:1,b:2", "HOROVOD_ENGINE": "python"},
     "python"),
    ({"HOROVOD_RING_ADDRS": "a:1,b:2", "HOROVOD_CPU_OPS": "star"},
     "python"),
    ({"HOROVOD_ENGINE": "native"}, "native"),
])
def test_engine_choice_is_the_jax_rule(monkeypatch, env, want):
    from horovod_tpu.common import config as jconfig

    from horovod_tpu_torch.common import config

    for var in ("HOROVOD_RING_ADDRS", "HOROVOD_ENGINE", "HOROVOD_CPU_OPS"):
        monkeypatch.delenv(var, raising=False)
    for k, v in sorted(env.items()):
        monkeypatch.setenv(k, v)
    assert config.selected_engine() == want
    jax_choice = jconfig.engine() or (
        "native" if jconfig.ring_data_plane_enabled() else "python")
    assert jax_choice == want


def _topology(size=2):
    from horovod_tpu_torch.common.topology import Topology

    return Topology(rank=0, size=size, local_rank=0, local_size=size,
                    cross_rank=0, cross_size=1)


def test_native_engine_without_ring_addresses_raises(monkeypatch):
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.controller.native import NativeController

    monkeypatch.delenv("HOROVOD_RING_ADDRS", raising=False)
    monkeypatch.setenv("HOROVOD_ENGINE", "native")
    with pytest.raises(RuntimeError, match="native engine requires "
                       "HOROVOD_RING_ADDRS .exported by horovodrun.; set "
                       "HOROVOD_ENGINE=python to use the TCP star"):
        NativeController(Config.from_env(), _topology())


def test_a_core_that_does_not_build_raises(monkeypatch, tmp_path):
    """A failed build surfaces the compiler's output and stops the
    controller before any plane starts: no fall back to the star."""
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.controller.controller import Controller
    from horovod_tpu_torch.controller.native import NativeController
    from horovod_tpu_torch.core import bindings

    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(bindings, "CXX_FLAGS",
                        bindings.CXX_FLAGS + ["-fno-such-flag-for-g++"])
    with pytest.raises(RuntimeError, match="(?s)building the native core "
                       "failed.*no-such-flag"):
        bindings.load()
    monkeypatch.setenv("HOROVOD_RING_ADDRS", "127.0.0.1:1,127.0.0.1:2")
    monkeypatch.setenv("HOROVOD_CONTROLLER_ADDR", "127.0.0.1:3")
    monkeypatch.delenv("HOROVOD_CPU_OPS", raising=False)
    for make in (lambda: NativeController(Config.from_env(), _topology()),
                 lambda: Controller(Config.from_env(), _topology())):
        with pytest.raises(RuntimeError, match="building the native core"):
            make()
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.parametrize("env", [
    {},
    {"HOROVOD_RING_ADDRS": "127.0.0.1:1,127.0.0.1:2",
     "HOROVOD_RING_WIRE_DTYPE": "BF16"},
    {"HOROVOD_RING_ADDRS": "10.1.2.3:1,10.9.8.7:2",
     "HOROVOD_RING_WIRE_DTYPE": "garbage",
     "HOROVOD_CROSS_RING_ADDRS": "10.1.2.3:5,10.9.8.7:6",
     "HOROVOD_LOCAL_RING_ADDRS": "127.0.0.1:3,127.0.0.1:4",
     "HOROVOD_HIERARCHICAL_ALLREDUCE": "1"},
    {"HOROVOD_RING_CHUNK_BYTES": "65536", "HOROVOD_RING_LINK_CLASS": "dcn",
     "HOROVOD_RING_WIRE_DTYPE_LOCAL": "fp16",
     "HOROVOD_CROSS_RING_LINK_CLASS": "ici",
     "HOROVOD_HIERARCHICAL_ALLGATHER": "yes"},
    {"HOROVOD_RING_LINK_CLASS": "tcp", "HOROVOD_RING_CHUNK_BYTES": "x",
     "HOROVOD_LOCAL_RING_LINK_CLASS": "dcn"},
], ids=["unset", "loopback-bf16", "two-hosts", "explicit", "tcp"])
def test_ring_knobs_resolve_as_the_jax_packages(monkeypatch, env):
    from horovod_tpu.common import config as jconfig

    from horovod_tpu_torch.common import config

    for var in sorted(os.environ):
        if var.startswith(("HOROVOD_RING", "HOROVOD_LOCAL_RING",
                           "HOROVOD_CROSS_RING", "HOROVOD_HIERARCHICAL")):
            monkeypatch.delenv(var)
    for k, v in sorted(env.items()):
        monkeypatch.setenv(k, v)
    for name in ("ring_wire_dtype", "ring_wire_dtype_local",
                 "ring_wire_dtype_cross", "resolved_ring_chunk_bytes",
                 "ring_link_class", "ring_data_plane_enabled"):
        assert getattr(config, name)() == getattr(jconfig, name)(), name
    port, jax = config.Config.from_env(), jconfig.Config.from_env()
    assert (port.hierarchical_allreduce, port.hierarchical_allgather) == \
        (jax.hierarchical_allreduce, jax.hierarchical_allgather)
