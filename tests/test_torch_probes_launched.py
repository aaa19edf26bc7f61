"""The port's probe examples that launch jobs, at smoke size on the CPU,
against the JAX package's where both run here. The jobs run three at a
time (one module fixture).

* the wire probe at 2 ranks has the JAX probe's row and summary keys and
  the same wire bytes per dtype (int8 included);
* ``scaling_projection.project`` equals the JAX ``project()`` as data on
  the same step time and the gradient groups of a profiled two-rank
  ``DistributedOptimizer`` step (the MLP);
* ``scaling_efficiency`` at MLP ranks 1 and 2, ``autotune_efficacy`` (A
  and C) for one short window and ``allreduce_benchmark`` at size 1 and
  at 2 ranks under the port's ``horovodrun``.

Tolerances: wire bytes exactly; the projection's floats to 1e-12
relative (the same arithmetic in both packages).
"""

import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from horovod_tpu_torch.examples import scaling_projection

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable
WIRE_ARGS = ["--ranks", "2", "--sizes-mib", "1", "--wire", "none,bf16,int8",
             "--chunks-kib", "256", "--reps", "1"]
ALLREDUCE = ["-m", "horovod_tpu_torch.examples.allreduce_benchmark",
             "--device", "cpu", "--size-mb", "1", "--iters", "2"]
JOBS = {
    "wire_port": [PY, "-m", "horovod_tpu_torch.examples."
                  "wire_bandwidth_probe"] + WIRE_ARGS,
    "wire_jax": [PY, os.path.join(REPO, "examples",
                                  "wire_bandwidth_probe.py")] + WIRE_ARGS,
    "scaling": [PY, "-m", "horovod_tpu_torch.examples.scaling_efficiency",
                "--sizes", "1,2", "--steps", "3", "--warmup", "1",
                "--batch-per-rank", "16"],
    "autotune": [PY, "-m", "horovod_tpu_torch.examples.autotune_efficacy",
                 "--runs", "A,C", "--steps", "4", "--window", "4"],
    "allreduce_one": [PY] + ALLREDUCE,
    "allreduce_two": [PY, "-m", "horovod_tpu_torch.run", "-np", "2",
                      PY] + ALLREDUCE,
}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_CONTROLLER_ADDR",
              "HOROVOD_SPMD_COORDINATOR", "HOROVOD_RENDEZVOUS_FILE"):
        env.pop(k, None)
    return env


def _last_json(text: str) -> dict:
    lines = [ln.partition("]: ")[2] if ln.startswith("[") else ln
             for ln in text.splitlines()]
    return json.loads([ln for ln in lines if ln.startswith("{")][-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's (returncode, stdout, stderr), and the projection's
    profiled trace (its two-rank job started from this process)."""
    def run(cmd):
        res = subprocess.run(cmd, cwd=REPO, env=_env(), text=True,
                             capture_output=True, timeout=300)
        return res.returncode, res.stdout, res.stderr

    def trace():
        args = scaling_projection.parse_args(
            ["--model", "mlp", "--step-ms", "12.5"])
        return scaling_projection.profiled_groups_trace(
            args, str(tmp_path_factory.mktemp("projection")))

    # Three jobs at a time: the suite's other workers share the cores.
    with ThreadPoolExecutor(3) as pool:
        futures = {name: pool.submit(run, cmd)
                   for name, cmd in sorted(JOBS.items())}
        futures["trace"] = pool.submit(trace)
        return {name: f.result() for name, f in sorted(futures.items())}


def _ok(runs, name):
    code, stdout, stderr = runs[name]
    assert code == 0, stdout[-3000:] + stderr[-3000:]
    return _last_json(stdout)


def test_wire_probe_matches_the_jax_probe(runs):
    mine, theirs = _ok(runs, "wire_port"), _ok(runs, "wire_jax")
    assert sorted(mine) == sorted(theirs)
    assert [sorted(r) for r in mine["rows"]] == \
        [sorted(r) for r in theirs["rows"]]
    key = ("payload_mib", "wire", "chunk_kib")
    assert [tuple(r[k] for k in key) for r in mine["rows"]] == \
        [tuple(r[k] for k in key) for r in theirs["rows"]]
    assert sorted(mine["best_by_size_and_wire"]) == \
        sorted(theirs["best_by_size_and_wire"])
    for dtype in ("int8", "bf16", "none"):
        assert mine["wire_stats_rank0"]["tx_bytes"][dtype] == \
            theirs["wire_stats_rank0"]["tx_bytes"][dtype], dtype
    assert mine["wire_stats_rank0"]["tx_bytes"]["int8"] > 0


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_projection_equals_the_jax_project(runs, monkeypatch):
    jsp = _jax_example("scaling_projection")
    report = scaling_projection.overlap_report(runs["trace"])
    step_s, batch = 0.0125, 64
    nv = scaling_projection.LINKS["nvlink4"]
    ib = scaling_projection.LINKS["infiniband_ndr"]
    grad_bytes = scaling_projection.param_bytes("mlp", 32)
    mine = scaling_projection.project(step_s, report, grad_bytes)
    monkeypatch.setattr(jsp, "MEASURED", {"mlp": {
        "rate": batch / step_s, "batch": batch}})
    monkeypatch.setattr(jsp.sm, "ICI_BW_BYTES_PER_S",
                        {"v5e": nv["bytes_per_s"]})
    monkeypatch.setattr(jsp.sm, "CONSERVATIVE_LINK_FRACTION",
                        {"v5e": nv["conservative_fraction"]})
    theirs = jsp.project("mlp", report, grad_bytes)
    groups = mine["trace_input"]["gradient_groups"]
    assert len(groups) == 6          # three Dense layers: kernel and bias
    assert groups == theirs["hlo_input"]["gradient_groups"]
    assert mine["trace_input"]["allreduce_payload_bytes"] == \
        theirs["hlo_input"]["hlo_allreduce_payload_bytes"] == grad_bytes
    curve = {k: v for k, v in sorted(mine["projection"]["nvlink4"].items())
             if k != "source"}
    want = theirs["projection"]["v5e"]
    assert sorted(curve) == sorted(want)
    for key, value in sorted(want.items()):
        if isinstance(value, dict):
            assert sorted(curve[key]) == sorted(value)
            np.testing.assert_allclose([curve[key][n] for n in sorted(value)],
                                       [value[n] for n in sorted(value)],
                                       rtol=1e-12)
        else:
            assert curve[key] == pytest.approx(value, rel=1e-12)
    assert mine["overlap_evidence"] == theirs["overlap_evidence"]
    # The two-tier layout is the JAX package's multislice arithmetic.
    jgroups = [jsp.sm.GradGroup(**g) for g in groups]
    for n, eff in sorted(mine["multi_node"]["conservative"].items()):
        assert eff == pytest.approx(jsp.sm.multislice_efficiency(
            step_s, jgroups, n_slices=n // 8, ici_size=8,
            ici_bw=nv["bytes_per_s"] * nv["conservative_fraction"],
            dcn_bw_per_chip=ib["bytes_per_s"] * ib["conservative_fraction"]),
            rel=1e-12)
    with pytest.raises(RuntimeError, match="no gradient allreduce groups"):
        scaling_projection.project(step_s, {**report,
                                            "sync_collectives": []}, 1)


def test_scaling_efficiency_mlp_ranks_one_and_two(runs):
    out = _ok(runs, "scaling")
    assert out["metric"] == "scaling_efficiency"
    assert out["sizes"] == [1, 2]
    assert out["efficiency"]["1"] == 1.0 and out["efficiency"]["2"] > 0
    assert set(out["img_sec"]) == {"1", "2"}


def test_autotune_efficacy_one_short_window(runs):
    out = _ok(runs, "autotune")
    stdout = runs["autotune"][1]
    a, c = (json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith('{"run"'))
    assert (a["run"], c["run"]) == ("A", "C")
    assert not a["autotune"] and c["autotune"]
    assert (c["fusion_threshold"], c["cycle_time"]) == ("4096", "25")
    assert a["fusion_threshold"] is None and a["size"] == 2
    assert len(a["windows_steps_per_s"]) == len(c["windows_steps_per_s"]) \
        == 1
    assert out["tuned_over_default"] > 0


def test_allreduce_benchmark_size_one_and_two_ranks(runs):
    one = _ok(runs, "allreduce_one")
    assert one["ranks"] == 1 and "own cost" in one["mode"]
    two = _ok(runs, "allreduce_two")
    assert two["ranks"] == 2 and two["bus_GB_s"] > 0
    assert "Controller" in two["mode"]
