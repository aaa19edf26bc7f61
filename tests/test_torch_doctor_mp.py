"""The cluster doctor across real ranks on the CPU, in both packages.

* **Delay chaos** (the JAX acceptance scenario of
  ``tests/test_doctor.py``): a seeded fault plan delays every
  ``wire_send`` of rank 1 by 50 ms. Three ranks under the port's
  ``horovodrun`` (Python controller, TCP star) with the metrics port,
  the piggyback every 5 cycles, a doctor sweep every 20 cycles, 1 s
  telemetry windows and the trace directory; beside them the same plan
  on three ranks of the JAX package's controller. Rank 0 of each polls
  its own ``GET /doctor`` until ``persistent_straggler`` names rank 1;
  after the lockstep shutdown each package's ``tools.doctor`` reads its
  trace directory. The live and the offline verdicts must agree with the
  JAX job's in rule, rank and evidence source (fields, not timings).
  The port's rank 0 also shows the periodic ``doctor:`` log line naming
  rank 1, the ``hvd_doctor_findings`` series, a windowed ``/metrics``
  view, at least one window ingested by the live calibration, and the
  workers' piggybacked snapshots; the job runs under both runtime
  monitors.
* **Healthy twin**: the same port job without the plan raises no
  ``persistent_straggler``.
* **Postmortem**: rank 1 of a two-rank job installs a fault plan that
  SIGKILLs it at its next ``wire_send`` after step 2; rank 0's
  ``fail_all`` dump under ``HOROVOD_FLIGHT_RECORDER`` must exist in both
  packages with the same event kinds and an ``abort`` naming rank 1,
  and ``tools.doctor`` over the directory exits 0 with rank 0 observed.

The jobs start in two waves, each under its own 120 s timeout."""

import contextlib
import io
import json
import re
import subprocess
import sys

import pytest

import torch_gloo
from horovod_tpu.tools import doctor as jcli
from horovod_tpu_torch.tools import doctor as tcli

PLAN = json.dumps({"seed": 7, "faults": [
    {"site": "wire_send", "action": "delay", "at": 5, "times": 1000000,
     "seconds": 0.05, "rank": 1}]})
KILL_PLAN = json.dumps({"seed": 7, "faults": [
    {"site": "wire_send", "action": "kill", "at": 1, "rank": 1}]})
TIMEOUT = 120

POLL_SRC = r'''
import json
import time
import urllib.request


def get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=5).read().decode()


def poll_straggler(port, seconds=60):
    """The first live persistent_straggler finding naming rank 1."""
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        try:
            report = json.loads(get(port, "/doctor"))
        except OSError:
            time.sleep(0.5)
            continue
        hits = [f for f in report["findings"]
                if f["rule"] == "persistent_straggler" and f["rank"] == 1]
        if hits:
            return hits[0]
        time.sleep(0.5)
    return None
'''

PORT_WORKER = torch_gloo.WORKER_HEAD + POLL_SRC + r'''
from horovod_tpu_torch import metrics
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.utils import live_calibration

_, specs = load_cases()
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
for i in range(30):
    out = hvd.allreduce(torch.ones(16) * i, average=False, name=f"dr.{i}")
    assert torch.equal(out, torch.full((16,), float(size * i)))
if rank == 0:
    port = basics._state.metrics_exporter.port
    if specs["expect"] == "straggler":
        named = poll_straggler(port)
        assert named is not None, "live /doctor never named rank 1"
        print("DOCTOR_HTTP " + json.dumps(named), flush=True)
    # Windows roll every second and sweeps run every 20 cycles: wait
    # until the live calibration has a window and a sweep ran since.
    end = time.monotonic() + 30
    while time.monotonic() < end:
        live = live_calibration.get()
        if live is not None and live.windows_ingested >= 2:
            break
        time.sleep(0.2)
    time.sleep(1.0)
    report = json.loads(get(port, "/doctor"))
    text = get(port, "/metrics")
    windowed = get(port, "/metrics?window=recent")
    live = live_calibration.get()
    print("DOCTOR_STATE " + json.dumps({
        "rules": sorted({f["rule"] for f in report["findings"]}),
        "findings_lines": [ln for ln in text.splitlines()
                           if ln.startswith("hvd_doctor_findings{")],
        "windowed": "hvd_controller_tick_lateness_seconds" in windowed
                    and "no completed telemetry window" not in windowed,
        "windows_ingested": live.windows_ingested if live else 0,
        "remote_ranks": sorted(metrics.remote_snapshots()),
    }), flush=True)
out = hvd.allreduce(torch.ones(2), average=False, name="dr.done")
assert torch.equal(out, torch.full((2,), float(size)))
save({"ok": torch.ones(1)})
hvd.shutdown()
print("worker ok", flush=True)
'''

JAX_WORKER = POLL_SRC + r'''
import sys

import numpy as np

import horovod_tpu as hvd
from horovod_tpu.common import basics

hvd.init()
rank, size = hvd.rank(), hvd.size()
for i in range(30):
    out = np.asarray(hvd.allreduce(np.ones(16, np.float32) * i,
                                   average=False, name=f"dr.{i}"))
    np.testing.assert_allclose(out, float(size) * i)
if rank == 0:
    named = poll_straggler(basics._state.metrics_exporter.port)
    assert named is not None, "live /doctor never named rank 1"
    print("DOCTOR_HTTP " + json.dumps(named), flush=True)
out = np.asarray(hvd.allreduce(np.ones(2, np.float32), average=False,
                               name="dr.done"))
np.testing.assert_allclose(out, float(size))
np.savez(sys.argv[2] + f".rank{rank}.npz", ok=np.ones(1))
hvd.shutdown()
print("worker ok", flush=True)
'''

KILL_SRC = r'''
def run(allreduce, install_kill, rank):
    for step in range(3):
        allreduce(step)
        if step == 2 and rank == 1:
            install_kill()
    try:
        for step in range(3, 200):
            allreduce(step)
    except RuntimeError as exc:
        print(f"postmortem error surfaced: {exc}", flush=True)
    else:
        raise AssertionError("a collective with a dead peer did not raise")
'''

PORT_KILL_WORKER = torch_gloo.WORKER_HEAD + KILL_SRC + r'''
from horovod_tpu_torch import fault

hvd.init(device="cpu")
run(lambda step: hvd.allreduce(torch.ones(4), average=False,
                               name=f"pm.{step}"),
    lambda: fault.install_plan(fault.FaultPlan.from_json(
        sys.argv[1], rank=1)), hvd.rank())
hvd.shutdown()
print("worker ok", flush=True)
'''

JAX_KILL_WORKER = KILL_SRC + r'''
import sys

import numpy as np

import horovod_tpu as hvd
from horovod_tpu import fault

hvd.init()
run(lambda step: hvd.allreduce(np.ones(4, np.float32), average=False,
                               name=f"pm.{step}"),
    lambda: fault.install_plan(fault.FaultPlan.from_json(
        sys.argv[1], rank=1)), hvd.rank())
hvd.shutdown()
print("worker ok", flush=True)
'''

STAR = {"HOROVOD_ENGINE": "python", "HOROVOD_CPU_OPS": "star"}


def _doctor_env(root, plan):
    env = {"HOROVOD_TRACE_DIR": str(root / "trace"),
           "HOROVOD_METRICS_PORT": str(torch_gloo.free_port()),
           "HOROVOD_METRICS_PUSH_CYCLES": "5",
           "HOROVOD_DOCTOR_CYCLES": "20",
           "HOROVOD_METRICS_WINDOW_SECONDS": "1"}
    if plan:
        env["HOROVOD_FAULT_PLAN"] = plan
    return env


def _kill_job(root, worker, pkg):
    """Two ranks spawned directly (the JAX package's launcher would
    tear rank 0 down when rank 1 dies, before its postmortem is
    written; both packages' jobs start the same way)."""
    root.mkdir(parents=True, exist_ok=True)
    script = root / "worker.py"
    script.write_text(worker)
    addr = f"127.0.0.1:{torch_gloo.free_port()}"
    procs = []
    for rank in range(2):
        env = torch_gloo._clean_env({
            "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": "2",
            "HOROVOD_LOCAL_RANK": str(rank), "HOROVOD_LOCAL_SIZE": "2",
            "HOROVOD_CONTROLLER_ADDR": addr, "HOROVOD_CYCLE_TIME": "1",
            "HOROVOD_FLIGHT_RECORDER": str(root / "pm" / "fr.{rank}.jsonl"),
            **STAR})
        if pkg == "port":
            env["HOROVOD_RENDEZVOUS_FILE"] = str(root / "store")
        else:
            env["JAX_PLATFORMS"] = "cpu"
        procs.append(subprocess.Popen(
            [sys.executable, str(script), KILL_PLAN], cwd=torch_gloo.REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    (root / "pm").mkdir(exist_ok=True)
    return torch_gloo.Job(procs, None, 2, TIMEOUT)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    roots = {name: tmp_path_factory.mktemp(name) for name in (
        "port_chaos", "jax_chaos", "port_healthy", "port_kill",
        "jax_kill")}
    monitor = roots["port_chaos"] / "monitor"
    # Two waves (the chaos pair, then the rest), about half the processes
    # at once, so the jobs of the files that run beside this one keep
    # their timing.
    waves = [
        {"port_chaos": lambda: torch_gloo.start_launched(
            roots["port_chaos"], 3, PORT_WORKER, {}, {"expect": "straggler"},
            env={**STAR, **_doctor_env(roots["port_chaos"], PLAN),
                 **torch_gloo.monitor_env(monitor)}, timeout=TIMEOUT),
         "jax_chaos": lambda: torch_gloo.start_reference(
            roots["jax_chaos"], 3, JAX_WORKER, {}, {},
            env=_doctor_env(roots["jax_chaos"], PLAN), timeout=TIMEOUT)},
        {"port_healthy": lambda: torch_gloo.start_launched(
            roots["port_healthy"], 3, PORT_WORKER, {}, {"expect": "healthy"},
            env={**STAR, **_doctor_env(roots["port_healthy"], None)},
            timeout=TIMEOUT),
         "port_kill": lambda: _kill_job(roots["port_kill"], PORT_KILL_WORKER,
                                        "port"),
         "jax_kill": lambda: _kill_job(roots["jax_kill"], JAX_KILL_WORKER,
                                       "jax")},
    ]
    out, started = {}, {}
    try:
        for wave in waves:
            for name, start in sorted(wave.items()):
                started[name] = start()
            for name in sorted(wave):
                job = started[name]
                if name.endswith("kill"):
                    out[name] = job.finish()
                else:
                    out[name] = job.wait()[1]
        return {"out": out, "roots": roots, "monitor": monitor}
    finally:
        for _, job in sorted(started.items()):
            job.kill()


def _tagged(text, tag):
    lines = [line.split(tag + " ", 1)[1] for line in text.splitlines()
             if tag + " " in line]
    assert lines, text[-6000:]
    return json.loads(lines[-1])


def _cli(main, path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main([str(path), "--format", "json"])
    return rc, (json.loads(buf.getvalue()) if rc != 2 else None)


def test_live_doctor_names_rank1_like_the_jax_job(jobs):
    port = _tagged(jobs["out"]["port_chaos"], "DOCTOR_HTTP")
    jax = _tagged(jobs["out"]["jax_chaos"], "DOCTOR_HTTP")
    for finding in (port, jax):
        assert finding["rule"] == "persistent_straggler"
        assert finding["rank"] == 1
        assert finding["evidence"]["source"] == "tick_lateness"
        assert finding["evidence"]["tick_lateness_p99_seconds"] >= 0.03
        assert "rank 1" in finding["hint"]
    # The severity follows the measured lateness (critical from 100 ms),
    # a timing: only the fields must agree.
    assert sorted(port["evidence"]) == sorted(jax["evidence"])
    assert {port["severity"], jax["severity"]} <= {"warning", "critical"}


def test_offline_doctor_names_rank1_like_the_jax_job(jobs):
    verdicts = {}
    for pkg, main in (("port", tcli.main), ("jax", jcli.main)):
        trace = jobs["roots"][f"{pkg}_chaos"] / "trace"
        assert (trace / "straggler_report.json").exists(), \
            sorted(p.name for p in trace.iterdir())
        rc, rep = _cli(main, trace)
        assert rc == 0 and not rep["healthy"], rep
        offline = [f for f in rep["findings"]
                   if f["rule"] == "persistent_straggler"]
        assert offline and all(f["rank"] == 1 for f in offline), rep
        verdicts[pkg] = sorted({f["evidence"]["source"] for f in offline})
        assert rep["ranks_observed"] == [0, 1, 2]
    assert verdicts["port"] == verdicts["jax"]


def test_cluster_view_windows_sweep_and_series(jobs):
    text = jobs["out"]["port_chaos"]
    state = _tagged(text, "DOCTOR_STATE")
    assert "persistent_straggler" in state["rules"]
    [line] = [ln for ln in state["findings_lines"]
              if 'rule="persistent_straggler"' in ln]
    assert float(line.rsplit(" ", 1)[1]) >= 1
    assert state["windowed"] and state["windows_ingested"] >= 1
    assert state["remote_ranks"] == [1, 2]
    assert re.search(r"doctor: \d+ finding\(s\): .*rank 1 "
                     r"persistent_straggler", text), text[-6000:]
    torch_gloo.assert_monitored(jobs["monitor"], "port", require=3,
                                context="doctor delay-chaos job")


def test_healthy_twin_raises_no_straggler(jobs):
    state = _tagged(jobs["out"]["port_healthy"], "DOCTOR_STATE")
    assert "persistent_straggler" not in state["rules"], state
    assert state["windows_ingested"] >= 1
    assert state["remote_ranks"] == [1, 2]


def _dump(root):
    path = root / "pm" / "fr.0.jsonl"
    assert path.exists(), sorted(p.name for p in (root / "pm").iterdir())
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_killed_rank_leaves_the_same_postmortem_in_both(jobs):
    kinds = {}
    for pkg in ("port", "jax"):
        codes, outputs = jobs["out"][f"{pkg}_kill"]
        assert codes == [0, -9], outputs
        assert "postmortem error surfaced" in outputs[0], outputs[0]
        events = _dump(jobs["roots"][f"{pkg}_kill"])
        assert events[0]["kind"] == "flight_recorder_dump"
        assert events[0]["rank"] == 0
        [abort] = [e for e in events if e["kind"] == "abort"]
        assert abort["dead_rank"] == 1
        assert any(e["kind"] == "fail_all" for e in events)
        kinds[pkg] = sorted({e["kind"] for e in events})
        assert not (jobs["roots"][f"{pkg}_kill"] / "pm" /
                    "fr.1.jsonl").exists()
    assert kinds["port"] == kinds["jax"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_tools_doctor_reads_the_postmortem(jobs, pkg):
    main = tcli.main if pkg == "port" else jcli.main
    rc, rep = _cli(main, jobs["roots"][f"{pkg}_kill"] / "pm")
    assert rc == 0, rep
    assert 0 in rep["ranks_observed"]
