"""Elastic membership across real ranks on the CPU: jobs under the port's
``horovodrun --elastic`` (``python -m horovod_tpu_torch.run``) beside the
same jobs under the JAX package's (``python -m horovod_tpu.run``).

The scenarios are torch rewrites of ``tests/mp_worker.py``'s elastic ones,
made deterministic by aligning each membership change to a step: a
3-rank job whose rank 2 is SIGKILLed, or leaves gracefully (exit 0), at
the start of step 3; a 2-rank job that waits at step 3 for a joiner the
test starts (once more under ``HOROVOD_ELASTIC_RESTORE=broadcast``); a
2-rank job at ``--max-ranks 2`` that keeps training while a joiner stays
parked. Every step allreduces an integer (each rank's rank + 1, summed)
and a float32 average of seeded draws into the state. Each package's job
must give the same epoch and size series, the same integer sums, the
same final state on every member (bit for bit; the joiner's included,
restored over the p2p shard plane or by rank 0's broadcast) and the same
membership counters on rank 0; the port's job must equal the JAX job's.

Then the launcher: the elastic rank environment (the Python engine
pinned, the ring addresses scrubbed, the join flag only for a respawn)
against the JAX launcher's, the flag errors; and one tiny-Llama job
(``examples/elastic_llama_training.py``, 2 layers, dim 64, f32) through
a kill and a respawn, whose final weights must equal a one-process
replay of the schedule rank 0 logs, with the joiner fetching every shard
and rank 0 moving none. Each job has its own time limit."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from horovod_tpu.run import launch as jlaunch
from horovod_tpu_torch.run import launch as tlaunch

from torch_gloo import REPO, _clean_env, free_port

STEPS = 8
AT = 3          # the step at which membership changes
JOB_LIMIT = 100  # seconds a job (both packages' run concurrently)

WORKER = r'''
import json
import os
import signal
import sys
import time

import numpy as np

PKG, SCEN, OUT = sys.argv[1], sys.argv[2], sys.argv[3]
STEPS, AT = int(sys.argv[4]), int(sys.argv[5])
if PKG == "jax":
    import horovod_tpu as hvd
    from horovod_tpu.common import basics
    from horovod_tpu.fault import plan as plan_mod

    hvd.init()

    def t(a):
        return np.ascontiguousarray(a)

    def arr(x):
        return np.asarray(x)
else:
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.fault import plan as plan_mod

    hvd.init(device="cpu")

    def t(a):
        return torch.from_numpy(np.array(a))

    def arr(x):
        return x.numpy() if hasattr(x, "numpy") else np.asarray(x)

joiner = os.environ.get("HOROVOD_ELASTIC_JOIN") == "1"
role = "joiner" if joiner else f"rank{hvd.rank()}"
state = hvd.elastic.State(step=0, w=t(np.zeros(4, np.float32)),
                          n=t(np.zeros(3, np.int32)),
                          series=t(np.zeros((STEPS, 4), np.int32)))


def draw(step, rank):
    return np.random.RandomState([step, rank]).randn(4).astype(np.float32)


def until(cond, what):
    deadline = time.monotonic() + 60.0
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{role}: {what} never happened")
        time.sleep(0.02)


@hvd.elastic.run
def train(state):
    while state.step < STEPS:
        step = state.step
        if step == AT and not joiner:
            if SCEN in ("kill", "leave") and hvd.rank() == 2:
                sys.stdout.flush()
                if SCEN == "kill":
                    os.kill(os.getpid(), signal.SIGKILL)
                plan_mod._graceful_leave()
            if SCEN == "join":
                if hvd.rank() == 0:
                    open(OUT + ".ready", "w").close()
                until(lambda: hvd.size() == 3, "the grow")
            if SCEN == "parked" and hvd.rank() == 0:
                open(OUT + ".ready", "w").close()
                service = basics.controller()._service
                until(lambda: service.parked_joiner_count() == 1,
                      "the parked joiner")
        total = arr(hvd.allreduce(t(np.full(3, hvd.rank() + 1, np.int32)),
                                  average=False, name=f"el.n.{step}"))
        avg = arr(hvd.allreduce(t(draw(step, hvd.rank())), average=True,
                                name=f"el.w.{step}"))
        series = arr(state.series).copy()
        series[step] = [step, hvd.size(), hvd.elastic.epoch(), total[0]]
        state.w = t(arr(state.w) + avg)
        state.n = t(arr(state.n) + total)
        state.series = t(series)
        state.step = step + 1
        state.commit()


train(state)
final = hvd.allgather_object(
    (arr(state.w).tobytes().hex(), arr(state.n).tolist(),
     arr(state.series).tolist()), name="el.final")
record = {"role": role, "rank": hvd.rank(), "size": hvd.size(),
          "epoch": hvd.elastic.epoch(), "final": final,
          "w": arr(state.w).tolist(), "n": arr(state.n).tolist(),
          "series": arr(state.series).tolist()}
if hvd.rank() == 0:
    snap = hvd.metrics.snapshot()
    record["counters"] = {
        name: {(tuple(labels)[0] if labels else ""): value
               for labels, value in (snap.get(name) or {}).get("values", [])}
        for name in ("hvd_membership_transitions_total",
                     "hvd_membership_rank_departures_total",
                     "hvd_membership_epoch", "hvd_membership_size")}
with open(f"{OUT}.{role}.json", "w") as f:
    json.dump(record, f)
print(f"{role} ok", flush=True)
hvd.shutdown()
'''


def _env(pkg, extra=None):
    env = _clean_env({"HOROVOD_CYCLE_TIME": "1", "HOROVOD_METRICS": "1",
                      "HOROVOD_PARENT_WATCHDOG": "0"})
    if pkg == "jax":
        env["JAX_PLATFORMS"] = "cpu"
    env.update(extra or {})
    return env


def _start(tmp_path, pkg, scen, np_, flags, secret=None, addr=None,
           restore="p2p"):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = str(tmp_path / f"{pkg}.{scen}")
    launcher = "horovod_tpu.run" if pkg == "jax" else "horovod_tpu_torch.run"
    extra = {"HOROVOD_ELASTIC_RESTORE": restore}
    if secret:
        extra["HOROVOD_SECRET_KEY"] = secret
    cmd = [sys.executable, "-m", launcher, "--elastic", "-np", str(np_),
           *flags, *(["--controller-addr", addr] if addr else []),
           sys.executable, str(script), pkg, scen, out, str(STEPS), str(AT)]
    proc = subprocess.Popen(cmd, cwd=REPO, env=_env(pkg, extra),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, script


def _joiner(script, pkg, scen, out, secret, addr, restore="p2p"):
    env = _env(pkg, {"HOROVOD_SECRET_KEY": secret, "HOROVOD_ELASTIC": "1",
                     "HOROVOD_ELASTIC_RESTORE": restore,
                     "HOROVOD_ELASTIC_JOIN": "1", "HOROVOD_ENGINE": "python",
                     "HOROVOD_CONTROLLER_ADDR": addr, "HOROVOD_RANK": "2",
                     "HOROVOD_SIZE": "3", "HOROVOD_LOCAL_RANK": "0",
                     "HOROVOD_LOCAL_SIZE": "1"})
    return subprocess.Popen(
        [sys.executable, str(script), pkg, scen, out, str(STEPS), str(AT)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(procs, deadline):
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            outs.append(proc.communicate()[0] + "\n[timed out]")
    return outs


def _records(out, roles):
    recs = {}
    for role in roles:
        with open(f"{out}.{role}.json") as f:
            recs[role] = json.load(f)
    return recs


def run_scenario(tmp_path, scen, restore="p2p"):
    """Both packages' jobs of ``scen`` at once, restoring by ``restore``;
    returns their records (role -> record) as {"jax": ..., "port": ...}."""
    np_ = 3 if scen in ("kill", "leave") else 2
    flags = ["--elastic-respawns", "0"]
    if scen in ("kill", "leave"):
        flags += ["--min-ranks", "2"]
    if scen == "parked":
        flags += ["--max-ranks", "2"]
    deadline = time.monotonic() + JOB_LIMIT
    jobs = {}
    for pkg in ("jax", "port"):
        secret, addr = os.urandom(32).hex(), f"127.0.0.1:{free_port()}"
        proc, out, script = _start(tmp_path, pkg, scen, np_, flags,
                                   secret, addr, restore)
        jobs[pkg] = [proc, out, script, secret, addr, None]
    if scen in ("join", "parked"):
        pending = dict(jobs)
        while pending:
            for pkg, job in sorted(pending.items()):
                if os.path.exists(job[1] + ".ready"):
                    job[5] = _joiner(job[2], pkg, scen, job[1], job[3],
                                     job[4], restore)
                    del pending[pkg]
            assert time.monotonic() < deadline, "no job reached the step"
            time.sleep(0.05)
    results = {}
    for pkg, (proc, out, _s, _k, _a, joiner) in sorted(jobs.items()):
        procs = [proc] + ([joiner] if joiner and scen == "join" else [])
        outs = _finish(procs, deadline)
        text = "\n".join(outs)
        assert all(p.returncode == 0 for p in procs), f"{pkg}:\n{text[-6000:]}"
        if joiner is not None and scen == "parked":
            if joiner.poll() is None:
                joiner.kill()
            jout = joiner.communicate()[0]
            assert "CommTimeoutError" not in jout, jout
        roles = {"kill": ["rank0", "rank1"], "leave": ["rank0", "rank1"],
                 "join": ["rank0", "rank1", "joiner"],
                 "parked": ["rank0", "rank1"]}[scen]
        results[pkg] = _records(out, roles)
    return results


def _series(size_before, size_after, epoch_after):
    rows = []
    for step in range(STEPS):
        size, epoch = (size_before, 1) if step < AT else \
            (size_after, epoch_after)
        rows.append([step, size, epoch, size * (size + 1) // 2])
    return rows


EXPECT = {
    "kill": (_series(3, 2, 2), {"shrink": 1.0}, {"2": 1.0}, 2.0, 2.0),
    "leave": (_series(3, 2, 2), {"shrink": 1.0}, {"2": 1.0}, 2.0, 2.0),
    "join": (_series(2, 3, 2), {"grow": 1.0}, {}, 2.0, 3.0),
    "parked": (_series(2, 2, 1), {}, {}, 1.0, 2.0),
}


@pytest.mark.parametrize("scen,restore", [
    *((scen, "p2p") for scen in sorted(EXPECT)), ("join", "broadcast")])
def test_elastic_scenario_matches_jax(tmp_path, scen, restore):
    results = run_scenario(tmp_path, scen, restore)
    series, transitions, departures, epoch, size = EXPECT[scen]
    for pkg, recs in sorted(results.items()):
        for role, rec in sorted(recs.items()):
            assert rec["series"] == series, (pkg, role, rec["series"])
            assert (rec["epoch"], rec["size"]) == (int(epoch), int(size))
            # Every member's final state, bit for bit (the float32 bytes).
            assert all(f == rec["final"][0] for f in rec["final"]), (
                pkg, role)
            assert len(rec["final"]) == size
            assert rec["n"] == [sum(r[3] for r in series)] * 3
        counters = recs["rank0"]["counters"]
        assert counters["hvd_membership_transitions_total"] == transitions
        assert counters["hvd_membership_rank_departures_total"] == \
            departures
        assert counters["hvd_membership_epoch"] == {"": epoch}
        assert counters["hvd_membership_size"] == {"": size}
    for role in results["port"]:
        jrec, trec = results["jax"][role], results["port"][role]
        assert trec["final"] == jrec["final"]
        assert trec["w"] == jrec["w"] and trec["n"] == jrec["n"]
    assert results["port"]["rank0"]["counters"] == \
        results["jax"]["rank0"]["counters"]


# ---------------------------------------------------------------------------
# The launcher


def test_build_rank_env_elastic_matches_jax():
    base = {"HOROVOD_RING_ADDRS": "stale:1", "HOROVOD_ELASTIC_JOIN": "1",
            "HOROVOD_LOCAL_RING_ADDRS": "s:2", "HOROVOD_CROSS_RING_ADDRS":
            "s:3"}
    common = dict(rank=1, size=3, local_rank=1, local_size=3, cross_rank=0,
                  cross_size=1, controller_addr="127.0.0.1:1", secret="ab",
                  bind_chips=False)
    for join in (False, True):
        j = jlaunch.build_rank_env(dict(base), elastic=True, min_ranks=2,
                                   max_ranks=4, elastic_join=join, **common)
        t = tlaunch.build_rank_env(dict(base), elastic=True, min_ranks=2,
                                   max_ranks=4, elastic_join=join, **common)
        keys = ("HOROVOD_ELASTIC", "HOROVOD_ELASTIC_MIN_RANKS",
                "HOROVOD_ELASTIC_MAX_RANKS", "HOROVOD_ENGINE",
                "HOROVOD_ELASTIC_JOIN", "HOROVOD_RING_ADDRS",
                "HOROVOD_LOCAL_RING_ADDRS", "HOROVOD_CROSS_RING_ADDRS")
        assert {k: t.get(k) for k in keys} == {k: j.get(k) for k in keys}
        assert t["HOROVOD_ENGINE"] == "python"
        assert ("HOROVOD_ELASTIC_JOIN" in t) == join
    static = tlaunch.build_rank_env({"HOROVOD_ELASTIC": "1"}, **common)
    assert "HOROVOD_ELASTIC" not in static


@pytest.mark.parametrize("argv", [
    ["-np", "2", "--spmd", "--elastic", "true"],
    ["-np", "2", "--elastic", "--min-ranks", "5", "true"]])
def test_launcher_refuses_bad_elastic_flags(argv, capsys):
    for mod in (jlaunch, tlaunch):
        with pytest.raises(SystemExit) as exc:
            mod.main(argv)
        assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--elastic" in err or "--min-ranks" in err


def test_elastic_launch_exports_no_store_and_respawns(tmp_path):
    """A 2-rank elastic job whose rank 1 exits 7 once: the launcher
    respawns the slot as a joiner with the elastic environment (no
    process-group store, no ring addresses), and the coordinator's clean
    exit ends the job with 0."""
    script = tmp_path / "probe.py"
    script.write_text(
        "import os, sys, time\n"
        "keys = ('HOROVOD_ELASTIC', 'HOROVOD_ENGINE', 'HOROVOD_ELASTIC_JOIN',"
        " 'HOROVOD_SPMD_COORDINATOR', 'HOROVOD_RING_ADDRS')\n"
        "print('ENV', os.environ['HOROVOD_RANK'],"
        " [os.environ.get(k) for k in keys], flush=True)\n"
        "if os.environ['HOROVOD_RANK'] == '1' and"
        " 'HOROVOD_ELASTIC_JOIN' not in os.environ:\n"
        "    sys.exit(7)\n"
        "time.sleep(1.0 if os.environ['HOROVOD_RANK'] == '0' else 0)\n")
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "--elastic", "-np",
         "2", "--elastic-respawns", "1", sys.executable, str(script)],
        cwd=REPO, env=_env("port"), capture_output=True, text=True,
        timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "respawning its slot as an elastic joiner" in res.stderr
    lines = sorted(line.split("ENV ", 1)[1] for line in
                   res.stdout.splitlines() if "ENV " in line)
    assert lines == [
        "0 ['1', 'python', None, None, None]",
        "1 ['1', 'python', '1', None, None]",
        "1 ['1', 'python', None, None, None]"]


# ---------------------------------------------------------------------------
# Tiny Llama through a kill and a respawn, against a replay


def test_tiny_llama_kill_and_respawn_matches_replay(tmp_path):
    from horovod_tpu_torch.examples import elastic_llama_training as ex

    out = tmp_path / "llama"
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "--elastic", "-np",
         "2", "--min-ranks", "1", "--max-ranks", "2", "--elastic-respawns",
         "1", sys.executable, "-m",
         "horovod_tpu_torch.examples.elastic_llama_training", "--model",
         "tiny", "--seq-len", "64", "--batch-size", "2", "--device", "cpu",
         "--pace-seconds", "1", "--deadline", "90",
         "--out", str(out)],
        cwd=REPO, env=_env("port"), capture_output=True, text=True,
        timeout=JOB_LIMIT)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-3000:]
    recs = {}
    for role in ("rank0", "joiner", "kill"):
        recs[role] = json.loads((out / f"{role}.json").read_text())
    r0, joiner = recs["rank0"], recs["joiner"]
    assert [(r["epoch"], r["size"], r["lost"], r["joined"])
            for r in r0["reshapes"]] == [(2, 1, [1], 0), (3, 2, [], 1)]
    assert r0["started"] > r0["final_step"]  # a step rolled back
    assert r0["schedule"][:2] == [2, 2] and r0["schedule"][-2:] == [2, 2]
    assert 1 in r0["schedule"]
    grow_j = [r for r in joiner["restores"] if r["epoch"] == 3][0]
    grow_0 = [r for r in r0["restores"] if r["epoch"] == 3][0]
    assert grow_j["mode"] == grow_0["mode"] == "p2p"
    assert grow_j["fetched_shards"] == grow_j["shards"] >= 1
    assert grow_j["fetched_bytes"] == joiner["commit_bytes"]
    assert grow_0["fetched_bytes"] == 0 and grow_0["local_bytes"] > 0
    assert joiner["grow_entry"]["digests"] == \
        r0["grow_entry"]["authority"] == r0["grow_entry"]["digests"]
    want = ex.replay("tiny", r0["schedule"], 2, 64, 0, "cpu")
    got = torch.load(out / "final.pt")
    for name, w in sorted(want.items()):
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=name)
