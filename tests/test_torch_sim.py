"""The port's simulated cluster (``horovod_tpu_torch.sim``) against the
JAX package's (``horovod_tpu.sim``), on the CPU: the counterpart of
``tests/test_simcluster.py``.

* **Units**, equal as data on the same plans and seeds: the fault
  driver's schedule, ``sim_supported_plan``'s refusals,
  ``expected_diagnoses``, the scenario judge and the linear fit.
* **Harness**: each scenario runs on both packages' ``SimCluster`` (the
  port's real coordinator under multiplexed workers, rank 0 on CPU torch
  tensors; on the serial driver and on shard threads) and gives the same
  epochs, sizes, collective results, membership counters and aborts,
  with protocheck at zero violations.
* **Acceptance**: the 64-rank seeded storm (flapping-NIC straggler,
  kills, a leave, a rack kill, joiners) settles to the same world in
  both packages, and each doctor names the straggler (rank 5) and the
  most-departed rank (9). The 256-rank variant stays ``slow``.
* **CLI**: ``tools.simcluster`` gives the JAX tool's exit codes and
  verdicts. The live overlap check runs at 8 ranks.

Everything here is exact (integer-valued float sums, seeded schedules);
the overlap check keeps the JAX test's 0.25 model-vs-measured bound.
"""

import json

import numpy as np
import pytest

from mp_harness import counter_by_label

import horovod_tpu.sim as jsim
import horovod_tpu_torch.sim as tsim
from horovod_tpu.sim import faults as jfaults
from horovod_tpu.sim import scenario as jscenario
from horovod_tpu.utils import scaling_model as jsm
from horovod_tpu_torch.sim import faults as tfaults
from horovod_tpu_torch.sim import scenario as tscenario
from horovod_tpu_torch.utils import scaling_model as tsm

PKGS = {"jax": jsim, "port": tsim}


def test_public_surface_matches_jax():
    assert tsim.__all__ == jsim.__all__


# ---------------------------------------------------------------------------
# Units


SCHEDULE_PLAN = json.dumps({"seed": 7, "faults": [
    {"site": "cycle", "action": "kill", "rank": 3, "at": 2},
    {"site": "cycle", "action": "group_kill", "ranks": [5, 6], "at": 4},
    {"site": "cycle", "action": "leave", "rank": 7, "at": 4},
    {"site": "cycle", "action": "join", "rank": 1, "at": 5},
    {"site": "cycle", "action": "delay", "rank": 2, "at": 1, "times": 3,
     "seconds": 0.02, "jitter": 0.5},
]})


def _schedule(mod):
    driver = mod.SimFaultDriver.from_json(SCHEDULE_PLAN)
    rows = []
    for cycle in range(1, 6):
        f = driver.faults_for_cycle(cycle, list(range(1, 9)))
        rows.append((sorted(f.kills), sorted(f.leaves), f.joins,
                     sorted(f.delays.items())))
    return rows


def test_fault_driver_schedule_equal_as_data():
    assert _schedule(tsim) == _schedule(jsim)
    assert _schedule(tsim)[3][0] == [5, 6]


@pytest.mark.parametrize("rule", [
    dict(site="wire_send", action="drop", at=1),
    dict(site="cycle", action="raise", at=1)])
def test_unsupported_rules_refused_alike(rule):
    from horovod_tpu.fault.plan import FaultRule as JRule
    from horovod_tpu_torch.fault.plan import FaultRule as TRule

    errors = []
    for rule_cls, mod in ((JRule, jsim), (TRule, tsim)):
        with pytest.raises(ValueError) as exc:
            mod.SimFaultDriver([rule_cls(**rule)])
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


DIAG_PLAN = json.dumps({"faults": [
    {"site": "cycle", "action": "delay", "rank": 5, "at": 1, "times": 30,
     "seconds": 0.03},
    {"site": "cycle", "action": "delay", "rank": 6, "at": 1, "times": 30,
     "seconds": 0.004},
    {"site": "cycle", "action": "kill", "rank": 9, "at": 4},
    {"site": "cycle", "action": "group_kill", "ranks": [20, 21], "at": 8},
    {"site": "cycle", "action": "kill", "rank": 9, "at": 12},
    {"site": "cycle", "action": "join", "rank": 1, "at": 14},
    {"site": "cycle", "action": "leave", "at": 20, "times": 3},
]})


@pytest.mark.parametrize("cycles", [3, 19, 34])
def test_expected_diagnoses_equal(cycles):
    want = jsim.expected_diagnoses(jfaults.load_rules(DIAG_PLAN)[0], cycles)
    got = tsim.expected_diagnoses(tfaults.load_rules(DIAG_PLAN)[0], cycles)
    assert got == want


@pytest.mark.parametrize("findings", [
    [{"rule": "persistent_straggler", "rank": 5},
     {"rule": "membership_churn", "rank": 9}],
    [{"rule": "membership_churn", "rank": 3}],
    []])
def test_scenario_judge_equal(findings):
    expected = {"straggler_ranks": [5], "churn": True, "most_departed": 9,
                "departures": {9: 2}}
    out = []
    for mod in (jscenario, tscenario):
        problems = []
        mod._judge_diagnoses([dict(f, severity="warning", summary="s")
                              for f in findings], expected, problems)
        out.append(problems)
    assert out[0] == out[1]


@pytest.mark.parametrize("points", [
    {8: 1.8, 16: 2.6, 32: 4.2, 64: 7.4}, {8: 2.0, 64: 1.0}, {32: 6.4}])
def test_linear_fit_equal(points):
    assert tsm.fit_linear(points) == jsm.fit_linear(points)
    assert tsm.fit_linear_relative(points) == jsm.fit_linear_relative(points)


# ---------------------------------------------------------------------------
# Harness: the same scenario on both packages


def _ones(r):
    return np.ones(1, np.float32)


def _collectives(mod, driver_threads=1):
    from_rank = {"ar": lambda r: np.array([r + 1.0, 2.0], np.float32),
                 "ag": lambda r: np.array([[r]], np.int64),
                 "bc": lambda r: (np.array([3.5], np.float32) if r == 7
                                  else np.zeros(1, np.float32))}
    with mod.SimCluster(ranks=64, elastic=False,
                        driver_threads=driver_threads) as c:
        res = c.run_step([
            mod.allreduce_spec("ar", from_rank["ar"]),
            mod.StepSpec("allgather", "ag", from_rank["ag"]),
            mod.StepSpec("broadcast", "bc", from_rank["bc"], root_rank=7)])
        out = {k: v.tolist() for k, v in sorted(res.results0.items())}
        for rank in sorted(c.workers):
            w = c.workers[rank]
            for name in ("ar", "ag", "bc"):
                np.testing.assert_array_equal(w.results[name],
                                              res.results0[name])
    return out, c.protocheck_report


def _kill_join(mod):
    seen = []
    with mod.SimCluster(ranks=8, elastic=True) as c:
        c.run_step([mod.allreduce_spec("warm", _ones)])
        c.kill(3)
        res = c.run_step([mod.allreduce_spec("shrunk", _ones)])
        seen.append((c.epoch, c.size, float(res.results0["shrunk"][0])))
        c.spawn_joiner()
        res = c.run_step([mod.allreduce_spec("regrown", _ones)])
        seen.append((c.epoch, c.size, float(res.results0["regrown"][0]),
                     sorted(c.workers)))
    snap = c.final_metrics
    seen.append(counter_by_label(snap, "hvd_membership_transitions_total"))
    seen.append(counter_by_label(snap,
                                 "hvd_membership_rank_departures_total"))
    return seen, c.protocheck_report


def _parked(mod):
    seen = []
    with mod.SimCluster(ranks=6, elastic=True, max_ranks=6) as c:
        c.spawn_joiner()
        for k in range(4):
            res = c.run_step([mod.allreduce_spec(f"parked.{k}", _ones)])
            seen.append((c.epoch, float(res.results0[f"parked.{k}"][0])))
        seen.append(c.controller._service.parked_joiner_count())
        c.kill(5)
        res = c.run_step([mod.allreduce_spec("swapped", _ones)])
        seen.append((c.size, c.epoch >= 2,
                     float(res.results0["swapped"][0]),
                     c.controller._service.parked_joiner_count()))
    return seen, c.protocheck_report


def _abort(mod):
    with mod.SimCluster(ranks=6, elastic=False) as c:
        c.run_step([mod.allreduce_spec("warm", _ones)])
        c.kill(2)
        res = c.step([mod.allreduce_spec("doomed", _ones)])
        dead = sorted({w.abort.dead_rank for _, w in sorted(c.workers.items())
                       if w.abort is not None})
    return (res.aborted, dead), c.protocheck_report


def _dropped_tick(mod):
    with mod.SimCluster(ranks=4, elastic=False, comm_timeout=1.0) as c:
        c.run_step([mod.allreduce_spec("warm", _ones)])
        res = c.step([mod.allreduce_spec("dropped", _ones)],
                     skip_ticks={2})
        dead = [c.workers[r].abort.dead_rank for r in (1, 3)]
    trips = counter_by_label(c.final_metrics,
                             "hvd_wire_deadline_trips_total")
    return (res.aborted, dead, trips.get("recv", 0) >= 1), \
        c.protocheck_report


def _rack_kill(mod):
    plan = json.dumps({"faults": [
        {"site": "cycle", "action": "group_kill", "ranks": [8, 9, 10, 11],
         "at": 2}]})
    driver = mod.SimFaultDriver.from_json(plan)
    sums = []
    with mod.SimCluster(ranks=16, elastic=True) as c:
        for cycle in (1, 2, 3):
            f = driver.faults_for_cycle(cycle, c.alive_worker_ranks)
            for rank in sorted(f.kills):
                c.kill(rank)
            res = c.run_step([mod.allreduce_spec(f"rack.{cycle}", _ones)])
            sums.append((float(res.results0[f"rack.{cycle}"][0]), c.size))
        epoch_moved = c.epoch >= 2
    departures = counter_by_label(c.final_metrics,
                                  "hvd_membership_rank_departures_total")
    return (sums, epoch_moved,
            sorted(r for r in departures if departures[r] > 0)), \
        c.protocheck_report


def _cache_hits(mod):
    sums = []
    with mod.SimCluster(ranks=6, elastic=True) as c:
        for _ in range(6):
            res = c.run_step([mod.allreduce_spec(
                "same.tensor", lambda r: np.ones(4, np.float32))])
            sums.append(float(res.results0["same.tensor"][0]))
    hits = counter_by_label(c.final_metrics,
                            "hvd_controller_cache_hits_total")
    misses = counter_by_label(c.final_metrics,
                              "hvd_controller_cache_misses_total")
    return (sums, sum(hits[k] for k in sorted(hits)) >= 4,
            sum(misses[k] for k in sorted(misses)) >= 1), \
        c.protocheck_report


def _threaded_rack_kill(mod):
    """The 16-rank rack kill with the lockstep phases on 4 shard
    threads."""
    plan = json.dumps({"faults": [
        {"site": "cycle", "action": "group_kill", "ranks": [8, 9, 10, 11],
         "at": 2}]})
    driver = mod.SimFaultDriver.from_json(plan)
    sums = []
    with mod.SimCluster(ranks=16, elastic=True, driver_threads=4) as c:
        for cycle in (1, 2, 3):
            f = driver.faults_for_cycle(cycle, c.alive_worker_ranks)
            for rank in sorted(f.kills):
                c.kill(rank)
            res = c.run_step([mod.allreduce_spec(f"rack.{cycle}", _ones)])
            sums.append((float(res.results0[f"rack.{cycle}"][0]), c.size))
    return sums, c.protocheck_report


SCENARIOS = {"collectives_64": _collectives,
             "collectives_64_threaded": lambda mod: _collectives(mod, 8),
             "threaded_rack_kill": _threaded_rack_kill,
             "kill_then_join": _kill_join,
             "parked_at_max_ranks": _parked, "nonelastic_abort": _abort,
             "dropped_tick": _dropped_tick, "rack_kill": _rack_kill,
             "cache_hits": _cache_hits}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    got = {}
    for pkg, mod in sorted(PKGS.items()):
        seen, report = SCENARIOS[name](mod)
        assert report["ok"] and report["transitions"] > 0, (pkg, report)
        got[pkg] = seen
    assert got["port"] == got["jax"]


def test_scenario_outcomes_are_the_expected_ones():
    """The port's values themselves (the JAX test's assertions)."""
    seen, _ = _kill_join(tsim)
    assert seen[:2] == [(2, 7, 7.0), (3, 8, 8.0, list(range(1, 8)))]
    assert seen[2]["shrink"] >= 1 and seen[2]["grow"] >= 1
    assert seen[3]["3"] >= 1
    out, _ = _collectives(tsim)
    assert out["ar"] == [float(sum(range(1, 65))), 128.0]
    assert [row[0] for row in out["ag"]] == list(range(64))
    assert out["bc"] == [3.5]


# ---------------------------------------------------------------------------
# Acceptance: the seeded storm

STORM_PLAN = {"seed": 13, "faults": [
    {"site": "cycle", "action": "delay", "rank": 5, "at": 1, "times": 30,
     "seconds": 0.03},
    {"site": "cycle", "action": "kill", "rank": 9, "at": 6},
    {"site": "cycle", "action": "leave", "rank": 20, "at": 10},
    {"site": "cycle", "action": "group_kill", "ranks": [40, 41, 42, 43],
     "at": 14},
    {"site": "cycle", "action": "join", "rank": 1, "at": 16},
    {"site": "cycle", "action": "join", "rank": 1, "at": 18},
    {"site": "cycle", "action": "kill", "rank": 9, "at": 22},
]}


def _storm(mod, ranks, steps=34):
    driver = mod.SimFaultDriver.from_json(json.dumps(STORM_PLAN))
    result = mod.run_scenario(ranks, driver, steps=steps)
    assert result.ok, "\n".join(result.problems)
    assert result.transitions > 0 and not result.violations
    stragglers = {f["rank"] for f in result.findings
                  if f["rule"] == "persistent_straggler"}
    churn = {f["rank"] for f in result.findings
             if f["rule"] == "membership_churn"}
    assert 5 in stragglers and 9 in churn, result.findings
    return result


def test_64_rank_storm_matches_jax():
    want = _storm(jsim, 64)
    got = _storm(tsim, 64)
    assert (got.final_size, got.final_epoch) == \
        (want.final_size, want.final_epoch) == (59, want.final_epoch)
    assert got.final_epoch >= 6
    assert got.expected == want.expected


@pytest.mark.slow
def test_256_rank_storm_on_the_port():
    assert _storm(tsim, 256).final_size == 251


# ---------------------------------------------------------------------------
# The live overlap check and the CLI


def test_overlap_model_validated_live_at_8_ranks():
    from horovod_tpu_torch.sim.measure import run_overlap_probe

    row = run_overlap_probe(8, grads=8, grad_elems=4096, interval_s=0.004)
    assert row["buckets"] >= 2
    assert 0.0 < row["overlap_efficiency"] <= 1.0
    assert row["model_vs_measured_diff"] <= 0.25, row


def _cli(mod_name, argv, capsys):
    import importlib

    rc = importlib.import_module(mod_name).main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--ranks", "8", "--steps", "4"],
    ["--ranks", "4", "--steps", "4", "--json", "--plan", json.dumps(
        {"faults": [{"site": "cycle", "action": "group_kill",
                     "ranks": [1, 2, 3], "at": 2}]})],
    ["--ranks", "6", "--steps", "5", "--json", "--plan", json.dumps(
        {"faults": [{"site": "cycle", "action": "kill", "rank": 3,
                     "at": 2}]})]],
    ids=["clean", "total_rack_loss", "kill"])
def test_tools_simcluster_matches_jax(argv, capsys):
    jrc, jout = _cli("horovod_tpu.tools.simcluster", argv, capsys)
    trc, tout = _cli("horovod_tpu_torch.tools.simcluster", argv, capsys)
    assert trc == jrc == 0, tout
    if "--json" in argv:
        got, want = json.loads(tout), json.loads(jout)
        for key in ("final_size", "final_epoch", "problems", "violations",
                    "expected"):
            assert got.get(key) == want.get(key), key
    else:
        assert "8 logical ranks" in tout and "0 violation(s)" in tout


def test_tools_simcluster_plan_file_and_listing(tmp_path, capsys):
    from horovod_tpu_torch import tools

    assert "simcluster" in tools.__doc__
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "cycle", "action": "kill", "rank": 3, "at": 2}]}))
    rc, out = _cli("horovod_tpu_torch.tools.simcluster",
                   ["--ranks", "6", "--steps", "5", "--plan", f"@{plan}",
                    "--json"], capsys)
    verdict = json.loads(out)
    assert rc == 0 and verdict["final_size"] == 5 and \
        verdict["final_epoch"] == 2
