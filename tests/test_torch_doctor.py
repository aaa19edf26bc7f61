"""The port's cluster doctor against the JAX package's, on the CPU.

The same evidence goes through both packages: registry snapshots built
from numpy-seeded observations by each package's own
``MetricsRegistry`` (the snapshots themselves must be equal), straggler
reports, clock tables, flight-recorder postmortems, telemetry windows
and calibration artifacts. Every rule of ``ALL_RULES`` must give the
same ``Diagnosis.to_dict()`` list on every case (the cases are those of
``tests/test_doctor.py`` plus the serving, fleet, churn and capacity
rules'), and ``diagnose``, ``report``, ``summary``, ``render_text`` and
``periodic_line`` must agree too. Then ``Evidence.from_artifacts`` over
artifact directories, ``tools.doctor``'s output and exit codes, the
flight recorder's JSONL line for line (less timestamps),
``expand_rank_path``, and the exporter's ``/metrics``, ``?window=`` and
``/doctor`` routes served by a port process.

The only text allowed to differ is a module path: the JAX package's
``horovod_tpu.`` reads ``horovod_tpu_torch.`` in the port's hints."""

import copy
import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from horovod_tpu import doctor as jdoctor
from horovod_tpu import metrics as jmetrics
from horovod_tpu.common import wire as jwire
from horovod_tpu.doctor import rules as jrules
from horovod_tpu.metrics import recorder as jrecorder
from horovod_tpu.tools import doctor as jcli
from horovod_tpu.utils import scaling_model as jsm
from horovod_tpu_torch import doctor as tdoctor
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.common import wire as twire
from horovod_tpu_torch.doctor import rules as trules
from horovod_tpu_torch.metrics import recorder as trecorder
from horovod_tpu_torch.tools import doctor as tcli

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ENV_VARS = ("HOROVOD_METRICS", "HOROVOD_METRICS_PORT",
            "HOROVOD_FLIGHT_RECORDER", "HOROVOD_TRACE_DIR", "HOROVOD_RANK",
            "HOROVOD_SIZE", "HOROVOD_RESTART_EPOCH",
            "HOROVOD_CAPACITY_CALIBRATION", "HOROVOD_FLIGHT_RECORDER_SAMPLE",
            "HOROVOD_FLIGHT_RECORDER_CAPACITY")


@pytest.fixture(autouse=True)
def _fresh_metrics(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    jmetrics.reset_for_tests()
    tmetrics.reset_for_tests()
    yield
    jmetrics.reset_for_tests()
    tmetrics.reset_for_tests()


def norm(obj):
    """JSON-clean view with the JAX package's module path re-rooted."""
    return json.loads(json.dumps(obj, sort_keys=True, default=str).replace(
        "horovod_tpu.", "horovod_tpu_torch."))


PKGS = {"jax": (jmetrics.MetricsRegistry, jdoctor.Evidence),
        "port": (tmetrics.MetricsRegistry, tdoctor.Evidence)}


# ---------------------------------------------------------------------------
# Evidence builders: ``R`` is one package's registry class; the data are
# drawn from numpy generators seeded per case, so both packages' builds
# see identical numbers.


def _hist(R, name, per_label, labelnames=("rank",)):
    r = R()
    h = r.histogram(name, "", labelnames)
    for label, observations in sorted(per_label.items()):
        child = h.labels(label) if labelnames else h
        for value in observations:
            child.observe(float(value))
    return r.snapshot()


def _counter(R, name, per_label, labelnames=("side",)):
    r = R()
    c = r.counter(name, "", labelnames)
    for label, value in sorted(per_label.items()):
        (c.labels(label) if labelnames else c).inc(value)
    return r.snapshot()


def _gauges(R, values, labelled=None):
    r = R()
    for name, value in sorted(values.items()):
        r.gauge(name, "").set(value)
    for name, (labelname, per_label) in sorted((labelled or {}).items()):
        g = r.gauge(name, "", (labelname,))
        for label, value in sorted(per_label.items()):
            g.labels(label).set(value)
    return r.snapshot()


def _merge(*snaps):
    out = {}
    for snap in snaps:
        out.update(snap)
    return out


def _rng(seed):
    return np.random.RandomState(seed)


def _straggler_report(collectives=200, late_rank=1, p99=0.05, cycles=None):
    cycles = collectives if cycles is None else cycles
    per_rank = {}
    for rank in range(3):
        late = rank == late_rank
        per_rank[str(rank)] = {
            "straggler_cycles": cycles if late else 0,
            "lateness_p50_seconds": p99 * 0.9 if late else 0.0,
            "lateness_p99_seconds": p99 if late else 0.0001,
            "lateness_max_seconds": p99 * 1.1 if late else 0.0002,
        }
    return {"collectives": collectives, "ranks": [0, 1, 2],
            "per_rank": per_rank, "worst_rank": late_rank,
            "worst_collectives": [], "clock": {}}


def _lateness(R, late, other, n=30, seed=0):
    rng = _rng(seed)
    return _hist(R, "hvd_controller_tick_lateness_seconds", {
        "1": late + rng.rand(n) * 0.004, "2": other + rng.rand(n) * 4e-4})


def _recv_wait(R, per_rank, n=30, seed=1):
    rng = _rng(seed)
    return {rank: _hist(R, "hvd_wire_recv_wait_seconds",
                        {"": level + rng.rand(n) * level * 0.1},
                        labelnames=())
            for rank, level in sorted(per_rank.items())}


def _committed(per_rank=0.0005):
    rows = {n: {"negotiate_step_seconds": per_rank * n,
                "reshape_seconds": per_rank * n,
                "heartbeat_fanout_seconds": per_rank * n}
            for n in (8, 16, 32, 64)}
    report = jsm.control_plane_report(rows, relative=True)
    return {"control_plane": {str(n): r for n, r in sorted(rows.items())},
            **report}


def _live_summary(neg_slope, obs=40, windows=4, world=64):
    planes = {
        "negotiation": {"live_base_s": 0.0, "live_per_rank_s": neg_slope,
                        "observations": obs, "windows": windows},
        "reshape": {"live_base_s": 0.0, "live_per_rank_s": 0.0,
                    "observations": 0, "windows": windows},
        "restore": {"live_base_s": 0.0, "live_per_rank_s": 0.0,
                    "observations": 0, "windows": 0},
    }
    return {"source": "live", "windows_ingested": windows,
            "horizon_windows": 8, "world_size": world, "planes": planes}


def _autotune(R, values, objective=None, cycles=0):
    snap = _gauges(R, values, {"hvd_autotune_objective": (
        "component", objective)} if objective else None)
    if cycles:
        snap.update(_hist(R, "hvd_controller_cycle_seconds",
                          {"": _rng(5).rand(cycles) * 2e-3},
                          labelnames=()))
    return snap


def _window(index, snapshots):
    return {"index": index, "start": float(index), "end": index + 1.0,
            "duration_seconds": 1.0, "snapshots": snapshots}


CASES = {
    # persistent_straggler (tests/test_doctor.py)
    "straggler_report_warning": lambda R: dict(
        straggler_report=_straggler_report(late_rank=1)),
    "straggler_report_critical": lambda R: dict(
        straggler_report=_straggler_report(p99=0.25)),
    "straggler_report_few_collectives": lambda R: dict(
        straggler_report=_straggler_report(collectives=5)),
    "straggler_report_small_lateness": lambda R: dict(
        straggler_report=_straggler_report(p99=0.001)),
    "straggler_report_small_share": lambda R: dict(
        straggler_report=_straggler_report(collectives=200, cycles=10)),
    "tick_lateness_skew": lambda R: dict(
        snapshots={0: _lateness(R, 0.05, 0.0)}),
    "tick_lateness_flat": lambda R: dict(
        snapshots={0: _lateness(R, 0.05, 0.05)}),
    "tick_lateness_lone_worker": lambda R: dict(snapshots={0: _hist(
        R, "hvd_controller_tick_lateness_seconds",
        {"1": 0.05 + _rng(2).rand(30) * 0.004})}),
    "straggler_report_and_live": lambda R: dict(
        snapshots={0: _lateness(R, 0.05, 0.0)},
        straggler_report=_straggler_report(late_rank=1, p99=0.25)),
    # clock_sync_degraded
    "clock_unsynced_and_uncertain": lambda R: dict(clock={
        0: {"offset_seconds": 0.0, "synced": True},
        1: {"offset_seconds": 0.0, "synced": False},
        2: {"offset_seconds": 0.1, "uncertainty_seconds": 0.02,
            "synced": True}}),
    "clock_native_job": lambda R: dict(clock={
        0: {"applied_offset_seconds": 0.0, "synced": True},
        1: {"applied_offset_seconds": 0.0, "synced": False,
            "uncertainty_seconds": None},
        2: {"applied_offset_seconds": 0.0, "synced": False,
            "uncertainty_seconds": None}}),
    "clock_broken_table": lambda R: dict(clock={
        0: {"offset_seconds": 0.0, "synced": True},
        1: {"offset_seconds": 0.0, "samples": 0, "synced": False},
        2: {"offset_seconds": 0.0, "samples": 0, "synced": False}}),
    "clock_healthy_single": lambda R: dict(clock={0: {"synced": True}}),
    # recv_wait_skew
    "recv_wait_outlier": lambda R: dict(
        snapshots=_recv_wait(R, {0: 0.001, 1: 0.001, 2: 0.1})),
    "recv_wait_two_workers": lambda R: dict(
        snapshots=_recv_wait(R, {1: 0.001, 2: 0.1})),
    "recv_wait_two_healthy": lambda R: dict(
        snapshots=_recv_wait(R, {1: 0.03, 2: 0.03})),
    "recv_wait_coordinator": lambda R: dict(
        snapshots=_recv_wait(R, {0: 0.05, 1: 0.001})),
    "recv_wait_windowed": lambda R: dict(
        snapshots=_recv_wait(R, {1: 0.001, 2: 0.001}),
        windows=[_window(i, _recv_wait(R, {1: 0.001, 2: 0.1}, seed=i))
                 for i in range(3)]),
    # heartbeat_flapping
    "heartbeat_warning": lambda R: dict(snapshots={1: _counter(
        R, "hvd_wire_deadline_trips_total", {"recv": 4})}),
    "heartbeat_critical": lambda R: dict(snapshots={1: _counter(
        R, "hvd_wire_deadline_trips_total", {"recv": 12})}),
    "heartbeat_single_trip": lambda R: dict(snapshots={1: _counter(
        R, "hvd_wire_deadline_trips_total", {"recv": 1})}),
    "heartbeat_postmortem": lambda R: dict(postmortems=[[
        {"kind": "flight_recorder_dump", "rank": 2}] + [
        {"kind": "deadline_trip", "side": "recv", "rank": 2}] * 3]),
    # cache_hit_collapse (controller and serving prefix cache)
    "cache_collapse_after_restart": lambda R: dict(snapshots={0: _merge(
        _counter(R, "hvd_controller_cache_hits_total", {"": 10}, ()),
        _counter(R, "hvd_controller_cache_misses_total", {"": 490}, ()))},
        restart_epoch=1),
    "cache_healthy": lambda R: dict(snapshots={0: _merge(
        _counter(R, "hvd_controller_cache_hits_total", {"": 300}, ()),
        _counter(R, "hvd_controller_cache_misses_total", {"": 100}, ()))}),
    "cache_little_traffic": lambda R: dict(snapshots={0: _counter(
        R, "hvd_controller_cache_misses_total", {"": 50}, ())}),
    "prefix_collapse_cold": lambda R: dict(snapshots={0: _merge(
        _counter(R, "hvd_serving_prefix_hits_total", {"": 20}, ()),
        _counter(R, "hvd_serving_prefix_misses_total", {"": 300}, ()))}),
    "prefix_collapse_rewarm": lambda R: dict(snapshots={0: _merge(
        _counter(R, "hvd_serving_prefix_hits_total", {"": 20}, ()),
        _counter(R, "hvd_serving_prefix_misses_total", {"": 300}, ()))},
        restart_epoch=3),
    # restart_churn
    "restart_once": lambda R: dict(restart_epoch=1),
    "restart_twice": lambda R: dict(restart_epoch=2),
    "restart_crash_loop": lambda R: dict(restart_epoch=6),
    # membership_churn
    "membership_flapper": lambda R: dict(snapshots={0: _merge(
        _counter(R, "hvd_membership_transitions_total",
                 {"shrink": 3, "grow": 2}, ("kind",)),
        _counter(R, "hvd_membership_rank_departures_total",
                 {"2": 3, "1": 1}, ("rank",)),
        _gauges(R, {"hvd_membership_epoch": 6,
                    "hvd_membership_size": 3}))}),
    "membership_storm": lambda R: dict(snapshots={0: _counter(
        R, "hvd_membership_transitions_total", {"shrink": 11}, ("kind",))}),
    # autotune_stalled / autotune_wandering
    "autotune_young": lambda R: dict(snapshots={0: _autotune(
        R, {"hvd_autotune_active": 1, "hvd_autotune_steps_completed": 0},
        cycles=100)}),
    "autotune_stalled": lambda R: dict(snapshots={0: _autotune(
        R, {"hvd_autotune_active": 1, "hvd_autotune_steps_completed": 0},
        cycles=600)}),
    "autotune_wandering": lambda R: dict(snapshots={0: _autotune(
        R, {"hvd_autotune_active": 1, "hvd_autotune_steps_completed": 12,
            "hvd_autotune_best_objective": 100.0},
        objective={"score": 30.0, "throughput_bytes_per_sec": 30.0,
                   "slack_penalty": 0.0, "recv_wait_penalty": 0.0})}),
    "autotune_done": lambda R: dict(snapshots={0: _autotune(
        R, {"hvd_autotune_active": 0, "hvd_autotune_steps_completed": 20})}),
    "autotune_near_best": lambda R: dict(snapshots={0: _autotune(
        R, {"hvd_autotune_active": 1, "hvd_autotune_steps_completed": 12,
            "hvd_autotune_best_objective": 100.0},
        objective={"score": 90.0})}),
    # serving_queue_saturation / serving_block_exhaustion
    "serving_saturated": lambda R: dict(snapshots={0: _merge(
        _gauges(R, {"hvd_serving_queue_limit": 8,
                    "hvd_serving_queue_depth": 8,
                    "hvd_serving_blocks_total": 64}),
        _counter(R, "hvd_serving_requests_total",
                 {"rejected": 12, "finished": 40}, ("status",)),
        _counter(R, "hvd_serving_preemptions_total", {"": 25}, ()))}),
    "serving_two_replicas_warning": lambda R: dict(snapshots={
        0: _merge(_gauges(R, {"hvd_serving_queue_limit": 16,
                              "hvd_serving_queue_depth": 15}),
                  _counter(R, "hvd_serving_preemptions_total",
                           {"": 4}, ())),
        1: _gauges(R, {"hvd_serving_queue_limit": 16,
                       "hvd_serving_queue_depth": 2})}),
    "serving_quiet": lambda R: dict(snapshots={0: _merge(
        _gauges(R, {"hvd_serving_queue_limit": 16,
                    "hvd_serving_queue_depth": 3}),
        _counter(R, "hvd_serving_preemptions_total", {"": 1}, ()))}),
    # router_replica_flapping (tests/test_serving_fleet.py)
    "router_flapping": lambda R: dict(snapshots={0: _merge(
        _counter(R, "hvd_router_replica_departures_total",
                 {"1": 4.0, "2": 1.0}, ("replica",)),
        _gauges(R, {"hvd_router_replicas": 2, "hvd_router_epoch": 7}))}),
    "router_one_departure": lambda R: dict(snapshots={0: _counter(
        R, "hvd_router_replica_departures_total", {"0": 1.0},
        ("replica",))}),
    # capacity_headroom
    "capacity_headroom": lambda R: dict(
        capacity_calibration=_committed(),
        snapshots={0: _merge(
            _gauges(R, {"hvd_membership_size": 16}),
            _hist(R, "hvd_controller_cycle_seconds",
                  {"": 0.2 + _rng(3).rand(30) * 0.01}, labelnames=()))}),
    "capacity_within_envelope": lambda R: dict(
        capacity_calibration=_committed(),
        snapshots={0: _merge(
            _gauges(R, {"hvd_membership_size": 16}),
            _hist(R, "hvd_controller_cycle_seconds",
                  {"": _rng(4).rand(30) * 1e-3}, labelnames=()))}),
    # calibration_drift (tests/test_live_calibration.py)
    "calibration_drift": lambda R: dict(
        capacity_calibration=_committed(),
        live_calibration=_live_summary(0.0015)),
    "calibration_mild": lambda R: dict(
        capacity_calibration=_committed(),
        live_calibration=_live_summary(0.00095)),
    "calibration_thin": lambda R: dict(
        capacity_calibration=_committed(),
        live_calibration=_live_summary(
            0.0015, obs=jrules.CAPACITY_MIN_CYCLES - 1)),
    "calibration_brief": lambda R: dict(
        capacity_calibration=_committed(),
        live_calibration=_live_summary(0.0015, windows=1)),
    # diagnose's ordering and dedupe over several rules at once
    "mixed_severities": lambda R: dict(
        snapshots={1: _counter(R, "hvd_wire_deadline_trips_total",
                               {"recv": 3})},
        straggler_report=_straggler_report(late_rank=2, p99=0.25),
        restart_epoch=2),
    "empty": lambda R: dict(),
}


def evidence(pkg, case):
    registry, ev_cls = PKGS[pkg]
    return ev_cls(**copy.deepcopy(CASES[case](registry)))


RULE_NAMES = [rule.__name__ for rule in jrules.ALL_RULES]


def test_catalog_and_thresholds_equal():
    assert [r.__name__ for r in trules.ALL_RULES] == RULE_NAMES
    assert len(RULE_NAMES) == 12
    assert trules.RULE_SLUGS == jrules.RULE_SLUGS
    assert len(trules.RULE_SLUGS) == 14
    assert trules.SEVERITIES == jrules.SEVERITIES
    consts = {k: v for k, v in sorted(vars(jrules).items())
              if k.isupper() and k != "ALL_RULES"}
    assert consts and {k: getattr(trules, k) for k in consts} == consts
    assert sorted(tdoctor.__all__) == sorted(jdoctor.__all__)


@pytest.mark.parametrize("case", sorted(CASES))
def test_snapshots_equal(case):
    jev, tev = evidence("jax", case), evidence("port", case)
    for field in ("snapshots", "windows", "straggler_report", "clock",
                  "postmortems", "restart_epoch", "capacity_calibration",
                  "live_calibration"):
        assert norm(getattr(tev, field)) == norm(getattr(jev, field)), field


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_rule_matches_jax(rule):
    """The rule alone, over every case: the same findings, and at least
    one case it fires in."""
    jfn, tfn = getattr(jrules, rule), getattr(trules, rule)
    fired = []
    for case in sorted(CASES):
        want = [d.to_dict() for d in jfn(evidence("jax", case))]
        got = [d.to_dict() for d in tfn(evidence("port", case))]
        assert norm(got) == norm(want), case
        if want:
            fired.append(case)
    assert fired, rule


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagnose_and_report_functions_match_jax(case):
    jev, tev = evidence("jax", case), evidence("port", case)
    assert norm([d.to_dict() for d in trules.diagnose(tev)]) == \
        norm([d.to_dict() for d in jrules.diagnose(jev)])
    assert [d.one_line() for d in trules.diagnose(tev)] == \
        [d.one_line() for d in jrules.diagnose(jev)]
    jrep, trep = jdoctor.report(jev), tdoctor.report(tev)
    assert norm(trep) == norm(jrep)
    assert norm(tdoctor.summary(trep)) == norm(jdoctor.summary(jrep))
    assert tdoctor.render_text(trep) == jdoctor.render_text(jrep).replace(
        "horovod_tpu.", "horovod_tpu_torch.")
    assert tdoctor.periodic_line(rep=trep) == jdoctor.periodic_line(
        rep=jrep).replace("horovod_tpu.", "horovod_tpu_torch.")
    assert tdoctor.periodic_line(tev) == jdoctor.periodic_line(jev).replace(
        "horovod_tpu.", "horovod_tpu_torch.")


def test_every_slug_fires_in_some_case():
    """The cases are not vacuous: together they make every rule slug
    fire, at each severity the catalog uses."""
    fired = set()
    for case in sorted(CASES):
        fired |= {(d.rule, d.severity)
                  for d in trules.diagnose(evidence("port", case))}
    assert {rule for rule, _ in fired} == set(trules.RULE_SLUGS)
    assert {sev for _, sev in fired} == set(trules.SEVERITIES)


def test_live_report_and_doctor_series_match_jax():
    jmetrics.enable()
    tmetrics.enable()
    jrep, trep = jdoctor.report(), tdoctor.report()
    assert norm(trep) == norm(jrep)
    assert trep["healthy"] and trep["source"] == "live"
    jsnap, tsnap = jmetrics.snapshot(), tmetrics.snapshot()
    for name in ("hvd_doctor_runs_total", "hvd_doctor_findings"):
        assert tsnap[name] == jsnap[name], name
    assert {tuple(k)[0] for k, _ in tsnap["hvd_doctor_findings"][
        "values"]} == set(tdoctor.RULE_SLUGS)
    # Evidence built by hand carries source "live" by default, so it
    # counts as a sweep in both packages alike.
    jdoctor.report(evidence("jax", "straggler_report_warning"))
    tdoctor.report(evidence("port", "straggler_report_warning"))
    jsnap, tsnap = jmetrics.snapshot(), tmetrics.snapshot()
    for name in ("hvd_doctor_runs_total", "hvd_doctor_findings"):
        assert tsnap[name] == jsnap[name], name
    assert tsnap["hvd_doctor_runs_total"]["values"] == [[[], 2.0]]


def _frame(wire_cls, obj):
    """The bytes one ``send_obj(obj)`` puts on a socket."""
    a, b = socket.socketpair()
    try:
        wire_cls(a, secret=bytes(range(32))).send_obj(obj)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("case", ["tick_lateness_skew", "serving_saturated",
                                  "membership_flapper", "recv_wait_outlier"])
def test_piggybacked_snapshot_frames_are_byte_identical(case):
    """A worker's tick carries ``metrics.snapshot()`` under ``"metrics"``:
    the same series give the same frame bytes in both packages."""
    frames = []
    for pkg in ("jax", "port"):
        snaps = CASES[case](PKGS[pkg][0])["snapshots"]
        snap = snaps[max(snaps)]
        frames.append(_frame(jwire.Wire if pkg == "jax" else twire.Wire,
                             {"rank": 1, "metrics": snap}))
    assert frames[0] == frames[1]


def test_doctor_registers_nothing_at_import_time():
    code = ("import horovod_tpu_torch.doctor, horovod_tpu_torch.metrics as m,"
            " horovod_tpu_torch.utils.live_calibration, "
            "horovod_tpu_torch.tools.doctor\n"
            "m.enable(); print(sorted(m.snapshot()))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# Evidence from artifact directories, and the offline CLI


def _write_trace_dir(path, late_rank=1, late_us=400_000, n=12):
    def rank_file(rank, spans):
        events = [{"name": "clock_sync", "ph": "M", "pid": rank,
                   "args": {"wall_anchor": 1000.0, "monotonic_origin": 0.0,
                            "rank": rank}}] + spans
        with open(os.path.join(path, f"trace.rank{rank}.json"), "w") as f:
            json.dump(events, f)

    rng = _rng(9)
    for rank in range(3):
        spans = []
        for seq in range(n):
            ts = (seq * 2_000_000 + int(rng.randint(0, 500))
                  + (late_us if rank == late_rank else 0))
            spans.append({"name": "negotiate", "ph": "X", "pid": rank,
                          "tid": 2, "ts": ts, "dur": 100,
                          "args": {"seq": seq, "op": f"t.{seq}"}})
        rank_file(rank, spans)
    offsets = {str(r): {"offset_seconds": 0.0, "uncertainty_seconds": 1e-5,
                        "rtt_seconds": 2e-5, "samples": 4, "synced": True}
               for r in range(3)}
    with open(os.path.join(path, "clock_offsets.json"), "w") as f:
        json.dump(offsets, f)


def _write_postmortems(path):
    lines = [{"kind": "flight_recorder_dump", "reason": "fail_all",
              "rank": 2, "events": 3}]
    lines += [{"kind": "deadline_trip", "side": "recv", "rank": 2}] * 3
    for name in ("fr.jsonl.rank2", "fr.jsonl.rank2.tmp.123.456"):
        with open(os.path.join(path, name), "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    with open(os.path.join(path, "not_a_dump.jsonl"), "w") as f:
        f.write('{"kind": "other"}\n')
    with open(os.path.join(path, "fr.jsonl.launcher"), "w") as f:
        for line in ({"kind": "flight_recorder_dump", "events": 2},
                     {"kind": "launcher_restart", "epoch": 1},
                     {"kind": "launcher_restart", "epoch": 2}):
            f.write(json.dumps(line) + "\n")


def _write_report(path):
    with open(os.path.join(path, "straggler_report.json"), "w") as f:
        json.dump(_straggler_report(late_rank=1), f)


def _write_live_calibration(path):
    from horovod_tpu_torch.utils import live_calibration as tlc

    live = tlc.LiveCalibration()
    for world in (8, 16):
        snap = {"hvd_membership_size": {"type": "gauge",
                                        "values": [[[], float(world)]]},
                "hvd_controller_cycle_seconds": {
                    "type": "histogram", "buckets": [0.01, 0.1, 1.0],
                    "values": [[[], {"counts": [0, 0, 30, 0],
                                     "sum": 0.0015 * world * 30,
                                     "count": 30}]]}}
        live.ingest_window(_window(0, {0: snap}))
    with open(os.path.join(path, "capacity_live.json"), "w") as f:
        json.dump(live.refit(), f)
    with open(os.path.join(path, "capacity_r17.json"), "w") as f:
        json.dump(_committed(0.0005), f)


DIRS = {
    "trace": _write_trace_dir,
    "postmortems": _write_postmortems,
    "report": _write_report,
    "live_calibration": _write_live_calibration,
    "everything": lambda p: (_write_trace_dir(p), _write_postmortems(p),
                             _write_live_calibration(p)),
    "empty": lambda p: None,
}


def _artifact_dir(tmp_path, kind):
    path = tmp_path / kind
    path.mkdir()
    DIRS[kind](str(path))
    return str(path)


@pytest.mark.parametrize("kind", sorted(DIRS))
def test_evidence_from_artifacts_matches_jax(tmp_path, kind):
    path = _artifact_dir(tmp_path, kind)
    jev = jdoctor.Evidence.from_artifacts(path)
    tev = tdoctor.Evidence.from_artifacts(path)
    assert tev.source == jev.source == f"artifacts:{path}"
    assert tev.ranks_observed() == jev.ranks_observed()
    assert norm(tdoctor.report(tev)) == norm(jdoctor.report(jev))
    # Read-only: the in-memory attribution is never written back.
    if kind == "trace":
        assert not os.path.exists(os.path.join(path,
                                               "straggler_report.json"))
        assert tev.straggler_report["collectives"] == 12
        [finding] = [f for f in trules.diagnose(tev)
                     if f.rule == "persistent_straggler"]
        assert finding.rank == 1 and finding.severity == "critical"
    if kind == "postmortems":
        assert len(tev.postmortems) == 2 and tev.restart_epoch == 2


CLI_ARGS = [["--format", "json"], [], ["--fail-on-findings"],
            ["--format", "json", "--fail-on-findings"]]


@pytest.mark.parametrize("args", CLI_ARGS, ids=lambda a: " ".join(a) or "text")
@pytest.mark.parametrize("kind", ["trace", "report", "postmortems", "empty",
                                  "missing"])
def test_tools_doctor_matches_jax(tmp_path, capsys, kind, args):
    if kind == "missing":
        path = str(tmp_path / "missing")
    else:
        path = _artifact_dir(tmp_path, kind)
    want_rc = jcli.main([path] + args)
    want = capsys.readouterr()
    got_rc = tcli.main([path] + args)
    got = capsys.readouterr()
    assert got_rc == want_rc
    assert got.out == want.out.replace("horovod_tpu.", "horovod_tpu_torch.")
    assert bool(got.err) == bool(want.err)
    expected = {"empty": 2, "missing": 2}.get(
        kind, 1 if "--fail-on-findings" in args else 0)
    assert got_rc == expected


def test_tools_doctor_module_entry_point(tmp_path):
    path = _artifact_dir(tmp_path, "report")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.doctor", path,
         "--format", "json"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout)
    [finding] = [f for f in rep["findings"]
                 if f["rule"] == "persistent_straggler"]
    assert finding["rank"] == 1 and "NIC" in finding["hint"]
    empty = tmp_path / "nothing"
    empty.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.doctor",
         str(empty)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 2 and "nothing diagnosable" in proc.stderr


# ---------------------------------------------------------------------------
# Flight recorder


def _record_script(rec, n_sampled=140):
    rng = _rng(11)
    rec.record("init", size=3, restart_epoch=0)
    for i in range(n_sampled):
        rec.record_sampled("enqueue", op="allreduce", name=f"g.{i}",
                           nbytes=int(rng.randint(1, 1 << 20)))
    rec.record("stall", op="g.7", age_seconds=61.25, missing_ranks=[2])
    rec.record("abort", dead_rank=2, cause="peer closed connection",
               inflight="'g.9'", last_seq=41)
    rec.record("fail_all", error="boom", pending=1, inflight=["g.9"],
               last_seq=41)


def _lines(path):
    out = []
    with open(path) as f:
        for line in f:
            event = json.loads(line)
            assert isinstance(event.pop("ts"), float)
            out.append(event)
    return out


@pytest.mark.parametrize("capacity,sample,rank", [
    (512, 64, "1"), (16, 64, "0"), (32, 4, None), (16, 1, "2")])
def test_flight_recorder_jsonl_equal_less_timestamps(tmp_path, capacity,
                                                     sample, rank):
    paths = {}
    for pkg, mod in (("jax", jrecorder), ("port", trecorder)):
        rec = mod.FlightRecorder(capacity=capacity, sample=sample, rank=rank)
        _record_script(rec)
        paths[pkg] = rec.dump(str(tmp_path / f"{pkg}.{{rank}}.jsonl"),
                              "fail_all")
    assert paths["port"] == paths["jax"].replace("jax.", "port.")
    got, want = _lines(paths["port"]), _lines(paths["jax"])
    assert got == want
    assert got[0]["kind"] == "flight_recorder_dump"
    assert len(got) - 1 == got[0]["events"] <= capacity


@pytest.mark.parametrize("path,rank", [
    ("/x/fr.jsonl", "3"), ("/x/fr.jsonl", None), ("/x/fr.{rank}.jsonl", "0"),
    ("/x/fr.{rank}.jsonl", None), ("fr", "12")])
def test_expand_rank_path_equal(path, rank):
    assert trecorder.expand_rank_path(path, rank) == \
        jrecorder.expand_rank_path(path, rank)


def test_recorder_facade_and_env_switch(tmp_path, monkeypatch):
    assert not tmetrics.on()
    tmetrics.record_event("init", size=1)  # off: a no-op
    assert tmetrics.dump_flight_recorder("x") is None
    pattern = str(tmp_path / "fr.{rank}.jsonl")
    for pkg, mod in (("jax", jmetrics), ("port", tmetrics)):
        monkeypatch.setenv("HOROVOD_FLIGHT_RECORDER",
                           pattern.replace("fr.", f"{pkg}."))
        monkeypatch.setenv("HOROVOD_RANK", "2")
        mod.reset_for_tests()
        assert mod.on()  # the recorder path turns telemetry on
        mod.record_event("init", size=3)
        for i in range(70):
            mod.record_sampled_event("execute", seq=i, op="allreduce")
        mod.dump_flight_recorder("fail_all")
    got = _lines(str(tmp_path / "port.2.jsonl"))
    want = _lines(str(tmp_path / "jax.2.jsonl"))
    assert got == want and [e["kind"] for e in got] == [
        "flight_recorder_dump", "init", "execute", "execute"]


# ---------------------------------------------------------------------------
# Exporter: /metrics, ?window=, /doctor from a port process


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=5).read().decode()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_exporter_serves_metrics_window_and_doctor(monkeypatch):
    monkeypatch.setenv("HOROVOD_METRICS_PORT", str(_free_port()))
    for mod in (jmetrics, tmetrics):
        mod.reset_for_tests()
        c = mod.counter("hvd_collective_ops_total", "probe", ("op",))
        c.labels("allreduce").inc(4)
    exp = tmetrics.maybe_start_exporter(0)
    assert exp is not None
    try:
        body = _get(exp.port, "/metrics")
        assert body == tmetrics.render_all()

        def probe(text):
            return [ln for ln in text.splitlines()
                    if "hvd_collective_ops_total" in ln]

        assert probe(body) == probe(jmetrics.render_all())
        assert 'hvd_collective_ops_total{op="allreduce"} 4' in body
        hint = _get(exp.port, "/metrics?window=recent")
        assert hint == jmetrics.render_all("window=recent")
        assert "no completed telemetry window" in hint
        roller = tmetrics.start_window_roller(interval_s=3600)
        roller.roll_now()
        tmetrics.counter("hvd_collective_ops_total", "probe",
                         ("op",)).labels("allreduce").inc(2)
        roller.roll_now()
        windowed = _get(exp.port, "/metrics?window=recent")
        assert 'hvd_collective_ops_total{op="allreduce"} 2' in windowed
        assert windowed == tmetrics.render_all("window=recent")
        rep = json.loads(_get(exp.port, "/doctor"))
        assert rep["healthy"] is True and rep["source"] == "live"
        assert "hvd_doctor_findings" in _get(exp.port, "/metrics")
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(exp.port, "/nope")
        assert err.value.code == 404
    finally:
        exp.close()


def test_exporter_stride_walks_past_sibling_slots(monkeypatch):
    """Rank 1's slot (base + 1) is taken: the walk steps by the job size
    (HOROVOD_SIZE=3), never onto a sibling rank's slot."""
    blocker = socket.socket()
    blocker.bind(("", 0))
    blocker.listen(1)
    taken = blocker.getsockname()[1]
    monkeypatch.setenv("HOROVOD_METRICS_PORT", str(taken - 1))
    monkeypatch.setenv("HOROVOD_SIZE", "3")
    ports = {}
    try:
        for pkg, mod in (("jax", jmetrics), ("port", tmetrics)):
            exp = mod.maybe_start_exporter(1)
            ports[pkg] = exp.port
            exp.close()
    finally:
        blocker.close()
    assert ports["port"] != taken
    assert (ports["port"] - taken) % 3 == 0 or ports["port"] > taken + 93
    assert (ports["jax"] - taken) % 3 == 0 or ports["jax"] > taken + 93
