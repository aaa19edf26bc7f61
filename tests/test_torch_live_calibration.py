"""The port's windowed telemetry and live calibration against the JAX
package's, on the CPU.

* **Delta algebra**: ``set_mark``/``snapshot_delta`` on each package's
  registry under the same numpy-seeded metric writes give equal deltas,
  also when writer threads hammer the series (the delta must then be
  exact), with independent watermarks, label growth mid-window and
  ``reset_for_tests`` dropping every watermark.
* **Window roller**: the same writes rolled by both packages' rollers
  give equal window records (less the wall stamps), the same bounded
  ring, observer calls and ``hvd_metrics_windows_total``, and the same
  ``render_all("window=recent")`` text.
* **Live re-fit**: ``LiveCalibration.refit`` / ``summary``,
  ``summary_from_artifact``, ``drift_report``, the ``on_window``
  observer's gauges and persisted ``capacity_live.json``,
  ``persist_on_shutdown`` and ``reseed_from_live`` agree on the same
  windows.
* **The drift drive** on the port's ``SimCluster`` (4 logical ranks, the
  JAX test's drive): a healthy phase calibrates, a 150 ms tick delay of
  rank 1 makes ``calibration_drift`` name the negotiation plane within 3
  windows, the drifted ``capacity_live.json`` loads through the planner's
  loader, healthy windows heal the finding, and the silent twin stays
  silent over 20 windows. Every window is one the test rolls
  (``HOROVOD_METRICS_WINDOW_SECONDS`` is an hour, so the roller thread
  rolls none on its own under a slow run): the windows are judged by
  their count and their steps, not by wall time."""

import copy
import json
import threading

import numpy as np
import pytest

from horovod_tpu import metrics as jmetrics
from horovod_tpu.common.config import Config as JConfig
from horovod_tpu.controller import autotune_glue as jglue
from horovod_tpu.metrics.registry import subtract_snapshots as jsubtract
from horovod_tpu.utils import live_calibration as jlc
from horovod_tpu.utils import scaling_model as jsm
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.common.config import Config as TConfig
from horovod_tpu_torch.controller import autotune_glue as tglue
from horovod_tpu_torch.metrics.registry import subtract_snapshots as tsubtract
from horovod_tpu_torch.utils import live_calibration as tlc

ENV_VARS = ("HOROVOD_METRICS", "HOROVOD_METRICS_PORT",
            "HOROVOD_FLIGHT_RECORDER", "HOROVOD_RANK",
            "HOROVOD_METRICS_WINDOW_SECONDS",
            "HOROVOD_CAPACITY_REFIT_WINDOWS", "HOROVOD_CAPACITY_LIVE_DIR",
            "HOROVOD_CAPACITY_CALIBRATION", "HOROVOD_BUCKET_BYTES",
            "HOROVOD_RING_CHUNK_BYTES", "HOROVOD_AUTOTUNE_PRIORS")
PKGS = {"jax": (jmetrics, jlc), "port": (tmetrics, tlc)}


@pytest.fixture(autouse=True)
def _fresh_metrics(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    jmetrics.reset_for_tests()
    tmetrics.reset_for_tests()
    yield
    jmetrics.reset_for_tests()
    tmetrics.reset_for_tests()


def _enable(monkeypatch):
    monkeypatch.setenv("HOROVOD_METRICS", "1")
    jmetrics.reset_for_tests()
    tmetrics.reset_for_tests()


def _clean(obj):
    return json.loads(json.dumps(obj, sort_keys=True))


# ---------------------------------------------------------------------------
# Delta algebra


def _writes(seed, n):
    """A seeded script of metric writes: (kind, label, value) rows."""
    rng = np.random.RandomState(seed)
    kinds = rng.randint(0, 3, n)
    labels = rng.choice(["a", "b", "c"], n)
    values = rng.exponential(0.05, n)
    return [(int(k), str(lbl), float(v))
            for k, lbl, v in zip(kinds, labels, values)]


def _apply(r, rows):
    c = r.counter("hvd_d_total", "", ("op",))
    h = r.histogram("hvd_d_seconds", "", ("op",), buckets=(0.01, 0.1, 1.0))
    g = r.gauge("hvd_d_level", "", ("op",))
    for kind, label, value in rows:
        if kind == 0:
            c.labels(label).inc(value * 100)
        elif kind == 1:
            h.labels(label).observe(value)
        else:
            g.labels(label).set(value)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_snapshot_delta_equal_under_the_same_writes(seed):
    before, after = _writes(seed, 40), _writes(seed + 100, 60)
    deltas = {}
    for pkg, (metrics_mod, _) in sorted(PKGS.items()):
        r = metrics_mod.MetricsRegistry()
        _apply(r, before)
        mark = r.set_mark("w")
        _apply(r, after)
        deltas[pkg] = (_clean(mark), _clean(r.snapshot_delta("w")),
                       _clean(r.snapshot_delta("never-set")),
                       _clean(r.snapshot()))
    assert deltas["port"] == deltas["jax"]
    _, delta, full, snap = deltas["port"]
    assert full == snap  # a mark never set reads as process start
    counted = sum(v for k, _, v in after if k == 0) * 100
    total = sum(v for _, v in delta["hvd_d_total"]["values"])
    assert total == pytest.approx(counted)


def test_snapshot_delta_exact_under_concurrent_writes():
    results = {}
    for pkg, (metrics_mod, _) in sorted(PKGS.items()):
        r = metrics_mod.MetricsRegistry()
        c = r.counter("hvd_cc_total", "")
        h = r.histogram("hvd_cc_seconds", "", buckets=(1.0,))
        c.inc(7)
        h.observe(0.5)
        r.set_mark("w")
        threads, per_thread = 8, 500
        start = threading.Barrier(threads)

        def spin():
            start.wait()
            for _ in range(per_thread):
                c.inc()
                h.observe(0.5)

        workers = [threading.Thread(target=spin, name=f"hvd-test-{i}",
                                    daemon=True)
                   for i in range(threads)]
        for t in workers:
            t.start()
        mid = r.snapshot_delta("w")
        for t in workers:
            t.join()
        [[_, mid_c]] = mid["hvd_cc_total"]["values"]
        [[_, mid_h]] = mid["hvd_cc_seconds"]["values"]
        assert 0 <= mid_c <= threads * per_thread
        assert mid_h["count"] == sum(mid_h["counts"])
        results[pkg] = _clean(r.snapshot_delta("w"))
    assert results["port"] == results["jax"]
    [[_, cval]] = results["port"]["hvd_cc_total"]["values"]
    [[_, hval]] = results["port"]["hvd_cc_seconds"]["values"]
    assert cval == 8 * 500 and hval["count"] == 8 * 500


def test_watermarks_independent_label_growth_and_reset():
    out = {}
    for pkg, (metrics_mod, _) in sorted(PKGS.items()):
        r = metrics_mod.MetricsRegistry()
        c = r.counter("hvd_m_total", "", ("op",))
        c.labels("a").inc(3)
        r.set_mark("x")
        c.labels("a").inc(2)
        r.set_mark("y")
        c.labels("a").inc(1)
        c.labels("new").inc(4)  # a label set born mid-window
        views = [r.snapshot_delta("x"), r.snapshot_delta("y")]
        r.drop_mark("x")
        views.append(r.snapshot_delta("x"))
        r.clear()
        r.counter("hvd_m_total", "", ("op",)).labels("a").inc(1)
        views.append(r.snapshot_delta("y"))  # clear dropped the mark
        out[pkg] = _clean(views)
    assert out["port"] == out["jax"]
    x, y, dropped, after_clear = out["port"]
    assert dict((k[0], v) for k, v in x["hvd_m_total"]["values"]) == \
        {"a": 3.0, "new": 4.0}
    assert dict((k[0], v) for k, v in y["hvd_m_total"]["values"]) == \
        {"a": 1.0, "new": 4.0}
    assert dict((k[0], v) for k, v in dropped["hvd_m_total"]["values"]) \
        == {"a": 6.0, "new": 4.0}
    assert after_clear["hvd_m_total"]["values"] == [[["a"], 1.0]]


def test_subtract_snapshots_pure_and_equal():
    cur = {"hvd_p_total": {"type": "counter", "values": [[[], 9.0]]},
           "hvd_p_level": {"type": "gauge", "values": [[[], 2.0]]}}
    base = {"hvd_p_total": {"type": "counter", "values": [[[], 4.0]]}}
    keep = copy.deepcopy((cur, base))
    assert tsubtract(cur, base) == jsubtract(cur, base)
    assert (cur, base) == keep
    [[_, val]] = tsubtract(cur, base)["hvd_p_total"]["values"]
    assert val == 5.0


def test_facade_set_mark_and_snapshot_delta_equal(monkeypatch):
    _enable(monkeypatch)
    out = {}
    for pkg, (metrics_mod, _) in sorted(PKGS.items()):
        c = metrics_mod.counter("hvd_collective_ops_total", "", ("op",))
        c.labels("allreduce").inc(5)
        metrics_mod.set_mark("probe")
        c.labels("allreduce").inc(2)
        delta = metrics_mod.snapshot_delta("probe")
        out[pkg] = delta["hvd_collective_ops_total"]["values"]
    assert out["port"] == out["jax"] == [[["allreduce"], 2.0]]


# ---------------------------------------------------------------------------
# Window roller


def _strip_stamps(window):
    """A window record less its wall stamps, each rank's delta reduced
    to the series the test writes (a process that loaded a native core
    earlier also mirrors its counters into the registry)."""
    out = {k: v for k, v in sorted(window.items())
           if k not in ("start", "end", "duration_seconds")}
    out["snapshots"] = {
        rank: {name: entry for name, entry in sorted(snap.items())
               if name.startswith("hvd_d_")}
        for rank, snap in sorted(window["snapshots"].items())}
    return out


def test_window_roller_deltas_ring_and_observers_equal(monkeypatch):
    _enable(monkeypatch)
    rows = [_writes(s, 25) for s in range(5)]
    out = {}
    for pkg, (metrics_mod, _) in sorted(PKGS.items()):
        r = metrics_mod.default_registry()
        roller = metrics_mod.start_window_roller(interval_s=3600,
                                                 capacity=3)
        assert metrics_mod.start_window_roller(interval_s=3600) is roller
        seen = []
        roller.add_observer(seen.append)
        roller.add_observer(seen.append)  # the same fn: registered once
        windows = []
        for batch in rows:
            _apply(r, batch)
            windows.append(_strip_stamps(roller.roll_now()))
        ring = [_strip_stamps(w) for w in metrics_mod.windows()]
        rolls = metrics_mod.snapshot()["hvd_metrics_windows_total"]
        assert all(w["duration_seconds"] >= 0.0
                   for w in metrics_mod.windows())
        out[pkg] = _clean((windows, ring, len(seen), rolls))
        metrics_mod.stop_window_roller()
        assert metrics_mod.window_roller() is None
        assert metrics_mod.windows() == []
    assert out["port"] == out["jax"]
    windows, ring, calls, rolls = out["port"]
    assert [w["index"] for w in ring] == [2, 3, 4]
    assert calls == 5 and rolls["values"] == [[[], 5.0]]
    counted = sum(v for k, _, v in rows[1] if k == 0) * 100
    got = sum(v for _, v in
              windows[1]["snapshots"]["0"]["hvd_d_total"]["values"])
    assert got == pytest.approx(counted)


def test_window_roller_swallows_observer_errors(monkeypatch):
    _enable(monkeypatch)
    roller = tmetrics.start_window_roller(interval_s=3600)

    def boom(window):
        raise RuntimeError("telemetry must never kill the job")

    roller.add_observer(boom)
    assert roller.roll_now()["index"] == 0


def test_window_roller_thread_rolls_on_its_interval(monkeypatch):
    _enable(monkeypatch)
    monkeypatch.setenv("HOROVOD_METRICS_WINDOW_SECONDS", "0.05")
    roller = tmetrics.start_window_roller()
    assert roller.interval_s == 0.05
    done = threading.Event()
    roller.add_observer(lambda w: done.set() if w["index"] >= 2 else None)
    assert done.wait(10.0)
    tmetrics.stop_window_roller()


def test_render_window_query_equal(monkeypatch):
    _enable(monkeypatch)
    out = {}
    for pkg, (metrics_mod, _) in sorted(PKGS.items()):
        c = metrics_mod.counter("hvd_collective_ops_total", "", ("op",))
        c.labels("allreduce").inc(4)
        hint = metrics_mod.render_all("window=recent")
        roller = metrics_mod.start_window_roller(interval_s=3600)
        roller.roll_now()
        c.labels("allreduce").inc(2)
        roller.roll_now()
        probe = [ln for ln in metrics_mod.render_all(
            "window=recent").splitlines() if "hvd_collective" in ln]
        life = [ln for ln in metrics_mod.render_all().splitlines()
                if "hvd_collective" in ln]
        out[pkg] = (hint, probe, life)
    assert out["port"] == out["jax"]
    hint, probe, life = out["port"]
    assert "no completed telemetry window" in hint
    assert 'hvd_collective_ops_total{op="allreduce"} 2' in probe
    assert 'hvd_collective_ops_total{op="allreduce"} 6' in life


# ---------------------------------------------------------------------------
# Live re-fit


def _hist(mean, count, buckets=(0.01, 0.1, 1.0)):
    counts = [0] * (len(buckets) + 1)
    counts[-2] = count
    return {"type": "histogram", "buckets": list(buckets),
            "values": [[[], {"counts": counts, "sum": mean * count,
                             "count": count}]]}


def _gauge(value):
    return {"type": "gauge", "values": [[[], float(value)]]}


def _window(world, neg_mean=None, neg_count=0, reshape_mean=None,
            reshape_count=0, restore_mean=None, restore_count=0):
    snap = {"hvd_membership_size": _gauge(world)}
    if neg_count:
        snap["hvd_controller_cycle_seconds"] = _hist(neg_mean, neg_count)
    if reshape_count:
        snap["hvd_elastic_reshape_seconds"] = _hist(reshape_mean,
                                                    reshape_count)
    if restore_count:
        snap["hvd_elastic_restore_seconds"] = _hist(restore_mean,
                                                    restore_count)
    return {"index": 0, "start": 0.0, "end": 1.0,
            "duration_seconds": 1.0, "snapshots": {0: snap}}


def _committed(per_rank=0.0005, noise=0.0):
    rng = np.random.RandomState(17)
    rows = {n: {"negotiate_step_seconds":
                per_rank * n * (1 + noise * rng.randn()),
                "reshape_seconds": per_rank * n,
                "heartbeat_fanout_seconds": per_rank * n}
            for n in (8, 16, 32, 64)}
    report = jsm.control_plane_report(rows, relative=True)
    return {"control_plane": {str(n): r for n, r in sorted(rows.items())},
            **report}


def _seeded_windows(seed, n=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        world = int(rng.choice([8, 16, 32, 64]))
        out.append(_window(
            world, neg_mean=0.0005 * world * (1 + 0.1 * rng.randn()),
            neg_count=int(rng.randint(10, 40)),
            reshape_mean=0.001 * world, reshape_count=int(rng.randint(0, 3)),
            restore_mean=0.002 * world,
            restore_count=int(rng.randint(0, 2))))
    return out


WINDOW_SETS = {
    "empty": [],
    "slope_exact": [_window(w, neg_mean=0.0005 * w, neg_count=30,
                            reshape_mean=0.01, reshape_count=2)
                    for w in (8, 16, 32)],
    "one_world": [_window(16, neg_mean=0.008, neg_count=25)],
    "horizon_heal": ([_window(16, neg_mean=0.080, neg_count=30)] * 4
                     + [_window(16, neg_mean=0.008, neg_count=30)] * 4),
    "seeded_a": _seeded_windows(1),
    "seeded_b": _seeded_windows(2, n=12),
}


@pytest.mark.parametrize("horizon", [4, 8])
@pytest.mark.parametrize("name", sorted(WINDOW_SETS))
def test_refit_and_summary_equal(name, horizon):
    out = {}
    for pkg, (_, lc) in sorted(PKGS.items()):
        live = lc.LiveCalibration(horizon_windows=horizon)
        samples = [live.ingest_window(copy.deepcopy(w))
                   for w in WINDOW_SETS[name]]
        artifact = live.refit()
        out[pkg] = _clean((samples, artifact, live.summary(),
                           live.windows_ingested,
                           lc.summary_from_artifact(artifact)
                           if artifact else None,
                           {p: live.observations(p)
                            for p in sorted(lc.PLANE_SERIES)}))
    assert out["port"] == out["jax"]
    if name == "slope_exact":
        artifact = out["port"][1]
        cal = jsm.control_plane_from_artifact(artifact)
        assert cal.negotiation_per_rank_s == pytest.approx(0.0005,
                                                           rel=1e-6)
        assert artifact["source"] == "live"
    if name == "empty":
        assert out["port"][1] is None and out["port"][2] is None


@pytest.mark.parametrize("data", [
    {"source": "live"}, {"junk": 1}, None, "text",
    {"source": "live", "calibration": {"negotiation_per_rank_s": 0.001},
     "control_plane": {"8": {"restore_seconds": 0.1},
                       "16": {"restore_seconds": 0.2}},
     "windows": 3, "world_sizes": [8, 16]}])
def test_summary_from_artifact_edge_cases_equal(data):
    assert _clean(tlc.summary_from_artifact(data)) == \
        _clean(jlc.summary_from_artifact(data))


def _live_summary(neg_slope, obs=40, windows=4, world=64,
                  reshape_slope=0.0, reshape_obs=0):
    planes = {
        "negotiation": {"live_base_s": 0.0, "live_per_rank_s": neg_slope,
                        "observations": obs, "windows": windows},
        "reshape": {"live_base_s": 0.0, "live_per_rank_s": reshape_slope,
                    "observations": reshape_obs, "windows": windows},
        "restore": {"live_base_s": 0.0, "live_per_rank_s": 0.0,
                    "observations": 0, "windows": 0},
    }
    return {"source": "live", "windows_ingested": windows,
            "horizon_windows": 8, "world_size": world, "planes": planes}


def _flat_reshape():
    flat = {n: {"negotiate_step_seconds": 0.0005 * n,
                "reshape_seconds": 0.01} for n in (8, 16, 32, 64)}
    return {"control_plane": {str(n): r for n, r in sorted(flat.items())},
            **jsm.control_plane_report(flat, relative=True)}


DRIFTS = {
    "three_x": (_live_summary(0.0015), _committed()),
    "mild": (_live_summary(0.00095), _committed()),
    "noisy_committed": (_live_summary(0.0015), _committed(noise=0.2)),
    "reshape_flat": (_live_summary(0.0015, reshape_slope=0.01,
                                   reshape_obs=5), _flat_reshape()),
    "garbage": (_live_summary(0.0015), {"junk": 1}),
}


@pytest.mark.parametrize("name", sorted(DRIFTS))
def test_drift_report_equal(name):
    live, committed = DRIFTS[name]
    got = tlc.drift_report(copy.deepcopy(live), copy.deepcopy(committed))
    assert _clean(got) == _clean(jlc.drift_report(live, committed))
    if name == "three_x":
        assert got["negotiation"]["ratio"] == pytest.approx(3.0, rel=1e-4)
        assert got["negotiation"]["threshold"] == pytest.approx(2.0)
    if name == "reshape_flat":
        assert "reshape" not in got
    if name == "garbage":
        assert got == {}


def test_on_window_gauges_refit_counter_and_persist_equal(monkeypatch,
                                                          tmp_path):
    _enable(monkeypatch)
    committed = tmp_path / "committed.json"
    committed.write_text(json.dumps(_committed(0.0005)))
    monkeypatch.setenv("HOROVOD_CAPACITY_CALIBRATION", str(committed))
    monkeypatch.setenv("HOROVOD_CAPACITY_REFIT_WINDOWS", "2")
    out = {}
    for pkg, (metrics_mod, lc) in sorted(PKGS.items()):
        live_dir = tmp_path / pkg
        monkeypatch.setenv("HOROVOD_CAPACITY_LIVE_DIR", str(live_dir))
        for world in (8, 16, 32):
            lc.on_window(_window(world, neg_mean=3 * 0.0005 * world,
                                 neg_count=30))
        snap = metrics_mod.snapshot()
        artifact = json.loads((live_dir / "capacity_live.json").read_text())
        out[pkg] = _clean((snap["hvd_capacity_drift_ratio"],
                           snap["hvd_capacity_refits_total"], artifact,
                           lc.live_summary()))
    assert out["port"] == out["jax"]
    drift, refits, artifact, _ = out["port"]
    assert dict((k[0], v) for k, v in drift["values"])["negotiation"] == \
        pytest.approx(3.0, rel=1e-3)
    assert refits["values"] == [[[], 1.0]]
    assert artifact["source"] == "live" and artifact["windows"] == 2


def test_on_window_is_inert_with_telemetry_off():
    for _, (_, lc) in sorted(PKGS.items()):
        lc.on_window(_window(8, neg_mean=0.004, neg_count=30))
        assert lc.get() is None and lc.live_summary() is None


def test_persist_on_shutdown_equal(monkeypatch, tmp_path):
    _enable(monkeypatch)
    out = {}
    for pkg, (_, lc) in sorted(PKGS.items()):
        monkeypatch.delenv("HOROVOD_CAPACITY_LIVE_DIR", raising=False)
        assert lc.persist_on_shutdown() is None
        monkeypatch.setenv("HOROVOD_CAPACITY_LIVE_DIR", str(tmp_path / pkg))
        assert lc.persist_on_shutdown() is None  # no data yet
        lc.ensure().ingest_window(_window(8, neg_mean=0.004, neg_count=30))
        path = lc.persist_on_shutdown()
        assert path.endswith("capacity_live.json")
        with open(path) as f:
            out[pkg] = json.load(f)
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("pin", [None, "bucket", "chunk"])
def test_reseed_from_live_applies_the_same_seeds(monkeypatch, pin):
    if pin == "bucket":
        monkeypatch.setenv("HOROVOD_BUCKET_BYTES", str(4 << 20))
    if pin == "chunk":
        monkeypatch.setenv("HOROVOD_RING_CHUNK_BYTES", str(1 << 18))
    out = {}
    for pkg, (glue, cfg, lc) in sorted({
            "jax": (jglue, JConfig, jlc),
            "port": (tglue, TConfig, tlc)}.items()):
        live = lc.ensure()
        for world in (8, 16, 32):
            live.ingest_window(_window(world, neg_mean=0.0005 * world,
                                       neg_count=30))
        pm = glue.make_parameter_manager(cfg.from_env(), tune_bucket=True,
                                         tune_ring_chunk=True,
                                         world_size=1024)
        applied = glue.reseed_from_live(pm, 1024)
        out[pkg] = (applied, pm.bucket_bytes, pm.ring_chunk_bytes)
    assert out["port"] == out["jax"]
    if pin is None:
        assert out["port"][0] == {"bucket_bytes": 1 << 26,
                                  "ring_chunk_bytes": 1 << 20}
    if pin == "bucket":
        assert out["port"][1] == 4 << 20


def test_reseed_from_live_without_data_or_tuner():
    assert tglue.reseed_from_live(None, 64) is None
    tlc.ensure()  # a live instance with no window yet
    assert tglue.reseed_from_live(None, 64) is None
    pm = tglue.make_parameter_manager(TConfig.from_env(), tune_bucket=True,
                                      world_size=64)
    assert tglue.reseed_from_live(pm, 64) is None


# ---------------------------------------------------------------------------
# The drift drive on the port's simulated cluster

# No window rolls on its own within a test: each is one the test closes.
TEST_WINDOWS = {"HOROVOD_METRICS_WINDOW_SECONDS": "3600"}


def _spec(name):
    from horovod_tpu_torch.sim import allreduce_spec

    return allreduce_spec(name, lambda r: np.ones(4, np.float32))


def _drift(c):
    return [f for f in c.doctor_report()["findings"]
            if f["rule"] == "calibration_drift"]


def test_live_drift_drive_fires_heals_and_persists(tmp_path, monkeypatch):
    from horovod_tpu_torch.sim import SimCluster
    from horovod_tpu_torch.utils import scaling_model as tsm

    live_dir = tmp_path / "live"
    committed_path = tmp_path / "committed.json"
    step = 0
    cluster = SimCluster(ranks=4, elastic=True, protocheck=True,
                         env={"HOROVOD_CAPACITY_LIVE_DIR": str(live_dir),
                              **TEST_WINDOWS})
    with cluster as c:
        for _ in range(3):
            for _ in range(8):
                c.run_step([_spec(f"s.{step}")])
                step += 1
            assert c.roll_window() is not None
        healthy = tlc.get().refit()
        assert healthy is not None
        committed_path.write_text(json.dumps(healthy))
        monkeypatch.setenv("HOROVOD_CAPACITY_CALIBRATION",
                           str(committed_path))
        baseline = tsm.control_plane_from_artifact(
            healthy).negotiation_per_rank_s
        assert not _drift(c)
        finding = None
        for _ in range(3):
            for _ in range(2):
                c.run_step([_spec(f"s.{step}")], delays={1: 0.15})
                step += 1
            c.roll_window()
            drift = _drift(c)
            if drift:
                finding = drift[0]
                break
        assert finding is not None, \
            "calibration_drift never fired within 3 drifted windows"
        assert finding["evidence"]["plane"] == "negotiation"
        assert finding["evidence"]["ratio"] >= \
            finding["evidence"]["threshold"]
        drifted_path = tlc.persist(str(live_dir))
        assert drifted_path is not None
        with open(drifted_path) as f:
            drifted = tsm.control_plane_from_artifact(json.load(f))
        assert drifted.source == "live"
        assert drifted.negotiation_per_rank_s >= 2 * baseline
        for _ in range(9):
            for _ in range(4):
                c.run_step([_spec(f"s.{step}")])
                step += 1
            c.roll_window()
        assert not _drift(c)
    final = json.loads((live_dir / "capacity_live.json").read_text())
    assert final["source"] == "live"
    assert tsm.control_plane_from_artifact(final).negotiation_per_rank_s \
        < drifted.negotiation_per_rank_s
    report = cluster.protocheck_report
    assert report is not None and not report["violations"]


def test_live_drift_twin_stays_silent(tmp_path, monkeypatch):
    from horovod_tpu_torch.sim import SimCluster

    committed_path = tmp_path / "committed.json"
    step = 0
    cluster = SimCluster(ranks=4, elastic=True, protocheck=True,
                         env=TEST_WINDOWS)
    with cluster as c:
        for _ in range(4):
            for _ in range(3):
                c.run_step([_spec(f"t.{step}")])
                step += 1
            c.roll_window()
        committed_path.write_text(json.dumps(tlc.get().refit()))
        monkeypatch.setenv("HOROVOD_CAPACITY_CALIBRATION",
                           str(committed_path))
        for window in range(20):
            for _ in range(3):
                c.run_step([_spec(f"t.{step}")])
                step += 1
            c.roll_window()
            assert not _drift(c), (window, _drift(c))
    report = cluster.protocheck_report
    assert report is not None and not report["violations"]
