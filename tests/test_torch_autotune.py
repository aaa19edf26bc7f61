"""The port's autotuner (``common/autotune.py``,
``controller/autotune_glue.py``) and its new config knobs against the JAX
package's, on the CPU.

Both tuners are numpy over the same seeded ``RandomState``, so the same
sample stream must give the same proposals, the same ``state()`` after
every sample and the same CSV log, byte for byte (``time.time()`` is
replaced by one counter on both sides): the tolerance is exact equality.
The environment rules (which knobs ``fixed=`` pins, where the search
starts, the capacity priors) are held the same way, and so are the
``hvd_autotune_*`` gauges.
"""

import itertools
import json
import os
import time

import numpy as np
import pytest

from horovod_tpu.common import autotune as jat
from horovod_tpu.common import config as jconfig
from horovod_tpu.controller import autotune_glue as jglue

from horovod_tpu_torch.common import autotune as pat
from horovod_tpu_torch.common import config as pconfig
from horovod_tpu_torch.controller import autotune_glue as pglue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Constructor arguments of the tuner: the Python controller's set (all
# categoricals searchable, the bucket knob), the native engine's (ring
# chunk and bucket, categoricals pinned), the legacy 2-D box, and pinned
# knobs.
CASES = {
    "python-engine": dict(
        fusion_threshold=64 << 20, cycle_time_ms=5.0,
        categoricals={"hierarchical_allreduce": False,
                      "hierarchical_allgather": True,
                      "cache_enabled": True},
        straggler_weight=1.0, overlap_weight=1.0, bucket_bytes=8 << 20),
    "native-engine": dict(
        fusion_threshold=64 << 20, cycle_time_ms=1.0,
        categoricals={"hierarchical_allreduce": False,
                      "hierarchical_allgather": False,
                      "cache_enabled": True},
        fixed=frozenset({"hierarchical_allreduce",
                         "hierarchical_allgather", "cache_enabled"}),
        straggler_weight=1.0, overlap_weight=1.0,
        ring_chunk_bytes=1 << 20, bucket_bytes=8 << 20),
    "legacy-2d": dict(fusion_threshold=1 << 24, cycle_time_ms=3.5),
    "pinned": dict(
        fusion_threshold=3_000_001, cycle_time_ms=2.5,
        categoricals={"cache_enabled": False},
        fixed=frozenset({"fusion_threshold"}), straggler_weight=0.5,
        bucket_bytes=4 << 20),
}


def _stream(seed, n):
    """``n`` seeded cycle samples: (bytes, seconds, slack, wait,
    overlap), some of them empty (skipped by both tuners)."""
    rng = np.random.RandomState(seed)
    for k in range(n):
        nbytes = int(rng.randint(0, 1 << 24)) if k % 17 else 0
        yield (nbytes, float(rng.uniform(1e-4, 2e-2)),
               float(rng.uniform(0, 2e-3)), float(rng.uniform(0, 1e-3)),
               None if k % 5 == 0 else float(rng.uniform(0, 1)))


@pytest.fixture
def fixed_clock(monkeypatch):
    """One counter for ``time.time()`` on both sides, reset per run."""
    def install():
        counter = itertools.count(1_700_000_000)
        monkeypatch.setattr(time, "time", lambda: float(next(counter)))
    return install


@pytest.mark.parametrize("case", sorted(CASES))
def test_proposals_state_and_log_match_the_jax_tuner(tmp_path, fixed_clock,
                                                     case):
    runs = {}
    for pkg, mod in (("jax", jat), ("port", pat)):
        fixed_clock()
        log = tmp_path / f"{pkg}.csv"
        pm = mod.ParameterManager(log_path=str(log), seed=3, **CASES[case])
        trail = []
        for sample in _stream(11, 900):
            out = pm.record(*sample[:2], slack_seconds=sample[2],
                            recv_wait_seconds=sample[3], overlap=sample[4])
            trail.append((out, json.dumps(pm.state(), sort_keys=True)))
        runs[pkg] = (trail, log.read_bytes() if log.exists() else b"",
                     pm.tunable, dict(pm.categoricals))
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][1:] == runs["jax"][1:]
    moves = [t for t, _ in runs["port"][0] if t is not None]
    assert len(moves) >= 2, case
    assert runs["port"][1].count(b"\n") >= 3


def test_tuning_completes_and_pins_the_same_best():
    """Past BO_MAX_STEPS both tuners stop on the same pinned best."""
    pms = [mod.ParameterManager(64 << 20, 5.0, seed=0, bucket_bytes=8 << 20)
           for mod in (jat, pat)]
    for sample in _stream(5, 6000):
        outs = [pm.record(*sample[:2]) for pm in pms]
        assert outs[0] == outs[1]
    assert [pm.tunable for pm in pms] == [False, False]
    assert pms[0].state() == pms[1].state()
    assert pms[1].state()["steps_completed"] == pat.ParameterManager.BO_MAX_STEPS


def test_gaussian_process_and_optimizer_are_the_jax_ones():
    rng = np.random.RandomState(0)
    x = rng.rand(7, 3)
    y = np.sin(x.sum(1) * 3)
    q = rng.rand(11, 3)
    gps = [mod.GaussianProcess(length_scale=0.3) for mod in (jat, pat)]
    for gp in gps:
        gp.fit(x, y)
    np.testing.assert_array_equal(gps[0].predict(q)[0], gps[1].predict(q)[0])
    np.testing.assert_array_equal(gps[0].predict(q)[1], gps[1].predict(q)[1])
    bos = [mod.BayesianOptimizer([(20.0, 28.0), (1.0, 25.0)], seed=4)
           for mod in (jat, pat)]
    for step in range(6):
        picks = [bo.suggest() for bo in bos]
        np.testing.assert_array_equal(picks[0], picks[1])
        for bo in bos:
            bo.add_sample(picks[0], float(np.cos(picks[0]).sum() + step))
    assert pat.ParameterManager.blend(1e9, 0.1, 0.05, 1.0, 0.5, 1.0) == \
        jat.ParameterManager.blend(1e9, 0.1, 0.05, 1.0, 0.5, 1.0)


KNOB_ENVS = {
    "unset": {},
    "pinned": {"HOROVOD_FUSION_THRESHOLD": "1048576",
               "HOROVOD_CYCLE_TIME": "2", "HOROVOD_BUCKET_BYTES": "4194304",
               "HOROVOD_RING_CHUNK_BYTES": "131072",
               "HOROVOD_CACHE_CAPACITY": "0"},
    "auto-sentinels": {"HOROVOD_BUCKET_BYTES": "0",
                       "HOROVOD_RING_CHUNK_BYTES": "garbage",
                       "HOROVOD_HIERARCHICAL_ALLREDUCE": "1"},
    "weights": {"HOROVOD_AUTOTUNE_STRAGGLER_WEIGHT": "-3",
                "HOROVOD_AUTOTUNE_OVERLAP_WEIGHT": "0.25",
                "HOROVOD_AUTOTUNE": "yes",
                "HOROVOD_AUTOTUNE_LOG": "/tmp/at.csv",
                "HOROVOD_TRACE_DIR": "  /tmp/tr  ",
                "HOROVOD_CLOCK_SYNC_CYCLES": "7"},
    "garbage": {"HOROVOD_AUTOTUNE": "0", "HOROVOD_AUTOTUNE_LOG": "",
                "HOROVOD_TRACE_DIR": "   ",
                "HOROVOD_AUTOTUNE_STRAGGLER_WEIGHT": "x",
                "HOROVOD_AUTOTUNE_OVERLAP_WEIGHT": "-1",
                "HOROVOD_CLOCK_SYNC_CYCLES": "0",
                "HOROVOD_BUCKET_BYTES": "-5",
                "HOROVOD_AUTOTUNE_PRIORS": "CAPACITY",
                "HOROVOD_CAPACITY_CALIBRATION": " "},
}

_KNOB_VARS = ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_CYCLE_TIME",
              "HOROVOD_BUCKET_BYTES", "HOROVOD_RING_CHUNK_BYTES",
              "HOROVOD_CACHE_CAPACITY", "HOROVOD_HIERARCHICAL_ALLREDUCE",
              "HOROVOD_HIERARCHICAL_ALLGATHER", "HOROVOD_AUTOTUNE",
              "HOROVOD_AUTOTUNE_LOG", "HOROVOD_TRACE_DIR",
              "HOROVOD_AUTOTUNE_STRAGGLER_WEIGHT",
              "HOROVOD_AUTOTUNE_OVERLAP_WEIGHT", "HOROVOD_CLOCK_SYNC_CYCLES",
              "HOROVOD_AUTOTUNE_PRIORS", "HOROVOD_CAPACITY_CALIBRATION",
              "HOROVOD_RING_ADDRS", "HOROVOD_RING_LINK_CLASS")


def _set_env(monkeypatch, env):
    for var in _KNOB_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in sorted(env.items()):
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("env", sorted(KNOB_ENVS))
def test_config_knobs_resolve_as_the_jax_config(monkeypatch, env):
    _set_env(monkeypatch, KNOB_ENVS[env])
    port, jax = pconfig.Config.from_env(), jconfig.Config.from_env()
    assert (port.autotune, port.autotune_log, port.trace_dir) == \
        (jax.autotune, jax.autotune_log, jax.trace_dir)
    for name in ("bucket_bytes", "resolved_bucket_bytes", "ring_chunk_bytes",
                 "resolved_ring_chunk_bytes", "autotune_straggler_weight",
                 "autotune_overlap_weight", "autotune_priors",
                 "capacity_calibration_path"):
        assert getattr(pconfig, name)() == getattr(jconfig, name)(), name
    assert pconfig.DEFAULT_BUCKET_BYTES == jconfig.DEFAULT_BUCKET_BYTES
    # The JAX controller reads HOROVOD_CLOCK_SYNC_CYCLES inline.
    assert pconfig.clock_sync_cycles() == max(
        1, jconfig._env_int("HOROVOD_CLOCK_SYNC_CYCLES", 100))


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("env", sorted(KNOB_ENVS))
def test_fixed_knobs_follow_the_jax_env_rules(monkeypatch, env, engine):
    _set_env(monkeypatch, KNOB_ENVS[env])
    # The two controllers' calls of make_parameter_manager.
    kwargs = (dict(tune_hierarchical=False, tune_cache=True,
                   tune_bucket=True, world_size=2) if engine == "python"
              else dict(tune_ring_chunk=True, tune_bucket=True,
                        world_size=2))
    pms = [jglue.make_parameter_manager(jconfig.Config.from_env(), **kwargs),
           pglue.make_parameter_manager(pconfig.Config.from_env(), **kwargs)]
    assert pms[1].fixed == pms[0].fixed
    assert pms[1].state() == pms[0].state()
    assert pms[1].categoricals == pms[0].categoricals
    assert (pms[1]._tune_chunk, pms[1]._tune_bucket) == \
        (pms[0]._tune_chunk, pms[0]._tune_bucket)


@pytest.mark.parametrize("ranks", [2, 64, 4096])
def test_capacity_priors_seed_as_the_jax_glue(monkeypatch, ranks):
    _set_env(monkeypatch, {
        "HOROVOD_AUTOTUNE_PRIORS": "capacity",
        "HOROVOD_CAPACITY_CALIBRATION": os.path.join(
            REPO, "artifacts", "capacity_r17.json")})
    port, jax = pglue._capacity_priors(ranks), jglue._capacity_priors(ranks)
    assert port == jax and port is not None
    pm = pglue.make_parameter_manager(
        pconfig.Config.from_env(), tune_ring_chunk=True, tune_bucket=True,
        world_size=ranks)
    assert (pm.bucket_bytes, pm.ring_chunk_bytes) == \
        (port["bucket_bytes"], port["ring_chunk_bytes"])


def test_tuner_gauges_are_the_jax_series():
    from horovod_tpu import metrics as jmetrics
    from horovod_tpu_torch import metrics as pmetrics

    snaps = []
    for metrics, glue, mod in ((jmetrics, jglue, jat),
                               (pmetrics, pglue, pat)):
        metrics.reset_for_tests()
        metrics.enable()
        pm = mod.ParameterManager(64 << 20, 5.0, seed=1,
                                  straggler_weight=1.0, overlap_weight=1.0,
                                  bucket_bytes=8 << 20)
        for sample in _stream(2, 200):
            pm.record(*sample[:2], slack_seconds=sample[2],
                      recv_wait_seconds=sample[3], overlap=sample[4])
        glue.publish_tuner_gauges(pm)
        snap = metrics.snapshot()
        snaps.append({k: v for k, v in sorted(snap.items())
                      if k.startswith("hvd_autotune_")})
        metrics.reset_for_tests()
    assert len(snaps[1]) == 9
    assert snaps[1] == snaps[0]


@pytest.mark.parametrize("module,factory,names", [
    ("controller.bucket_scheduler", "_overlap_metrics",
     ["buckets", "efficiency", "priority_jumps"]),
    ("controller.autotune_glue", "_autotune_metrics", None),
    ("trace.straggler", "_straggler_metrics", ["slack", "cycles"]),
    ("controller.controller", "_ctl_metrics", ["tick_lateness"]),
])
def test_series_keep_the_jax_names_and_help(module, factory, names):
    """The tuning and tracing loop's series: the JAX package's names,
    kinds, help strings and labels."""
    import importlib

    from horovod_tpu import metrics as jmetrics
    from horovod_tpu_torch import metrics as pmetrics

    shapes = []
    for metrics, pkg in ((jmetrics, "horovod_tpu"),
                         (pmetrics, "horovod_tpu_torch")):
        metrics.reset_for_tests()
        ns = getattr(importlib.import_module(f"{pkg}.{module}"), factory)()
        keys = names or sorted(vars(ns))
        shapes.append({k: (getattr(ns, k).name, getattr(ns, k).kind,
                           getattr(ns, k).help,
                           tuple(getattr(ns, k).labelnames)) for k in keys})
        metrics.reset_for_tests()
    assert shapes[1] == shapes[0]
