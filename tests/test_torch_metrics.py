"""The port's metrics plane and the serving engine's telemetry, held
against the JAX package on the CPU.

* **Registry.** The same sequence of counter, gauge and histogram
  operations on the port's registry copy and on the JAX package's gives
  equal ``snapshot()`` dicts and identical Prometheus text; ``on()``
  reads ``HOROVOD_METRICS`` / ``HOROVOD_METRICS_PORT`` as the JAX
  package does ("0"/"false" mean off).
* **Engine.** One deterministic ``run_until_idle`` workload (a shared
  prefix, a pool small enough to preempt, a cancel and a reject) through
  the JAX engine and the port's engine, on the same weights, gives the
  same ``hvd_serving_*`` counters and histogram counts.
* **Trace.** Under ``HOROVOD_TRACE_DIR`` the port's engine writes the
  ``schedule``, ``prefill`` and ``decode`` spans, with the JAX engine's
  span arguments.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import metrics as jmetrics
from horovod_tpu.metrics import registry as jregistry
from horovod_tpu.models import llama as jllama
from horovod_tpu.serving import RejectedError as JRejectedError
from horovod_tpu.serving import ServingConfig as JServingConfig
from horovod_tpu.serving.engine import ServingEngine as JServingEngine
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.metrics import registry as tregistry
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models.convert import llama_from_flax
from horovod_tpu_torch.serving import RejectedError, ServingConfig
from horovod_tpu_torch.serving import ServingEngine

JCFG = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32,
                           max_seq_len=64)
TCFG = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32,
                           max_seq_len=64)
JMODEL = jllama.LlamaLM(JCFG)


@pytest.fixture(scope="module")
def pair():
    variables = JMODEL.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return variables, llama_from_flax(params, TCFG, device="cpu")


@pytest.fixture
def both_on():
    """Metrics enabled on both packages, and forgotten afterwards."""
    jmetrics.reset_for_tests()
    tmetrics.reset_for_tests()
    jmetrics.enable()
    tmetrics.enable()
    yield
    jmetrics.reset_for_tests()
    tmetrics.reset_for_tests()


# ---------------------------------------------------------------------------
# Registry


def _drive(reg):
    """One fixed sequence of operations on a registry module's
    ``MetricsRegistry``; returns the registry."""
    r = reg.MetricsRegistry()
    c = r.counter("hvd_test_requests_total", "Requests by outcome.",
                  ("outcome",))
    c.labels("finished").inc()
    c.labels(outcome="finished").inc(2)
    c.labels("failed").inc(0.5)
    plain = r.counter("hvd_test_steps_total", "Steps.\nTwo lines \\ here.")
    plain.inc(7)
    g = r.gauge("hvd_test_depth", "Queue depth.")
    g.set(3)
    g.inc(4)
    g.dec(1.25)
    lg = r.gauge("hvd_test_replica", 'Per replica "load".', ("replica",))
    lg.labels('r"0').set(1)
    lg.labels("r\n1").set(2.5)
    h = r.histogram("hvd_test_latency_seconds", "Latency.")
    for x in (5e-5, 1e-4, 3e-3, 0.2, 0.2, 7.0, 1e4):
        h.observe(x)
    hb = r.histogram("hvd_test_sizes", "Sizes.", ("kind",),
                     buckets=reg.log_buckets(1.0, 4.0, 6))
    for i, x in enumerate((0.5, 1, 3, 17, 900, 5000)):
        hb.labels("ab"[i % 2]).observe(x)
    # A re-fetch returns the same metric; a conflicting one raises.
    assert r.counter("hvd_test_steps_total") is plain
    for bad in (lambda: r.gauge("hvd_test_steps_total"),
                lambda: r.histogram("hvd_test_sizes", "", ("kind",),
                                    buckets=(1.0, 2.0)),
                lambda: c.labels("a", "b"),
                lambda: c.labels(kind="x")):
        with pytest.raises(ValueError):
            bad()
    return r


def test_registry_snapshot_and_exposition_match_the_jax_registry():
    jr, tr = _drive(jregistry), _drive(tregistry)
    jsnap, tsnap = jr.snapshot(), tr.snapshot()
    assert tsnap == jsnap
    assert json.loads(json.dumps(tsnap)) == tsnap       # JSON-clean
    for rank, remote in ((None, None), (0, {1: jsnap, 3: {}})):
        want = jregistry.render_prometheus(jsnap, rank, remote)
        assert tregistry.render_prometheus(tsnap, rank, remote) == want
    assert "# TYPE hvd_test_latency_seconds histogram" in \
        tregistry.render_prometheus(tsnap)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        for name in ("hvd_test_latency_seconds", "hvd_test_sizes"):
            assert tregistry.quantile(tsnap[name], q) == \
                jregistry.quantile(jsnap[name], q)
    assert tregistry.quantile(None, 0.5) is None
    # Deltas between two snapshots: counters and histograms subtract,
    # gauges pass the current level through.
    for r in (jr, tr):
        r.get("hvd_test_steps_total").inc(2)
        r.get("hvd_test_latency_seconds").observe(0.01)
        r.get("hvd_test_depth").set(11)
    delta = tregistry.subtract_snapshots(tr.snapshot(), tsnap)
    assert delta == jregistry.subtract_snapshots(jr.snapshot(), jsnap)
    assert delta["hvd_test_steps_total"]["values"] == [[[], 2.0]]
    assert tregistry.DEFAULT_TIME_BUCKETS == jregistry.DEFAULT_TIME_BUCKETS


@pytest.mark.parametrize("env,want", [
    ({}, False), ({"HOROVOD_METRICS": "1"}, True),
    ({"HOROVOD_METRICS": "0"}, False), ({"HOROVOD_METRICS": "false"}, False),
    ({"HOROVOD_METRICS": " Off "}, False),
    ({"HOROVOD_METRICS_PORT": "9100"}, True),
    ({"HOROVOD_METRICS_PORT": "0"}, False),
    ({"HOROVOD_METRICS_PORT": "junk"}, False),
    ({"HOROVOD_METRICS": "0", "HOROVOD_METRICS_PORT": "9100"}, True)])
def test_on_reads_the_env_as_the_jax_package_does(monkeypatch, env, want):
    for name in ("HOROVOD_METRICS", "HOROVOD_METRICS_PORT",
                 "HOROVOD_FLIGHT_RECORDER"):
        monkeypatch.delenv(name, raising=False)
    for name, value in sorted(env.items()):
        monkeypatch.setenv(name, value)
    try:
        jmetrics.reset_for_tests()
        tmetrics.reset_for_tests()
        assert tmetrics.on() is want
        assert jmetrics.on() is want
        # The answer is cached: a later env change does not flip it.
        monkeypatch.setenv("HOROVOD_METRICS", "0" if want else "1")
        assert tmetrics.on() is want
        tmetrics.enable()
        assert tmetrics.on() is True
    finally:
        jmetrics.reset_for_tests()
        tmetrics.reset_for_tests()


def test_nothing_registers_until_the_engine_runs(pair, both_on,
                                                  monkeypatch):
    # A snapshot mirrors the native core's counters in any process that
    # has loaded the core, as an earlier test in this process may have:
    # this test holds the serving engine, so the core reads as unloaded.
    from horovod_tpu_torch.core import bindings

    monkeypatch.setattr(bindings, "loaded", lambda: None)
    _, model = pair
    assert tmetrics.snapshot() == {}
    ServingEngine(model, config=ServingConfig(max_batch=2, block_size=8,
                                              max_seq_len=64))
    assert tmetrics.snapshot() == {}
    assert "hvd_serving" not in tmetrics.render_all()


# ---------------------------------------------------------------------------
# Engine counters, JAX engine vs port engine


SCFG = dict(max_batch=3, block_size=4, num_blocks=10, queue_depth=32,
            max_seq_len=28)


def _workload():
    """A shared 8-token prefix with short tails and 10-12 new tokens each
    over a 10-block pool: preemptions, prefix hits and donor evictions."""
    rng = np.random.RandomState(5)
    shared = rng.randint(0, TCFG.vocab_size, (8,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(
        0, TCFG.vocab_size, ((2, 3, 5)[i % 3],)).astype(np.int32)])
        for i in range(6)]
    news = [(10, 12)[i % 2] for i in range(6)]
    return prompts, news


def _run(engine, rejected_cls):
    prompts, news = _workload()
    handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
    with pytest.raises(rejected_cls):          # can never fit: rejected
        engine.submit(np.arange(40, dtype=np.int32), 4)
    handles[-1].cancel()                       # still waiting: cancelled
    engine.run_until_idle()
    tokens = [h.result(timeout=0) for h in handles[:-1]]
    engine.shutdown()
    return tokens


SERVING_COUNTERS = (
    "hvd_serving_requests_total", "hvd_serving_tokens_generated_total",
    "hvd_serving_steps_total", "hvd_serving_preemptions_total",
    "hvd_serving_prefix_hits_total", "hvd_serving_prefix_misses_total",
    "hvd_serving_prefix_evictions_total", "hvd_serving_cow_copies_total")


def test_engine_counters_match_the_jax_engine(pair, both_on):
    variables, model = pair
    jtokens = _run(JServingEngine(JMODEL, variables,
                                  config=JServingConfig(**SCFG)),
                   JRejectedError)
    ttokens = _run(ServingEngine(model, config=ServingConfig(**SCFG)),
                   RejectedError)
    assert ttokens == jtokens
    jsnap, tsnap = jmetrics.snapshot(), tmetrics.snapshot()
    for name in SERVING_COUNTERS:
        assert tsnap[name]["values"] == jsnap[name]["values"], name
    outcomes = dict((k[0], v) for k, v in
                    tsnap["hvd_serving_requests_total"]["values"])
    assert outcomes == {"finished": 5.0, "rejected": 1.0, "cancelled": 1.0}
    assert tsnap["hvd_serving_preemptions_total"]["values"][0][1] > 0
    assert tsnap["hvd_serving_prefix_hits_total"]["values"][0][1] > 0
    for name in ("hvd_serving_ttft_seconds", "hvd_serving_tpot_seconds"):
        (_, jval), = jsnap[name]["values"]
        (_, tval), = tsnap[name]["values"]
        assert tval["count"] == jval["count"] > 0, name
        assert sum(tval["counts"]) == tval["count"]
        assert tsnap[name]["buckets"] == jsnap[name]["buckets"]
    # Gauges hold the last sweep of a live engine (shutdown publishes
    # nothing), in both packages alike.
    for name in ("hvd_serving_queue_limit", "hvd_serving_blocks_total",
                 "hvd_serving_queue_depth", "hvd_serving_active_sequences"):
        assert tsnap[name]["values"] == jsnap[name]["values"], name
    assert tsnap["hvd_serving_queue_limit"]["values"] == [[[], 32]]
    for name, entry in sorted(jsnap.items()):
        if name.startswith("hvd_serving_"):
            assert tsnap[name]["help"] == entry["help"], name
            assert tsnap[name]["type"] == entry["type"], name
    assert set(n for n in tsnap if n.startswith("hvd_serving_")) == set(
        n for n in jsnap if n.startswith("hvd_serving_"))


# ---------------------------------------------------------------------------
# Trace spans


def _spans(path):
    with open(path) as f:
        events = json.load(f)
    return [e for e in events if e.get("ph") == "X"], events


def test_engine_writes_schedule_prefill_decode_spans(pair, tmp_path,
                                                     monkeypatch):
    variables, model = pair
    monkeypatch.delenv("HOROVOD_RANK", raising=False)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setenv("HOROVOD_TRACE_DIR", str(tdir))
    engine = ServingEngine(model, config=ServingConfig(**SCFG))
    prompts, news = _workload()
    for p, n in zip(prompts[:3], news[:3]):
        engine.submit(p, n)
    engine.run_until_idle()
    engine.shutdown()
    monkeypatch.setenv("HOROVOD_TRACE_DIR", str(jdir))
    jengine = JServingEngine(JMODEL, variables,
                             config=JServingConfig(**SCFG))
    for p, n in zip(prompts[:3], news[:3]):
        jengine.submit(p, n)
    jengine.run_until_idle()
    jengine.shutdown()

    spans, events = _spans(os.path.join(tdir, "trace.serving.rank0.json"))
    jspans, _ = _spans(os.path.join(jdir, "trace.serving.rank0.json"))
    names = [e["name"] for e in spans]
    assert {"schedule", "prefill", "decode"} <= set(names)
    assert names.count("prefill") >= 3      # recompute prefills too
    assert [e["name"] for e in events if e.get("ph") == "M"][0] == \
        "clock_sync"
    assert events[-1]["name"] == "trace_end"
    assert events[-1]["args"]["dropped_events"] == 0
    # The JAX engine's span vocabulary, track ids and argument keys.
    key = {e["name"]: (e["tid"], sorted(e["args"])) for e in jspans}
    assert {e["name"]: (e["tid"], sorted(e["args"])) for e in spans} == key
    assert sorted(names) == sorted(e["name"] for e in jspans)
    assert all(e["dur"] >= 0 and e["pid"] == 0 for e in spans)
