"""The port's serving fleet (``horovod_tpu_torch.serving.Router``): the
tier-1 cases of ``tests/test_serving_fleet.py`` held by the port on the
CPU — placement (prefix affinity, then least-loaded), replica death as a
reshape (queued re-route, in-flight replay, zero lost requests), joins,
the router metrics and the ``serving.fleet`` module API.

Port engines run over weights crossed from the JAX model with
``llama_from_flax``; every request's tokens equal the JAX ``generate()``
on the same weights, replayed requests included. On the CPU the paged
decode wrapper runs its plain version. The two chaos cases at load
generator scale are ``@slow`` here as there. The JAX file's two doctor
cases (the flapping and prefix-collapse rules) run on the port's doctor
and hold its findings equal to the JAX doctor's on the same snapshots.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jllama
from horovod_tpu_torch import metrics
from horovod_tpu_torch import serving
from horovod_tpu_torch.examples import serving_loadgen as loadgen
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models.convert import llama_from_flax
from horovod_tpu_torch.serving import (
    RejectedError,
    Router,
    RouterConfig,
    ServingConfig,
    ServingEngine,
)
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JCFG = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32,
                           max_seq_len=64)
TCFG = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32,
                           max_seq_len=64)
JMODEL = jllama.LlamaLM(JCFG)
SCFG = ServingConfig(max_batch=2, block_size=8, num_blocks=0,
                     queue_depth=64, max_seq_len=64)


@pytest.fixture(scope="module")
def pair():
    """(JAX variables, the port's model on the same weights)."""
    variables = JMODEL.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return variables, llama_from_flax(params, TCFG, device="cpu")


def _engines(model, n, config=SCFG):
    return [ServingEngine(model, config=config) for _ in range(n)]


def _drive_until_idle(router, max_steps=100000):
    """Synchronously step every live replica until the whole fleet is
    idle (deterministic scheduling, like engine.run_until_idle)."""
    for _ in range(max_steps):
        busy = False
        for engine in router.engines():
            busy |= engine.step()
        if not busy:
            return
    raise RuntimeError("fleet still busy")


def _prompts(seed, n, shared_len=16, tails=(3, 5, 9)):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, TCFG.vocab_size, (shared_len,)).astype(np.int32)
    return [np.concatenate(
        [shared, rng.randint(0, TCFG.vocab_size,
                             (tails[i % len(tails)],)).astype(np.int32)])
        for i in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_tokens(prompt_bytes, n, variables_id):
    variables = _VARIABLES[variables_id]
    prompt = np.frombuffer(prompt_bytes, np.int32)
    ref = jllama.generate(JMODEL, variables, jnp.asarray(prompt[None]),
                          max_new_tokens=n)
    return list(np.asarray(ref)[0, len(prompt):])


_VARIABLES = {}


def _want(variables, prompt, n):
    """JAX ``generate()`` of ``prompt`` alone on ``variables``."""
    _VARIABLES[id(variables)] = variables
    return _jax_tokens(np.asarray(prompt, np.int32).tobytes(), n,
                       id(variables))


def _assert_router_parity(variables, prompts, news, handles):
    for i, (prompt, n, handle) in enumerate(zip(prompts, news, handles)):
        got = handle.result(timeout=120)
        want = _want(variables, prompt, n)
        assert got == want, (
            f"request {i} (replays={handle.replays}) diverged:\n"
            f" got={got}\nwant={want}")


# ---------------------------------------------------------------------------
# Config / placement


def test_router_env_knobs_parse(monkeypatch):
    from horovod_tpu_torch.common import config as hvd_config

    monkeypatch.setenv("HOROVOD_ROUTER_REPLICAS", "5")
    monkeypatch.setenv("HOROVOD_ROUTER_AFFINITY", "0")
    monkeypatch.setenv("HOROVOD_ROUTER_RETRIES", "-1")
    rcfg = RouterConfig.from_env()
    assert rcfg.replicas == 5
    assert rcfg.affinity is False
    assert rcfg.retries == 0              # negative clamps
    assert hvd_config.router_replicas() == 5
    monkeypatch.setenv("HOROVOD_ROUTER_REPLICAS", "0")
    monkeypatch.delenv("HOROVOD_ROUTER_AFFINITY")
    assert RouterConfig.from_env() == RouterConfig(replicas=2,
                                                   affinity=True, retries=0)


def test_router_least_loaded_spreads_unrelated_prompts(pair):
    variables, model = pair
    router = Router(_engines(model, 3), RouterConfig(affinity=False))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, TCFG.vocab_size, (8 + i,)).astype(np.int32)
               for i in range(6)]
    handles = [router.submit(p, 4) for p in prompts]
    # Least-loaded round-robins a uniform fleet: 2 requests each.
    by_replica = {}
    for handle in handles:
        by_replica.setdefault(handle.replica_id, 0)
        by_replica[handle.replica_id] += 1
    assert sorted(by_replica.values()) == [2, 2, 2]
    _drive_until_idle(router)
    _assert_router_parity(variables, prompts, [4] * 6, handles)
    router.shutdown()


def test_router_prefix_affinity_follows_warm_pages(pair):
    """Same shared prefix -> same replica (its cache is warm); the
    router records affinity hits and the landing replica shows prefix
    hits while the others stay cold."""
    variables, model = pair
    router = Router(_engines(model, 3), RouterConfig())
    prompts = _prompts(1, 6)
    handles = [router.submit(p, 4) for p in prompts]
    assert len({h.replica_id for h in handles}) == 1
    _drive_until_idle(router)
    target = handles[0].replica_id
    stats = {rid: router.engine(rid).stats()
             for rid in router.replicas()}
    assert stats[target]["prefix_hits"] > 0
    assert all(stats[rid]["prefix_hits"] == 0
               for rid in stats if rid != target)
    with router._lock:
        assert router._affinity_hits >= 5    # all but the first placement
    _assert_router_parity(variables, prompts, [4] * 6, handles)
    router.shutdown()


def test_router_rejects_only_when_every_replica_rejects(pair):
    _, model = pair
    scfg = dataclasses.replace(SCFG, queue_depth=1)
    router = Router(_engines(model, 2, scfg), RouterConfig(affinity=False))
    prompt = np.arange(8, dtype=np.int32)
    for _ in range(2):                     # one queued per replica
        router.submit(prompt, 4)
    with pytest.raises(RejectedError, match="every live replica"):
        router.submit(prompt, 4)
    _drive_until_idle(router)
    router.shutdown()


# ---------------------------------------------------------------------------
# Membership: death = reshape, join = reshape


def test_router_replica_kill_replays_with_zero_failures(pair):
    """Kill a replica with queued AND running work; every request still
    returns exactly its JAX generate() tokens (queued re-route, in-flight
    replay skips nothing and duplicates nothing). Replays need running
    engine loops (the reroute happens inside result()), so the engines
    start theirs."""
    variables, model = pair
    metrics.reset_for_tests()
    metrics.enable()
    try:
        router = Router(_engines(model, 3), RouterConfig())
        prompts = _prompts(2, 9)          # shared prefix: affinity piles
        news = [8] * 9                    # them onto ONE replica
        handles = [router.submit(p, n) for p, n in zip(prompts, news)]
        victim = handles[0].replica_id
        # Partial progress, then a hard kill (not a router drain).
        for engine in router.engines():
            engine.step()
        router.engine(victim).shutdown()
        for engine in router.engines():
            if not engine.closed:         # the router may not yet know
                engine.start()
        _assert_router_parity(variables, prompts, news, handles)
        assert any(h.replays > 0 for h in handles), "kill replayed nobody"
        rstats = router.router_stats()
        assert rstats["router_replica_departures"] == 1
        assert rstats["router_replicas"] == 2
        assert rstats["router_reroutes"] > 0
        assert router.epoch == 1
        snap = metrics.snapshot()
        deps = {tuple(k): v for k, v in
                snap["hvd_router_replica_departures_total"]["values"]}
        assert deps[(str(victim),)] == 1.0
        reroutes = snap["hvd_router_reroutes_total"]["values"][0][1]
        assert reroutes == rstats["router_reroutes"]
        router.shutdown()
    finally:
        metrics.reset_for_tests()


def test_router_streaming_survives_kill_without_token_gap(pair):
    """A stream caught mid-kill resumes on the survivor with no gap and
    no duplicates (greedy replay + delivered-token skip)."""
    variables, model = pair
    router = Router(_engines(model, 2), RouterConfig())
    prompt = np.arange(10, dtype=np.int32)
    handle = router.submit(prompt, 8)
    victim = handle.replica_id
    streamed = []
    stream = handle.stream(timeout=120)
    for engine in router.engines():
        engine.step()                     # prefill: first token exists
    streamed.append(next(stream))
    router.engine(victim).shutdown()
    for engine in router.engines():
        if not engine.closed:
            engine.start()                # a running loop for the replay
    streamed.extend(stream)
    assert streamed == _want(variables, prompt, 8)
    assert handle.replays == 1
    router.shutdown()


def test_router_join_is_a_reshape_and_takes_load(pair):
    variables, model = pair
    router = Router(_engines(model, 1), RouterConfig(affinity=False))
    rid = router.add_replica(ServingEngine(model, config=SCFG))
    assert router.epoch == 1
    assert sorted(router.replicas()) == [0, rid]
    # Least-loaded placement drains fresh load onto the joiner too.
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, TCFG.vocab_size, (8,)).astype(np.int32)
               for _ in range(4)]
    handles = [router.submit(p, 6) for p in prompts]
    assert {h.replica_id for h in handles} == {0, rid}
    _drive_until_idle(router)
    _assert_router_parity(variables, prompts, [6] * 4, handles)
    router.shutdown()


def test_router_retries_exhausted_surfaces_failure(pair):
    _, model = pair
    router = Router(_engines(model, 2),
                    RouterConfig(affinity=False, retries=0))
    prompt = np.arange(8, dtype=np.int32)
    handle = router.submit(prompt, 6)
    router.engine(handle.replica_id).shutdown()
    with pytest.raises(RuntimeError, match="failed on 1 replica"):
        handle.result(timeout=10)
    # The fleet itself is still serving on the survivor.
    other = router.submit(prompt, 4)
    _drive_until_idle(router)
    other.result(timeout=0)
    router.shutdown()


def test_router_no_live_replica_is_loud(pair):
    _, model = pair
    router = Router(_engines(model, 1), RouterConfig())
    router.engine(0).shutdown()
    with pytest.raises(RuntimeError, match="no live serving replica"):
        router.submit(np.arange(8, dtype=np.int32), 4)
    router.shutdown()


# ---------------------------------------------------------------------------
# Module API + stats + health


def test_fleet_module_api_and_aggregate_stats(pair):
    variables, model = pair
    prev_router = serving._default_router
    prev_engine = serving._default_engine
    try:
        router = serving.fleet(model, replicas=2, config=SCFG, start=False)
        assert serving.default_router() is router
        # One model behind every replica: its weights are held once.
        engines = router.engines()
        assert all(e._model is model for e in engines)
        prompts = _prompts(4, 4)
        handles = [router.submit(p, 4) for p in prompts]
        _drive_until_idle(router)
        _assert_router_parity(variables, prompts, [4] * 4, handles)
        s = serving.stats()               # module stats ride the router
        assert s["router_replicas"] == 2
        assert s["router_requests"] == 4
        assert s["requests_finished"] == 4
        assert s["tokens_generated"] == 16
        assert set(s) == set(serving.zero_stats())
        health = router.health()
        assert set(health) == {0, 1}
        assert all(health[rid]["alive"] for rid in sorted(health))
        router.shutdown()
        assert not any(t.name == "hvd-serving-engine"
                       for t in threading.enumerate())
    finally:
        serving._default_router = prev_router
        serving._default_engine = prev_engine


def _both_diagnoses(snap, **kwargs):
    """The port's and the JAX package's diagnoses of one snapshot."""
    from horovod_tpu.doctor import Evidence as JEvidence
    from horovod_tpu.doctor import diagnose as jdiagnose
    from horovod_tpu_torch.doctor import Evidence, diagnose

    got = diagnose(Evidence(snapshots={0: snap}, **kwargs))
    want = jdiagnose(JEvidence(snapshots={0: snap}, **kwargs))
    assert [d.to_dict() for d in got] == [d.to_dict() for d in want]
    return {d.rule: d for d in got}


def test_doctor_router_flapping_rule_synthetic():
    def gauge(v):
        return {"type": "gauge", "values": [[[], v]]}

    snap = {
        "hvd_router_replica_departures_total": {
            "type": "counter", "values": [[["1"], 4.0], [["2"], 1.0]]},
        "hvd_router_replicas": gauge(2),
        "hvd_router_epoch": gauge(7),
    }
    flap = _both_diagnoses(snap)["router_replica_flapping"]
    assert flap.severity == "critical"           # 5 departures total
    assert "replica 1" in flap.hint              # names the flapper
    assert flap.evidence["departures_total"] == 5
    # One departure is elastic working as designed: silent.
    quiet = {"hvd_router_replica_departures_total": {
        "type": "counter", "values": [[["0"], 1.0]]}}
    assert "router_replica_flapping" not in _both_diagnoses(quiet)


def test_doctor_prefix_collapse_hint_branches_synthetic():
    snap = {
        "hvd_serving_prefix_hits_total": {
            "type": "counter", "values": [[[], 20.0]]},
        "hvd_serving_prefix_misses_total": {
            "type": "counter", "values": [[[], 300.0]]},
    }
    cold = _both_diagnoses(snap)
    assert "cold start" in cold["cache_hit_collapse"].hint
    assert "byte-identical" in cold["cache_hit_collapse"].hint
    rewarm = _both_diagnoses(snap, restart_epoch=3)
    assert "post-restart re-warm" in rewarm["cache_hit_collapse"].hint
    # Healthy rate: silent.
    ok = {"hvd_serving_prefix_hits_total": {
        "type": "counter", "values": [[[], 300.0]]},
        "hvd_serving_prefix_misses_total": {
            "type": "counter", "values": [[[], 20.0]]}}
    assert "cache_hit_collapse" not in _both_diagnoses(ok)


def test_router_sampled_midstream_kill_fails_loudly(pair):
    """A temperature>0 request that already streamed tokens cannot replay
    coherently (the replay draws a DIFFERENT sequence): replica death
    must surface loudly, never splice."""
    _, model = pair
    router = Router(_engines(model, 2), RouterConfig())
    handle = router.submit(np.arange(10, dtype=np.int32), 8,
                           temperature=0.7)
    victim = handle.replica_id
    stream = handle.stream(timeout=60)
    for engine in router.engines():
        engine.step()                     # prefill: one token delivered
    next(stream)
    router.engine(victim).shutdown()
    with pytest.raises(RuntimeError, match="sampled"):
        for _ in stream:
            pass
    # An undelivered sampled request still replays (fresh draw is valid).
    h2 = router.submit(np.arange(10, dtype=np.int32), 4, temperature=0.7)
    if h2.replica_id == victim:           # placement skips the dead one
        raise AssertionError("placed on a dead replica")
    for engine in router.engines():
        if not engine.closed:
            engine.start()
    assert len(h2.result(timeout=60)) == 4
    router.shutdown()


def test_fleet_gauges_sum_over_live_replicas(pair):
    """The unlabelled hvd_serving_* gauges describe the PROCESS: with a
    fleet in it they sum over live engines, and a killed replica drops
    out of the sum."""
    _, model = pair
    metrics.reset_for_tests()
    metrics.enable()
    try:
        engines = _engines(model, 2)
        router = Router(engines, RouterConfig(affinity=False))
        for engine in engines:
            engine._update_gauges()
        snap = metrics.snapshot()
        per_engine = engines[0].config.max_batch * 8   # 64/8 pages x 2
        assert snap["hvd_serving_blocks_total"]["values"][0][1] == (
            2 * per_engine)
        assert snap["hvd_serving_queue_limit"]["values"][0][1] == (
            2 * SCFG.queue_depth)
        engines[0].shutdown()
        engines[1]._update_gauges()
        snap = metrics.snapshot()
        assert snap["hvd_serving_blocks_total"]["values"][0][1] == (
            per_engine)
        router.shutdown()
    finally:
        metrics.reset_for_tests()


# ---------------------------------------------------------------------------
# Heavy fleet/chaos acceptance (@slow, as in the JAX file)


@pytest.mark.slow
def test_fleet_chaos_kill_join_under_load(pair):
    """A 3-replica fleet under load-generator-scale shared-prefix traffic
    survives one replica hard-killed mid-load with ZERO failed requests
    and exact tokens, then absorbs a joiner that takes new placements."""
    variables, model = pair
    router = Router(_engines(model, 3), RouterConfig())
    for engine in router.engines():
        engine.start()
    trace = loadgen.build_trace(
        seed=11, requests=48, rate=0.0, min_prompt=24, max_prompt=48,
        min_new=8, max_new=16, vocab_size=TCFG.vocab_size,
        prefix_share=4, prefix_len=16)

    def kill():
        health = router.health()
        live = [rid for rid, h in sorted(health.items()) if h["alive"]]
        victim = max(live,
                     key=lambda rid: health[rid]["active_sequences"])
        router.engine(victim).shutdown()

    handles, rejected, failed, _ = loadgen.run_workload(
        router, trace, timeout_s=300.0, kill_after=24, kill_fn=kill)
    assert rejected == 0 and failed == 0
    assert router.router_stats()["router_replica_departures"] == 1
    for (_, prompt, new), handle in zip(trace, handles):
        assert handle.result(timeout=0) == _want(variables, prompt, new)
    # Join heals the fleet; the joiner serves immediately.
    rid = router.add_replica(ServingEngine(model, config=SCFG).start())
    fresh = router.submit(trace[0][1], 4)
    assert fresh.result(timeout=60) is not None
    assert rid in router.replicas()
    router.shutdown()


@pytest.mark.slow
def test_fleet_prefix_storm_stays_bit_exact(pair):
    """Prefix storm: many concurrent warm admissions against a small
    pool (constant eviction + recompute churn) stay bit-exact and
    actually share (hits, donor evictions, live-peak below the
    no-sharing run)."""
    variables, model = pair
    scfg = ServingConfig(max_batch=4, block_size=4, num_blocks=24,
                         queue_depth=64, max_seq_len=48)
    rng = np.random.RandomState(9)
    shared = [rng.randint(0, TCFG.vocab_size, (12,)).astype(np.int32)
              for _ in range(3)]
    prompts = [np.concatenate(
        [shared[i % 3], rng.randint(0, TCFG.vocab_size,
                                    (2 + i % 7,)).astype(np.int32)])
        for i in range(24)]
    news = [6 + i % 5 for i in range(24)]

    on = ServingEngine(model, config=scfg)
    handles = [on.submit(p, n) for p, n in zip(prompts, news)]
    on.run_until_idle()
    stats = on.stats()
    assert stats["prefix_hits"] > 0
    assert stats["prefix_evictions"] > 0, "storm never pressured the cache"
    off = ServingEngine(model, config=dataclasses.replace(
        scfg, prefix_cache=False))
    handles_off = [off.submit(p, n) for p, n in zip(prompts, news)]
    off.run_until_idle()
    assert stats["blocks_live_peak"] <= off.stats()["blocks_live_peak"]
    for i, (a, b) in enumerate(zip(handles, handles_off)):
        assert a.result(timeout=0) == b.result(timeout=0), f"request {i}"
    assert handles[0].result(timeout=0) == _want(variables, prompts[0],
                                                 news[0])
