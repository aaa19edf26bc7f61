"""The port's serving tier (``horovod_tpu_torch.serving``): the
single-device contracts of ``tests/test_serving.py`` held by the port.

Bookkeeping (block pool, scheduler, prefix cache) runs against the
port's own copies. The engine contracts hold per request: the tokens
through the continuous batcher equal the port's ``generate()`` alone, in
float32 — and, where marked, JAX's ``generate()`` on the same weights
(crossed through ``llama_from_flax``). On the CPU the paged decode
wrapper runs its plain version.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jllama
from horovod_tpu_torch import serving
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models.convert import llama_from_flax
from horovod_tpu_torch.serving import (
    NULL_BLOCK,
    BlockPool,
    CancelledError,
    OutOfBlocks,
    PrefixCache,
    RejectedError,
    Request,
    Scheduler,
    ServingConfig,
    ServingEngine,
    page_hashes,
    zero_stats,
)
from horovod_tpu_torch.serving.kv_blocks import padded_table
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JCFG = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32,
                           max_seq_len=64)
TCFG = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32,
                           max_seq_len=64)
JMODEL = jllama.LlamaLM(JCFG)
SCFG = ServingConfig(max_batch=4, block_size=8, num_blocks=0,
                     queue_depth=64, max_seq_len=64)


@pytest.fixture(scope="module")
def pair():
    variables = JMODEL.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return variables, llama_from_flax(params, TCFG, device="cpu")


def _mixed_workload(rng, n, prompt_lens, new_tokens):
    prompts = [rng.randint(0, TCFG.vocab_size,
                           (prompt_lens[i % len(prompt_lens)],)
                           ).astype(np.int32) for i in range(n)]
    news = [new_tokens[i % len(new_tokens)] for i in range(n)]
    return prompts, news


def _shared_prefix_workload(rng, n, prefix_len, tail_lens, new_tokens):
    shared = rng.randint(0, TCFG.vocab_size, (prefix_len,)).astype(np.int32)
    prompts = [np.concatenate(
        [shared, rng.randint(0, TCFG.vocab_size,
                             (tail_lens[i % len(tail_lens)],)
                             ).astype(np.int32)]) for i in range(n)]
    news = [new_tokens[i % len(new_tokens)] for i in range(n)]
    return prompts, news


def _assert_parity(model, prompts, news, handles, variables=None):
    """Each request equals the port's generate() alone; with
    ``variables``, also JAX's generate() on the same weights."""
    for i, (prompt, n, handle) in enumerate(zip(prompts, news, handles)):
        got = handle.result(timeout=0)
        ref = tllama.generate(model, torch.from_numpy(prompt[None]),
                              max_new_tokens=n)
        want = ref[0, len(prompt):].tolist()
        assert got == want, (
            f"request {i} (prompt {len(prompt)}, {n} new) diverged from "
            f"generate():\n got={got}\nwant={want}")
        if variables is not None:
            jref = jllama.generate(JMODEL, variables,
                                   jnp.asarray(prompt[None]),
                                   max_new_tokens=n)
            assert got == np.asarray(jref)[0, len(prompt):].tolist(), (
                f"request {i} diverged from JAX's generate()")


# ---------------------------------------------------------------------------
# Block pool


def test_block_pool_alloc_free_reuse():
    pool = BlockPool(4, block_size=8)
    assert pool.blocks_for(0) == 0
    assert pool.blocks_for(1) == 1
    assert pool.blocks_for(8) == 1
    assert pool.blocks_for(9) == 2
    a, b = pool.alloc(), pool.alloc()
    assert {a, b} == {1, 2} and NULL_BLOCK not in (a, b)
    assert pool.blocks_in_use == 2 and pool.free_blocks == 2
    pool.free([a])
    c = pool.alloc()
    assert c == a
    assert pool.peak_in_use == 2
    assert pool.stats()["block_allocs"] == 3
    assert pool.stats()["block_frees"] == 1
    assert pool.utilization() == 0.5
    pool.free([b, c])
    assert pool.blocks_in_use == 0 and pool.free_blocks == 4


def test_block_pool_exhaustion_and_all_or_nothing():
    pool = BlockPool(3, block_size=4)
    held = pool.alloc_many(2)
    with pytest.raises(OutOfBlocks):
        pool.alloc_many(2)
    assert pool.blocks_in_use == 2
    pool.alloc()
    with pytest.raises(OutOfBlocks):
        pool.alloc()
    pool.free(held)
    assert pool.can_fit(2)


def test_block_pool_free_validation():
    pool = BlockPool(2, block_size=4)
    a = pool.alloc()
    pool.free([a])
    with pytest.raises(ValueError, match="double free"):
        pool.free([a])
    with pytest.raises(ValueError, match="null block"):
        pool.free([NULL_BLOCK])
    with pytest.raises(ValueError, match="not allocated"):
        pool.free([2])


def test_padded_table():
    assert padded_table([3, 1], 4) == [3, 1, NULL_BLOCK, NULL_BLOCK]
    with pytest.raises(ValueError):
        padded_table([1, 2, 3], 2)


def test_block_pool_share_and_release_semantics():
    pool = BlockPool(4, block_size=8)
    a = pool.alloc()
    assert pool.refcount(a) == 1 and not pool.is_shared(a)
    pool.share(a)
    assert pool.refcount(a) == 2 and pool.is_shared(a)
    assert pool.blocks_shared == 1
    pool.free([a])
    assert pool.refcount(a) == 1 and pool.blocks_in_use == 1
    assert a not in [pool.alloc() for _ in range(pool.free_blocks)]
    pool.free([a])
    assert pool.refcount(a) == 0
    assert pool.alloc() == a


def test_block_pool_double_free_of_shared_block_is_loud():
    pool = BlockPool(2, block_size=4)
    a = pool.alloc()
    pool.share(a)
    pool.free([a])
    pool.free([a])
    with pytest.raises(ValueError, match="double free"):
        pool.free([a])
    with pytest.raises(ValueError, match="cannot share"):
        pool.share(a)
    with pytest.raises(ValueError, match="null block"):
        pool.share(NULL_BLOCK)


def test_block_pool_stats_count_shares():
    pool = BlockPool(4, block_size=8)
    a = pool.alloc()
    pool.share(a)
    s = pool.stats()
    assert s["block_shares"] == 1 and s["blocks_shared"] == 1
    pool.free([a])
    assert pool.stats()["blocks_shared"] == 0


# ---------------------------------------------------------------------------
# Scheduler (pure bookkeeping)


def _req(rid, prompt_len, max_new):
    return Request(rid=rid, prompt=np.zeros((prompt_len,), np.int32),
                   max_new_tokens=max_new)


def test_scheduler_admission_and_rejects():
    sched = Scheduler(BlockPool(8, 4), max_batch=2, queue_depth=2,
                      max_seq_len=16)
    with pytest.raises(RejectedError, match="max_seq_len"):
        sched.check_admissible(10, 10)
    with pytest.raises(ValueError):
        sched.check_admissible(0, 4)
    big = Scheduler(BlockPool(2, 4), max_batch=2, queue_depth=2,
                    max_seq_len=64)
    with pytest.raises(RejectedError, match="KV blocks"):
        big.check_admissible(8, 16)
    sched.enqueue(_req(0, 4, 4))
    sched.enqueue(_req(1, 4, 4))
    with pytest.raises(RejectedError, match="queue is full"):
        sched.check_admissible(4, 4)
    assert sched.rejected == 2
    admitted = sched.admit()
    assert [r.rid for r in admitted] == [0, 1]
    assert sorted(r.slot for r in admitted) == [0, 1]
    assert all(len(r.blocks) == 1 for r in admitted)


def test_scheduler_preempts_youngest_and_requeues_front():
    pool = BlockPool(4, 4)
    sched = Scheduler(pool, max_batch=2, queue_depth=4, max_seq_len=16)
    r0, r1 = _req(0, 6, 8), _req(1, 6, 8)
    sched.enqueue(r0)
    sched.enqueue(r1)
    assert len(sched.admit()) == 2
    r0.tokens.extend([5, 5, 5])
    preempted = sched.ensure_decode_capacity()
    assert preempted == [r1]
    assert r1.state == "waiting" and r1.blocks == [] and r1.slot is None
    assert sched.waiting[0] is r1
    assert sched.preempted == 1 and r1.preemptions == 1
    assert len(r0.blocks) == 3
    sched.retire(r0, "finished")
    assert [r.rid for r in sched.admit()] == [1]


def test_scheduler_warm_admission_maps_shared_blocks():
    pool = BlockPool(8, 4)
    cache = PrefixCache(pool)
    sched = Scheduler(pool, max_batch=2, queue_depth=4, max_seq_len=32,
                      prefix_cache=cache)
    donor = pool.alloc_many(2)
    toks = np.arange(10, dtype=np.int32)
    for digest, block in zip(page_hashes(toks, 4), donor):
        cache.insert(digest, block)
    req = Request(rid=0, prompt=toks, max_new_tokens=4)
    sched.enqueue(req)
    [admitted] = sched.admit()
    assert admitted.warm_pages == 2
    assert admitted.blocks[:2] == donor
    assert pool.refcount(donor[0]) == 3
    assert cache.hits == 2 and cache.misses == 0
    pool.free(donor)
    assert pool.refcount(donor[0]) == 2
    sched.retire(req, "finished")
    assert pool.refcount(donor[0]) == 1


def test_scheduler_cow_private_copy_before_shared_write():
    pool = BlockPool(8, 4)
    sched = Scheduler(pool, max_batch=2, queue_depth=4, max_seq_len=32)
    req = Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                  max_new_tokens=8)
    sched.enqueue(req)
    [r] = sched.admit()
    src = r.blocks[1]
    pool.share(src)
    sched.ensure_decode_capacity()
    assert sched.cow_copies == 1
    assert r.blocks[1] != src
    assert sched.pending_copies == [(src, r.blocks[1])]
    assert pool.refcount(src) == 1
    assert pool.refcount(r.blocks[1]) == 1
    sched.pending_copies.clear()
    sched.ensure_decode_capacity()
    assert sched.cow_copies == 1


def test_scheduler_cow_under_preemption_pressure():
    pool = BlockPool(4, 4)
    sched = Scheduler(pool, max_batch=2, queue_depth=4, max_seq_len=16)
    r0 = Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                 max_new_tokens=8)
    r1 = Request(rid=1, prompt=np.arange(6, dtype=np.int32),
                 max_new_tokens=8)
    sched.enqueue(r0)
    sched.enqueue(r1)
    assert len(sched.admit()) == 2
    src = r0.blocks[1]
    pool.share(src)
    preempted = sched.ensure_decode_capacity()
    assert preempted == [r1]
    assert r1.blocks == [] and r1.state == "waiting"
    assert sched.cow_copies == 1
    assert sched.pending_copies == [(src, r0.blocks[1])]
    assert r0.blocks[1] != src
    assert pool.refcount(src) == 1


# ---------------------------------------------------------------------------
# Prefix cache (pure bookkeeping)


def test_page_hashes_chain_commits_to_whole_prefix():
    toks = np.arange(32, dtype=np.int32)
    h = page_hashes(toks, 8)
    assert len(h) == 4
    assert len(page_hashes(toks[:31], 8)) == 3
    other = toks.copy()
    other[0] += 1
    h2 = page_hashes(other, 8)
    assert h[0] != h2[0] and h[2] != h2[2] and h[3] != h2[3]
    assert page_hashes(toks, 8) == h


def test_prefix_cache_lookup_insert_and_cap():
    pool = BlockPool(8, block_size=4)
    cache = PrefixCache(pool)
    toks = np.arange(12, dtype=np.int32)
    hashes = page_hashes(toks, 4)
    blocks = pool.alloc_many(3)
    for digest, block in zip(hashes, blocks):
        assert cache.insert(digest, block)
        assert not cache.insert(digest, block)
    assert pool.refcount(blocks[0]) == 2
    warm, got_hashes = cache.lookup(np.arange(13, dtype=np.int32))
    assert got_hashes == hashes
    assert warm == blocks
    warm_aligned, _ = cache.lookup(toks)
    assert warm_aligned == blocks[:2]
    warm_aligned, _ = cache.lookup(toks[:8])
    assert warm_aligned == blocks[:1]
    cache.release(8, for_capacity=True)
    for digest, block in ((hashes[0], blocks[0]), (hashes[2], blocks[2])):
        cache.insert(digest, block)
    warm_broken, _ = cache.lookup(toks)
    assert warm_broken == [blocks[0]]


def test_prefix_cache_release_skips_live_and_frees_cold():
    pool = BlockPool(4, block_size=4)
    cache = PrefixCache(pool)
    toks = np.arange(8, dtype=np.int32)
    hashes = page_hashes(toks, 4)
    blocks = pool.alloc_many(2)
    for digest, block in zip(hashes, blocks):
        cache.insert(digest, block)
    pool.free([blocks[1]])
    assert cache.cache_only_blocks() == 1
    assert cache.release(2) == 1
    assert pool.refcount(blocks[1]) == 0
    assert pool.refcount(blocks[0]) == 2
    assert cache.evictions == 1


def test_prefix_cache_capacity_lru():
    pool = BlockPool(8, block_size=4)
    cache = PrefixCache(pool, capacity_blocks=2)
    toks = np.arange(16, dtype=np.int32)
    hashes = page_hashes(toks, 4)
    blocks = pool.alloc_many(4)
    for digest, block in zip(hashes[:2], blocks[:2]):
        cache.insert(digest, block)
    assert len(cache) == 2
    cache.lookup(toks[:5])
    cache.insert(hashes[2], blocks[2])
    assert len(cache) == 2
    warm, _ = cache.lookup(toks)
    assert warm == [blocks[0]]
    assert cache.evictions == 1


# ---------------------------------------------------------------------------
# Engine


def test_engine_parity_single_device(pair):
    variables, model = pair
    engine = ServingEngine(model, config=SCFG)
    assert engine.decode_path.path == "kernel"
    rng = np.random.RandomState(0)
    prompts, news = _mixed_workload(rng, 6, [5, 9, 16, 3], [6, 4, 8])
    handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
    engine.run_until_idle()
    _assert_parity(model, prompts, news, handles, variables)
    stats = engine.stats()
    assert stats["requests_finished"] == 6
    assert stats["tokens_generated"] == sum(news)
    assert stats["steps"] < sum(news)      # continuous batching cycled


def test_engine_preemption_recompute_parity(pair):
    variables, model = pair
    scfg = ServingConfig(max_batch=3, block_size=4, num_blocks=7,
                         queue_depth=32, max_seq_len=28)
    engine = ServingEngine(model, config=scfg)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, TCFG.vocab_size, (8,)).astype(np.int32)
               for _ in range(3)]
    news = [12, 12, 12]
    handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
    engine.run_until_idle()
    stats = engine.stats()
    assert stats["preemptions"] > 0, "pool sizing did not force preemption"
    _assert_parity(model, prompts, news, handles, variables)
    assert stats["blocks_peak"] <= 7
    assert stats["blocks_live"] == 0
    assert stats["blocks_in_use"] == stats["prefix_cached_blocks"]


def test_engine_reject_when_queue_full(pair):
    _, model = pair
    engine = ServingEngine(model,
                           config=dataclasses.replace(SCFG, queue_depth=2))
    prompt = np.zeros((4,), np.int32)
    engine.submit(prompt, 4)
    engine.submit(prompt, 4)
    with pytest.raises(RejectedError, match="queue is full"):
        engine.submit(prompt, 4)
    assert engine.stats()["requests_rejected"] == 1
    engine.run_until_idle()
    assert engine.stats()["requests_finished"] == 2


def test_engine_cancel_waiting_and_running(pair):
    _, model = pair
    engine = ServingEngine(model,
                           config=dataclasses.replace(SCFG, max_batch=1))
    prompt = np.arange(4, dtype=np.int32)
    run = engine.submit(prompt, 8)
    parked = engine.submit(prompt, 8)
    engine.step()
    parked.cancel()
    run.cancel()
    engine.run_until_idle()
    for handle in (run, parked):
        with pytest.raises(CancelledError):
            handle.result(timeout=0)
    stats = engine.stats()
    assert stats["requests_cancelled"] == 2
    assert stats["blocks_in_use"] == 0 and stats["active_sequences"] == 0


def test_engine_stream_threaded_and_serve_default(pair):
    _, model = pair
    engine = serving.serve(model, config=SCFG)       # starts the loop
    try:
        assert serving.default_engine() is engine
        handle = engine.submit(np.arange(6, dtype=np.int32), 5)
        streamed = list(handle.stream(timeout=60))
        assert streamed == handle.result(timeout=60)
        assert len(streamed) == 5
        assert serving.stats()["requests_finished"] == 1
    finally:
        engine.shutdown()
    assert not any(t.name == "hvd-serving-engine"
                   for t in threading.enumerate())
    with pytest.raises(RuntimeError, match="shut down"):
        engine.submit(np.arange(3, dtype=np.int32), 2)


def test_serving_stats_zero_state_before_any_engine(monkeypatch):
    monkeypatch.setattr(serving, "_default_engine", None)
    stats = serving.stats()
    assert stats == zero_stats()
    from horovod_tpu.serving import zero_stats as jax_zero_stats

    assert set(stats) == set(jax_zero_stats())    # same catalog


def test_engine_parity_sharing_on_off(pair):
    _, model = pair
    rng = np.random.RandomState(7)
    prompts, news = _shared_prefix_workload(rng, 8, 16, [3, 5, 9, 17],
                                            [4, 6, 8])
    on = ServingEngine(model, config=SCFG)
    handles_on = [on.submit(p, n) for p, n in zip(prompts, news)]
    on.run_until_idle()
    _assert_parity(model, prompts, news, handles_on)
    assert on.stats()["prefix_hits"] > 0, "warm path never engaged"
    assert any(h.warm_pages > 0 for h in handles_on)
    off = ServingEngine(model, config=dataclasses.replace(
        SCFG, prefix_cache=False))
    handles_off = [off.submit(p, n) for p, n in zip(prompts, news)]
    off.run_until_idle()
    assert off.stats()["prefix_hits"] == 0
    for a, b in zip(handles_on, handles_off):
        assert a.result(timeout=0) == b.result(timeout=0)


def test_engine_parity_sharing_across_preemption_and_donor_eviction(pair):
    _, model = pair
    scfg = ServingConfig(max_batch=3, block_size=4, num_blocks=10,
                         queue_depth=32, max_seq_len=28)
    engine = ServingEngine(model, config=scfg)
    rng = np.random.RandomState(5)
    prompts, news = _shared_prefix_workload(rng, 6, 8, [2, 3, 5], [10, 12])
    handles = [engine.submit(p, n) for p, n in zip(prompts, news)]
    engine.run_until_idle()
    stats = engine.stats()
    assert stats["preemptions"] > 0
    assert stats["prefix_hits"] > 0
    assert stats["prefix_evictions"] > 0
    _assert_parity(model, prompts, news, handles)
    assert engine.stats()["blocks_live"] == 0


def test_engine_cow_copy_is_content_correct(pair):
    variables, model = pair
    engine = ServingEngine(model, config=SCFG)
    prompt = np.random.RandomState(6).randint(
        0, TCFG.vocab_size, (9,)).astype(np.int32)
    handle = engine.submit(prompt, 8)
    engine.step()                        # prefill + first decode step
    with engine._cond:
        req = engine._sched.running[handle._req.slot]
        widx = (req.total_len() - 1) // SCFG.block_size
        shared_block = req.blocks[widx]
        engine._sched.pool.share(shared_block)   # external holder appears
    engine.run_until_idle()
    assert engine.stats()["cow_copies"] >= 1
    _assert_parity(model, [prompt], [8], [handle], variables)
    assert engine._sched.pool.refcount(shared_block) == 1


def test_engine_recompute_readmits_warm_from_own_pages(pair):
    _, model = pair
    scfg = ServingConfig(max_batch=2, block_size=4, num_blocks=8,
                         queue_depth=8, max_seq_len=32)
    engine = ServingEngine(model, config=scfg)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, TCFG.vocab_size, (8,)).astype(np.int32)
               for _ in range(2)]
    handles = [engine.submit(p, 12) for p in prompts]
    engine.run_until_idle()
    assert engine.stats()["preemptions"] > 0
    assert any(h.warm_pages > 0 for h in handles)
    _assert_parity(model, prompts, [12, 12], handles)


def test_engine_sampling_is_seeded(pair):
    """temperature > 0 draws from the engine's seeded torch.Generator:
    the same seed gives the same tokens; greedy rows in the same batch
    still equal generate()."""
    _, model = pair
    prompt = np.arange(5, dtype=np.int32)
    runs = []
    for _ in range(2):
        engine = ServingEngine(model, config=SCFG, seed=3)
        sampled = engine.submit(prompt, 6, temperature=0.9)
        greedy = engine.submit(prompt + 1, 6)
        engine.run_until_idle()
        runs.append(sampled.result(timeout=0))
        _assert_parity(model, [prompt + 1], [6], [greedy])
    assert runs[0] == runs[1]
    assert all(0 <= t < TCFG.vocab_size for t in runs[0])


def test_serving_env_knobs_parse(monkeypatch):
    from horovod_tpu_torch.common import config as hvd_config

    monkeypatch.setenv("HOROVOD_SERVING_MAX_BATCH", "32")
    monkeypatch.setenv("HOROVOD_SERVING_BLOCK_SIZE", "garbage")
    monkeypatch.setenv("HOROVOD_SERVING_NUM_BLOCKS", "-3")
    monkeypatch.setenv("HOROVOD_SERVING_QUEUE_DEPTH", "0")
    monkeypatch.setenv("HOROVOD_SERVING_MAX_SEQ_LEN", "4096")
    monkeypatch.setenv("HOROVOD_SERVING_PREFIX_CACHE", "0")
    monkeypatch.setenv("HOROVOD_SERVING_PREFIX_CAPACITY", "-5")
    cfg = ServingConfig.from_env()
    assert cfg.max_batch == 32
    assert cfg.block_size == 16
    assert cfg.num_blocks == 0
    assert cfg.queue_depth == 128
    assert cfg.max_seq_len == 4096
    assert cfg.prefix_cache is False
    assert cfg.prefix_capacity == 0
    assert hvd_config.serving_max_batch() == 32
