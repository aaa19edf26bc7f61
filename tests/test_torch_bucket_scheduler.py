"""The port's backward-order bucket scheduler
(``controller/bucket_scheduler.py``) against the JAX package's, on the
CPU.

* ``partition_buckets`` on the same entries gives the same buckets.
* Over a scripted controller (it records every launch and answers at
  once) the two schedulers launch the same names, in the same order, in
  the same buckets, with the same priority tags, in batched and eager
  mode; with ``time.monotonic()`` scripted the same on both sides, the
  measured overlap report (the union formula of the scaling model) is
  the same dict.
* The port's ``plan_from_compiled`` records one backward of a tiny
  ``LlamaLM``: its order is the order in which the gradient hooks fire,
  its buckets are the JAX ``partition_buckets`` of that order, and its
  ``compute_after_frac`` falls along it.

The tolerance is exact equality; the reduced values are sums of one.
"""

import itertools
import time

import numpy as np
import pytest
import torch

from horovod_tpu.controller import bucket_scheduler as jbs

from horovod_tpu_torch.controller import bucket_scheduler as pbs
from horovod_tpu_torch.models.llama import LLAMA_TINY, LlamaLM, causal_lm_loss


def _entries(seed, n=30):
    rng = np.random.RandomState(seed)
    return [(f"layer{i}.w", int(rng.randint(1, 1 << 22))) for i in range(n)]


@pytest.mark.parametrize("seed,bound", [(0, 1 << 20), (1, 4 << 20),
                                        (2, 1), (3, 1 << 40)])
def test_partition_is_the_jax_partition(seed, bound):
    entries = _entries(seed)
    got = pbs.partition_buckets(entries, bound)
    want = jbs.partition_buckets(entries, bound)
    assert [(b.index, b.names, b.payload_bytes) for b in got] == \
        [(b.index, b.names, b.payload_bytes) for b in want]
    assert pbs.partition_buckets([], bound) == []
    for bad in (0, -1):
        with pytest.raises(ValueError, match="bucket_bytes must be positive"):
            pbs.partition_buckets(entries, bad)


class _Handle:
    def __init__(self, value):
        self.value = value

    def done(self):
        return True

    def wait(self):
        return self.value


class _ScriptedController:
    """Records ``(name, priority, average)`` per launch and answers with
    the input itself: a sum over one rank."""

    def __init__(self, pipelined=False):
        self.launches = []
        self.pipeline_enabled = pipelined

    def allreduce_async(self, tensor, average=True, name=None, priority=0):
        self.launches.append((name, int(priority), bool(average)))
        return _Handle(tensor)


def _grads(seed, n=24):
    rng = np.random.RandomState(seed)
    return [(f"p{i}", rng.standard_normal(int(rng.randint(1, 40000)))
             .astype(np.float32)) for i in range(n)]


def _drive(mod, grads, as_tensor, monkeypatch, **kwargs):
    clock = itertools.count()
    monkeypatch.setattr(time, "monotonic", lambda: next(clock) * 1e-3)
    ctl = _ScriptedController(kwargs.pop("pipelined", False))
    sched = mod.BucketScheduler(ctl, **kwargs)
    sched.backward_started()
    for name, g in grads:
        sched.grad_ready(name, torch.from_numpy(g) if as_tensor else g)
    results, report = sched.finish()
    monkeypatch.undo()
    return ctl.launches, results, report


@pytest.mark.parametrize("mode", ["batched", "eager", "priority",
                                  "average-off", "one-bucket"])
def test_launches_and_report_are_the_jax_schedulers(monkeypatch, mode):
    kwargs = {"batched": dict(bucket_bytes=64 << 10),
              "eager": dict(bucket_bytes=64 << 10, pipelined=True),
              "priority": dict(bucket_bytes=48 << 10,
                               priority_names=["p3", "p20"]),
              "average-off": dict(bucket_bytes=96 << 10, average=False),
              "one-bucket": dict(bucket_bytes=1 << 30)}[mode]
    grads = _grads(len(mode))
    want = _drive(jbs, grads, False, monkeypatch, **dict(kwargs))
    got = _drive(pbs, grads, True, monkeypatch, **dict(kwargs))
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1]) == sorted(n for n, _ in grads)
    for name in sorted(want[1]):
        np.testing.assert_array_equal(got[1][name].numpy(), want[1][name])
    assert got[2] == want[2]
    assert got[2]["eager"] == (mode == "eager")
    if mode == "batched":
        # The finish() tail bucket is tagged; earlier ones are not.
        prios = [p for _, p, _ in got[0]]
        assert prios[-1] == 1 and prios[0] == 0


def test_bucket_size_resolution_is_the_jax_one(monkeypatch):
    for env in ("", "0", "4194304", "garbage"):
        monkeypatch.setenv("HOROVOD_BUCKET_BYTES", env)
        for tuned in (None, 3 << 20):
            jbs.set_autotuned_bucket_bytes(tuned)
            pbs.set_autotuned_bucket_bytes(tuned)
            assert pbs.current_bucket_bytes() == jbs.current_bucket_bytes()
            sched = pbs.BucketScheduler(_ScriptedController())
            assert sched.bucket_bytes == pbs.current_bucket_bytes()
    jbs.set_autotuned_bucket_bytes(None)
    pbs.set_autotuned_bucket_bytes(None)
    assert pbs.last_overlap_efficiency() is None or \
        0.0 <= pbs.last_overlap_efficiency() <= 1.0


def test_scheduler_without_a_controller_needs_init(monkeypatch):
    from horovod_tpu_torch.common import basics

    monkeypatch.setattr(basics, "_state", None)
    with pytest.raises(ValueError, match="has not been initialized"):
        pbs.BucketScheduler()


def _tiny_model():
    return LlamaLM(LLAMA_TINY, device="cpu", seed=0,
                   param_dtype=torch.float32)


def _step(ids):
    def step(model):
        return causal_lm_loss(model(ids), ids)
    return step


@pytest.mark.parametrize("bound", [1 << 12, 1 << 16, 1 << 30])
def test_plan_from_a_recorded_backward(bound):
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, LLAMA_TINY.vocab_size, (2, 16)))
    model = _tiny_model()
    # The hook order of a plain backward of the same model and batch.
    seen = []
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=name: seen.append((n, p.grad.numel() * 4)))
        for name, p in model.named_parameters()]
    _step(ids)(model).backward()
    for h in hooks:
        h.remove()
    model.zero_grad(set_to_none=True)

    plan = pbs.plan_from_compiled(model, _step(ids), bucket_bytes=bound)
    assert plan.order == [n for n, _ in seen]
    assert sorted(plan.order) == sorted(n for n, _ in model.named_parameters())
    want = jbs.partition_buckets(seen, bound)
    assert [(b.names, b.payload_bytes) for b in plan.buckets] == \
        [(b.names, b.payload_bytes) for b in want]
    assert [g.payload_bytes for g in plan.groups] == [n for _, n in seen]
    fracs = [g.compute_after_frac for g in plan.groups]
    assert all(0.0 <= f <= 1.0 for f in fracs)
    assert fracs == sorted(fracs, reverse=True)
    assert plan.bucket_bytes == bound
    # The embedding is used first in the forward and the head last, so
    # their gradients land last and first in the backward.
    assert (plan.order[0], plan.order[-1]) == ("lm_head", "tok_embeddings")
    small = pbs.plan_from_compiled(model, _step(ids), bucket_bytes=bound,
                                   min_bytes=1 << 14)
    assert small.order == [n for n, b in seen if b >= 1 << 14]


def _tuned_bucket_push(sim, bs):
    """The first tune push that carries a bucket size, on 4 logical
    ranks of ``sim`` under ``HOROVOD_AUTOTUNE=1``: (the step at which
    every worker had adopted it, the adopted values, rank 0's own
    value)."""
    try:
        with sim.SimCluster(ranks=4, elastic=False,
                            env={"HOROVOD_AUTOTUNE": "1"}) as c:
            for k in range(40):
                c.run_step([sim.allreduce_spec(
                    f"t.{k}", lambda r: np.ones(256, np.float32))])
                values = {w.tuned_bucket_bytes
                          for _, w in sorted(c.workers.items())}
                if values != {None} and None not in values:
                    return k, values, bs.current_bucket_bytes()
            raise AssertionError(
                "no tune push carried a bucket size within 40 steps")
    finally:
        bs.set_autotuned_bucket_bytes(None)


def test_tuned_bucket_rides_the_synced_reply_like_jax():
    """End to end over real wires on each package's simulated cluster:
    an autotuning coordinator's first scored configuration ships the
    bucket size in the cycle reply's tune element, every logical rank
    adopts the same value, and it is rank 0's own live knob, in both
    packages (the value itself follows each run's cycle timings)."""
    import horovod_tpu.sim as jsim
    import horovod_tpu_torch.sim as tsim

    for sim, bs in ((jsim, jbs), (tsim, pbs)):
        _, values, own = _tuned_bucket_push(sim, bs)
        assert len(values) == 1 and own in values, (sim.__name__, values)
