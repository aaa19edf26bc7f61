"""The port's eager-tier controller across real ranks: 2- and 3-rank jobs
launched by the port's ``horovodrun`` (``python -m
horovod_tpu_torch.run``) on the CPU, running the JAX package's
multi-process scenarios (``tests/mp_worker.py``) on torch tensors —
``allreduce``, ``fusion``, ``grouped``, ``allgather``, ``broadcast``,
``cache``, ``error_mismatch``, ``duplicate_name``,
``reducescatter_alltoall``, ``objects``, ``torch`` — then ``stall`` and
``peer_death`` in jobs of their own.

Inputs come from numpy seeded per rank (``make_inputs``, shared by the
workers and the checks here). ``allreduce``, ``fusion`` and ``torch``
also run, on the same inputs, through ``horovod_tpu.torch`` on the JAX
package's Python controller (TCP star, no native engine) in a second
job: float32 and integer results must be bitwise equal, bfloat16 bits
equal, float32 averages too (a division by the size rounds once either
way). The port's integer average over the process group (``group=``)
is held to the JAX adapter's as well (truncation toward zero)."""

import json
import re
import subprocess
import sys

import numpy as np
import pytest

import torch_gloo

INPUTS_SRC = '''
import time

import numpy as np

MATRIX = ("float16", "float64", "int8", "uint8", "int16", "int64", "bool")
# The priority scenario's tensors: (key, dtype, launch priority). Fusion
# groups them by dtype; the groups launch by their highest priority.
PRIORITY = (("a.0", "float32", 0), ("a.1", "int32", 0), ("a.2", "float64", 0),
            ("zz.hi", "int32", 2), ("zz.mid", "float32", 1))


def make_inputs(rank, size):
    rng = np.random.RandomState(1234 + rank)
    out = {
        "f32": rng.randn(37).astype(np.float32),
        "i32": rng.randint(-1000, 1000, 29).astype(np.int32),
        "bf16": rng.randn(33).astype(np.float32) * 3,
        "fuse": rng.randn(12, 32).astype(np.float32),
        "gather": rng.randn(rank + 1, 3).astype(np.float32),
        "w": rng.randn(2).astype(np.float32),
    }
    for dt in MATRIX:
        if dt == "bool":
            out[dt] = rng.rand(9) > 0.5
        elif np.dtype(dt).kind in "iu":
            info = np.iinfo(dt)
            out[dt] = rng.randint(max(info.min, -100), min(info.max, 100),
                                  13).astype(dt)
        else:
            out[dt] = rng.randn(13).astype(dt)
    for i, dt in enumerate(("float32", "float64", "int32") * 3):
        out[f"mixed{i}"] = (rng.randn(16) * 10).astype(dt)
    for key, dt, _ in PRIORITY:
        out[f"prio.{key}"] = (rng.randn(8) * 10).astype(dt)
    return out


def launch_order(ctl, rank, enqueue):
    """The fused responses a cycle launches, in order, on ``ctl`` (either
    package's controller): each round every rank but 0 queues the
    PRIORITY tensors at once, and rank 0 queues them 0.1 s later, so that
    all become ready in one cycle; a round in which rank 0's own queueing
    straddled two of its ticks launches more than three groups and is
    run again (the decision is the same on every rank: all see the same
    launches). ``enqueue(rnd)`` queues one round and returns its waited
    results."""
    seen = []
    orig = ctl._execute

    def spy(response, *args, **kwargs):
        seen.append(list(response.tensor_names))
        return orig(response, *args, **kwargs)

    ctl._execute = spy
    try:
        for rnd in range(8):
            if rank == 0:
                time.sleep(0.1)
            del seen[:]
            results = enqueue(rnd)
            if len(seen) == 3:
                break
    finally:
        del ctl._execute
    order = [[n.split(".", 2)[2] for n in names] for names in seen]
    return results, order, rnd + 1
'''

PORT_WORKER = torch_gloo.WORKER_HEAD + INPUTS_SRC + r'''
import os
import time
import traceback

import torch.distributed as dist

from horovod_tpu_torch.common import basics
import horovod_tpu_torch.torch.mpi_ops as tops


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bf(a):
    return t(a).to(torch.bfloat16)


def arr(x):
    x = x.detach().cpu()
    return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
        else x.numpy()


def expect(cond, msg):
    if not cond:
        raise AssertionError(msg)


def scenario_allreduce(rank, size, x, out, notes):
    out["f32.avg"] = hvd.allreduce(t(x["f32"]), name="ar.f32.avg")
    out["f32.sum"] = hvd.allreduce(t(x["f32"]), average=False,
                                   name="ar.f32.sum")
    out["i32.sum"] = hvd.allreduce(t(x["i32"]), average=False,
                                   name="ar.i32.sum")
    out["i32.avg"] = hvd.allreduce(t(x["i32"]), name="ar.i32.avg")
    # The process group's integer average, held to the same rounding.
    out["i32.avg.pg"] = hvd.allreduce(t(x["i32"]), group=dist.group.WORLD)
    out["bf16.sum"] = hvd.allreduce(bf(x["bf16"]), average=False,
                                    name="ar.bf16.sum")
    out["bf16.avg"] = hvd.allreduce(bf(x["bf16"]), name="ar.bf16.avg")
    out["fp16c"] = hvd.allreduce(t(x["f32"]), name="ar.fp16c",
                                 compression=hvd.Compression.fp16)
    for dt in MATRIX:
        res = hvd.allreduce(t(x[dt]), average=False, name=f"ar.{dt}")
        expect(res.dtype == t(x[dt]).dtype, f"{dt} became {res.dtype}")
        out[f"m.{dt}"] = res


def scenario_fusion(rank, size, x, out, notes):
    ctl = basics.controller()
    before = ctl.counters()
    handles = [hvd.allreduce_async(t(x["fuse"][i]), average=False,
                                   name=f"fuse.{i}") for i in range(12)]
    mixed = [hvd.allreduce_async(t(x[f"mixed{i}"]), average=False,
                                 name=f"fuse.mixed.{i}") for i in range(9)]
    for i, h in enumerate(handles):
        out[f"fuse.{i}"] = hvd.synchronize(h)
    for i, h in enumerate(mixed):
        res = hvd.synchronize(h)
        expect(res.dtype == t(x[f"mixed{i}"]).dtype, "mixed dtype changed")
        out[f"mixed.{i}"] = res
    after = ctl.counters()
    notes["responses"] = after["responses"] - before["responses"]
    notes["tensors"] = after["tensors"] - before["tensors"]


def scenario_grouped(rank, size, x, out, notes):
    res = hvd.grouped_allreduce([t(x["fuse"][i]) for i in range(6)],
                                average=False, name="grp")
    for i, r in enumerate(res):
        out[f"grp.{i}"] = r
    res = hvd.grouped_allreduce([t(x["f32"]), t(x["w"])], average=True)
    out["grp.avg.0"], out["grp.avg.1"] = res
    ts = [t(x["fuse"][i]).clone() for i in range(4)]
    got = hvd.grouped_allreduce_(ts, average=False, name="grp.ip")
    expect(all(g is s for g, s in zip(got, ts)),
           "grouped_allreduce_ returned new tensors")
    for i, s in enumerate(ts):
        out[f"grp.ip.{i}"] = s


def scenario_allgather(rank, size, x, out, notes):
    out["gather"] = hvd.allgather(t(x["gather"]), name="gather.var")
    out["gather.i32"] = hvd.allgather(t(x["i32"][:rank + 2]),
                                      name="gather.i32")


def scenario_broadcast(rank, size, x, out, notes):
    out["bc.0"] = hvd.broadcast(t(x["f32"]), root_rank=0, name="bc.0")
    out["bc.last"] = hvd.broadcast(t(x["f32"]), root_rank=size - 1,
                                   name="bc.last")
    y = bf(x["bf16"])
    got = hvd.broadcast_(y, root_rank=1, name="bc.ip")
    expect(got is y, "broadcast_ returned a new tensor")
    out["bc.ip"] = y


def scenario_cache(rank, size, x, out, notes):
    ctl = basics.controller()
    before = ctl.counters()["cache_hits"]
    for it in range(6):
        out[f"cache.{it}"] = hvd.allreduce(t(x["f32"]) * (it + 1),
                                           average=False, name="cached.t")
    notes["hits"] = ctl.counters()["cache_hits"] - before
    # Shape change under the same name: invalidation + renegotiation.
    out["cache.reshaped"] = hvd.allreduce(t(x["fuse"][:2]), average=False,
                                          name="cached.t")


def _raises(fn, needle):
    try:
        fn()
    except RuntimeError as exc:
        expect(needle in str(exc), f"wrong error: {exc}")
        return str(exc)
    raise AssertionError(f"expected an error containing {needle!r}")


def scenario_error_mismatch(rank, size, x, out, notes):
    notes["shape"] = _raises(lambda: hvd.allreduce(
        torch.ones(2 + rank), name="bad.shape"),
        "Mismatched allreduce tensor shapes")
    notes["dtype"] = _raises(lambda: hvd.allreduce(
        torch.ones(4, dtype=torch.float32 if rank == 0 else torch.float64),
        name="bad.dtype"), "Mismatched data types")
    notes["root"] = _raises(lambda: hvd.broadcast(
        torch.ones(3), root_rank=rank % size, name="bad.root"),
        "Mismatched broadcast root ranks")
    notes["gather_rank"] = _raises(lambda: hvd.allgather(
        torch.ones((2,) * (rank + 1)), name="bad.gather.rank"),
        "Mismatched allgather tensor ranks")
    notes["gather_shape"] = _raises(lambda: hvd.allgather(
        torch.ones(2, 2 + rank), name="bad.gather.shape"),
        "Mismatched allgather tensor shapes")
    notes["op"] = _raises(
        (lambda: hvd.allreduce(torch.ones(3), name="bad.op")) if rank == 0
        else (lambda: hvd.allgather(torch.ones(3), name="bad.op")),
        "Mismatched collective operations")
    out["good.after"] = hvd.allreduce(torch.ones(3), average=False,
                                      name="good.after")


def scenario_duplicate_name(rank, size, x, out, notes):
    h1 = hvd.allreduce_async(torch.ones(4), name="dup", average=False)
    h2 = hvd.allreduce_async(torch.ones(4), name="dup", average=False)
    out["dup"] = hvd.synchronize(h1)
    notes["dup"] = _raises(lambda: hvd.synchronize(h2),
                           "Duplicate tensor name")


def scenario_reducescatter_alltoall(rank, size, x, out, notes):
    xs = torch.arange(10, dtype=torch.float32).reshape(5, 2) + rank
    out["rs.sum"] = hvd.reducescatter(xs, average=False)
    out["rs.avg"] = hvd.reducescatter(xs, average=True)
    rows = size * (rank + 1)
    xa = torch.full((rows, 3), float(rank))
    xa[:, 1] = torch.arange(size).repeat_interleave(rank + 1).float()
    out["a2a"] = hvd.alltoall(xa)
    try:
        hvd.alltoall(torch.zeros(size + 1, 2))
        raise AssertionError("indivisible alltoall must raise")
    except ValueError as exc:
        expect("divisible" in str(exc), str(exc))
    try:
        hvd.reducescatter(torch.tensor(3.0))
        raise AssertionError("scalar reducescatter must raise")
    except ValueError:
        pass
    out["rs.after"] = hvd.allreduce(torch.ones(2), average=False)


def scenario_objects(rank, size, x, out, notes):
    obj = {"rank": rank, "data": list(range(rank + 1)), "tag": "x" * rank}
    got = hvd.broadcast_object(obj if rank == 1 % size else None,
                               root_rank=1 % size, name="obj.bc")
    expect(got["rank"] == 1 % size, f"wrong root object: {got}")
    gathered = hvd.allgather_object(obj, name="obj.ag")
    expect([o["rank"] for o in gathered] == list(range(size)),
           f"gathered {gathered}")
    for r, o in enumerate(gathered):
        expect(o["data"] == list(range(r + 1)), f"rank {r}: {o}")
    hvd.barrier()
    hvd.barrier(name="obj.barrier2")
    try:
        hvd.broadcast_object(obj, root_rank=size + 3, name="obj.badroot")
        raise AssertionError("out-of-range root did not raise")
    except ValueError as exc:
        expect("out of range" in str(exc), f"wrong error: {exc}")


def scenario_torch(rank, size, x, out, notes):
    xt = torch.arange(8, dtype=torch.float32) + rank
    out["tt.avg"] = hvd.allreduce(xt, average=True, name="tt.avg")
    y = xt.clone()
    hvd.allreduce_(y, average=False, name="tt.sum")
    out["tt.sum"] = y
    g_in = torch.full((rank + 1, 2), float(rank), requires_grad=True)
    gathered = hvd.allgather(g_in, name="tt.gather")
    gathered.sum().backward()
    out["tt.gather"], out["tt.gather.grad"] = gathered, g_in.grad
    calls = []
    orig = tops.allgather_async
    tops.allgather_async = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
    try:
        g_cnt = torch.full((rank + 1, 2), float(rank), requires_grad=True)
        res = hvd.allgather(g_cnt, name="tt.gather.count")
        res.sum().backward()
    finally:
        tops.allgather_async = orig
    notes["gathers"] = len(calls)
    out["tt.bc"] = hvd.broadcast(xt, root_rank=size - 1, name="tt.bc")
    xb = bf(x["bf16"][:8])
    out["tt.bf16"] = hvd.allreduce(xb, average=False, name="tt.bf16")
    yb = xb.clone()
    got = hvd.allreduce_(yb, average=True, name="tt.bf16.inp")
    expect(got is yb, "bf16 allreduce_ returned a new tensor")
    out["tt.bf16.inp"] = yb
    zb = torch.full((6,), float(rank), dtype=torch.bfloat16)
    hvd.broadcast_(zb, root_rank=0, name="tt.bf16.bc")
    out["tt.bf16.bc"] = zb
    vb = torch.full((3,), float(rank + 1), dtype=torch.bfloat16)
    out["tt.bf16.obc"] = hvd.broadcast(vb, root_rank=size - 1,
                                       name="tt.bf16.obc")
    out["tt.bf16.ag"] = hvd.allgather(
        torch.full((rank + 1, 2), float(rank), dtype=torch.bfloat16),
        name="tt.bf16.ag")
    model = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(t(x["w"]).view(1, 2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=1.0),
                                   named_parameters=model.named_parameters())
    model(torch.ones(1, 2) * (rank + 1)).sum().backward()
    opt.step()
    out["tt.opt.w"] = model.weight
    model2 = torch.nn.Linear(2, 2)
    with torch.no_grad():
        for p in model2.parameters():
            p.fill_(float(rank + 7))
    hvd.broadcast_parameters(model2.state_dict(), root_rank=0)
    out["tt.bp.w"] = model2.weight
    opt2 = torch.optim.Adam(model2.parameters(), lr=0.01)
    hvd.broadcast_optimizer_state(opt2, root_rank=0)
    out["tt.bos"] = opt2.state_dict()["state"][0]["exp_avg"]


def scenario_priority(rank, size, x, out, notes):
    ctl = basics.controller()

    def enqueue(rnd):
        handles = [ctl.allreduce_async(t(x[f"prio.{key}"]), average=False,
                                       name=f"prio.{rnd}.{key}", priority=p)
                   for key, _, p in PRIORITY]
        return [h.wait() for h in handles]

    results, order, notes["rounds"] = launch_order(ctl, rank, enqueue)
    for (key, _, _), res in zip(PRIORITY, results):
        out[key] = res
    out["order"] = torch.frombuffer(bytearray(json.dumps(order).encode()),
                                    dtype=torch.uint8)


def main():
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    ctl = basics.controller()
    specs = json.load(open(sys.argv[1] + ".json"))
    expect(ctl is not None, "no controller under horovodrun")
    x = make_inputs(rank, size)
    results, notes = {}, {}
    for name in specs["scenarios"]:
        out, note = {}, {}
        try:
            globals()["scenario_" + name](rank, size, x, out, note)
            note["ok"] = True
        except Exception:
            note["ok"] = False
            note["error"] = traceback.format_exc()
            print(f"scenario {name} failed:\n{note['error']}", flush=True)
        notes[name] = note
        for key, value in out.items():
            results[f"{name}/{key}"] = arr(value)
    # A group= call takes the process group: the controller sees nothing.
    before = ctl.counters()["tensors"]
    hvd.allreduce(torch.ones(3), group=dist.group.WORLD)
    notes["pg_tensors"] = ctl.counters()["tensors"] - before
    hvd.shutdown()
    results["notes"] = np.frombuffer(json.dumps(notes).encode(), np.uint8)
    np.savez(sys.argv[2] + f".rank{rank}.npz", **results)
    print("worker ok", flush=True)


main()
'''

REFERENCE_WORKER = INPUTS_SRC + r'''
import json
import sys
import time

import numpy as np
import torch

import horovod_tpu as hvd
import horovod_tpu.torch as thvd
from horovod_tpu.common import basics as jbasics


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bf(a):
    return t(a).to(torch.bfloat16)


def arr(x):
    x = x.detach().cpu()
    return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
        else x.numpy()


def scenario_allreduce(rank, size, x, out):
    out["f32.avg"] = thvd.allreduce(t(x["f32"]), name="ar.f32.avg")
    out["f32.sum"] = thvd.allreduce(t(x["f32"]), average=False,
                                    name="ar.f32.sum")
    out["i32.sum"] = thvd.allreduce(t(x["i32"]), average=False,
                                    name="ar.i32.sum")
    out["i32.avg"] = thvd.allreduce(t(x["i32"]), name="ar.i32.avg")
    out["bf16.sum"] = thvd.allreduce(bf(x["bf16"]), average=False,
                                     name="ar.bf16.sum")
    out["bf16.avg"] = thvd.allreduce(bf(x["bf16"]), name="ar.bf16.avg")
    out["fp16c"] = thvd.allreduce(t(x["f32"]), name="ar.fp16c",
                                  compression=thvd.Compression.fp16)
    for dt in MATRIX:
        out[f"m.{dt}"] = thvd.allreduce(t(x[dt]), average=False,
                                        name=f"ar.{dt}")


def scenario_fusion(rank, size, x, out):
    handles = [thvd.allreduce_async(t(x["fuse"][i]), average=False,
                                    name=f"fuse.{i}") for i in range(12)]
    mixed = [thvd.allreduce_async(t(x[f"mixed{i}"]), average=False,
                                  name=f"fuse.mixed.{i}") for i in range(9)]
    for i, h in enumerate(handles):
        out[f"fuse.{i}"] = thvd.synchronize(h)
    for i, h in enumerate(mixed):
        out[f"mixed.{i}"] = thvd.synchronize(h)


def scenario_torch(rank, size, x, out):
    xt = torch.arange(8, dtype=torch.float32) + rank
    out["tt.avg"] = thvd.allreduce(xt, average=True, name="tt.avg")
    y = xt.clone()
    thvd.allreduce_(y, average=False, name="tt.sum")
    out["tt.sum"] = y
    g_in = torch.full((rank + 1, 2), float(rank), requires_grad=True)
    gathered = thvd.allgather(g_in, name="tt.gather")
    gathered.sum().backward()
    out["tt.gather"], out["tt.gather.grad"] = gathered, g_in.grad
    out["tt.bc"] = thvd.broadcast(xt, root_rank=size - 1, name="tt.bc")
    xb = bf(x["bf16"][:8])
    out["tt.bf16"] = thvd.allreduce(xb, average=False, name="tt.bf16")
    yb = xb.clone()
    thvd.allreduce_(yb, average=True, name="tt.bf16.inp")
    out["tt.bf16.inp"] = yb
    zb = torch.full((6,), float(rank), dtype=torch.bfloat16)
    thvd.broadcast_(zb, root_rank=0, name="tt.bf16.bc")
    out["tt.bf16.bc"] = zb
    vb = torch.full((3,), float(rank + 1), dtype=torch.bfloat16)
    out["tt.bf16.obc"] = thvd.broadcast(vb, root_rank=size - 1,
                                        name="tt.bf16.obc")
    out["tt.bf16.ag"] = thvd.allgather(
        torch.full((rank + 1, 2), float(rank), dtype=torch.bfloat16),
        name="tt.bf16.ag")
    model = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(t(x["w"]).view(1, 2))
    opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                    lr=1.0),
                                    named_parameters=model.named_parameters())
    model(torch.ones(1, 2) * (rank + 1)).sum().backward()
    opt.step()
    out["tt.opt.w"] = model.weight
    model2 = torch.nn.Linear(2, 2)
    with torch.no_grad():
        for p in model2.parameters():
            p.fill_(float(rank + 7))
    thvd.broadcast_parameters(model2.state_dict(), root_rank=0)
    out["tt.bp.w"] = model2.weight
    opt2 = torch.optim.Adam(model2.parameters(), lr=0.01)
    thvd.broadcast_optimizer_state(opt2, root_rank=0)
    out["tt.bos"] = opt2.state_dict()["state"][0]["exp_avg"]


def scenario_priority(rank, size, x, out):
    ctl = jbasics.controller()

    def enqueue(rnd):
        handles = [ctl.allreduce_async(x[f"prio.{key}"], average=False,
                                       name=f"prio.{rnd}.{key}", priority=p)
                   for key, _, p in PRIORITY]
        return [np.asarray(h.wait()) for h in handles]

    results, order, _ = launch_order(ctl, rank, enqueue)
    for (key, _, _), res in zip(PRIORITY, results):
        out[key] = t(res)
    out["order"] = torch.frombuffer(bytearray(json.dumps(order).encode()),
                                    dtype=torch.uint8)


def main():
    hvd.init()
    rank, size = hvd.rank(), hvd.size()
    specs = json.load(open(sys.argv[1] + ".json"))
    x = make_inputs(rank, size)
    results = {}
    for name in specs["scenarios"]:
        out = {}
        globals()["scenario_" + name](rank, size, x, out)
        for key, value in out.items():
            results[f"{name}/{key}"] = arr(value)
    hvd.shutdown()
    np.savez(sys.argv[2] + f".rank{rank}.npz", **results)
    print("worker ok", flush=True)


main()
'''

SCENARIOS = ["allreduce", "fusion", "grouped", "allgather", "broadcast",
             "cache", "error_mismatch", "duplicate_name",
             "reducescatter_alltoall", "objects", "torch", "priority"]
PARITY = ["allreduce", "fusion", "torch", "priority"]
SIZES = [2, 3]
# These jobs hold the Python controller's TCP star (its rank-order sums);
# the launcher's default, the native engine on the ring, is held by
# tests/test_torch_native_engine.py.
STAR = {"HOROVOD_CPU_OPS": "star"}

_inputs = {}
exec(INPUTS_SRC, _inputs)
make_inputs, MATRIX = _inputs["make_inputs"], _inputs["MATRIX"]
PRIORITY = _inputs["PRIORITY"]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both packages' jobs at 2 and 3 ranks, started together, each under
    both runtime monitors (artifacts under ``("monitor", pkg, size)``)."""
    started, monitors = {}, {}
    for size in SIZES:
        for pkg in ("port", "jax"):
            monitors[("monitor", pkg, size)] = \
                tmp_path_factory.mktemp(f"monitor_{pkg}{size}")
        started[("port", size)] = torch_gloo.start_launched(
            tmp_path_factory.mktemp(f"port{size}"), size, PORT_WORKER, {},
            {"scenarios": SCENARIOS}, env={
                **STAR, **torch_gloo.monitor_env(
                    monitors[("monitor", "port", size)])})
        started[("jax", size)] = torch_gloo.start_reference(
            tmp_path_factory.mktemp(f"jax{size}"), size, REFERENCE_WORKER,
            {}, {"scenarios": PARITY}, env=torch_gloo.monitor_env(
                monitors[("monitor", "jax", size)]))
    try:
        return {**{key: job.wait()[0]
                   for key, job in sorted(started.items())}, **monitors}
    finally:
        for _, job in sorted(started.items()):
            job.kill()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_jobs_run_clean_under_both_monitors(jobs, pkg, size):
    """Every rank's protocol report is clean with transitions, every lock
    graph acyclic, and each runtime lock edge in the static graph."""
    summary = torch_gloo.assert_monitored(
        jobs[("monitor", pkg, size)], pkg, require=size,
        context=f"{pkg} controller job at {size} ranks")
    assert summary["transitions"] > 0, summary


def _notes(ranks):
    return [json.loads(r["notes"].tobytes()) for r in ranks]


def _rank_order_sum(size, key):
    acc = make_inputs(0, size)[key]
    for r in range(1, size):
        acc = acc + make_inputs(r, size)[key]
    return acc


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_passes_on_every_rank(jobs, scenario, size):
    for rank, note in enumerate(_notes(jobs[("port", size)])):
        assert note[scenario]["ok"], (
            f"rank {rank}: {note[scenario].get('error')}")


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("scenario", PARITY)
def test_results_equal_the_jax_controllers(jobs, scenario, size):
    port, ref = jobs[("port", size)], jobs[("jax", size)]
    for rank in range(size):
        keys = sorted(k for k in ref[rank] if k.startswith(scenario + "/"))
        assert keys
        for key in keys:
            got, want = port[rank][key], ref[rank][key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("size", SIZES)
def test_results_equal_numpy_rank_order_sums(jobs, size):
    ranks = jobs[("port", size)]
    for rank, res in enumerate(ranks):
        np.testing.assert_array_equal(res["allreduce/f32.sum"],
                                      _rank_order_sum(size, "f32"))
        np.testing.assert_array_equal(res["allreduce/f32.avg"],
                                      _rank_order_sum(size, "f32") / size)
        isum = _rank_order_sum(size, "i32")
        np.testing.assert_array_equal(res["allreduce/i32.sum"], isum)
        # Integer averages truncate toward zero on both tiers.
        trunc = (isum / size).astype(np.int32)
        assert (isum % size != 0).any() and (isum < 0).any()
        np.testing.assert_array_equal(res["allreduce/i32.avg"], trunc)
        np.testing.assert_array_equal(res["allreduce/i32.avg.pg"], trunc)
        for dt in MATRIX:
            np.testing.assert_array_equal(res[f"allreduce/m.{dt}"],
                                          _rank_order_sum(size, dt))
        fuse = _rank_order_sum(size, "fuse")
        for i in range(12):
            np.testing.assert_array_equal(res[f"fusion/fuse.{i}"], fuse[i])
            if i < 6:
                np.testing.assert_array_equal(res[f"grouped/grp.{i}"],
                                              fuse[i])
        for i in range(9):
            np.testing.assert_array_equal(res[f"fusion/mixed.{i}"],
                                          _rank_order_sum(size, f"mixed{i}"))
        want = np.concatenate([make_inputs(r, size)["gather"]
                               for r in range(size)])
        np.testing.assert_array_equal(res["allgather/gather"], want)
        np.testing.assert_array_equal(
            res["allgather/gather.i32"],
            np.concatenate([make_inputs(r, size)["i32"][:r + 2]
                            for r in range(size)]))
        np.testing.assert_array_equal(res["broadcast/bc.0"],
                                      make_inputs(0, size)["f32"])
        np.testing.assert_array_equal(res["broadcast/bc.last"],
                                      make_inputs(size - 1, size)["f32"])
        np.testing.assert_array_equal(res["broadcast/bc.ip"],
                                      ranks[1]["broadcast/bc.ip"])
        for it in range(6):
            acc = make_inputs(0, size)["f32"] * (it + 1)
            for r in range(1, size):
                acc = acc + make_inputs(r, size)["f32"] * (it + 1)
            np.testing.assert_array_equal(res[f"cache/cache.{it}"], acc)
        np.testing.assert_array_equal(res["cache/cache.reshaped"],
                                      fuse[:2])


@pytest.mark.parametrize("size", SIZES)
def test_fusion_cache_and_tiers(jobs, size):
    for note in _notes(jobs[("port", size)]):
        # 21 tensors of three dtypes travel in fewer fused responses.
        assert note["fusion"]["tensors"] == 21
        assert note["fusion"]["responses"] < 21
        # The first of six negotiates; the other five bypass it.
        assert note["cache"]["hits"] == 5
        # One collective per autograd allgather: the backward slices by
        # the negotiated sizes on the handle.
        assert note["torch"]["gathers"] == 1
        # A group= allreduce runs on the process group.
        assert note["pg_tensors"] == 0


@pytest.mark.parametrize("size", SIZES)
def test_error_texts_agree_across_ranks(jobs, size):
    notes = _notes(jobs[("port", size)])
    for key in ("shape", "dtype", "root", "gather_rank", "gather_shape",
                "op"):
        texts = {n["error_mismatch"][key] for n in notes}
        assert len(texts) == 1, texts
    assert re.search(r"rank 0 has shape \(2,\) for tensor bad\.shape, but "
                     r"rank 1 has shape \(3,\)",
                     notes[0]["error_mismatch"]["shape"])
    for res in jobs[("port", size)]:
        np.testing.assert_array_equal(res["error_mismatch/good.after"],
                                      np.full(3, float(size), np.float32))
        np.testing.assert_array_equal(res["duplicate_name/dup"],
                                      np.full(4, float(size), np.float32))


@pytest.mark.parametrize("size", SIZES)
def test_reducescatter_alltoall_blocks(jobs, size):
    full = sum(np.arange(10, dtype=np.float32).reshape(5, 2) + r
               for r in range(size))
    counts = [len(b) for b in np.array_split(np.arange(5), size)]
    for rank, res in enumerate(jobs[("port", size)]):
        off = sum(counts[:rank])
        np.testing.assert_array_equal(res["reducescatter_alltoall/rs.sum"],
                                      full[off:off + counts[rank]])
        np.testing.assert_allclose(res["reducescatter_alltoall/rs.avg"],
                                   full[off:off + counts[rank]] / size)
        want = np.concatenate([
            np.stack([np.full(j + 1, float(j)), np.full(j + 1, float(rank)),
                      np.full(j + 1, float(j))], axis=1)
            for j in range(size)]).astype(np.float32)
        np.testing.assert_array_equal(res["reducescatter_alltoall/a2a"],
                                      want)


@pytest.mark.parametrize("size", SIZES)
def test_priority_launches_the_highest_group_first(jobs, size):
    """Fusion groups the cycle's tensors by dtype; the groups then launch
    by their highest member priority, the same order on every rank (the
    JAX controller's order is held by the parity test)."""
    want = [["a.1", "zz.hi"], ["a.0", "zz.mid"], ["a.2"]]
    for rank, res in enumerate(jobs[("port", size)]):
        assert json.loads(res["priority/order"].tobytes()) == want, rank
        for key, dt, _ in PRIORITY:
            got = res[f"priority/{key}"]
            assert got.dtype == np.dtype(dt)
            np.testing.assert_array_equal(
                got, _rank_order_sum(size, f"prio.{key}"))


STALL_WORKER = torch_gloo.WORKER_HEAD + r'''
import time

hvd.init(device="cpu")
if hvd.rank() != 0:
    time.sleep(2.5)
out = hvd.allreduce(torch.ones(2), average=False, name="stall.t")
assert torch.equal(out, torch.full((2,), float(hvd.size())))
hvd.shutdown()
print("worker ok", flush=True)
'''


def test_stall_warns_and_completes(tmp_path):
    job = torch_gloo.start_launched(
        tmp_path, 2, STALL_WORKER, {}, {},
        env={"HOROVOD_STALL_CHECK_TIME_SECONDS": "1", **STAR,
             **torch_gloo.monitor_env(tmp_path / "monitor")}, timeout=120)
    codes, outputs = job.finish()
    text = "\n".join(outputs)
    assert codes == [0], text
    assert text.count("worker ok") == 2, text
    assert "waiting for remainder of ranks" in text, text
    assert "Stalled op: stall.t [missing ranks: 1]" in text, text
    torch_gloo.assert_monitored(tmp_path / "monitor", "port", require=2,
                                context="stall job")


PEER_DEATH_WORKER = torch_gloo.WORKER_HEAD + r'''
import os
import signal

hvd.init(device="cpu")
out = hvd.allreduce(torch.ones(4), average=False, name="pd.warm")
assert torch.equal(out, torch.full((4,), float(hvd.size())))
if hvd.rank() == 1:
    os.kill(os.getpid(), signal.SIGKILL)
try:
    hvd.allreduce(torch.ones(4), name="pd.after")
except RuntimeError as exc:
    print(f"peer-death error surfaced: {exc}", flush=True)
else:
    raise AssertionError("allreduce with a dead peer did not raise")
print("worker ok", flush=True)
'''


def test_peer_death_fails_the_survivor_with_a_diagnosis(tmp_path):
    """A SIGKILLed rank surfaces on its peer as an engine error naming it
    (ranks spawned directly: the launcher would tear the survivor down
    as soon as one rank dies)."""
    script = tmp_path / "worker.py"
    script.write_text(PEER_DEATH_WORKER)
    addr = f"127.0.0.1:{torch_gloo.free_port()}"
    procs = []
    for rank in range(2):
        env = torch_gloo._clean_env({
            "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": "2",
            "HOROVOD_LOCAL_RANK": str(rank), "HOROVOD_LOCAL_SIZE": "2",
            "HOROVOD_CONTROLLER_ADDR": addr, "HOROVOD_CYCLE_TIME": "1",
            "HOROVOD_RENDEZVOUS_FILE": str(tmp_path / "store"),
            **torch_gloo.monitor_env(tmp_path / "monitor")})
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], cwd=torch_gloo.REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    job = torch_gloo.Job(procs, None, 2, 120)
    codes, outputs = job.finish()
    assert codes == [0, -9], outputs
    assert "peer-death error surfaced" in outputs[0], outputs[0]
    assert re.search(r"rank 1 died or became unreachable", outputs[0]), \
        outputs[0]
    # The killed rank leaves no artifact; the survivor's must be clean.
    torch_gloo.assert_monitored(tmp_path / "monitor", "port", require=1,
                                context="peer-death job")
