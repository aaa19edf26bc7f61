"""Elastic membership in one process, the port against the JAX package:
the wire's JOIN / RESHAPE / SHARD frames (a RESHAPE raises
``RanksChangedError`` with the assignment, the join hello round-trips,
the ack drain discards dead-epoch traffic, a stray JOIN in the data
stream is an auth error, and the frames' bytes equal the JAX wire's for
the same payloads); the coordinator's ``reform`` on a bare service
(heartbeats reach parked joiners, a reform below min-ranks re-parks its
joiners, a reform admits a parked joiner through the ack handshake;
``tests/test_elastic.py``); ``State`` commit/restore semantics on the
same numpy tree in both packages; ``shard_digest`` over the same flat
layout giving the same digests in both packages, bfloat16 included; the
shard plane's parts; the refusal of process-group paths under elastic;
and ``DistributedOptimizer`` following the membership."""

import socket
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.elastic as jelastic
from horovod_tpu.common import wire as jwire
from horovod_tpu.utils import checkpoint as jckpt
import horovod_tpu_torch as thvd
import horovod_tpu_torch.elastic as telastic
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import wire as twire
from horovod_tpu_torch.controller.service import CoordinatorService
from horovod_tpu_torch.elastic import shards
from horovod_tpu_torch.utils import checkpoint as tckpt

SECRET = b"x" * 32


def _wire_pair(mod=twire):
    a, b = socket.socketpair()
    return mod.Wire(a, secret=SECRET), mod.Wire(b, secret=SECRET)


# ---------------------------------------------------------------------------
# Wire: the JOIN / RESHAPE / SHARD frames


@pytest.mark.parametrize("mod", [jwire, twire], ids=["jax", "port"])
def test_reshape_frame_raises_ranks_changed_with_assignment(mod):
    a, b = _wire_pair(mod)
    a.send_reshape(rank=1, size=2, epoch=5)
    with pytest.raises(mod.RanksChangedError) as exc_info:
        b.recv_obj()
    exc = exc_info.value
    assert (exc.rank, exc.size, exc.epoch) == (1, 2, 5)
    a.close(), b.close()


def test_join_hello_roundtrip_via_recv_hello():
    a, b = _wire_pair()
    a.send_join({"join": True, "rank": 7})
    kind, hello = b.recv_hello()
    assert kind == twire.FRAME_JOIN and hello == {"join": True, "rank": 7}
    a.send_obj({"rank": 3})
    kind, hello = b.recv_hello()
    assert kind == twire.FRAME_DATA and hello == {"rank": 3}
    a.send_reshape(1, 2, 3)
    with pytest.raises(twire.AuthError, match="reshape frame during hello"):
        b.recv_hello()
    a.close(), b.close()


def test_reshape_ack_drain_discards_dead_epoch_traffic():
    a, b = _wire_pair()
    a.send_obj({"rank": 1, "requests": "stale-tick"})
    a.send_bytes(b"\x00" * 128)
    a.send_shard_fetch({"shard": 0, "digest": "d", "req": 1, "owner": 0})
    a.send_join({"ack": 3})
    a.send_join({"ack": 4})
    b.recv_reshape_ack(4)
    a.send_obj({"fresh": True})
    assert b.recv_obj() == {"fresh": True}
    a.send_join({"join": True})
    with pytest.raises(twire.AuthError, match="unexpected join payload"):
        b.recv_reshape_ack(5)
    a.close(), b.close()


def test_unexpected_join_frame_in_data_stream_is_auth_error():
    a, b = _wire_pair()
    a.send_join({"join": True})
    with pytest.raises(twire.AuthError, match="join frame"):
        b.recv_bytes()
    a.close(), b.close()


def _raw_frames(mod, send):
    a, b = socket.socketpair()
    try:
        send(mod.Wire(a, secret=SECRET))
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


FRAMES = {
    "join_hello": lambda w: w.send_join({"join": True, "rank": 1}),
    "ack": lambda w: w.send_join({"ack": 7}),
    "reshape": lambda w: w.send_reshape(2, 3, 7),
    "shard_fetch": lambda w: w.send_shard_fetch(
        {"shard": 1, "digest": "ab" * 16, "leaves": [0, 3], "req": 2,
         "owner": 0, "nonce": 5}),
    "shard_data": lambda w: w.send_shard_data(
        {"shard": 1, "digest": "ab" * 16, "req": 2, "nonce": 5,
         "found": True, "data": bytes(range(256)) * 3}),
    "abort": lambda w: w.send_abort("rank 2 died", dead_rank=2, op="x"),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_bytes_equal_the_jax_wire(name):
    assert _raw_frames(jwire, FRAMES[name]) == _raw_frames(
        twire, FRAMES[name])


def test_shard_frames_reach_the_callback_mid_stream():
    a, b = _wire_pair()
    seen = []
    b.set_shard_callback(lambda event, info: seen.append((event, info)))
    FRAMES["shard_fetch"](a)
    FRAMES["shard_data"](a)
    a.send_bytes(b"tick")
    assert bytes(b.recv_bytes()) == b"tick"
    assert [e for e, _ in seen] == ["fetch", "data"]
    assert seen[1][1]["data"] == bytes(range(256)) * 3
    a.close(), b.close()


# ---------------------------------------------------------------------------
# CoordinatorService: the reform handshake (bare service, socketpairs)


def _bare_service(wires=None, pending=None):
    svc = CoordinatorService.__new__(CoordinatorService)
    svc.epoch = 1
    svc._wires_lock = threading.Lock()
    svc.wires = dict(wires or {})
    svc._pending_joins = list(pending or [])
    svc._comm_timeout = 0
    svc._shard_cb = None
    svc._join_stop = None
    svc._join_thread = None
    return svc


def test_heartbeats_reach_parked_joiners():
    w1a, w1b = _wire_pair()
    wja, wjb = _wire_pair()
    svc = _bare_service(wires={1: w1a}, pending=[(wja, {"join": True})])
    assert svc._hb_wires() == [w1a, wja]
    assert svc.parked_joiner_count() == 1
    for w in (w1a, w1b, wja, wjb):
        w.close()


def test_reform_below_min_ranks_reparks_absorbed_joiners():
    wja, wjb = _wire_pair()
    svc = _bare_service(pending=[(wja, {"join": True})])
    assert svc.reform(dead=set(), min_ranks=3) is None
    assert svc.epoch == 1
    assert [wire for wire, _ in svc._pending_joins] == [wja]
    wja.close(), wjb.close()


def test_reform_admits_parked_joiner_with_ack_handshake():
    wja, wjb = _wire_pair()
    w1a, w1b = _wire_pair()
    svc = _bare_service(wires={1: w1a}, pending=[(wja, {"join": True})])
    got = {}

    def member(wire, key):
        with pytest.raises(twire.RanksChangedError) as exc_info:
            wire.send_obj({"tick": "of the dead epoch"})
            wire.recv_obj()
        exc = exc_info.value
        got[key] = (exc.rank, exc.size, exc.epoch)
        wire.send_join({"ack": exc.epoch})

    threads = [threading.Thread(target=member, args=(w, k),
                                name=f"hvd-test-{k}", daemon=True)
               for w, k in ((w1b, "survivor"), (wjb, "joiner"))]
    for t in threads:
        t.start()
    res = svc.reform(dead=set(), min_ranks=1)
    for t in threads:
        t.join(timeout=10)
    assert (res.epoch, res.size, res.lost, res.joined) == (2, 3, (), 1)
    assert got == {"survivor": (1, 3, 2), "joiner": (2, 3, 2)}
    assert svc.wires == {1: w1a, 2: wja} and not svc._pending_joins
    for w in (wja, wjb, w1a, w1b):
        w.close()


def test_reform_drops_dead_ranks_and_renumbers():
    w1a, w1b = _wire_pair()
    w2a, w2b = _wire_pair()
    svc = _bare_service(wires={1: w1a, 2: w2a})

    def survivor():
        with pytest.raises(twire.RanksChangedError) as exc_info:
            w2b.recv_obj()
        w2b.send_join({"ack": exc_info.value.epoch})

    t = threading.Thread(target=survivor, name="hvd-test-survivor",
                         daemon=True)
    t.start()
    res = svc.reform(dead={1}, min_ranks=2)
    t.join(timeout=10)
    assert (res.epoch, res.size, res.lost, res.joined) == (2, 2, (1,), 0)
    assert svc.wires == {1: w2a}
    for w in (w1b, w2a, w2b):
        w.close()


# ---------------------------------------------------------------------------
# State: the same numpy tree through both packages


def _semantics(hvd_mod, elastic_mod):
    state = elastic_mod.State(step=3, weights=np.arange(4.0))
    seen = [state.step]
    state.step = 10
    state.weights = state.weights + 1
    state.restore()
    seen += [state.step, state.weights.tolist()]
    state.step = 10
    state.commit()
    state.step = 99
    state.weights[0] = 7.0
    state.restore()
    seen += [state.step, state.weights.tolist(), elastic_mod.epoch()]
    with pytest.raises(ValueError):
        elastic_mod.State()
    return seen


def test_state_semantics_match_jax():
    jhvd.init()
    try:
        jax_seen = _semantics(jhvd, jelastic)
    finally:
        jhvd.shutdown()
    thvd.init(device="cpu")
    try:
        port_seen = _semantics(thvd, telastic)
    finally:
        thvd.shutdown()
    assert jax_seen == port_seen == [3, 3, [0.0, 1.0, 2.0, 3.0], 10,
                                     [0.0, 1.0, 2.0, 3.0], 1]


def test_state_restores_modules_and_optimizers_in_place():
    thvd.init(device="cpu")
    try:
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 3)
        opt = torch.optim.AdamW(model.parameters(), lr=0.1)
        params = list(model.parameters())
        state = telastic.State(step=0, model=model, optimizer=opt)

        def step():
            opt.zero_grad()
            model(torch.ones(2, 4)).sum().backward()
            opt.step()

        step()
        state.step = 1
        state.commit()
        saved = {k: v.clone() for k, v in sorted(model.state_dict().items())}
        moments = opt.state[params[0]]["exp_avg"].clone()
        step()
        state.step = 2
        state.restore()
        assert state.step == 1
        assert list(model.parameters()) == params  # the same objects
        for k, v in sorted(model.state_dict().items()):
            assert torch.equal(v, saved[k])
        assert torch.equal(opt.state[params[0]]["exp_avg"], moments)
        step()  # the restored moments are the optimizer's own copy
        state.restore()
        assert torch.equal(opt.state[params[0]]["exp_avg"], moments)
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# Digests over the flat layout, both packages


def _leaves(rng):
    f32 = rng.randn(5, 3).astype(np.float32)
    bf = rng.randn(7).astype(np.float32).astype(ml_dtypes.bfloat16)
    return {"b": {"w": f32, "bf": bf},
            "a": [np.arange(6, dtype=np.int64).reshape(2, 3),
                  np.asarray(2.5, np.float32)],
            "c": rng.randn(11).astype(np.float64)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_shard_digests_equal_across_packages(world):
    import jax

    tree = _leaves(np.random.RandomState(world))
    jflat = jax.tree_util.tree_flatten(tree)[0]
    tflat = tckpt.tree_flatten(_as_torch(tree))[0]
    assert len(jflat) == len(tflat)
    jlayout = jckpt.shard_layout([int(x.nbytes) for x in jflat], world)
    tlayout = tckpt.shard_layout([tckpt.leaf_nbytes(x) for x in tflat],
                                 world)
    assert jlayout == tlayout
    jd = [jckpt.shard_digest([jflat[i] for i in ids]) for ids in jlayout]
    td = [tckpt.shard_digest([tflat[i] for i in ids]) for ids in tlayout]
    assert jd == td and len(set(jd)) == world


def test_state_layout_and_digests_match_jax():
    tree = {k: v for k, v in sorted(_leaves(np.random.RandomState(9)).items())
            if k != "b"}
    jhvd.init()
    try:
        js = jelastic.State(step=4, params=tree)
        jflat, _td, jids, _ = js._flat_commit()
        jlayout = js._layout(jflat, jids, 2)
        jdig = js._hash_layout(jflat, jlayout)
        js.close()
    finally:
        jhvd.shutdown()
    ts = telastic.State(step=4, params=_as_torch(tree))
    tflat, _st, tids, _ = ts._flat_commit()
    tlayout = ts._layout(tflat, tids, 2)
    assert tlayout == jlayout
    assert ts._hash_layout(tflat, tlayout) == jdig
    ts.close()


# ---------------------------------------------------------------------------
# The shard plane's parts and provider


def test_shard_parts_cut_at_the_limit():
    assert shards.shard_parts([10, 10, 10], limit=25) == [(0, 2), (2, 3)]
    assert shards.shard_parts([30, 5, 5], limit=25) == [(0, 1), (1, 3)]
    assert shards.shard_parts([1, 2], limit=100) == [(0, 2)]
    assert shards.shard_parts([], limit=1) == [(0, 0)]


def test_memory_provider_serves_parts_of_a_matching_shard():
    flat = [torch.arange(4.0), torch.ones(3, dtype=torch.int64),
            np.full(2, 7.0, np.float32)]
    digest = tckpt.shard_digest(flat)
    provide = shards.make_memory_provider(lambda: flat)
    whole = tckpt.unpack_shard(provide(0, digest, [0, 1, 2], (0, 3)),
                               expect_digest=digest)
    part = tckpt.unpack_shard(provide(0, digest, [0, 1, 2], (1, 3)))
    assert [a.tolist() for a in part] == [a.tolist() for a in whole[1:]]
    assert provide(0, "0" * 32, [0, 1, 2], (0, 3)) is None
    assert provide(0, digest, [0, 9], (0, 2)) is None
    # The parts, hashed in order as they arrive, give the shard's digest.
    h = tckpt.shard_hasher()
    for a in tckpt.unpack_shard(provide(0, digest, [0, 1, 2], (0, 1))) \
            + part:
        tckpt.digest_update(h, a)
    assert h.hexdigest() == digest


# ---------------------------------------------------------------------------
# Elastic jobs build no process group; the optimizer follows membership


def test_process_group_paths_refused_under_elastic(monkeypatch):
    from horovod_tpu_torch.parallel.mesh import group_rank, group_size
    from horovod_tpu_torch.torch import mpi_ops

    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    for call in (lambda: group_size(None), lambda: group_rank(None),
                 lambda: mpi_ops._size(object())):
        with pytest.raises(RuntimeError, match="elastic"):
            call()


def test_distributed_optimizer_follows_elastic_membership(monkeypatch):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_CONTROLLER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    thvd.init(device="cpu")
    try:
        model = torch.nn.Linear(3, 2)
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        # Hooks at size 1: a job that grows reduces at once.
        assert opt._reduces and len(opt._grad_accs) == 2
        model(torch.ones(1, 3)).sum().backward()
        assert len(opt._handles) == 2  # local identities at size 1

        class Drained:
            def wait(self):
                raise twire.RanksChangedError("reshaped", 0, 1, 2)

        p = next(iter(opt._handles))
        opt._handles[p] = (Drained(),) + opt._handles[p][1:]
        with pytest.raises(twire.RanksChangedError):
            opt.step()
        assert not opt._handles  # dropped, not joined
    finally:
        thvd.shutdown()
    monkeypatch.delenv("HOROVOD_ELASTIC")
    thvd.init(device="cpu")
    try:
        model = torch.nn.Linear(3, 2)
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1))
        assert not opt._reduces and not opt._grad_accs
    finally:
        thvd.shutdown()


def test_replace_topology_keeps_the_card(monkeypatch):
    thvd.init(device="cpu")
    try:
        dev = thvd.device()
        topo = basics._state.topology
        basics.replace_topology(type(topo)(
            rank=1, size=3, local_rank=0, local_size=1, cross_rank=1,
            cross_size=3))
        assert (thvd.rank(), thvd.size()) == (1, 3)
        assert thvd.device() == dev
    finally:
        thvd.shutdown()
