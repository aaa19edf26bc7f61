"""The port's eager-tier controller pieces (``horovod_tpu_torch.common``
message / response cache / wire / timeline, ``controller.controller``'s
fusion rule, ``run.task_fn``'s frame) held against the JAX package's, in
one process.

Every case feeds both packages the same inputs — request matrices, a
seeded sequence of 200 response-cache operations, seeded response mixes
around the fusion threshold, fixed secrets and payloads, a scripted
timeline — and requires equal results: the same responses and error
texts, the same cache bits, hits, stale bits and evictions, the same
fused groups, byte-identical frames, the same timeline events (their
timestamps aside)."""

import json
import pickle
import random
import socket
import types

import numpy as np
import pytest
import torch

from horovod_tpu.common import message as jmsg
from horovod_tpu.common import response_cache as jcache
from horovod_tpu.common import timeline as jtl
from horovod_tpu.common import wire as jwire
from horovod_tpu.controller import controller as jctl
from horovod_tpu.run import task_fn as jtask
from horovod_tpu_torch.common import message as tmsg
from horovod_tpu_torch.common import response_cache as tcache
from horovod_tpu_torch.common import timeline as ttl
from horovod_tpu_torch.common import wire as twire
from horovod_tpu_torch.controller import controller as tctl
from horovod_tpu_torch.run import task_fn as ttask

SECRET = bytes(range(32))


def _requests(mod, specs):
    """``mod.Request`` per (rank, type, dtype, shape, root) spec."""
    return [mod.Request(request_rank=r, request_type=mod.RequestType(t),
                        tensor_name="t", tensor_dtype=d,
                        tensor_shape=tuple(s), root_rank=root)
            for r, t, d, s, root in specs]


def _fields(resp):
    return (int(resp.response_type), list(resp.tensor_names),
            resp.error_message, list(resp.tensor_sizes))


AR, AG, BC = 0, 1, 2
RESPONSE_CASES = {
    "matched_allreduce": [(0, AR, "float32", (4, 3), -1),
                          (1, AR, "float32", (4, 3), -1),
                          (2, AR, "float32", (4, 3), -1)],
    "dtype_mismatch": [(0, AR, "float32", (4,), -1),
                       (1, AR, "bfloat16", (4,), -1)],
    "shape_mismatch": [(0, AR, "int32", (4,), -1),
                       (1, AR, "int32", (5,), -1)],
    "op_mismatch": [(0, AR, "float32", (3,), -1),
                    (1, AG, "float32", (3,), -1)],
    "broadcast_roots_agree": [(0, BC, "float32", (2, 2), 1),
                              (1, BC, "float32", (2, 2), 1)],
    "broadcast_root_mismatch": [(0, BC, "float32", (3,), 0),
                                (1, BC, "float32", (3,), 1)],
    "broadcast_root_out_of_range": [(0, BC, "float32", (3,), 2),
                                    (1, BC, "float32", (3,), 2)],
    "broadcast_shape_mismatch": [(0, BC, "float32", (3,), 0),
                                 (1, BC, "float32", (4,), 0)],
    "allgather_first_dims": [(0, AG, "float32", (1, 3), -1),
                             (1, AG, "float32", (4, 3), -1),
                             (2, AG, "float32", (2, 3), -1)],
    "allgather_rank_mismatch": [(0, AG, "float32", (2,), -1),
                                (1, AG, "float32", (2, 2), -1)],
    "allgather_trailing_mismatch": [(0, AG, "float32", (2, 2), -1),
                                    (1, AG, "float32", (2, 3), -1)],
    "allgather_scalar": [(0, AG, "float32", (), -1),
                         (1, AG, "float32", (), -1)],
}


@pytest.mark.parametrize("case", sorted(RESPONSE_CASES))
def test_construct_response_matches_jax(case):
    specs = RESPONSE_CASES[case]
    got = tmsg.construct_response(_requests(tmsg, specs), len(specs))
    want = jmsg.construct_response(_requests(jmsg, specs), len(specs))
    assert _fields(got) == _fields(want)
    if case != "matched_allreduce" and case != "allgather_first_dims" \
            and case != "broadcast_roots_agree":
        assert got.response_type == tmsg.ResponseType.ERROR, got


def _cache_trace(mod, cache_mod, seed, capacity):
    """200 seeded operations on a ResponseCache; every result in order."""
    rng = random.Random(seed)
    cache = cache_mod.ResponseCache(capacity)
    names = [f"t{i}" for i in range(12)]
    shapes = [(4,), (2, 2), (8,)]
    out = []
    for step in range(200):
        name = rng.choice(names)
        req = mod.Request(request_rank=0,
                          request_type=mod.RequestType(rng.choice([0, 1])),
                          tensor_name=name,
                          tensor_dtype=rng.choice(["float32", "bfloat16"]),
                          tensor_shape=rng.choice(shapes))
        op = rng.choice(["lookup", "put", "put", "stale", "touch", "evict",
                         "evict_name", "request_of"])
        if op == "lookup":
            out.append((step, op, cache.lookup(req)))
        elif op == "put":
            cache.put(req, mod.Response(mod.ResponseType.ALLREDUCE, [name]))
            out.append((step, op, len(cache), cache.lookup(req)))
        elif op == "stale":
            out.append((step, op, cache.stale_bit(req)))
        elif op == "touch":
            cache.touch(rng.randrange(capacity))
            out.append((step, op, len(cache)))
        elif op == "evict":
            cache.evict_bit(rng.randrange(capacity))
            out.append((step, op, len(cache)))
        elif op == "evict_name":
            cache.evict_name(name)
            out.append((step, op, len(cache)))
        else:
            r = cache.request_of(rng.randrange(capacity))
            out.append((step, op, None if r is None else (
                r.tensor_name, int(r.request_type), r.tensor_dtype,
                r.tensor_shape, r.root_rank)))
    bits = [cache.lookup(mod.Request(0, mod.RequestType(0), n, "float32",
                                     (4,))) for n in names]
    mask = cache.bits_to_mask(b for b in bits if b is not None)
    out.append(("mask", mask, cache_mod.ResponseCache.mask_to_bits(mask)))
    return out


@pytest.mark.parametrize("seed,capacity", [(0, 4), (1, 8), (2, 1024)])
def test_response_cache_matches_jax(seed, capacity):
    assert (_cache_trace(tmsg, tcache, seed, capacity)
            == _cache_trace(jmsg, jcache, seed, capacity))


def _mix(mod, seed, n):
    """A seeded mix of responses (mostly allreduce, some gathers and
    broadcasts) with their dtypes and byte sizes around the threshold."""
    rng = random.Random(seed)
    table, responses = {}, []
    for i in range(n):
        name = f"r{i}"
        kind = rng.choices([0, 1, 2], weights=[8, 1, 1])[0]
        table[name] = (rng.choice(["float32", "bfloat16", "int32"]),
                       rng.choice([4, 64, 300, 700, 1000, 1500]))
        responses.append(mod.Response(mod.ResponseType(kind), [name]))
    return table, responses


def _jax_fused(table, responses, threshold):
    ctl = jctl.Controller.__new__(jctl.Controller)
    ctl._table = {
        n: types.SimpleNamespace(
            request=types.SimpleNamespace(tensor_dtype=d),
            array=np.empty(b, np.uint8))
        for n, (d, b) in sorted(table.items())}
    ctl._fusion_threshold = threshold
    return [(int(r.response_type), r.tensor_names)
            for r in ctl._fuse_responses(responses)]


def _port_fused(table, responses, threshold):
    ctl = tctl.Controller.__new__(tctl.Controller)
    ctl._table = {
        n: types.SimpleNamespace(
            request=types.SimpleNamespace(tensor_dtype=d), nbytes=b)
        for n, (d, b) in sorted(table.items())}
    ctl._fusion_threshold = threshold
    return [(int(r.response_type), r.tensor_names)
            for r in ctl._fuse_responses(responses)]


@pytest.mark.parametrize("seed,threshold",
                         [(0, 1000), (1, 1024), (2, 1500), (3, 4096),
                          (4, 0)])
def test_fuse_responses_matches_jax(seed, threshold):
    table, jresp = _mix(jmsg, seed, 40)
    _, tresp = _mix(tmsg, seed, 40)
    got = _port_fused(table, tresp, threshold)
    want = _jax_fused(table, jresp, threshold)
    assert got == want
    if threshold >= 1500:
        # Look-ahead packs same-dtype tensors past other dtypes.
        assert any(len(names) > 2 for _, names in got)


def _prioritized(ctl_mod, msg_mod, seed, tagged):
    """A seeded cycle of fused responses through ``ctl_mod``'s
    ``_prioritize_responses``: their names as given, their names in
    launch order, and whether the very list came back."""
    rng = random.Random(seed)
    names = [f"p{i}" for i in range(24)]
    ctl = ctl_mod.Controller.__new__(ctl_mod.Controller)
    ctl._table = {
        n: types.SimpleNamespace(request=types.SimpleNamespace(
            priority=rng.choice([0, 0, 1, 2, 5]) if tagged else 0))
        for n in names}
    responses, i = [], 0
    while i < len(names):
        k = rng.randint(1, 4)
        responses.append(msg_mod.Response(msg_mod.ResponseType.ALLREDUCE,
                                          names[i:i + k]))
        i += k
    # A member that already completed counts as priority 0.
    responses.insert(rng.randrange(len(responses)), msg_mod.Response(
        msg_mod.ResponseType.ALLREDUCE, ["gone"]))
    given = [r.tensor_names for r in responses]
    out = ctl._prioritize_responses(responses)
    return given, [r.tensor_names for r in out], out is responses


@pytest.mark.parametrize("seed,tagged",
                         [(0, True), (1, True), (2, True), (3, True),
                          (4, False)])
def test_prioritize_responses_matches_jax(seed, tagged):
    given, got, got_same = _prioritized(tctl, tmsg, seed, tagged)
    _, want, want_same = _prioritized(jctl, jmsg, seed, tagged)
    assert got == want
    assert got_same == want_same == (not tagged)
    # The seeded tags really reorder the launches; no tags keep them.
    assert (got != given) == tagged


def _frames(wire_cls, send):
    """Raw bytes one send of ``send(wire)`` puts on a socket."""
    a, b = socket.socketpair()
    try:
        send(wire_cls(a, secret=SECRET))
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


FRAME_CASES = {
    "data": lambda w: w.send_bytes(bytes(range(256)) * 9),
    "data_empty": lambda w: w.send_bytes(b""),
    "data_obj": lambda w: w.send_obj({"rank": 3, "x": [1, 2.5, "s"]}),
    "heartbeat": lambda w: w.send_heartbeat(),
    "abort": lambda w: w.send_abort("rank 2 died", dead_rank=2,
                                    op="'grad.0'"),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_wire_frames_are_byte_identical(case):
    got = _frames(twire.Wire, FRAME_CASES[case])
    assert got == _frames(jwire.Wire, FRAME_CASES[case])
    assert got[0] == {"data": 0, "data_empty": 0, "data_obj": 0,
                      "heartbeat": 1, "abort": 2}[case]


def test_wire_frames_from_numpy_and_torch_buffers_equal_bytes():
    data = np.arange(1000, dtype=np.float32)
    want = _frames(jwire.Wire, lambda w: w.send_bytes(data.tobytes()))
    assert _frames(twire.Wire, lambda w: w.send_bytes(data)) == want
    t = torch.from_numpy(data.copy())
    assert _frames(twire.Wire, lambda w: w.send_bytes(
        t.view(torch.uint8).numpy())) == want


def test_task_fn_frame_equals_wire_frame(monkeypatch):
    monkeypatch.setenv("HOROVOD_SECRET_KEY", SECRET.hex())
    obj = {"op": "register", "index": 1, "addrs": [("eth0", "10.0.0.2")],
           "probe_port": 4242}
    want = _frames(twire.Wire, lambda w: w.send_obj(obj))
    assert want == _frames(jwire.Wire, lambda w: w.send_obj(obj))
    a, b = socket.socketpair()
    try:
        ttask._send_obj(a, obj)
        a.shutdown(socket.SHUT_WR)
        got = b.recv(1 << 16)
        # The JAX probe's frame is the same, and each side reads the
        # other's frame back.
        jtask._send_obj(b, obj)
        assert ttask._recv_obj(a) == obj
    finally:
        a.close()
        b.close()
    assert got == want


@pytest.mark.parametrize("sender,receiver", [(jwire, twire), (twire, jwire)])
def test_wires_read_each_others_frames(sender, receiver):
    a, b = socket.socketpair()
    try:
        tx, rx = sender.Wire(a, secret=SECRET), receiver.Wire(b,
                                                              secret=SECRET)
        payload = bytes(range(200)) * 50
        tx.send_heartbeat()
        tx.send_bytes(payload)
        tx.send_obj({"rank": 1})
        assert bytes(rx.recv_bytes()) == payload
        assert rx.recv_obj() == {"rank": 1}
        tx.send_abort("gone", dead_rank=1, op="x")
        with pytest.raises(receiver.RemoteAbortError, match="gone") as err:
            rx.recv_bytes()
        assert err.value.dead_rank == 1 and err.value.op == "x"
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("mod", [jwire, twire], ids=["jax", "port"])
def test_a_frame_to_a_peer_that_aborted_and_closed_leaves_whole(mod):
    """A coordinator that sent ABORT and closed its end: the worker's next
    frame (a tick) leaves in one send, which a closed peer still takes,
    and the worker's recv then reads the abort. Sent as two writes, the
    peer's reset to the first failed the second with EPIPE."""
    listener = socket.create_server(("127.0.0.1", 0))
    try:
        a = socket.create_connection(listener.getsockname())
        b, _ = listener.accept()
    finally:
        listener.close()
    try:
        tx, rx = mod.Wire(b, secret=SECRET), mod.Wire(a, secret=SECRET)
        tx.send_abort("rank 2 died", dead_rank=2, op="x")
        b.close()
        rx.send_obj({"rank": 1, "requests": list(range(64))})
        with pytest.raises(mod.RemoteAbortError, match="rank 2 died") as err:
            rx.recv_bytes()
        assert err.value.dead_rank == 2
    finally:
        a.close()


def test_wire_rejects_a_tampered_frame_and_reserved_kinds():
    a, b = socket.socketpair()
    try:
        rx = twire.Wire(b, secret=SECRET)
        frame = bytearray(_frames(jwire.Wire, lambda w: w.send_bytes(b"xy")))
        frame[-1] ^= 1
        a.sendall(bytes(frame))
        with pytest.raises(twire.AuthError, match="HMAC"):
            rx.recv_bytes()
    finally:
        a.close()
        b.close()
    # The kinds elastic membership uses (reserved until it landed): in
    # the data stream a JOIN is a protocol violation, a RESHAPE tears the
    # recv out with the assignment, and the shard frames go to the shard
    # callback while the recv reads on.
    for kind in (twire.FRAME_JOIN, twire.FRAME_RESHAPE,
                 twire.FRAME_SHARD_FETCH, twire.FRAME_SHARD_DATA):
        a, b = socket.socketpair()
        try:
            tx, rx = twire.Wire(a, secret=SECRET), twire.Wire(b, secret=SECRET)
            tx._send_frame(kind, pickle.dumps(
                {"join": True, "rank": 1, "size": 2, "epoch": 3}))
            if kind == twire.FRAME_JOIN:
                with pytest.raises(twire.AuthError, match="join frame"):
                    rx.recv_bytes()
            elif kind == twire.FRAME_RESHAPE:
                with pytest.raises(twire.RanksChangedError) as exc:
                    rx.recv_bytes()
                assert (exc.value.rank, exc.value.size,
                        exc.value.epoch) == (1, 2, 3)
            else:
                seen = []
                rx.set_shard_callback(lambda event, info: seen.append(event))
                tx.send_bytes(b"after")
                assert bytes(rx.recv_bytes()) == b"after"
                assert seen == ["fetch" if kind == twire.FRAME_SHARD_FETCH
                                else "data"]
        finally:
            a.close()
            b.close()


def _timeline_events(mod, path):
    tl = mod.Timeline(str(path), mark_cycles=True)
    tl.mark_cycle_start()
    tl.negotiate_start("grad.w", "allreduce")
    tl.negotiate_rank_ready("grad.w", 0)
    tl.negotiate_rank_ready("grad.w", 1)
    tl.negotiate_end("grad.w", "allreduce")
    tl.negotiate_start("grad.b", "allgather")
    tl.negotiate_rank_ready("grad.b", 1)
    tl.negotiate_end("grad.b", "allgather")
    tl.start("fused[2]", "ALLREDUCE")
    for name in ("MEMCPY_IN_FUSION_BUFFER", "TCP_COLLECTIVE",
                 "MEMCPY_OUT_FUSION_BUFFER"):
        tl.activity_start("fused[2]", getattr(mod, name))
        tl.activity_end("fused[2]")
    tl.end("fused[2]")
    tl.start("grad.b", "ALLGATHER")
    tl.end("grad.b")
    tl.mark_cycle_start()
    tl.close()
    events = json.loads(path.read_text())
    for ev in events:
        ev.pop("ts", None)
        if ev.get("name") == "clock_sync":
            ev["args"].pop("wall_anchor")
            ev["args"].pop("monotonic_origin")
    return events


def test_timeline_event_sequence_matches_jax(tmp_path):
    got = _timeline_events(ttl, tmp_path / "port.json")
    want = _timeline_events(jtl, tmp_path / "jax.json")
    assert got == want
    names = [e.get("name") for e in got]
    assert names.count("NEGOTIATE_ALLREDUCE") == 2
    assert "TCP_COLLECTIVE" in names and names[-1] == "trace_end"


def test_timeline_names_the_card_copies():
    assert ttl.MEMCPY_D2H == "MEMCPY_D2H"
    assert ttl.MEMCPY_H2D == "MEMCPY_H2D"
    for name in ("NEGOTIATE_ALLREDUCE", "MEMCPY_IN_FUSION_BUFFER",
                 "MEMCPY_OUT_FUSION_BUFFER", "TCP_COLLECTIVE", "CYCLE_START",
                 "ALLREDUCE", "ALLGATHER", "BROADCAST", "QUEUE"):
        assert getattr(ttl, name) == getattr(jtl, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64,
                                   torch.int32, torch.int64, torch.int8,
                                   torch.uint8, torch.bool])
def test_dtype_names_are_numpys(dtype):
    import ml_dtypes

    probe = torch.empty(0, dtype=dtype)
    want = (np.dtype(ml_dtypes.bfloat16) if dtype == torch.bfloat16
            else probe.numpy().dtype)
    assert tctl.dtype_name(dtype) == str(want)


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "int8",
                                   "uint8", "uint16", "bool", "bfloat16"])
def test_host_sum_and_average_round_as_the_jax_adapter(dtype):
    """The coordinator's rank-order sum and the average, in the tensors'
    dtype, against numpy (ml_dtypes for bfloat16) as the JAX controller
    and its torch adapter compute them."""
    import ml_dtypes

    rng = np.random.RandomState(7)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    if dtype == "bool":
        parts = [rng.rand(64) > 0.5 for _ in range(3)]
    elif np.dtype(np_dtype).kind in "iu":
        info = np.iinfo(np_dtype)
        parts = [rng.randint(info.min, info.max, 64).astype(np_dtype)
                 for _ in range(3)]
    else:
        parts = [(rng.randn(64) * 3).astype(np_dtype) for _ in range(3)]
    want = parts[0].copy()
    for p in parts[1:]:
        want = want + p

    def to_torch(a):
        if dtype == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    got = to_torch(parts[0])
    for p in parts[1:]:
        got = tctl._host_sum(got, to_torch(p))
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy() if dtype == "bfloat16"
        else got.numpy(), want.view(np.int16) if dtype == "bfloat16"
        else want)
    if dtype != "uint16":
        # The JAX torch adapter: numpy's ``out / size``, cast back to the
        # tensor's dtype (bool is not divided).
        avg = want if dtype == "bool" else want / 3
        want_avg = to_torch(np.asarray(avg).astype(np_dtype)) \
            if dtype == "bfloat16" else torch.from_numpy(
                np.asarray(avg)).to(got.dtype)
        assert torch.equal(tctl.average(got, 3), want_avg)
