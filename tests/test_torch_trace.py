"""The port's trace plane (``trace/clock.py``, ``tracer.py``, ``merge.py``,
``straggler.py`` and the clock frames of ``common/wire.py``) against the
JAX package's, on the CPU.

The tolerance is exact equality throughout: the clock table of the same
scripted ping/pong series, the bytes of a span file written at the same
clock readings, the bytes of ``merged_trace.json`` and
``straggler_report.json`` from the same per-rank files, the straggler
series fed into the metrics registry, and the bytes of the HEARTBEAT
frames that carry a ping and its pong (``time.time()`` fixed on both
sides).
"""

import json
import os
import socket
import struct
import time

import numpy as np
import pytest

from horovod_tpu import trace as jtrace
from horovod_tpu.common import wire as jwire

from horovod_tpu_torch import trace as ptrace
from horovod_tpu_torch.common import wire as pwire

SECRET = bytes(range(32))


def _series(seed, ranks, n):
    """A scripted ping/pong series: (rank, t0, peer_wall, t1) with skewed
    clocks, asymmetric paths and a negative-RTT sample."""
    rng = np.random.RandomState(seed)
    skew = {r: float(rng.uniform(-0.5, 0.5)) for r in range(1, ranks)}
    out = []
    for k in range(n):
        r = 1 + k % (ranks - 1)
        t0 = 1000.0 + k * 0.01
        up, down = rng.uniform(1e-5, 3e-3, 2)
        out.append((r, t0, t0 + up + skew[r], t0 + up + down))
    out.append((1, 2000.0, 2000.0, 1999.0))
    return out


@pytest.mark.parametrize("ranks,n,window", [(2, 5, 64), (4, 90, 64),
                                            (3, 200, 8), (5, 3, 1)])
def test_clock_table_is_the_jax_clock_sync(tmp_path, ranks, n, window):
    clocks = [jtrace.ClockSync(ranks, window=window),
              ptrace.ClockSync(ranks, window=window)]
    for sample in _series(ranks + n, ranks, n):
        for clock in clocks:
            clock.observe(*sample)
    assert clocks[1].table() == clocks[0].table()
    for r in range(ranks):
        assert clocks[1].estimate(r) == clocks[0].estimate(r)
    paths = [clock.write(str(tmp_path / f"{k}.json"))
             for k, clock in enumerate(clocks)]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert ptrace.load_offsets(paths[1]) == jtrace.load_offsets(paths[0])
    assert ptrace.load_offsets(str(tmp_path / "missing.json")) == {}


def test_the_trace_surface_is_the_jax_one():
    assert ptrace.__all__ == jtrace.__all__
    for name in ("PHASES", "SERVING_PHASES", "ALL_PHASES",
                 "MERGED_TRACE_FILE", "OFFSETS_FILE", "REPORT_FILE"):
        assert getattr(ptrace, name) == getattr(jtrace, name), name
    assert ptrace.rank_trace_path("/d", 3) == jtrace.rank_trace_path("/d", 3)


def _spans(seed, rank, n=40):
    """(phase, t0, t1, seq, op) spans of one rank: every seq on every
    rank, each rank's negotiate arrival drawn late or early."""
    rng = np.random.RandomState(seed * 31 + rank)
    out = []
    for seq in range(n):
        base = 10.0 + seq * 0.01 + float(rng.uniform(0, 2e-3))
        for k, phase in enumerate(jtrace.PHASES):
            t0 = base + k * 1e-4
            out.append((phase, t0, t0 + float(rng.uniform(0, 5e-5)), seq,
                        f"grad.{seq % 7}"))
    return out


def _write_rank_files(trace_dir, pkg, ranks, seed, monkeypatch):
    """Each rank's file through ``pkg``'s TraceWriter, at clock readings
    made the same on both sides."""
    os.makedirs(trace_dir, exist_ok=True)
    for rank in range(ranks):
        monkeypatch.setattr(time, "monotonic", lambda: 10.0)
        monkeypatch.setattr(time, "time", lambda r=rank: 5000.0 + r * 1e-3)
        writer = pkg.TraceWriter(pkg.rank_trace_path(trace_dir, rank), rank)
        for phase, t0, t1, seq, op in _spans(seed, rank):
            writer.span(phase, t0, t1, seq=seq, op=op)
        writer.span("fuse", 11.0, 11.5, seq=99, op="fused[2]", tensors=2)
        writer.close()
    monkeypatch.undo()


@pytest.mark.parametrize("ranks,seed,offsets", [(2, 0, True),
                                                (3, 1, True),
                                                (4, 2, False)])
def test_span_files_merge_and_report_are_the_jax_bytes(tmp_path, monkeypatch,
                                                       ranks, seed, offsets):
    out = {}
    for name, pkg in (("jax", jtrace), ("port", ptrace)):
        trace_dir = str(tmp_path / name)
        _write_rank_files(trace_dir, pkg, ranks, seed, monkeypatch)
        if offsets:
            clock = pkg.ClockSync(ranks)
            for sample in _series(seed, ranks, 20):
                clock.observe(*sample)
            clock.write(os.path.join(trace_dir, pkg.OFFSETS_FILE))
        merged = pkg.merge_trace_dir(trace_dir)
        report = pkg.write_report(trace_dir, feed=False)
        files = pkg.rank_trace_files(trace_dir)
        out[name] = [open(p, "rb").read() for p in
                     [files[r] for r in sorted(files)] + [merged, report]]
    assert out["port"] == out["jax"]
    report = json.loads(out["port"][-1])
    assert report["collectives"] == 40 and report["ranks"] == \
        list(range(ranks))


def test_attribution_feeds_the_jax_series():
    from horovod_tpu import metrics as jmetrics
    from horovod_tpu_torch import metrics as pmetrics

    events = []
    for rank in range(3):
        events.append({"name": "clock_sync", "ph": "M", "pid": rank,
                       "args": {"rank": rank, "synced": True}})
        for seq in range(30):
            late = 0.004 if (seq % 3 == rank) else 0.0
            events.append({"name": "negotiate", "ph": "X", "pid": rank,
                           "ts": int((seq * 0.01 + late) * 1e6), "dur": 5,
                           "args": {"seq": seq, "op": f"t{seq}"}})
    snaps, reports = [], []
    for metrics, pkg in ((jmetrics, jtrace), (pmetrics, ptrace)):
        metrics.reset_for_tests()
        metrics.enable()
        reports.append(pkg.attribute(events, feed=True))
        snap = metrics.snapshot()
        snaps.append({k: snap[k] for k in ("hvd_negotiation_slack_seconds",
                                           "hvd_straggler_cycles_total")})
        reports.append(pkg.summary(snap))
        metrics.reset_for_tests()
    assert reports[2:] == reports[:2]
    assert snaps[1] == snaps[0]
    assert reports[2]["worst_rank"] in (0, 1, 2)


def test_merge_of_an_empty_dir_raises_as_the_jax_merge(tmp_path):
    for pkg in (jtrace, ptrace):
        with pytest.raises(FileNotFoundError, match="no trace.rank"):
            pkg.merge_trace_dir(str(tmp_path))


# ------------------------------------------------------ the clock frames

def _frames(sock, n):
    """The next ``n`` raw frames on ``sock``: header + digest + payload."""
    out, buf = [], b""
    hdr = struct.Struct("!BI").size + 32
    sock.settimeout(5.0)
    while len(out) < n:
        while len(buf) < hdr:
            buf += sock.recv(65536)
        length = struct.unpack("!BI", buf[:5])[1]
        while len(buf) < hdr + length:
            buf += sock.recv(65536)
        out.append(buf[:hdr + length])
        buf = buf[hdr + length:]
    return out


@pytest.mark.parametrize("stamp", [1700000000.25, 12.5])
def test_heartbeat_clock_frames_are_the_jax_bytes(monkeypatch, stamp):
    monkeypatch.setattr(time, "time", lambda: stamp)
    sent = {}
    for name, mod in (("jax", jwire), ("port", pwire)):
        a, b = socket.socketpair()
        try:
            wire = mod.Wire(a, secret=SECRET)
            seen = []
            wire.set_clock_callback(lambda *args: seen.append(args))
            # A ping, the heartbeat a clocked wire sends, and a plain one.
            assert wire.send_clock_ping()
            assert wire.try_send_heartbeat()
            plain = mod.Wire(a, secret=SECRET)
            assert plain.try_send_heartbeat()
            frames = _frames(b, 3)
            # The peer answers a ping with a pong inside its next recv.
            peer = mod.Wire(b, secret=SECRET)
            a.sendall(frames[0])
            wire.send_bytes(b"tick")
            assert bytes(peer.recv_bytes()) == b"tick"
            pong = _frames(a, 1)[0]
            # The pong reaches the clock callback inside the next recv.
            b.sendall(pong)
            peer.send_bytes(b"tock")
            assert bytes(wire.recv_bytes()) == b"tock"
            sent[name] = (frames, pong, seen)
        finally:
            a.close()
            b.close()
    assert sent["port"] == sent["jax"]
    frames, pong, seen = sent["port"]
    assert frames[0][0] == pwire.FRAME_HEARTBEAT and frames[0] == frames[1]
    assert len(frames[2]) == 5 + 32  # plain liveness: an empty payload
    assert seen == [(stamp, stamp, stamp)]


def test_engine_tracing_entries_are_bound():
    """The tuning and tracing entries of the port's core are bound with
    the JAX bindings' types, and answer zeros before an engine exists."""
    import ctypes

    from horovod_tpu_torch.core import bindings

    lib = bindings.load()
    c_int, c_ll, c_d = ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    want = {
        "hvd_eng_set_params": ([c_ll, c_d], None),
        "hvd_eng_set_tuned_bucket": ([c_ll], None),
        "hvd_eng_trace_set": ([c_int, c_ll], None),
        "hvd_eng_span_probe": ([c_ll], c_d),
        "hvd_eng_get_spans": ([c_ll, ctypes.POINTER(c_int),
                               ctypes.POINTER(c_ll), ctypes.POINTER(c_d),
                               ctypes.POINTER(c_d), ctypes.POINTER(c_int),
                               ctypes.c_char_p, c_int], c_int),
    }
    for name, (args, res) in sorted(want.items()):
        fn = getattr(lib, name)
        assert list(fn.argtypes) == args and fn.restype == res, name
    if not lib.hvd_eng_active():
        assert lib.hvd_eng_span_probe(10) == 0.0
        assert bindings.engine_stats() == (0, 0, 0.0)
        assert list(bindings.drain_engine_spans()) == []
    assert bindings.NATIVE_SPAN_OP_BYTES == 64
