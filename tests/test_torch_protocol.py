"""The port's wire-protocol spec and monitor (``horovod_tpu_torch/
analysis/protocol.py``) against the JAX package's: the spec equal as
data, the same scripted frame sequences through both monitors giving
the same states, epochs, violations and reports in record and raise
modes, the port's own ``Wire`` through the reshape handshake and a
planted off-spec JOIN, the handler↔spec bijection over the port's
sources (and its drift cases in a temporary clone), and the
``protocheck`` CLI's exit codes."""

import json
import os
import shutil
import socket

import pytest

from horovod_tpu.analysis import protocol as jax_protocol
from horovod_tpu_torch.analysis import protocol
from horovod_tpu_torch.analysis.protocol import (
    ProtocolMonitor,
    ProtocolViolationError,
)
from horovod_tpu_torch.tools import protocheck as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "horovod_tpu_torch")
SECRET = b"x" * 32


# ---------------------------------------------------------------------------
# The spec


def test_spec_equals_the_jax_spec_as_data():
    assert protocol.SPEC == jax_protocol.SPEC
    assert protocol.KINDS == jax_protocol.KINDS
    assert protocol.ROLES == jax_protocol.ROLES
    assert protocol.INITIAL_EPOCH == jax_protocol.INITIAL_EPOCH
    assert protocol.INVARIANTS == jax_protocol.INVARIANTS
    assert protocol.HEARTBEAT_ALWAYS_LEGAL is True
    # The joiner's admitted states are the worker's rows, shared.
    assert protocol.SPEC["joiner"]["states"]["steady"] is \
        protocol.SPEC["worker"]["states"]["steady"]


def test_spec_is_consistent_and_renders_like_the_jax_one():
    assert protocol.check_spec() == []
    assert protocol.render_state_tables() == \
        jax_protocol.render_state_tables()
    assert list(protocol.iter_spec_entries()) == \
        list(jax_protocol.iter_spec_entries())


@pytest.mark.parametrize("new,current", [(2, 1), (1, 1), (1, 2), (3, 2)])
def test_epoch_helpers_match(new, current):
    assert protocol.epoch_advances(new, current) == \
        jax_protocol.epoch_advances(new, current)
    assert protocol.epoch_is_stale(new, current) == \
        jax_protocol.epoch_is_stale(new, current)


# ---------------------------------------------------------------------------
# The same frame sequences through both monitors


SCRIPTS = {
    "worker_lifecycle": ("worker", [
        ("send", "data", None), ("recv", "data", None),
        ("send", "heartbeat", None),
        ("recv", "reshape", {"epoch": 2, "rank": 1, "size": 2}),
        ("send", "join", {"ack": 2}), ("send", "data", None)]),
    "coordinator_drain_stale_ack": ("coordinator", [
        ("recv", "data", None), ("send", "reshape", {"epoch": 2}),
        ("recv", "data", None), ("recv", "join", {"ack": 1}),
        ("recv", "join", {"ack": 2}), ("send", "reshape", {"epoch": 3}),
        ("send", "reshape", {"epoch": 4}), ("recv", "join", {"ack": 4})]),
    "joiner_admission": ("joiner", [
        ("send", "join", {"join": True, "rank": None}),
        ("recv", "heartbeat", None),
        ("recv", "reshape", {"epoch": 3, "rank": 2, "size": 3}),
        ("send", "join", {"ack": 3}), ("send", "data", None),
        ("recv", "reshape", {"epoch": 4, "rank": 1, "size": 2})]),
    "shard_plane": ("worker", [
        ("send", "data", None), ("send", "shard_fetch", {"shard": 0}),
        ("recv", "shard_data", {"shard": 0}),
        ("recv", "reshape", {"epoch": 2}),
        ("send", "shard_fetch", {"shard": 1}), ("send", "join", {"ack": 2})]),
    "reshape_not_advancing": ("coordinator", [
        ("recv", "data", None), ("send", "reshape", {"epoch": 1})]),
    "ack_from_the_future": ("coordinator", [
        ("recv", "data", None), ("send", "reshape", {"epoch": 2}),
        ("recv", "join", {"ack": 5})]),
    "hello_where_an_ack_belongs": ("coordinator", [
        ("recv", "data", None), ("send", "reshape", {"epoch": 2}),
        ("recv", "join", {"join": True})]),
    "join_in_the_data_stream": ("coordinator", [
        ("recv", "data", None), ("recv", "join", {"join": True})]),
    "worker_sends_join_unasked": ("worker", [
        ("send", "data", None), ("send", "join", {"join": True}),
        ("send", "data", None)]),
    "parked_joiner_sends_data": ("joiner", [
        ("send", "join", {"join": True}), ("send", "data", None)]),
}


def _drive(mod, monkeypatch, mode, role, script):
    """Run ``script`` through a fresh monitor of ``mod``; returns the
    per-frame (state, epoch, pending, raised) trail and the report."""
    monkeypatch.setattr(mod, "_mode", mode)
    rec = mod._Recorder()
    mon = mod.ProtocolMonitor(role, recorder_=rec)
    trail = []
    for direction, kind, info in script:
        raised = None
        try:
            mon.observe(direction, kind, info)
        except mod.ProtocolViolationError as exc:
            raised = str(exc)
        trail.append((mon.state, mon.epoch, mon.pending_epoch, raised))
    report = rec.report()
    report.pop("enabled")
    return trail, report


@pytest.mark.parametrize("mode", ["record", "raise"])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_monitors_agree_on_scripted_frames(monkeypatch, name, mode):
    role, script = SCRIPTS[name]
    got = _drive(protocol, monkeypatch, mode, role, script)
    want = _drive(jax_protocol, monkeypatch, mode, role, script)
    assert got == want
    trail, report = got
    legal = not name.startswith(("reshape_not", "ack_from", "hello_where",
                                 "join_in", "worker_sends", "parked"))
    assert report["ok"] == legal
    assert report["transitions"] == len(script)
    if mode == "raise" and not legal:
        assert any(raised for *_, raised in trail)


def test_unknown_role_rejected():
    with pytest.raises(ValueError):
        ProtocolMonitor("bystander")


# ---------------------------------------------------------------------------
# The port's Wire under the monitor


@pytest.fixture
def protocheck_on(monkeypatch):
    monkeypatch.setattr(protocol, "_mode", "record")
    protocol.recorder().clear()
    yield
    protocol.recorder().clear()


def _wire_pair():
    from horovod_tpu_torch.common.wire import Wire

    a, b = socket.socketpair()
    return Wire(a, secret=SECRET), Wire(b, secret=SECRET)


def test_port_wire_reshape_handshake_is_conformant(protocheck_on):
    from horovod_tpu_torch.common.wire import RanksChangedError

    worker, coord = _wire_pair()
    worker.set_protocol_role("worker")
    coord.set_protocol_role("coordinator")
    worker.send_obj({"rank": 1})
    assert coord.recv_obj() == {"rank": 1}
    worker.send_obj({"tick": 0})
    coord.recv_obj()
    coord.send_obj({"reply": 0})
    worker.recv_obj()
    worker.send_heartbeat()
    coord.send_reshape(rank=1, size=2, epoch=2)
    with pytest.raises(RanksChangedError):
        worker.recv_obj()
    worker.send_shard_fetch({"shard": 0})   # late restore traffic
    worker.send_join({"ack": 2})
    coord.recv_reshape_ack(2)
    coord.send_obj({"epoch2": True})
    assert worker.recv_obj() == {"epoch2": True}
    report = protocol.recorder().report()
    assert report["ok"], report["violations"]
    assert report["transitions"] >= 12
    assert (coord._monitor.state, coord._monitor.epoch) == ("steady", 2)
    assert (worker._monitor.state, worker._monitor.epoch) == ("steady", 2)
    worker.close(), coord.close()


def test_join_in_the_data_stream_fires_naming_the_transition(protocheck_on):
    from horovod_tpu_torch.common.wire import AuthError

    worker, coord = _wire_pair()
    worker.set_protocol_role("worker")
    coord.set_protocol_role("coordinator")
    worker.send_obj({"rank": 1})
    coord.recv_obj()
    worker.send_join({"join": True})        # off-spec: no reshape pending
    with pytest.raises(AuthError, match="join frame"):
        coord.recv_obj()
    report = protocol.recorder().report()
    assert not report["ok"]
    named = {(v["role"], v["state"], v["direction"], v["kind"])
             for v in report["violations"]}
    assert named == {("worker", "steady", "send", "join"),
                     ("coordinator", "steady", "recv", "join")}
    detail = [v["detail"] for v in report["violations"]
              if v["role"] == "coordinator"][0]
    assert "join frame in the data stream" in detail
    worker.close(), coord.close()


def test_raise_mode_stops_the_frame_before_the_socket(monkeypatch):
    monkeypatch.setattr(protocol, "_mode", "raise")
    protocol.recorder().clear()
    worker, coord = _wire_pair()
    worker.set_protocol_role("worker")
    worker.send_obj({"rank": 1})
    with pytest.raises(ProtocolViolationError, match="worker.steady send "
                                                     "join"):
        worker.send_join({"join": True})
    coord._sock.setblocking(False)
    coord.recv_obj()                         # the hello
    with pytest.raises(BlockingIOError):
        coord._sock.recv(1)                  # nothing else was sent
    protocol.recorder().clear()
    worker.close(), coord.close()


def test_monitor_off_costs_no_monitor(monkeypatch):
    monkeypatch.setattr(protocol, "_mode", "")
    worker, coord = _wire_pair()
    worker.set_protocol_role("worker")
    assert worker._monitor is None
    worker.close(), coord.close()


def test_report_artifact_and_rank_expansion(protocheck_on, tmp_path,
                                            monkeypatch):
    ProtocolMonitor("worker").observe("send", "data")
    out = tmp_path / "protocheck.json"
    assert protocol.write_report(str(out)) == str(out)
    payload = json.loads(out.read_text())
    assert payload["ok"] is True and payload["transitions"] >= 1
    for knob in ("pc-{rank}.json", "pc.json"):
        monkeypatch.setenv("HOROVOD_PROTOCHECK_OUTPUT", str(tmp_path / knob))
        monkeypatch.setenv("HOROVOD_RANK", "3")
        assert protocol.output_path() == jax_protocol.output_path()
    assert protocol.output_path() == str(tmp_path / "pc.json") + ".rank3"


# ---------------------------------------------------------------------------
# The static bijection over the port's sources


def test_handler_spec_bijection_holds_on_the_port():
    findings = protocol.check_handlers(PKG)
    assert findings == [], "\n".join(
        f"{f['path']}:{f['line']}: {f['message']}" for f in findings)
    # The port's own surface: the native engine's traced star and the
    # shard plane are scanned too.
    assert {"controller/native.py", "elastic/shards.py"} <= \
        set(protocol.PROTOCOL_SURFACE)
    assert protocol.HANDLERS == jax_protocol.HANDLERS


def _clone(tmp_path):
    """A copy of the port's protocol surface to seed drift into."""
    root = tmp_path / "pkg"
    for rel in protocol.PROTOCOL_SURFACE:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(PKG, rel), root / rel)
    return root


def _seed(path, old, new):
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))


def test_seeded_off_spec_handler_fails(tmp_path):
    root = _clone(tmp_path)
    # recv_hello loses its explicit branch for RESHAPE frames.
    _seed(root / "common/wire.py",
          "if kind in (FRAME_ABORT, FRAME_RESHAPE, FRAME_SHARD_FETCH,",
          "if kind in (FRAME_ABORT, FRAME_SHARD_FETCH,")
    # And the native engine's module grows a frame-kind dispatch.
    with open(root / "controller/native.py", "a") as f:
        f.write("\n\ndef _peek(kind):\n"
                "    from ..common.wire import FRAME_ABORT\n"
                "    return kind == FRAME_ABORT\n")
    messages = [f["message"] for f in protocol.check_handlers(str(root))]
    assert any("recv_hello has no branch for frame kind 'reshape'" in m
               for m in messages), messages
    assert any("dispatch in _peek" in m for m in messages), messages


def test_cli_exit_codes(tmp_path, monkeypatch, capsys):
    assert cli.main(["--format", "json", "--native"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["static_findings"] == []
    assert payload["native"]["findings"] == []
    assert payload["native"]["coverage"]["data"]["status"] == "handled"
    assert cli.main(["--dump-spec"]) == 0
    out = capsys.readouterr().out
    assert out == jax_protocol.render_state_tables()
    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps(
        {"ok": True, "transitions": 5, "violations": []}))
    assert cli.main(["--runtime", str(clean)]) == 0
    capsys.readouterr()
    dirty = tmp_path / "dirty.json"
    dirty.write_text(json.dumps({
        "ok": False, "transitions": 5,
        "violations": [{"role": "worker", "state": "steady",
                        "direction": "send", "kind": "join", "epoch": 1,
                        "pending_epoch": None,
                        "detail": "reshape ack without a reshape"}]}))
    assert cli.main(["--runtime", str(clean), str(dirty)]) == 1
    assert "OFF-SPEC worker.steady send join" in capsys.readouterr().out
    assert cli.main(["--runtime", str(tmp_path / "missing.json")]) == 1
    capsys.readouterr()
    trimmed = {k: v for k, v in sorted(protocol.HANDLERS.items())
               if not k.endswith("recv_reshape_ack")}
    monkeypatch.setattr(protocol, "HANDLERS", trimmed)
    assert cli.main(["--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert any("recv_reshape_ack" in f["message"]
               for f in payload["static_findings"])
