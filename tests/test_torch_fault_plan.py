"""The port's fault plan (``horovod_tpu_torch.fault``) against the JAX
package's (``horovod_tpu.fault``): the plan cases of
``tests/test_fault_tolerance.py`` and ``tests/test_elastic.py`` run on the
same JSON through both packages — the firing sequences (results and
raised errors) are equal, the seeded delay jitter is equal to the float,
and both reject the same bad plans with the same message. Then the
port's own hooks: the wedged init (``init`` and ``init_distributed``)
recovers within the retry budget and fails loudly once it is spent
(nothing falls back to the CPU), and with no plan the wire writes the
JAX wire's bytes and every hook is a no-op."""

import json
import socket
import subprocess
import sys

import pytest

import horovod_tpu.fault as jfault
import horovod_tpu.fault.plan as jplan
from horovod_tpu.common import wire as jwire
import horovod_tpu_torch.fault as tfault
import horovod_tpu_torch.fault.plan as tplan
from horovod_tpu_torch.common import basics, retry
from horovod_tpu_torch.common import wire as twire

PACKAGES = ((jfault, jplan), (tfault, tplan))


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    jfault.reset()
    tfault.reset()


def _fire_all(plan_mod, spec, events, rank=None, monkeypatch=None):
    """Fire ``events`` (site names) through ``plan_mod``'s plan of
    ``spec``; returns, per event, its result or the error it raised
    (class name and message), and the sleeps the plan asked for."""
    slept = []
    if monkeypatch is not None:
        monkeypatch.setattr(plan_mod.time, "sleep", slept.append)
    plan = plan_mod.FaultPlan.from_json(json.dumps(spec), rank=rank)
    out = []
    for site in events:
        try:
            out.append(("ok", plan.fire(site)))
        except Exception as exc:  # FaultInjected / InitWedged
            out.append((type(exc).__name__, str(exc)))
    return out, slept, {site: plan.count(site) for site in set(events)}


SEQUENCES = [
    ({"seed": 7, "faults": [
        {"site": "wire_send", "action": "drop", "at": 3},
        {"site": "cycle", "action": "raise", "at": 2,
         "message": "boom at cycle 2"}]}, None,
     ["wire_send"] * 4 + ["cycle"] * 3),
    ({"faults": [{"site": "cycle", "action": "raise", "at": 1, "rank": 1},
                 {"site": "init", "action": "wedge", "times": 1}]}, 0,
     ["cycle", "init", "init"]),
    ({"faults": [{"site": "cycle", "action": "raise", "at": 1, "rank": 1},
                 {"site": "init", "action": "wedge", "times": 1}]}, 1,
     ["cycle", "init"]),
    ({"faults": [{"site": "init", "action": "wedge", "times": 2}]}, None,
     ["init"] * 4),
    ({"faults": [{"site": "init_distributed", "action": "wedge",
                  "times": 1, "message": "store down"}]}, 3,
     ["init_distributed"] * 2 + ["init"]),
    ({"faults": [{"site": "wire_recv", "action": "raise", "at": 2,
                  "times": 2}]}, None, ["wire_recv"] * 5),
    ({"faults": [{"site": "ckpt_save", "action": "raise", "at": 1}]},
     None, ["ckpt_save"] * 2),
]


@pytest.mark.parametrize("spec,rank,events", SEQUENCES)
def test_firing_sequences_equal(spec, rank, events):
    runs = [_fire_all(plan_mod, spec, events, rank)
            for _, plan_mod in PACKAGES]
    assert runs[0] == runs[1]
    assert any(r != ("ok", None) for r in runs[0][0])


def test_seeded_delay_jitter_equal_to_the_float(monkeypatch):
    spec = {"seed": 42, "faults": [
        {"site": "cycle", "action": "delay", "at": 1, "times": 5,
         "seconds": 0.01, "jitter": 0.5},
        {"site": "wire_send", "action": "delay", "at": 2, "times": 2,
         "seconds": 0.02, "jitter": 0.25}]}
    events = ["cycle", "wire_send"] * 5
    runs = [_fire_all(plan_mod, spec, events, monkeypatch=monkeypatch)
            for _, plan_mod in PACKAGES]
    assert runs[0][1] == runs[1][1] and len(runs[0][1]) == 7
    assert len(set(runs[0][1])) > 1  # jittered, not constant
    # The same seed, the same delays: twice through the port.
    assert _fire_all(tplan, spec, events,
                     monkeypatch=monkeypatch)[1] == runs[1][1]


BAD_PLANS = [
    {"faults": [{"site": "nope", "action": "kill", "at": 1}]},
    {"faults": [{"site": "cycle", "action": "nope", "at": 1}]},
    {"faults": [{"site": "cycle", "action": "kill"}]},
    {"faults": [{"site": "cycle", "action": "drop", "at": 1}]},
    {"faults": [{"site": "cycle", "action": "wedge", "times": 1}]},
    {"faults": [{"site": "wire_send", "action": "join", "at": 1}]},
    {"faults": [{"site": "wire_recv", "action": "leave", "at": 1}]},
    {"faults": [{"site": "cycle", "action": "group_kill", "at": 1}]},
    {"faults": [{"site": "cycle", "action": "kill", "at": 1,
                 "ranks": [1]}]},
    {"faults": [{"site": "cycle", "action": "kill", "at": 1,
                 "bogus": 1}]},
]


@pytest.mark.parametrize("spec", BAD_PLANS)
def test_bad_plans_refused_alike(spec):
    errors = []
    for _, plan_mod in PACKAGES:
        with pytest.raises((ValueError, TypeError)) as exc:
            plan_mod.FaultPlan.from_json(json.dumps(spec), rank=0)
        errors.append((type(exc.value), str(exc.value)))
    assert errors[0] == errors[1]


def test_group_kill_needs_a_rank_identity():
    spec = json.dumps({"faults": [{"site": "cycle", "action": "group_kill",
                                   "at": 2, "ranks": [2, 1]}]})
    for _, plan_mod in PACKAGES:
        with pytest.raises(ValueError, match="HOROVOD_RANK"):
            plan_mod.FaultPlan.from_json(spec)
        assert plan_mod.FaultPlan.from_json(spec, rank=1).rules[0].ranks \
            == [1, 2]
        assert not plan_mod.FaultPlan.from_json(spec, rank=0).rules


def test_env_loading_inline_and_file(tmp_path, monkeypatch):
    spec = {"faults": [{"site": "wire_send", "action": "drop", "at": 1}]}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(spec))
    for raw in (json.dumps(spec), f"@{path}", json.dumps(spec["faults"])):
        monkeypatch.setenv("HOROVOD_FAULT_PLAN", raw)
        monkeypatch.setenv("HOROVOD_RANK", "0")
        for _, plan_mod in PACKAGES:
            assert plan_mod.FaultPlan.from_env().fire("wire_send") == "drop"
    monkeypatch.setenv("HOROVOD_FAULT_PLAN", "   ")
    for _, plan_mod in PACKAGES:
        assert plan_mod.FaultPlan.from_env() is None


def test_hook_follows_the_environment_per_process(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_PLAN", json.dumps({"faults": [
        {"site": "wire_send", "action": "drop", "at": 2, "rank": 3}]}))
    for rank, want in (("3", [None, "drop", None]), ("1", [None] * 3)):
        monkeypatch.setenv("HOROVOD_RANK", rank)
        for fault_mod, _ in PACKAGES:
            fault_mod.reset()
            assert [fault_mod.hook("wire_send") for _ in range(3)] == want


def test_leave_and_join_actions(monkeypatch):
    for _, plan_mod in PACKAGES:
        calls = []
        monkeypatch.setattr(plan_mod, "_graceful_leave",
                            lambda: calls.append("leave"))
        monkeypatch.setattr(plan_mod, "_spawn_joiner",
                            lambda: calls.append("join"))
        plan = plan_mod.FaultPlan.from_json(json.dumps({"faults": [
            {"site": "cycle", "action": "leave", "at": 3},
            {"site": "cycle", "action": "join", "at": 2, "rank": 1}]}),
            rank=1)
        for _ in range(4):
            plan.fire("cycle")
        assert calls == ["join", "leave"]


def test_spawn_joiner_scrubs_the_plan(monkeypatch):
    captured = []

    def fake_popen(cmd, env=None, **kwargs):
        captured.append((cmd, env))

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    monkeypatch.setenv("HOROVOD_FAULT_PLAN", "[]")
    jplan._spawn_joiner()
    tplan._spawn_joiner()
    (jcmd, jenv), (tcmd, tenv) = captured
    assert jcmd == tcmd == [sys.executable] + sys.argv
    for env in (jenv, tenv):
        assert env["HOROVOD_ELASTIC_JOIN"] == "1"
        assert "HOROVOD_FAULT_PLAN" not in env


# ---------------------------------------------------------------------------
# The port's init hooks


def _init_with(monkeypatch, spec, retries, launched=None):
    monkeypatch.setenv("HOROVOD_TPU_INIT_RETRIES", str(retries))
    monkeypatch.setenv("HOROVOD_TPU_INIT_BACKOFF", "0")
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_CONTROLLER_ADDR",
                "HOROVOD_SPMD_COORDINATOR", "HOROVOD_RENDEZVOUS_FILE",
                "HOROVOD_ELASTIC"):
        monkeypatch.delenv(var, raising=False)
    for var, value in sorted((launched or {}).items()):
        monkeypatch.setenv(var, value)
    plan = tplan.FaultPlan.from_json(json.dumps(spec), rank=0)
    tfault.install_plan(plan)
    return plan


@pytest.mark.parametrize("site", ["init", "init_distributed"])
def test_wedged_init_recovers_within_its_budget(monkeypatch, tmp_path,
                                                site):
    launched = {"HOROVOD_RANK": "0", "HOROVOD_SIZE": "1",
                "HOROVOD_RENDEZVOUS_FILE": str(tmp_path / "store")}
    plan = _init_with(monkeypatch, {"faults": [
        {"site": site, "action": "wedge", "times": 2}]}, retries=3,
        launched=launched)
    basics.init(device="cpu")
    try:
        assert plan.count(site) == 3 and basics.size() == 1
        import torch.distributed as dist

        assert dist.is_initialized()
    finally:
        basics.shutdown()


@pytest.mark.parametrize("site", ["init", "init_distributed"])
def test_wedged_init_fails_loudly_when_the_budget_is_spent(
        monkeypatch, tmp_path, site):
    launched = {"HOROVOD_RANK": "0", "HOROVOD_SIZE": "1",
                "HOROVOD_RENDEZVOUS_FILE": str(tmp_path / "store")}
    plan = _init_with(monkeypatch, {"faults": [
        {"site": site, "action": "wedge", "times": 5}]}, retries=2,
        launched=launched)
    with pytest.raises(retry.RetryError) as exc:
        basics.init(device="cpu")
    assert isinstance(exc.value.last, tplan.InitWedged)
    assert plan.count(site) == 2
    assert not basics.is_initialized()  # no CPU fallback: nothing runs


def test_no_plan_wire_bytes_equal_the_jax_wire():
    tfault.install_plan(None)
    jfault.install_plan(None)
    secret = b"k" * 32
    frames = []
    for mod in (jwire, twire):
        a, b = socket.socketpair()
        try:
            w = mod.Wire(a, secret=secret)
            w.send_bytes(b"payload" * 9)
            w.send_obj({"rank": 1, "requests": [1, 2]})
            w.send_join({"ack": 4})
            a.shutdown(socket.SHUT_WR)
            got = b""
            while True:
                chunk = b.recv(1 << 16)
                if not chunk:
                    break
                got += chunk
            frames.append(got)
        finally:
            a.close()
            b.close()
    assert frames[0] == frames[1] and len(frames[0]) > 100
    for site in tplan.VALID_SITES:
        assert tfault.hook(site) is None
    assert tfault.active_plan() is None
