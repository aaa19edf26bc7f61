"""The port's lock-order detector (``horovod_tpu_torch/analysis/
lockorder.py``) against the JAX package's: the same acquisition scripts
through both ``LockGraph``s give the same edges, counts and cycles (a
seeded inversion included), ``make_lock`` and the artifact behave alike,
a ``TrackedLock`` works under ``threading.Condition``, the static pass
agrees with the JAX one on the same sources, and the port's own static
graph (its ``make_lock`` sites with the C++ core's mutexes) is acyclic
and carries the JAX package's lock names."""

import json
import threading

import pytest

from horovod_tpu.analysis import lockorder as jax_lockorder
from horovod_tpu_torch.analysis import lockorder
from horovod_tpu_torch.tools import protocheck as cli

# Acquisition scripts: each thread's ops, run one thread after another
# (the graph is about order, not timing). ("a", n) acquires lock n,
# ("r", n) releases it, ("t", n) try-acquires a lock another holder has.
SCRIPTS = {
    "consistent": [[("a", "x"), ("a", "y"), ("r", "y"), ("r", "x")]] * 3,
    "inversion": [[("a", "x"), ("a", "y"), ("r", "y"), ("r", "x")],
                  [("a", "y"), ("a", "x"), ("r", "x"), ("r", "y")]],
    "three_cycle": [[("a", "x"), ("a", "y"), ("r", "y"), ("r", "x")],
                    [("a", "y"), ("a", "z"), ("r", "z"), ("r", "y")],
                    [("a", "z"), ("a", "x"), ("r", "x"), ("r", "z")]],
    "same_name": [[("a", "m"), ("a", "m2"), ("r", "m2"), ("r", "m")]],
    "non_lifo": [[("a", "x"), ("a", "y"), ("r", "x"), ("a", "z"),
                  ("r", "y"), ("r", "z")]],
    "failed_try": [[("a", "x"), ("t", "busy"), ("a", "y"), ("r", "y"),
                    ("r", "x")]],
}
# Two instances sharing one node name, as every metric's child lock does.
NAMES = {"m2": "m"}


def _run(mod, script):
    graph = mod.LockGraph()
    locks = {}

    def lock(name):
        if name not in locks:
            locks[name] = mod.TrackedLock(NAMES.get(name, name),
                                          graph_=graph)
        return locks[name]

    busy = lock("busy")
    busy._inner.acquire()          # held elsewhere: try-acquires fail
    for i, ops in enumerate(script):
        def body(ops=ops):
            for op, name in ops:
                if op == "a":
                    lock(name).acquire()
                elif op == "r":
                    lock(name).release()
                else:
                    assert not lock(name).acquire(blocking=False)
        t = threading.Thread(target=body, name=f"script-{i}", daemon=True)
        t.start()
        t.join()
    report = graph.report()
    for edge in report["edges"]:
        assert edge["stack_held"] and edge["stack_acquired"]
        edge.pop("stack_held"), edge.pop("stack_acquired")
    for cyc in report["cycles"]:
        for edge in cyc["edges"]:
            edge.pop("stack_held"), edge.pop("stack_acquired")
    report.pop("enabled")
    return report


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_lock_graphs_agree_on_scripts(name):
    got = _run(lockorder, SCRIPTS[name])
    assert got == _run(jax_lockorder, SCRIPTS[name])
    cyclic = name in ("inversion", "three_cycle")
    assert got["acyclic"] is not cyclic
    if name == "inversion":
        (cyc,) = got["cycles"]
        assert cyc["locks"] == ["x", "y", "x"]
        assert {e["thread"] for e in cyc["edges"]} == {"script-0",
                                                       "script-1"}
    if name == "same_name":
        assert got["edges"] == []
    if name == "consistent":
        assert got["edges"][0]["count"] == 3


def test_seeded_inversion_stacks_name_both_paths():
    graph = lockorder.LockGraph()
    a = lockorder.TrackedLock("seed.a", graph_=graph)
    b = lockorder.TrackedLock("seed.b", graph_=graph)

    def path_one():
        with a, b:
            pass

    def path_two():
        with b, a:
            pass

    path_one(), path_two()
    (cyc,) = graph.report()["cycles"]
    acquired = [fr for e in cyc["edges"] for fr in e["stack_acquired"]]
    assert any("path_one" in fr for fr in acquired)
    assert any("path_two" in fr for fr in acquired)


def test_acquisition_stacks_read_as_the_jax_ones():
    """The port walks at most the stack limit's frames instead of
    extracting the whole stack; the strings must be the same."""
    def nested(mod, depth):
        if depth:
            return nested(mod, depth - 1)
        return mod._capture_stack()

    for depth in (0, 3, 30):
        # One line, so the callers' frames read alike.
        got, want = nested(lockorder, depth), nested(jax_lockorder, depth)
        assert got == want
        assert len(got) == lockorder._STACK_LIMIT
        assert "in nested" in got[-1]


@pytest.mark.parametrize("edges", [
    [("a", "b"), ("b", "c"), ("c", "a"), ("b", "a")],
    [("a", "b")], [], [("q", "r"), ("r", "q"), ("r", "s"), ("s", "q")]])
def test_find_cycles_matches(edges):
    assert lockorder.find_cycles(edges) == jax_lockorder.find_cycles(edges)


def test_tracked_lock_under_a_condition():
    graph = lockorder.LockGraph()
    outer = lockorder.TrackedLock("cond.outer", graph_=graph)
    inner = lockorder.TrackedLock("cond.inner", graph_=graph)
    cond = threading.Condition(inner)
    ready = []

    def waiter():
        with cond:
            while not ready:
                cond.wait(timeout=5.0)

    t = threading.Thread(target=waiter, name="cond-waiter", daemon=True)
    t.start()
    with outer:
        with cond:
            ready.append(1)
            cond.notify_all()
    t.join(timeout=10)
    assert not t.is_alive()
    assert not inner.locked() and not outer.locked()
    assert ("cond.outer", "cond.inner") in graph.edges()
    assert graph.report()["acyclic"]


def test_make_lock_follows_the_knob(monkeypatch):
    plain = type(threading.Lock())
    for value, tracked in (("", False), ("1", True), ("0", False)):
        monkeypatch.setenv("HOROVOD_LOCKCHECK", value)
        for mod in (lockorder, jax_lockorder):
            monkeypatch.setattr(mod, "_enabled", None)
        got = lockorder.make_lock("k")
        assert isinstance(got, lockorder.TrackedLock if tracked else plain)
        assert type(jax_lockorder.make_lock("k")).__name__ == \
            type(got).__name__
    for mod in (lockorder, jax_lockorder):
        monkeypatch.setattr(mod, "_enabled", None)


def test_graph_artifact_and_rank_expansion(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_LOCKCHECK", "1")
    monkeypatch.setattr(lockorder, "_enabled", None)
    a = lockorder.TrackedLock("art.a")
    b = lockorder.TrackedLock("art.b")
    with a, b:
        pass
    out = tmp_path / "lockgraph.json"
    assert lockorder.write_graph(str(out)) == str(out)
    payload = json.loads(out.read_text())
    assert any((e["from"], e["to"]) == ("art.a", "art.b")
               for e in payload["edges"])
    for knob in ("lg-{rank}.json", "lg.json"):
        monkeypatch.setenv("HOROVOD_LOCKCHECK_OUTPUT", str(tmp_path / knob))
        monkeypatch.setenv("HOROVOD_RANK", "2")
        assert lockorder.output_path() == jax_lockorder.output_path()
    lockorder.graph().clear()
    monkeypatch.setattr(lockorder, "_enabled", None)


SEEDED = '''from {pkg}.analysis.lockorder import make_lock


class Widget:
    def __init__(self):
        self._a = make_lock("seed.a")
        self._b = make_lock("seed.b")

    def forwards(self):
        with self._a:
            with self._b:
                pass

    def backwards(self):
        with self._b:
            self.helper()

    def helper(self):
        with self._a:
            pass
'''


def test_static_pass_agrees_with_the_jax_one(tmp_path):
    (tmp_path / "mod.py").write_text(SEEDED.format(pkg="horovod_tpu_torch"))
    got = lockorder.static_graph([str(tmp_path)])
    assert got == jax_lockorder.static_graph([str(tmp_path)])
    assert not got["acyclic"]
    via = [e["via"] for e in got["edges"]
           if (e["from"], e["to"]) == ("seed.b", "seed.a")][0]
    assert "backwards" in via and "helper" in via


def test_port_static_graph_is_acyclic_with_the_jax_names():
    rep = lockorder.static_graph()
    assert rep["acyclic"], "; ".join(" -> ".join(c["locks"])
                                     for c in rep["cycles"])
    locks = set(rep["locks"])
    # Every make_lock name the JAX package has and the port ports, plus
    # the port-only control-plane locks the static pass finds held
    # across a tracked lock, plus the C++ core's mutexes.
    assert {"trace.writer", "trace.clock", "metrics.state",
            "metrics.metric", "metrics.registry", "timeline.pids",
            "timeline.drops", "shards.pending", "serving.router",
            "serving.engine", "controller.state", "service.wires",
            "ckpt.writer", "wire.send", "nativectl.state",
            "fault.plan"} <= locks
    assert {"native.engine.g_engine_mu", "native.engine.mu_"} <= locks
    edges = {(e["from"], e["to"]) for e in rep["edges"]}
    for edge in [("timeline.pids", "metrics.metric"),
                 ("wire.send", "metrics.metric"),
                 ("nativectl.state", "metrics.registry"),
                 ("fault.plan", "metrics.registry"),
                 ("native.engine.g_engine_mu", "native.engine.mu_")]:
        assert edge in edges, edge


def test_join_reports_matches():
    static = {"edges": [{"from": "a", "to": "b", "via": "x"},
                        {"from": "b", "to": "a", "via": "y"}],
              "cycles": [{"locks": ["a", "b", "a"]}]}
    runtime = [{"edges": [{"from": "a", "to": "b"}], "cycles": []},
               {"edges": [{"from": "c", "to": "a"}], "cycles": []}]
    got = lockorder.join_reports(static, runtime)
    assert got == jax_lockorder.join_reports(static, runtime)
    assert got["superset"] is False
    assert got["uncovered_runtime_edges"] == [["c", "a"]]


def test_cli_lockgraph_join(tmp_path, capsys):
    covered = tmp_path / "lockgraph.json.rank0"
    covered.write_text(json.dumps({
        "edges": [{"from": "timeline.pids", "to": "metrics.metric"}],
        "cycles": [], "acyclic": True, "locks": []}))
    assert cli.main(["--lockgraph", str(covered)]) == 0
    assert "superset=True" in capsys.readouterr().out
    stray = tmp_path / "lockgraph.json.rank1"
    stray.write_text(json.dumps({
        "edges": [{"from": "metrics.metric", "to": "wire.send"}],
        "cycles": [], "acyclic": True, "locks": []}))
    assert cli.main(["--lockgraph", str(covered), str(stray)]) == 1
    assert "MISSING from the static graph" in capsys.readouterr().out
