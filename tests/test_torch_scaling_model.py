"""The port's ``utils/scaling_model.py`` against the JAX package's, on the
CPU: every public function on the same inputs, each number within rtol
1e-12 (both are pure Python; most agree exactly), every string and
structure equal. The inputs are seeded draws and the repo's committed
calibration artifacts (``artifacts/*.json``)."""

import dataclasses
import json
import os

import numpy as np
import pytest

from horovod_tpu.utils import scaling_model as jsm

from horovod_tpu_torch.utils import scaling_model as psm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12


def _artifact(name):
    with open(os.path.join(REPO, "artifacts", name)) as f:
        return json.load(f)


def _plain(x):
    """Dataclasses as dicts, tuples as lists: a structure both packages'
    results share."""
    if dataclasses.is_dataclass(x):
        return {"__class__": type(x).__name__, **_plain(dataclasses.asdict(x))}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def assert_same(got, want, path="result"):
    got, want = _plain(got), _plain(want)
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in sorted(want):
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), path
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                   err_msg=path)
    else:
        assert got == want, (path, got, want)


def _groups(mod, seed, n=12):
    rng = np.random.RandomState(seed)
    return [mod.GradGroup(int(rng.randint(1 << 10, 1 << 26)),
                          float(rng.uniform(0, 1))) for _ in range(n)]


def _events(mod, seed, n=9):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = float(rng.uniform(0, 1))
        out.append(mod.BucketEvent(a, a + float(rng.uniform(0, 0.3))))
    return out


def _event_dicts(seed, n=9):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        launch = float(rng.uniform(0, 1))
        ready = launch + float(rng.uniform(0, 0.1))
        out.append({"launch_s": launch, "ready_s": ready,
                    "complete_s": ready + float(rng.uniform(0, 0.2))})
    return out


# name -> function of a module giving the call's result. Each runs on
# both packages with inputs built from that package's own dataclasses.
CALLS = {
    "dp_step_time": lambda m: [
        m.dp_step_time(0.25, _groups(m, 1), n, 12.5e9, overlap)
        for n in (1, 2, 8, 512) for overlap in (True, False)],
    "dp_efficiency": lambda m: [
        m.dp_efficiency(0.31, _groups(m, 2), n, 3e9, overlap)
        for n in (2, 64) for overlap in (True, False)],
    "hierarchical_exposed_bytes": lambda m: [
        m.hierarchical_exposed_bytes(b, i)
        for b in (1, 1 << 30, 12345) for i in (1, 4, 256)],
    "multislice_efficiency": lambda m: [
        m.multislice_efficiency(0.2, _groups(m, 3), s, 8, 50e9, 3e9,
                                overlap)
        for s in (2, 4) for overlap in (True, False)],
    "groups_from_overlap_report": lambda m: m.groups_from_overlap_report({
        "sync_collectives": [
            {"opcode": "all-reduce", "payload_bytes": 128,
             "compute_after_frac": 0.3, "op_name": "jit/hvd.allreduce/x"},
            {"opcode": "all-reduce", "payload_bytes": 64,
             "compute_after_frac": 0.2},
            {"opcode": "all-reduce", "payload_bytes": 1 << 20,
             "compute_after_frac": 0.7},
            {"opcode": "all-gather", "payload_bytes": 1 << 20,
             "compute_after_frac": 0.9}]}),
    "efficiency_curve": lambda m: m.efficiency_curve(
        0.4, _groups(m, 4), [1, 2, 4, 64, 512], 25e9),
    "overlap_efficiency_from_events": lambda m: [
        m.overlap_efficiency_from_events(_events(m, s), a, b)
        for s in (5, 6) for a, b in ((0.0, 1.0), (0.2, 0.6), (1.0, 0.5))],
    "predicted_bucket_events": lambda m: [
        m.predicted_bucket_events(0.3, _groups(m, 7), n, 10e9)
        for n in (1, 2, 16)],
    "modeled_events_from_measured": lambda m: [
        m.modeled_events_from_measured(_events(m, 8), w)
        for w in (0.0, 0.5, 1.7)],
    "fit_linear": lambda m: [
        m.fit_linear({8: 0.01, 64: 0.03, 512: 0.2}),
        m.fit_linear({16: 0.4}),
        m.fit_linear({2: 0.5, 4: 0.1})],
    "fit_linear_relative": lambda m: [
        m.fit_linear_relative({8: 0.01, 64: 0.03, 512: 0.2}),
        m.fit_linear_relative({16: 0.4}),
        m.fit_linear_relative({8: 0.0, 16: 0.5}),
        m.fit_linear_relative({2: 0.5, 4: 0.1, 8: 0.01})],
    "fit_control_plane": lambda m: [
        m.fit_control_plane({
            int(n): row for n, row in
            sorted(_artifact("simcluster_r13.json")["control_plane"]
                   .items())},
            relative=rel) for rel in (False, True)],
    "control_plane_report": lambda m: [
        m.control_plane_report({
            int(n): row for n, row in
            sorted(_artifact("capacity_r17.json")["control_plane"]
                   .items())},
            relative=rel) for rel in (False, True)],
    "control_plane_from_artifact": lambda m: [
        m.control_plane_from_artifact(_artifact(a))
        for a in ("simcluster_r13.json", "capacity_r17.json")],
    "calibration_curves": lambda m: [
        (cal.negotiation_seconds(n), cal.reshape_seconds(n),
         cal.heartbeat_fanout_seconds(n))
        for cal in [m.control_plane_from_artifact(
            _artifact("capacity_r17.json"))] for n in (1, 8, 4096)],
    "pipelined_modeled_events": lambda m: [
        m.pipelined_modeled_events(_event_dicts(9), w)
        for w in (0.0, 0.8)],
    "stall_split_report": lambda m: m.stall_split_report(
        _event_dicts(10), m.control_plane_from_artifact(
            _artifact("capacity_r17.json")), 16),
    "measured_overlap_report": lambda m: m.measured_overlap_report(
        _events(m, 11), 0.1, 0.9),
    "fit_restore_curve": lambda m: m.fit_restore_curve(
        _artifact("elastic_restore_r15.json")),
    "saturation_ranks": lambda m: [
        m.saturation_ranks(b, p, budget)
        for b, p, budget in ((0.1, 0.001, 0.05), (0.01, 0.0, 1.0),
                             (0.01, 1e-4, 0.5), (0.0, 3e-3, 10.0))],
    "capacity_plan": lambda m: [
        m.capacity_plan(ranks, model_bytes=1 << 30,
                        control_plane_data=_artifact("capacity_r17.json"),
                        restore_data=_artifact("elastic_restore_r15.json"),
                        overlap_data=_artifact("overlap_r16.json"))
        for ranks in (2, 512, 4096)] + [
        m.capacity_plan(64, control_plane_data=_artifact(
            "simcluster_r13.json"), step_window_s=0.02,
            comm_timeout_s=30.0)],
    "recommend_autotune_seeds": lambda m: [
        m.recommend_autotune_seeds(m.control_plane_from_artifact(
            _artifact("capacity_r17.json")), n) for n in (1, 64, 4096)],
    "constants": lambda m: [
        m.ICI_BW_BYTES_PER_S, m.CONSERVATIVE_LINK_FRACTION,
        m.DCN_BW_BYTES_PER_S_PER_CHIP, m.GRADIENT_MARKER,
        list(m.CAPACITY_PLANES), m.CAPACITY_HINTS,
        m.ring_wire_bytes(8, 1 << 20)],
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_function_matches_the_jax_scaling_model(name):
    assert_same(CALLS[name](psm), CALLS[name](jsm), name)


def test_every_public_function_is_held():
    covered = set(CALLS) | {"ring_wire_bytes"}
    public = {n for n, v in sorted(vars(jsm).items())
              if callable(v) and not n.startswith("_")
              and getattr(v, "__module__", None) == jsm.__name__
              and not isinstance(v, type)}
    assert public <= covered, sorted(public - covered)


def test_capacity_plan_refuses_as_the_jax_model():
    for bad in (dict(ranks=0, control_plane_data={}),
                dict(ranks=4, control_plane_data=None)):
        with pytest.raises(ValueError) as want:
            jsm.capacity_plan(**bad)
        with pytest.raises(ValueError) as got:
            psm.capacity_plan(**bad)
        assert str(got.value) == str(want.value)
