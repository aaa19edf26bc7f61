"""The port's capacity planner CLI (``python -m
horovod_tpu_torch.tools.capacity``) and its committed calibration against
the JAX package's tool: the counterpart of ``tests/test_capacity.py``'s
CLI and artifact cases (the planner's functions are held one by one in
``tests/test_torch_scaling_model.py``).

* On the same input files (the JAX package's ``artifacts/``, read as
  input) the port's ``--json`` plan and its text report equal the JAX
  tool's, byte for byte;
* an empty directory exits 2 with the probe hint in both;
* ``--live`` plans from a job's ``capacity_live.json`` as the JAX tool
  does, and a missing one exits 2 with the same guidance;
* by default the port's tool reads the port's own calibration
  (``horovod_tpu_torch/calibration/capacity_port.json``, package data),
  never the JAX package's measurements; that record names how it was
  measured, reaches 512 ranks, and its fit reproduces its own measured
  points within the JAX artifact gate's bounds through 128 ranks, past
  which that host's per-rank cost bends upward;
"""

import json
import os

import pytest

from horovod_tpu.tools import capacity as jcap
from horovod_tpu.utils import live_calibration as jlc
from horovod_tpu_torch.tools import capacity as tcap
from horovod_tpu_torch.utils import scaling_model as tsm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ARTIFACTS = os.path.join(REPO, "artifacts")
PORT_CALIBRATION = os.path.join(REPO, "horovod_tpu_torch", "calibration",
                                "capacity_port.json")


def _both(argv, capsys):
    out = {}
    for pkg, mod in (("jax", jcap), ("port", tcap)):
        rc = mod.main(argv)
        cap = capsys.readouterr()
        out[pkg] = (rc, cap.out, cap.err)
    return out


@pytest.mark.parametrize("extra", [["--json"], [],
                                   ["--json", "--step-time", "0.25"]],
                         ids=["json", "text", "step_time"])
def test_plan_equals_jax_on_the_same_files(extra, capsys):
    argv = ["--ranks", "4096", "--model-bytes", str(1 << 30),
            "--artifacts", JAX_ARTIFACTS, *extra]
    out = _both(argv, capsys)
    assert out["port"][0] == out["jax"][0] == 0, out["port"]
    assert out["port"][1] == out["jax"][1]
    if "--json" in extra:
        plan = json.loads(out["port"][1])
        assert plan["artifacts"]["control_plane"].endswith(
            "capacity_r17.json")
        assert set(plan["planes"]) == set(tsm.CAPACITY_PLANES)


def test_empty_directory_exits_2_with_the_probe_hint(tmp_path, capsys):
    out = _both(["--ranks", "4096", "--artifacts", str(tmp_path)], capsys)
    assert out["port"][0] == out["jax"][0] == 2
    assert "capacity_probe" in out["port"][2]


def test_live_plan_equals_jax(tmp_path, capsys):
    live = jlc.LiveCalibration()
    for world in (8, 16, 32):
        live.ingest_window({
            "index": 0, "start": 0.0, "end": 1.0, "duration_seconds": 1.0,
            "snapshots": {0: {
                "hvd_membership_size": {"type": "gauge",
                                        "values": [[[], float(world)]]},
                "hvd_controller_cycle_seconds": {
                    "type": "histogram", "buckets": [0.01, 0.1, 1.0],
                    "values": [[[], {"counts": [0, 0, 30, 0],
                                     "sum": 0.0005 * world * 30,
                                     "count": 30}]]}}}})
    (tmp_path / jlc.LIVE_ARTIFACT_NAME).write_text(
        json.dumps(live.refit()))
    out = _both(["--ranks", "4096", "--live", str(tmp_path), "--json",
                 "--artifacts", JAX_ARTIFACTS], capsys)
    assert out["port"][0] == out["jax"][0] == 0
    assert out["port"][1] == out["jax"][1]
    plan = json.loads(out["port"][1])
    assert plan["calibration_source"] == "live"
    assert plan["planes"]["negotiation"]["predicted_seconds"] == \
        pytest.approx(0.0005 * 4096, rel=1e-3)
    missing = _both(["--ranks", "64", "--live", str(tmp_path / "none")],
                    capsys)
    assert missing["port"][0] == missing["jax"][0] == 2
    assert missing["port"][2] == missing["jax"][2]
    assert "HOROVOD_CAPACITY_LIVE_DIR" in missing["port"][2]


def test_default_reads_the_ports_own_calibration(capsys):
    assert os.path.samefile(tcap.DEFAULT_ARTIFACTS,
                            os.path.dirname(PORT_CALIBRATION))
    rc = tcap.main(["--ranks", "4096", "--json"])
    plan = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert os.path.samefile(plan["artifacts"]["control_plane"],
                            PORT_CALIBRATION)
    assert plan["artifacts"]["restore"] is None
    assert plan["artifacts"]["overlap"] is None
    assert plan["first_bottleneck"]["plane"] in tsm.CAPACITY_PLANES


def test_port_calibration_names_its_measurement_and_refits():
    with open(PORT_CALIBRATION, encoding="utf-8") as f:
        data = json.load(f)
    for key in ("host", "card", "date", "command"):
        assert data["measured_on"].get(key), key
    assert data["fit"] == "relative" and "loopback" in data["substrate"]
    refit = tsm.control_plane_from_artifact(data)
    cal = data["calibration"]
    assert refit.negotiation_per_rank_s == pytest.approx(
        cal["negotiation_per_rank_s"], rel=1e-6)
    assert refit.reshape_per_rank_s == pytest.approx(
        cal["reshape_per_rank_s"], rel=1e-6)
    assert refit.negotiation_per_rank_s > 0 and refit.reshape_per_rank_s > 0
    for n in data["world_sizes"]:
        row = data["control_plane"][str(n)]
        assert row["protocheck_violations"] == 0, (n, row)
        assert row["protocheck_transitions"] > 0, (n, row)
    assert data["plan"]["first_bottleneck"]["plane"] in tsm.CAPACITY_PLANES


# The port's record on the card machine's host bends upward past this
# size: the per-rank negotiation cost there rose from 128 to 512 ranks in
# both protocheck-armed sweeps. Through it the fit holds the JAX gate's
# bounds; the rows past it stay in the fit, so the plan's uncertainty
# carries the bend.
LINEAR_THROUGH = 128


def test_port_calibration_model_vs_measured_gate():
    """The JAX artifact gate's bounds over the port's own record through
    ``LINEAR_THROUGH`` ranks: the fit reproduces the measured negotiation
    step within 10%, the reshape and heartbeat fanout within 35%, each row
    the median of at least three repeats. The record reaches 512 ranks as
    the JAX one does; every row is in the fit and its residual is the
    fit's own. The threaded driver's re-measurements sit beside the fit,
    on-spec (zero protocol violations), each with its ratio to the fit."""
    with open(PORT_CALIBRATION, encoding="utf-8") as f:
        data = json.load(f)
    sizes = data["world_sizes"]
    assert len([n for n in sizes if n <= LINEAR_THROUGH]) >= 4
    assert max(sizes) >= 512
    cal = tsm.control_plane_from_artifact(data)
    predict = {"negotiate_step_seconds": cal.negotiation_seconds,
               "reshape_seconds": cal.reshape_seconds,
               "heartbeat_fanout_seconds": cal.heartbeat_fanout_seconds}
    for n in sizes:
        entry = data["model_vs_measured"][str(n)]
        row = data["control_plane"][str(n)]
        assert row["repeats"] >= 3
        for key, fn in sorted(predict.items()):
            assert entry[key]["measured"] == pytest.approx(row[key],
                                                           abs=1e-6)
            assert entry[key]["rel_err"] == pytest.approx(
                abs(fn(n) - row[key]) / row[key], abs=1e-3), (n, key)
        if n <= LINEAR_THROUGH:
            assert entry["negotiate_step_seconds"]["rel_err"] <= 0.10, \
                (n, entry)
            assert entry["reshape_seconds"]["rel_err"] <= 0.35, (n, entry)
            assert entry["heartbeat_fanout_seconds"]["rel_err"] <= 0.35, \
                (n, entry)
    check = data["threaded_driver"]
    assert check["control_plane"]
    for n, row in sorted(check["control_plane"].items()):
        assert row["driver_threads"] > 1 and row["repeats"] >= 3
        assert row["protocheck_violations"] == 0, (n, row)
        assert row["protocheck_transitions"] > 0, (n, row)
        for key, fn in sorted(predict.items()):
            assert check["vs_fit"][n][key]["ratio"] == pytest.approx(
                row[key] / fn(int(n)), rel=1e-3), (n, key)


def test_probe_records_the_threaded_driver_beside_the_serial_fit(tmp_path):
    """``capacity_probe --driver-check``: the sweep's sizes on the serial
    driver make the fit; the checked sizes run again on the threaded
    driver and sit beside it, each cost over the fit's prediction."""
    from horovod_tpu_torch.examples import capacity_probe

    out = tmp_path / "cal.json"
    argv = ["--sizes", "4,8", "--threaded-sizes", "", "--driver-threads",
            "2", "--driver-check", "8", "--cycles", "2", "--repeats", "1",
            "--out", str(out)]
    assert capacity_probe.main(argv) == 0
    data = json.loads(out.read_text())
    assert data["world_sizes"] == [4, 8]
    assert all(data["control_plane"][n]["driver_threads"] == 1
               for n in ("4", "8"))
    assert data["settings"]["driver_check"] == [8]
    assert data["measured_on"]["command"].endswith(
        "--threaded-sizes '' --driver-threads 2 --driver-check 8 "
        f"--cycles 2 --repeats 1 --out {out}")
    row = data["threaded_driver"]["control_plane"]["8"]
    assert row["driver_threads"] == 2 and row["protocheck_violations"] == 0
    cal = tsm.control_plane_from_artifact(data)
    vs_fit = data["threaded_driver"]["vs_fit"]["8"]
    assert vs_fit["negotiate_step_seconds"]["ratio"] == pytest.approx(
        row["negotiate_step_seconds"] / cal.negotiation_seconds(8),
        rel=1e-3)
    assert vs_fit["reshape_seconds"]["predicted"] == pytest.approx(
        cal.reshape_seconds(8), abs=1e-6)
