"""Measurement rig: control-plane costs per world size, measured not
assumed, on the port's coordinator.

``utils/scaling_model.py`` extrapolates to hundreds of ranks. This
module runs the sim harness across world sizes and records:

* **negotiation** — wall time of one collective step (announce tick →
  negotiate → reply fanout → star data exchange; two controller cycles,
  the enqueue-races-the-cycle-loop shape real jobs have). The
  coordinator walks every rank's wire twice per cycle, so the curve is
  linear in N — ``fit_control_plane`` recovers base + per-rank cost.
* **reshape** — the coordinator's own ``hvd_elastic_reshape_seconds``
  measurement of a kill → re-formed-lockstep transition (assignment
  fanout + N ack drains).
* **heartbeat fanout** — one full sweep of ``try_send_heartbeat`` over
  every connected wire, the liveness plane's O(N) cost.
* **overlap** — the bucket-scheduler model-vs-measured check at 8-64
  logical ranks: a simulated backward pass produces gradients at a fixed
  cadence on every rank, the real ``BucketScheduler`` drives rank 0,
  and the measured ``overlap_efficiency`` is compared against the
  model's reconstruction (``modeled_events_from_measured``, the recipe
  ``examples/overlap_probe.py`` uses).

``examples/simcluster_probe.py`` and ``examples/capacity_probe.py``
write the records; ``tests/test_torch_sim.py`` holds the fitted model
against the measured points.

These are loopback-TCP, shared-GIL numbers: they calibrate the
*coordinator's* per-rank walk costs (recv/parse/dispatch/HMAC per
wire), not NIC latency. The record says so.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..controller.bucket_scheduler import BucketScheduler, partition_buckets
from ..utils.scaling_model import (
    BucketEvent,
    control_plane_report,
    modeled_events_from_measured,
    overlap_efficiency_from_events,
)
from .cluster import SimCluster, allreduce_spec
from .worker import SimOp


def measure_world_size(ranks: int, cycles: int = 30,
                       payload_elems: int = 16,
                       reshape: bool = True,
                       driver_threads: int = 1,
                       protocheck: bool = False,
                       roll_window: bool = False) -> dict:
    """One world size's control-plane row (see module docstring).
    Tensor names are unique per step, so every measured cycle takes the
    full negotiation path even with the response cache armed;
    ``driver_threads`` shards the logical ranks so sizes past ~256 are
    reachable (the coordinator walk being measured is unchanged).
    ``protocheck`` arms the wire-conformance monitor and records its
    violation count in the row — the capacity probe's proof that the
    threaded driver stayed on-spec at the size it calibrated.
    ``roll_window`` closes one telemetry window over the measured cycles
    (the live recalibration of ``utils/live_calibration.py``): the plane
    then ingests exactly this measurement, and a run launched with
    HOROVOD_CAPACITY_LIVE_DIR leaves a comparable capacity_live.json
    beside the committed artifact."""
    cluster = SimCluster(ranks=ranks, elastic=True, protocheck=protocheck,
                         enable_metrics=True,
                         driver_threads=driver_threads)
    cluster.start()
    try:
        for k in range(3):  # warm the wires and the allocator
            cluster.run_step([allreduce_spec(
                f"warm.{k}", lambda r: np.ones(payload_elems, np.float32))])
        samples: List[float] = []
        for k in range(cycles):
            spec = allreduce_spec(
                f"m.{k}", lambda r: np.ones(payload_elems, np.float32))
            t0 = time.perf_counter()
            cluster.run_step([spec])
            samples.append(time.perf_counter() - t0)
        hb = cluster.measure_heartbeat_fanout()
        reshape_s: Optional[float] = None
        if reshape and ranks > 2:
            cluster.kill(max(cluster.alive_worker_ranks))
            cluster.run_step([allreduce_spec(
                "reshaped", lambda r: np.ones(payload_elems, np.float32))])
            observed = cluster.reshape_seconds_observed()
            if observed:
                reshape_s = observed[-1]
        window_index = None
        if roll_window:
            window = cluster.roll_window()
            if window is not None:
                window_index = window["index"]
        row = {
            "ranks": ranks,
            "cycles": cycles,
            "driver_threads": driver_threads,
            "negotiate_step_seconds": float(np.median(samples)),
            "negotiate_step_seconds_p90": float(np.percentile(samples, 90)),
            "heartbeat_fanout_seconds": hb,
            "reshape_seconds": reshape_s,
        }
        if window_index is not None:
            row["telemetry_window"] = window_index
    finally:
        cluster.stop()
    if protocheck:
        report = cluster.protocheck_report or {}
        row["protocheck_violations"] = len(report.get("violations", []))
        row["protocheck_transitions"] = report.get("transitions", 0)
    return row


def measure_control_plane(sizes: Sequence[int] = (8, 16, 32, 64),
                          cycles: int = 30,
                          driver_threads: Optional[Dict[int, int]] = None,
                          protocheck_sizes: Sequence[int] = (),
                          repeats: int = 1,
                          relative_fit: bool = False) -> dict:
    """The artifact's ``control_plane`` section + fitted calibration +
    per-size model-vs-measured residuals. ``driver_threads`` maps a
    world size to its pool width (absent sizes run the serial driver);
    sizes listed in ``protocheck_sizes`` run with the conformance
    monitor armed and record its verdict (summed violations) in their
    row. ``repeats`` runs the whole size sweep that many times in
    round-robin order — each row is then the median across repeats, so
    machine-speed drift over the sweep (this substrate swings tens of
    percent over minutes) hits every size instead of whichever one was
    measured at the wrong moment. ``relative_fit`` selects the
    rel-err-weighted calibration fit (see ``fit_linear_relative``)."""
    threads = driver_threads or {}
    armed = set(protocheck_sizes or ())
    trials: Dict[int, List[dict]] = {int(n): [] for n in sizes}
    for _ in range(max(1, repeats)):
        for n in sizes:
            trials[n].append(measure_world_size(
                n, cycles=cycles, driver_threads=threads.get(n, 1),
                protocheck=n in armed))
    rows: Dict[int, dict] = {}
    for n in sorted(trials):
        runs = trials[n]
        row = dict(runs[0])
        for key in ("negotiate_step_seconds", "negotiate_step_seconds_p90",
                    "heartbeat_fanout_seconds", "reshape_seconds"):
            vals = [r[key] for r in runs if r.get(key) is not None]
            row[key] = float(np.median(vals)) if vals else None
        if n in armed:
            row["protocheck_violations"] = sum(
                r.get("protocheck_violations", 0) for r in runs)
            row["protocheck_transitions"] = sum(
                r.get("protocheck_transitions", 0) for r in runs)
        row["repeats"] = len(runs)
        rows[n] = row
    report = control_plane_report(rows, relative=relative_fit)
    return {
        "world_sizes": sorted(rows),
        "control_plane": {str(n): rows[n] for n in sorted(rows)},
        **report,
    }


def run_overlap_probe(ranks: int, grads: int = 12,
                      grad_elems: int = 8192,
                      interval_s: float = 0.004,
                      buckets_target: int = 4) -> dict:
    """The overlap model-vs-measured check at N logical ranks.

    Every rank "produces" one gradient per ``interval_s`` (the sim
    workers tick a whole bucket when its last gradient lands, mirroring
    the bucket launch rank 0's real :class:`BucketScheduler` performs at
    the same moment); measured overlap efficiency then runs through the
    exact model reconstruction the 2-rank probe uses."""
    grad_bytes = grad_elems * 4
    bucket_bytes = max(grad_bytes, (grads // buckets_target) * grad_bytes)
    names = [f"g.{i:03d}" for i in range(grads)]
    buckets = partition_buckets([(n, grad_bytes) for n in names],
                                bucket_bytes)
    cluster = SimCluster(ranks=ranks, elastic=False, protocheck=False,
                         enable_metrics=False)
    cluster.start()
    start_barrier = threading.Barrier(2)
    worker_error: List[BaseException] = []

    def drive_workers() -> None:
        try:
            start_barrier.wait(timeout=10.0)
            t0 = time.perf_counter()
            produced = 0
            for bucket in buckets:
                produced += len(bucket.names)
                target = t0 + produced * interval_s
                pause = target - time.perf_counter()
                if pause > 0:
                    time.sleep(pause)
                ops = {rank: [SimOp("allreduce", name,
                                    np.full(grad_elems, rank + 1.0,
                                            np.float32))
                              for name in bucket.names]
                       for rank in cluster.alive_worker_ranks}
                for rank in sorted(ops):
                    cluster.workers[rank].send_tick(ops[rank])
                replies = {}
                for rank in sorted(ops):
                    status, reply = cluster.workers[rank].recv_reply()
                    if status == "reply":
                        replies[rank] = reply
                _run_data_phases(cluster, replies)
            # Flush: the announce-lag means the tail buckets execute on
            # follow-up cycles; keep ticking empty until every gradient
            # has been exchanged.
            probe = min(cluster.alive_worker_ranks)
            for _ in range(grads + 8):
                if set(names) <= cluster.workers[probe].executed:
                    break
                replies = {}
                for rank in cluster.alive_worker_ranks:
                    cluster.workers[rank].send_tick([])
                for rank in cluster.alive_worker_ranks:
                    status, reply = cluster.workers[rank].recv_reply()
                    if status == "reply":
                        replies[rank] = reply
                _run_data_phases(cluster, replies)
        except BaseException as exc:  # surfaced at join below
            worker_error.append(exc)

    driver = threading.Thread(target=drive_workers,
                              name="hvd-sim-overlap", daemon=True)
    driver.start()
    try:
        sched = BucketScheduler(cluster.controller,
                                bucket_bytes=bucket_bytes)
        start_barrier.wait(timeout=10.0)
        t0 = time.perf_counter()
        sched.backward_started()
        for i, name in enumerate(names):
            target = t0 + (i + 1) * interval_s
            pause = target - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
            sched.grad_ready(name, torch.full((grad_elems,), 1.0))
        results, report = sched.finish()
        driver.join(timeout=60.0)
        if worker_error:
            raise worker_error[0]
        if driver.is_alive():
            raise TimeoutError("overlap probe worker driver hung")
        expected = float(sum(range(1, ranks + 1)))
        for name in names:
            got = float(results[name][0]) * ranks
            assert abs(got - expected) < 1e-3, (name, got, expected)
    finally:
        cluster.stop()
    events = [BucketEvent(e["launch_s"], e["complete_s"])
              for e in report["events"]]
    window = report["compute_window_s"]
    modeled = modeled_events_from_measured(events, window)
    modeled_eff = overlap_efficiency_from_events(modeled, 0.0, window)
    return {
        "ranks": ranks,
        "grads": grads,
        "bucket_bytes": bucket_bytes,
        "buckets": report["buckets"],
        "compute_window_s": window,
        "overlap_efficiency": report["overlap_efficiency"],
        "modeled_overlap_efficiency": round(modeled_eff, 4),
        "model_vs_measured_diff": round(
            abs(modeled_eff - report["overlap_efficiency"]), 4),
    }


def _run_data_phases(cluster: SimCluster, replies: Dict[int, dict]) -> None:
    if not replies:
        return
    ranks = sorted(replies)
    bypass: List = []
    for rank in ranks:
        popped = cluster.workers[rank].take_bypass(replies[rank])
        if rank == ranks[0]:
            bypass = popped
    for response in bypass:
        for rank in ranks:
            cluster.workers[rank].data_send(response)
        for rank in ranks:
            cluster.workers[rank].data_recv(response, cache_put=False)
    reply = replies[min(replies)]
    for response in reply["responses"].responses:
        for rank in ranks:
            cluster.workers[rank].data_send(response)
        for rank in ranks:
            cluster.workers[rank].data_recv(response)
