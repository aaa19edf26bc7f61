"""The port's metric catalog and its native counter mirror, held the way
``tests/test_metrics_lint.py`` holds the JAX package's: every registered
name unique, ``hvd_``-prefixed snake_case and never registered at import
time (hvdlint HVD007/HVD006 over ``horovod_tpu_torch/``), every name the
port registers also a name of the JAX catalog, and the known-series pin
below, which hvdabi's counter/metrics parity check (HVD011,
``analysis/cpp.py``) reads: the whole ``hvd_native_*``/``hvd_ring_*``
mirror must stay listed in ``test_known_series_present``."""

import ast
import os

from horovod_tpu.analysis.rules import MetricCatalogRule as JaxCatalogRule
from horovod_tpu_torch.analysis import cpp, run_lint
from horovod_tpu_torch.analysis.rules import MetricCatalogRule

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKG = os.path.join(REPO, "horovod_tpu_torch")


def _registered(pkg_dir, rule):
    names = set()
    for root, _, files in os.walk(pkg_dir):
        for fname in sorted(files):
            if fname.endswith(".py"):
                with open(os.path.join(root, fname)) as f:
                    tree = ast.parse(f.read())
                names |= {n for n, _ in rule.registrations(tree)}
    return names


def test_metric_names_unique_snake_case_hvd_prefixed():
    result = run_lint([PKG], root=REPO, select=["HVD007", "HVD006"])
    assert not result.parse_errors, result.parse_errors
    assert not result.findings, "\n".join(f.render()
                                          for f in result.findings)


def test_port_names_are_jax_catalog_names():
    port = _registered(PKG, MetricCatalogRule)
    jax = _registered(os.path.join(REPO, "horovod_tpu"), JaxCatalogRule)
    assert port and port <= jax, sorted(port - jax)


def test_known_series_present():
    """The pin hvdabi reads: a rename updates this list and the code
    together."""
    names = _registered(PKG, MetricCatalogRule)
    for expected in (
        "hvd_wire_frames_sent_total",
        "hvd_wire_frames_recv_total",
        "hvd_wire_bytes_sent_total",
        "hvd_wire_bytes_recv_total",
        "hvd_wire_recv_wait_seconds",
        "hvd_wire_deadline_trips_total",
        "hvd_controller_cycle_seconds",
        "hvd_controller_fused_bytes_total",
        "hvd_controller_tensors_total",
        "hvd_controller_cache_hits_total",
        "hvd_controller_cache_misses_total",
        "hvd_controller_stall_warnings_total",
        "hvd_controller_aborts_total",
        "hvd_controller_tick_lateness_seconds",
        "hvd_collective_ops_total",
        "hvd_collective_bytes_total",
        "hvd_timeline_events_total",
        "hvd_timeline_events_dropped_total",
        "hvd_retry_attempt_failures_total",
        "hvd_retry_backoff_seconds_total",
        "hvd_retry_giveups_total",
        "hvd_launcher_restarts_total",
        "hvd_negotiation_slack_seconds",
        "hvd_straggler_cycles_total",
        "hvd_membership_epoch",
        "hvd_membership_size",
        "hvd_membership_transitions_total",
        "hvd_membership_rank_departures_total",
        "hvd_elastic_reshape_seconds",
        "hvd_elastic_restore_seconds",
        "hvd_elastic_restore_bytes_total",
        "hvd_elastic_shard_fetches_total",
        "hvd_ckpt_commits_total",
        "hvd_ckpt_dropped_commits_total",
        "hvd_ckpt_write_seconds",
        "hvd_ckpt_written_bytes_total",
        "hvd_overlap_buckets_total",
        "hvd_overlap_efficiency",
        "hvd_overlap_priority_jumps_total",
        "hvd_autotune_active",
        "hvd_autotune_steps_completed",
        "hvd_autotune_steps_remaining",
        "hvd_autotune_fusion_threshold_bytes",
        "hvd_autotune_cycle_time_ms",
        "hvd_autotune_best_fusion_threshold_bytes",
        "hvd_autotune_best_cycle_time_ms",
        "hvd_autotune_objective",
        "hvd_autotune_best_objective",
        "hvd_serving_queue_depth",
        "hvd_serving_queue_limit",
        "hvd_serving_active_sequences",
        "hvd_serving_blocks_in_use",
        "hvd_serving_blocks_total",
        "hvd_serving_block_utilization",
        "hvd_serving_requests_total",
        "hvd_serving_preemptions_total",
        "hvd_serving_tokens_generated_total",
        "hvd_serving_steps_total",
        "hvd_serving_ttft_seconds",
        "hvd_serving_tpot_seconds",
        "hvd_serving_prefix_hits_total",
        "hvd_serving_prefix_misses_total",
        "hvd_serving_prefix_cached_blocks",
        "hvd_serving_prefix_evictions_total",
        "hvd_serving_blocks_shared",
        "hvd_serving_cow_copies_total",
        "hvd_router_replicas",
        "hvd_router_epoch",
        "hvd_router_requests_total",
        "hvd_router_reroutes_total",
        "hvd_router_replica_departures_total",
        "hvd_router_replica_joins_total",
        "hvd_router_affinity_hits_total",
        "hvd_ring_wire_bytes_total",
        "hvd_ring_compress_seconds",
        "hvd_ring_chunk_bytes",
        "hvd_native_cycles_total",
        "hvd_native_tensors_total",
        "hvd_native_fused_tensors_total",
        "hvd_native_fused_bytes_total",
        "hvd_native_cache_hits_total",
        "hvd_native_cache_misses_total",
        "hvd_native_spans_total",
        "hvd_native_spans_dropped_total",
        "hvd_native_fusion_buffer_capacity_bytes",
        "hvd_native_fusion_buffer_fill_bytes",
        "hvd_native_bucket_bytes",
        "hvd_native_pipeline_depth",
        "hvd_native_pipeline_stall_seconds",
        "hvd_native_cycle_seconds",
        "hvd_native_execute_seconds",
        "hvd_metrics_windows_total",
        "hvd_doctor_runs_total",
        "hvd_doctor_findings",
        "hvd_capacity_refits_total",
        "hvd_capacity_drift_ratio",
    ):
        assert expected in names, f"missing from the port: {expected}"


def test_doctor_and_window_series_register_lazily_as_in_jax():
    """The doctor's, the window roller's and the live calibration's series
    are registered by their owners on first use, never at import, with
    the JAX package's names, kinds, help texts and labels."""
    from horovod_tpu import metrics as jmetrics
    from horovod_tpu.doctor import _doctor_metrics as jdoctor_metrics
    from horovod_tpu.utils.live_calibration import _live_metrics as jlive
    from horovod_tpu_torch import metrics as tmetrics
    from horovod_tpu_torch.doctor import _doctor_metrics as tdoctor_metrics
    from horovod_tpu_torch.utils.live_calibration import (
        _live_metrics as tlive,
    )

    names = ("hvd_doctor_runs_total", "hvd_doctor_findings",
             "hvd_capacity_refits_total", "hvd_capacity_drift_ratio",
             "hvd_metrics_windows_total")
    views = {}
    try:
        for pkg, mod, doc, live in (
                ("jax", jmetrics, jdoctor_metrics, jlive),
                ("port", tmetrics, tdoctor_metrics, tlive)):
            mod.reset_for_tests()
            mod.enable()
            assert not set(names) & set(mod.snapshot()), pkg
            doc()
            live()
            mod.start_window_roller(interval_s=3600).roll_now()
            mod.stop_window_roller()
            reg = mod.default_registry()
            views[pkg] = {n: (type(reg.get(n)).__name__, reg.get(n).help,
                              tuple(reg.get(n).labelnames))
                          for n in names}
    finally:
        jmetrics.reset_for_tests()
        tmetrics.reset_for_tests()
    assert views["port"] == views["jax"]


def test_counter_mirror_parity_is_clean():
    sources = cpp.load_sources()
    with open(os.path.join(REPO, cpp.BINDINGS_PATH)) as f:
        bindings = cpp.parse_bindings(f.read())
    assert cpp.counter_findings(sources, bindings) == []
    # The pin above is what the check read.
    with open(os.path.join(HERE, "test_torch_metrics_lint.py")) as f:
        pinned = cpp._pinned_series(f.read())
    assert {s for _, s in sorted(cpp.NATIVE_SERIES_MAP.items()) if s} | \
        set(cpp.RING_SERIES) <= pinned


def test_mirror_consumes_the_keys_the_jax_mirror_does():
    with open(os.path.join(PKG, "metrics", "__init__.py")) as f:
        port = cpp._metrics_consumed_keys(f.read())
    with open(os.path.join(REPO, "horovod_tpu", "metrics",
                           "__init__.py")) as f:
        jax = cpp._metrics_consumed_keys(f.read())
    assert sorted(port) == sorted(jax)
    assert cpp.NATIVE_SERIES_MAP == __import__(
        "horovod_tpu.analysis.cpp", fromlist=["x"]).NATIVE_SERIES_MAP


def test_seeded_mirror_drift_is_hvd011():
    with open(os.path.join(PKG, "metrics", "__init__.py")) as f:
        source = f.read()
    assert cpp.metrics_source_findings(source) == []
    drifted = source.replace('_ctr(m.spans, "spans")',
                             '_ctr(m.spans, "spans_total")')
    drifted = drifted.replace('"hvd_native_spans_dropped_total"',
                              '"hvd_native_spans_lost_total"')
    messages = [f["message"] for f in cpp.metrics_source_findings(drifted)]
    assert any("'spans_total' which the C layout does not define" in m
               for m in messages), messages
    assert any("hvd_native_spans_lost_total has no owning counter slot"
               in m for m in messages), messages
