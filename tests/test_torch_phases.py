"""The port's trace readers (``horovod_tpu_torch/utils/hlo_phases.py``
and ``utils/overlap.py``): the bucketing equal to the JAX package's as
data; the kernel rows and the overlap report on hand-written Chrome
traces (kernels under nested labels, a backward kernel, collectives
fully, partly and not overlapped); and a CPU profile of a tiny Llama's
decode bucketed by the port's decode table."""

import numpy as np
import pytest

from horovod_tpu.utils import hlo_phases as jphases

from horovod_tpu_torch.utils import hlo_phases as tphases
from horovod_tpu_torch.utils.overlap import overlap_report


def _rows(seed):
    rng = np.random.RandomState(seed)
    names = ["fusion.1", "dot.2", "copy.3", "all-reduce.4", "conv.5"]
    return [{"self_ms": float(rng.rand() * 3),
             "tf_op_name": "jit(step)/layer_%d/%s" % (rng.randint(4),
                                                     rng.choice(names)),
             "hlo_op_name": str(rng.choice(names)),
             "bound_by": str(rng.choice(["", "HBM", "Compute"])),
             "occurrences": int(rng.randint(1, 9)), "expression": ""}
            for _ in range(int(rng.randint(5, 60)))]


@pytest.mark.parametrize("seed", range(5))
def test_buckets_equal_jax(seed):
    jb, tb = {}, {}
    for i, row in enumerate(_rows(seed)):
        phase = "p%d" % (i % 3)
        jphases.add_to_bucket(jb, phase, row["self_ms"], row)
        tphases.add_to_bucket(tb, phase, row["self_ms"], row)
    assert tb == jb
    def copy(buckets):
        return {k: {**v, "top": list(v["top"])}
                for k, v in sorted(buckets.items())}

    for top in (1, 4):
        assert tphases.finalize_buckets(copy(tb), top) == \
            jphases.finalize_buckets(copy(jb), top)


def X(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _device_trace():
    """Two launches under nested labels, one backward launch whose
    forward op is labelled, one copy with no launch in the trace."""
    return {"traceEvents": [
        X("user_annotation", "attention", 0, 100),
        X("user_annotation", "wq", 10, 40),
        X("cpu_op", "aten::mm", 12, 30, **{"Sequence number": 7}),
        X("cuda_runtime", "cudaLaunchKernel", 14, 5, correlation=1),
        X("user_annotation", "hvd.decode.kernel", 60, 30),
        X("cuda_runtime", "cudaLaunchKernel", 62, 5, correlation=2),
        X("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
          200, 50, **{"Sequence number": 7}),
        X("cpu_op", "MmBackward0", 201, 40, **{"Sequence number": 7}),
        X("cuda_runtime", "cudaLaunchKernel", 210, 5, correlation=3),
        X("kernel", "gemm_a", 20, 8, tid=7, pid=0, correlation=1),
        X("kernel", "decode_kernel", 70, 4, tid=7, pid=0, correlation=2),
        X("kernel", "gemm_a", 220, 16, tid=7, pid=0, correlation=3),
        X("gpu_memcpy", "Memcpy HtoD", 300, 2, tid=8, pid=0,
          correlation=99),
        {"ph": "i", "name": "instant", "ts": 5},
    ]}


def test_kernel_rows_carry_the_label_stack():
    rows = {(r["hlo_op_name"], r["tf_op_name"]): r
            for r in tphases.kernel_rows(_device_trace())}
    assert set(rows) == {
        ("gemm_a", "attention/wq/aten::mm"),
        ("decode_kernel", "attention/hvd.decode.kernel"),
        ("gemm_a", "transpose(attention/wq/aten::mm)/autograd::engine::"
                   "evaluate_function: MmBackward0/MmBackward0"),
        ("Memcpy HtoD", "")}
    row = rows[("gemm_a", "attention/wq/aten::mm")]
    assert row["self_ms"] == pytest.approx(0.008)
    assert row["occurrences"] == 1
    assert set(row) == {"self_ms", "tf_op_name", "hlo_op_name", "bound_by",
                        "occurrences", "expression"}


def test_cpu_rows_take_self_time_and_aggregate():
    trace = [X("user_annotation", "ffn_norm", 0, 100),
             X("cpu_op", "aten::mul", 10, 30),
             X("cpu_op", "aten::mul", 50, 20),
             X("cpu_op", "aten::empty", 52, 5),
             X("cpu_op", "aten::zero_size", 80, 0)]
    rows = {(r["hlo_op_name"], r["tf_op_name"]): r
            for r in tphases.kernel_rows(trace)}
    mul = rows[("aten::mul", "ffn_norm/aten::mul")]
    assert mul["occurrences"] == 2
    assert mul["self_ms"] == pytest.approx((30 + 15) / 1e3)
    assert rows[("aten::empty", "ffn_norm/aten::mul/aten::empty")][
        "self_ms"] == pytest.approx(0.005)
    assert not any(n == "aten::zero_size" for n, _ in rows)


def test_step_split_buckets_by_kernel_name():
    rows = list(tphases.kernel_rows(_device_trace()))
    split = tphases.step_split(
        rows, 2, (("decode_kernel", lambda n: "decode_kernel" in n),
                  ("matmul", lambda n: "gemm" in n)),
        step_ms=0.5, profiled_ms=1.0, listed="matmul")
    assert split["kernels_per_step"] == 2.0
    assert split["matmul_ms_per_step"] == pytest.approx(0.012)
    assert split["decode_kernel_ms_per_step"] == pytest.approx(0.002)
    assert split["other_ms_per_step"] == pytest.approx(0.001)
    busy = 0.015
    assert split["device_busy_ms_per_step"] == pytest.approx(busy)
    assert split["device_idle_share"] == pytest.approx(1 - busy / 1.0)
    assert split["device_busy_over_unprofiled_step"] == pytest.approx(
        busy / 0.5)
    assert split["top_kernels"][0][:2] == ["matmul", "gemm_a"]
    assert split["matmul_kernels"] == [["gemm_a", pytest.approx(0.012)]]


def _collective_trace(compute):
    """One NCCL allreduce kernel on stream 20 over [100, 200), launched
    inside an ``hvd.allreduce.w`` label from ``c10d::allreduce_`` of a
    (64, 32) float tensor; ``compute``: (stream, ts, dur) of the other
    kernels."""
    events = [
        X("user_annotation", "hvd.allreduce.w", 0, 50),
        X("cpu_op", "hvd_profile::mark", 1, 1,
          **{"Input Dims": [[64, 32], []], "Input type": ["float", "Scalar"],
             "Concrete Inputs": ["", "2"]}),
        X("cpu_op", "c10d::allreduce_", 5, 40,
          **{"Input Dims": [[[64, 32]], [], []],
             "Input type": ["TensorList", "", ""]}),
        X("cuda_runtime", "cudaLaunchKernel", 10, 3, correlation=1),
        X("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 100, 100,
          tid=20, pid=0, correlation=1),
    ]
    for k, (stream, ts, dur) in enumerate(compute):
        events.append(X("kernel", f"compute_{k}", ts, dur, tid=stream,
                        pid=0, correlation=100 + k))
    return events


@pytest.mark.parametrize("compute,inflight", [
    ([(7, 120, 30), (7, 150, 40)], 2),          # fully inside, two
    ([(7, 50, 60), (7, 190, 30)], 2),           # partly, at both ends
    ([(7, 20, 50), (7, 210, 30), (20, 300, 5)], 0),   # before and after
    ([(20, 120, 10)], 0),                       # same stream: serialized
])
def test_overlap_report_counts_compute_in_flight(compute, inflight):
    report = overlap_report(_collective_trace(compute))
    pairs = report["async_pairs"]
    assert report["n_scheduled_ops"] == 1 + len(compute)
    assert report["n_compute_ops"] == len(compute)
    assert pairs["count"] == 1
    assert pairs["total_compute_in_flight"] == inflight
    assert pairs["with_compute_in_flight"] == (1 if inflight else 0)
    assert pairs["payload_bytes"] == 64 * 32 * 4
    assert pairs["by_op"] == {"all-reduce": 1}
    syncs = report["sync_collectives"]
    if inflight:
        assert syncs == []
    else:
        (s,) = syncs
        after = sum(1 for _, ts, _ in compute if ts >= 200)
        assert s["opcode"] == "all-reduce"
        assert s["op_name"] == "hvd.allreduce.w"
        assert s["payload_bytes"] == 64 * 32 * 4
        assert s["compute_after"] == after
        assert s["compute_after_frac"] == pytest.approx(after / len(compute))
        assert set(s) == {"opcode", "index", "schedule_frac",
                          "payload_bytes", "compute_after",
                          "compute_after_frac", "op_name"}


def test_overlap_report_on_a_cpu_trace():
    """No device events: the c10d ranges are the collectives, the
    top-level ops of the other threads the compute."""
    events = _collective_trace([])[:3] + [
        X("cpu_op", "aten::mm", 20, 10, tid=2),
        X("cpu_op", "aten::add", 100, 10, tid=2),
        X("cpu_op", "aten::mm", 8, 2, tid=1)]
    report = overlap_report(events)
    assert report["async_pairs"]["count"] == 1
    assert report["async_pairs"]["total_compute_in_flight"] == 1
    assert report["n_compute_ops"] == 2


def test_cpu_profile_of_a_tiny_decode_fills_the_port_table(tmp_path):
    from horovod_tpu_torch.examples import decode_phase_profile as dpp

    path = dpp.capture("tiny", 2, 8, 4, str(tmp_path), device="cpu")
    table = dpp.phase_table(path, 4)
    body = table["decode_phases"]
    for phase in ("qkvo_proj", "ffn", "norm", "attention_kernel",
                  "attention_cache", "lm_head_embed", "cache_update"):
        assert body.get(phase, {}).get("ms", 0) > 0, (phase, body)
    assert "attention_prefill" in table["prefill_phases"]
    assert "attention_prefill" not in body
