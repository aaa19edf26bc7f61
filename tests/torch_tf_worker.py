"""One rank of the TF front ends' 2-rank scenario, for
``tests/test_torch_tf_custom_op.py``.

Run under a package's launcher as ``python torch_tf_worker.py port|jax``:
``port`` imports ``horovod_tpu_torch.tensorflow`` and nothing of
``horovod_tpu`` (``torch_import_guard`` records what the port's code and
this script import), ``jax`` the JAX package's front end.
The union of ``tests/mp_worker.py::scenario_tensorflow`` and
``::scenario_tf_custom_op``; every value goes into one JSON line
(``TFRESULT``), so the test compares the ranks of both packages, and
records which data path ran (the vote, and the op types of a traced
graph). ``HVD_TEST_MIXED=1`` opts rank 1 out of the custom-op path
(``HOROVOD_TENSORFLOW_CUSTOM_OP=0``), the shape of a host whose op library
cannot build.
"""

import json
import os
import sys

import numpy as np

PKG = sys.argv[1]
if PKG == "port":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_import_guard

    OFFENDERS = torch_import_guard.install(
        os.path.join(os.environ["HVD_TEST_REPO"], "horovod_tpu_torch"),
        files=[__file__])
if os.environ.get("HVD_TEST_MIXED") and os.environ["HOROVOD_RANK"] == "1":
    os.environ["HOROVOD_TENSORFLOW_CUSTOM_OP"] = "0"
if PKG == "port":
    import horovod_tpu_torch.tensorflow as tfhvd
    from horovod_tpu_torch.keras.callbacks import MetricAverageCallback

    OP = "HorovodTpuTorchAllreduce"
else:
    import horovod_tpu.tensorflow as tfhvd
    from horovod_tpu.keras.callbacks import MetricAverageCallback

    OP = "HorovodTpuAllreduce"
import tensorflow as tf  # noqa: E402


def L(t):
    t = tf.convert_to_tensor(t)
    if t.dtype == tf.bfloat16:
        t = tf.cast(t, tf.float32)
    return [t.dtype.name, np.asarray(t.numpy()).tolist()]


def error_of(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the class is the result
        return type(exc).__name__
    return None


tfhvd.init()
rank, size = tfhvd.rank(), tfhvd.size()
out = {"custom_op": tfhvd._custom_ops() is not None}

x = tf.constant(np.arange(6, dtype=np.float32) + rank)
out["avg"] = L(tfhvd.allreduce(x, average=True))
out["sum"] = L(tfhvd.allreduce(x, average=False))
out["bf16"] = L(tfhvd.allreduce(
    tf.cast(tf.fill([8], float(rank + 1)), tf.bfloat16), average=False))
out["int_avg"] = L(tfhvd.allreduce(
    tf.constant([1, 2, 5], dtype=tf.int32) * (rank + 1), average=True))
out["scalar"] = L(tfhvd.allreduce(tf.constant(float(rank + 1))))
for dt in (tf.float16, tf.float64, tf.int8, tf.uint8, tf.int16, tf.uint16,
           tf.int64):
    out[f"sum.{dt.name}"] = L(tfhvd.allreduce(
        tf.cast(np.arange(5) % 3 + rank, dt), average=False,
        name=f"tf.sum.{dt.name}"))
flags = np.zeros(4, bool)
flags[rank] = True
out["bool"] = L(tfhvd.allreduce(tf.constant(flags), average=False))
out["fp16_wire"] = L(tfhvd.allreduce(
    tf.constant(np.linspace(-2, 2, 16, dtype=np.float32) * (rank + 1)),
    compression=tfhvd.Compression.fp16))

out["allgather"] = L(tfhvd.allgather(tf.fill([rank + 1, 2], float(rank))))
out["broadcast"] = L(tfhvd.broadcast(tf.constant([float(rank)]),
                                     root_rank=size - 1))
out["broadcast_root_error"] = error_of(
    lambda: tfhvd.broadcast(tf.constant([1.0]), root_rank=size))

slices = tf.IndexedSlices(
    values=tf.constant([[float(rank + 1), 0.0]]),
    indices=tf.constant([rank]), dense_shape=tf.constant([size, 2]))
red = tfhvd.allreduce(slices, average=True)
out["sparse"] = [type(red).__name__, L(red.values), L(red.indices)]

v = tf.Variable(np.full(3, float(rank), np.float32))
s = tf.Variable(float(rank) + 0.5)
tfhvd.broadcast_variables([v, s], root_rank=1)
out["broadcast_variables"] = [L(v), L(s)]

w = tf.Variable([float(rank + 1)])
with tfhvd.DistributedGradientTape() as tape:
    loss = w * w
out["tape"] = L(tape.gradient(loss, [w])[0])

out["grouped"] = [L(t) for t in tfhvd.grouped_allreduce(
    [tf.constant([float(rank)]), tf.constant([1, 2]) * (rank + 1)],
    average=False, name="tf.grouped")]


@tf.function
def traced(t):
    return tfhvd.allreduce(t, average=False, name="tf.traced")


cf = traced.get_concrete_function(tf.TensorSpec([2], tf.float32))
op_types = {op.type for op in cf.graph.get_operations()}
out["graph"] = {"custom": OP in op_types, "py_function": bool(
    {"EagerPyFunc", "PyFunc"} & op_types)}
out["traced"] = L(traced(tf.constant([1.0, 2.0])))


@tf.function
def burst(t):
    return tf.stack([tfhvd.allreduce(t + float(i), average=False,
                                     name=f"tf.burst.{i}")
                     for i in range(32)])


out["burst"] = L(burst(tf.constant([float(rank)])))

if out["custom_op"]:
    # The registered gradients of the custom ops (the py_function path
    # leaves no graph to differentiate through).
    gv = tf.Variable(tf.fill([rank + 1, 2], float(rank + 1)))
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(
            tfhvd.allgather(gv, name="tf.ag_grad")) * float(size)
    out["allgather_grad"] = L(tape.gradient(loss, gv))
    bv = tf.Variable([2.0])
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(tfhvd.broadcast(
            bv, root_rank=0, name="tf.bc_grad")) * float(rank + 1)
    out["broadcast_grad"] = L(tape.gradient(loss, bv))
    # The engine rejects mismatched ranks as a TF error and keeps serving.
    out["mismatch_error"] = error_of(lambda: tfhvd.allreduce(
        tf.zeros([2] if rank == 0 else [2, 2]), name="tf.mismatch"))
    out["after_error"] = L(tfhvd.allreduce(
        tf.constant([1.0]), average=False, name="tf.after_error"))

cb = MetricAverageCallback()
logs = {"loss": float(rank), "acc": 0.25 * (rank + 1)}
cb.on_epoch_end(0, logs)
out["metric_average"] = logs

out["allgather_object"] = tfhvd.allgather_object({"rank": rank})
out["broadcast_object"] = tfhvd.broadcast_object(
    {"from": rank, "list": list(range(rank + 2))}, root_rank=1)
tfhvd.barrier()
if PKG == "port":
    out["imports"] = OFFENDERS
print("TFRESULT " + json.dumps({"rank": rank, "out": out}), flush=True)
tfhvd.shutdown()
