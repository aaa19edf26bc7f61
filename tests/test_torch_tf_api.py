"""The port's TF and Keras front ends (``horovod_tpu_torch.tensorflow``,
``horovod_tpu_torch.keras``, ``horovod_tpu_torch.tensorflow.keras``)
against the JAX package's, at size 1 in this process: every case of
``tests/test_tf_api.py`` through both packages, with equal values and the
same errors (class and message). The cross-rank cases are in
``tests/test_torch_tf_custom_op.py``.

Values compare exactly. The Keras models of both packages come from the
same TF and Keras: each case seeds Keras (``keras.utils.set_random_seed``)
before it runs, so both start from equal weights.
"""

import types

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import keras  # noqa: E402

import horovod_tpu.keras as jax_keras  # noqa: E402
import horovod_tpu.tensorflow as jax_tf  # noqa: E402
import horovod_tpu.tensorflow.keras as jax_tfk  # noqa: E402
import horovod_tpu_torch.keras as port_keras  # noqa: E402
import horovod_tpu_torch.tensorflow as port_tf  # noqa: E402
import horovod_tpu_torch.tensorflow.keras as port_tfk  # noqa: E402

PACKAGES = {
    "port": types.SimpleNamespace(hvd=port_tf, keras=port_keras,
                                  tfk=port_tfk),
    "jax": types.SimpleNamespace(hvd=jax_tf, keras=jax_keras, tfk=jax_tfk),
}


@pytest.fixture
def both(tmp_path):
    """Run ``case(P)`` through both packages; the port's result. Both
    inits are per test: the suite's conftest shuts the JAX package down
    after each one."""
    def run(case):
        got = {}
        for name, P in sorted(PACKAGES.items()):
            P.hvd.init()
            P.tmp = tmp_path / name
            P.tmp.mkdir()
            keras.utils.set_random_seed(0)
            got[name] = case(P)
        assert got["port"] == got["jax"], got
        return got["port"]

    yield run
    port_tf.shutdown()


def _raises(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the class is the result
        return [type(exc).__name__, str(exc)]
    return None


def _v(t):
    return np.asarray(t).tolist()


def test_ops_size1(both):
    def case(P):
        x = tf.constant([1.0, 2.0, 3.0])
        return [_v(P.hvd.allreduce(x)), _v(P.hvd.allgather(x)),
                _v(P.hvd.broadcast(x, root_rank=0)),
                _raises(lambda: P.hvd.broadcast(x, root_rank=1)),
                P.hvd.size(), P.hvd.rank(), P.hvd.local_size()]

    assert both(case)[:3] == [[1.0, 2.0, 3.0]] * 3


def test_indexed_slices_size1(both):
    def case(P):
        slices = tf.IndexedSlices(
            values=tf.constant([[1.0, 2.0]]), indices=tf.constant([3]),
            dense_shape=tf.constant([5, 2]))
        out = P.hvd.allreduce(slices, average=True)
        return [type(out).__name__, _v(out.values), _v(out.indices)]

    assert both(case) == ["IndexedSlices", [[1.0, 2.0]], [3]]


def test_distributed_gradient_tape_size1(both):
    def case(P):
        w = tf.Variable([2.0])
        with P.hvd.DistributedGradientTape() as tape:
            loss = w * w
        return _v(tape.gradient(loss, [w])[0])

    assert both(case) == [4.0]


def test_distributed_optimizer_apply(both):
    def case(P):
        opt = P.hvd.DistributedOptimizer(tf.keras.optimizers.SGD(0.5))
        v = tf.Variable(1.0)
        opt.apply_gradients([(tf.constant(1.0), v)])
        return [type(opt).__name__, _v(v),
                _raises(lambda: P.hvd.DistributedOptimizer(
                    tf.keras.optimizers.SGD(0.5),
                    backward_passes_per_step=2))]

    assert both(case)[:2] == ["DistributedSGD", 0.5]


def test_broadcast_variables_size1(both):
    def case(P):
        v = tf.Variable([1.0, 2.0])
        P.hvd.broadcast_variables([v], root_rank=0)
        return [_v(v), _raises(
            lambda: P.hvd.broadcast_variables([v], root_rank=2))]

    assert both(case)[1] == ["ValueError",
                             "root_rank 2 out of range for size 1"]


def test_keras_alias_surface(both):
    def case(P):
        return [P.tfk.DistributedOptimizer is P.keras.DistributedOptimizer,
                P.tfk.callbacks is P.keras.callbacks,
                sorted(n for n in dir(P.keras.callbacks)
                       if n.endswith("Callback")),
                sorted(n for n in dir(P.tfk) if not n.startswith("_")
                       and n not in ("annotations", "tensorflow"))]

    out = both(case)
    assert out[:3] == [True, True, [
        "BroadcastGlobalVariablesCallback",
        "LearningRateScheduleCallback", "LearningRateWarmupCallback",
        "MetricAverageCallback"]]


def test_lr_schedule_callback_size1(both):
    def case(P):
        model = tf.keras.Sequential(
            [tf.keras.layers.Dense(1, input_shape=(2,))])
        model.compile(optimizer=tf.keras.optimizers.SGD(0.1), loss="mse")
        cb = P.keras.callbacks.LearningRateScheduleCallback(
            multiplier=lambda epoch: 0.5 ** epoch)
        cb.set_model(model)
        lrs = []
        for epoch in (0, 2):
            cb.on_epoch_begin(epoch)
            lrs.append(float(model.optimizer.learning_rate.numpy()))
        warm = P.keras.callbacks.LearningRateWarmupCallback(
            warmup_epochs=2, steps_per_epoch=4, initial_lr=0.1)
        warm.set_model(model)
        warm.on_epoch_begin(1)
        warm.on_train_batch_begin(2)
        lrs.append(float(model.optimizer.learning_rate.numpy()))
        logs = {}
        warm.on_epoch_end(1, logs)
        return [lrs, logs, _raises(lambda: P.keras.callbacks.
                                   LearningRateScheduleCallback(
                                       1.0, staircase=False)
                                   .on_train_batch_begin(0))]

    lrs = both(case)[0]
    np.testing.assert_allclose(lrs[:2], [0.1, 0.025], rtol=1e-6)


def test_compression_tf(both):
    def case(P):
        x = tf.constant([1.0, 2.0])
        out = []
        for comp in (P.hvd.Compression.none, P.hvd.Compression.fp16,
                     P.hvd.Compression.bf16):
            c, ctx = comp.compress(x)
            out.append([c.dtype.name, comp.decompress(c, ctx).dtype.name])
        i, ctx = P.hvd.Compression.fp16.compress(tf.constant([1, 2]))
        return out + [[i.dtype.name, P.hvd.Compression.fp16.decompress(
            i, ctx).dtype.name]]

    assert both(case) == [["float32", "float32"], ["float16", "float32"],
                          ["bfloat16", "float32"], ["int32", "int32"]]


def test_broadcast_global_variables_eager_raises(both):
    def case(P):
        return _raises(lambda: P.hvd.broadcast_global_variables(0))

    out = both(case)
    assert out[0] == "NotImplementedError" and "broadcast_variables" in out[1]


def test_tf1_broadcast_global_variables_hook(both):
    def case(P):
        graph = tf.Graph()
        with graph.as_default():
            v = tf.compat.v1.get_variable(
                "hook_var", initializer=tf.constant([1.5, -2.0]))
            hook = P.hvd.BroadcastGlobalVariablesHook(root_rank=0)
            hook.begin()
            built = [hook.bcast_op is not None, hook.bcast_op.graph is graph]
            init_op = tf.compat.v1.global_variables_initializer()
            with tf.compat.v1.Session(graph=graph) as sess:
                sess.run(init_op)
                hook.after_create_session(sess, None)
                return built + [_v(sess.run(v))]

    assert both(case) == [True, True, [1.5, -2.0]]


def test_tf1_broadcast_global_variables_op_rebuilt_per_graph(both):
    def case(P):
        hook = P.hvd.BroadcastGlobalVariablesHook(root_rank=0)
        with tf.Graph().as_default():
            tf.compat.v1.get_variable("g1_var", initializer=tf.constant(1.0))
            hook.begin()
            op1 = hook.bcast_op
        with tf.Graph().as_default():
            tf.compat.v1.get_variable("g2_var", initializer=tf.constant(2.0))
            hook.begin()
            return hook.bcast_op is not op1

    assert both(case) is True


def test_keras_load_model_wraps_optimizer(both):
    def case(P):
        model = tf.keras.Sequential(
            [tf.keras.layers.Dense(1, input_shape=(2,))])
        model.compile(optimizer=tf.keras.optimizers.Adam(0.01), loss="mse")
        rng = np.random.RandomState(0)
        x = rng.rand(8, 2).astype(np.float32)
        y = rng.rand(8, 1).astype(np.float32)
        model.fit(x, y, epochs=1, verbose=0)
        path = str(P.tmp / "plain.keras")
        model.save(path)
        loaded = P.keras.load_model(path)
        opt = loaded.optimizer
        out = [type(opt).__name__, float(opt.learning_rate.numpy()),
               int(opt.iterations.numpy())]
        hist = loaded.fit(x, y, epochs=1, verbose=0)
        return out + [int(opt.iterations.numpy()), hist.history["loss"],
                      [_v(w) for w in loaded.get_weights()]]

    out = both(case)
    assert out[0] == "DistributedAdam" and out[1] == pytest.approx(0.01)
    assert out[3] > out[2] > 0


def test_keras_load_model_roundtrip_distributed(both):
    def case(P):
        model = tf.keras.Sequential(
            [tf.keras.layers.Dense(1, input_shape=(2,))])
        model.compile(optimizer=P.hvd.DistributedOptimizer(
            tf.keras.optimizers.SGD(0.5)), loss="mse")
        x = np.ones((4, 2), np.float32)
        y = np.ones((4, 1), np.float32)
        model.fit(x, y, epochs=1, verbose=0)
        path = str(P.tmp / "dist.keras")
        model.save(path)
        loaded = P.tfk.load_model(path)
        hist = loaded.fit(x, y, epochs=1, verbose=0)
        return [type(loaded.optimizer).__name__, hist.history["loss"]]

    assert both(case)[0] == "DistributedSGD"
