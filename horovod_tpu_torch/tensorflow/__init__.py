"""TensorFlow front end over the port's eager tier: ``import
horovod_tpu_torch.tensorflow as hvd`` — the counterpart of
``horovod_tpu/tensorflow/__init__.py``.

Reference: ``horovod/tensorflow/__init__.py`` (321 lines) + the custom-op
layer ``tensorflow/mpi_ops.cc``. The reference targets TF1 graph mode
(AsyncOpKernels + SessionRunHook); this front end targets TF2 eager /
``tf.function`` — the op surface is the same (allreduce with the
IndexedSlices→allgather sparse path, ``grouped_allreduce``,
``broadcast_variables``, ``DistributedOptimizer``,
``DistributedGradientTape``), and the v1 surface is kept as a
``tf.compat.v1`` shim (``broadcast_global_variables``,
``BroadcastGlobalVariablesHook``).

Two data paths, as in the JAX package:

* the custom-op path — real graph nodes (``src/tf_ops.cc``, ops named
  ``HorovodTpuTorch*``) enqueueing into the port's native engine, when
  that engine runs, the op library loads and ``HOROVOD_TENSORFLOW_CUSTOM_OP``
  is not 0 on every rank (one vote across ranks decides);
* the ``tf.py_function`` path otherwise — the Python controller, a rank
  without the op library, or the knob at 0: the tensor crosses to the
  controller as a CPU torch tensor (bfloat16 through its 16-bit pattern:
  ``torch.from_numpy`` refuses ``ml_dtypes.bfloat16``) and back.

TF tensors stay in host memory: ``init`` binds the CPU, and no CUDA kernel
lies on either path. ``allgather_object``, ``broadcast_object`` and
``barrier`` come from the port's eager tier (``torch/mpi_ops.py``). The
Keras models of both packages are built by the same TF and Keras, so from
the same seed they start from equal weights: nothing converts between
them.
"""

from __future__ import annotations

import threading
from typing import Optional

try:
    import tensorflow as tf
except ImportError as exc:
    raise ImportError(
        "horovod_tpu_torch.tensorflow requires the 'tensorflow' package, "
        "which is not installed in this environment. Use horovod_tpu_torch "
        "(the torch front end) instead.") from exc

import numpy as np
import torch

from ..common import basics
from ..common.basics import (  # noqa: F401
    cross_rank,
    cross_size,
    is_initialized,
    local_rank,
    local_size,
    mpi_threads_supported,
    rank,
    shutdown,
    size,
)
from ..torch.mpi_ops import (  # noqa: F401  (framework-agnostic)
    allgather_object,
    barrier,
    broadcast_object,
)
from .compression import Compression  # noqa: F401


def init(ranks=None, device="cpu") -> None:
    """``hvd.init`` on the CPU: TF tensors live in host memory, and the
    job's ranks need no card."""
    basics.init(ranks, device=device)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == tf.bfloat16.as_numpy_dtype:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor, shape=None) -> np.ndarray:
    """``t`` as numpy; ``shape`` restores a scalar's, which the
    controller returns as one element."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        a = t.view(torch.int16).numpy().view(tf.bfloat16.as_numpy_dtype)
    else:
        a = t.numpy()
    return a if shape is None else a.reshape(shape)


_custom_op_vote_lock = threading.Lock()


def _controller():
    ctrl = basics.controller()
    if ctrl is None:
        raise RuntimeError(
            "eager collectives at size > 1 require the background "
            "controller; launch through horovod_tpu_torch.run")
    return ctrl


def _custom_ops():
    """The native custom-op module when the fast path is live, else None.

    Fast path = real TF graph nodes (AsyncOpKernels in
    ``src/tf_ops.cc`` enqueueing into the C++ engine): no GIL on the data
    path, SavedModel-serializable, reference ``tensorflow/mpi_ops.cc``
    parity. Requires the native engine (the ops attach to the in-process
    engine the ctypes tier initialized) and an opt-out escape hatch
    ``HOROVOD_TENSORFLOW_CUSTOM_OP=0``.

    The choice is AGREED ACROSS RANKS (min over local availability via one
    controller allreduce, memoized on the controller): the custom-op path
    fixes anonymous names into graphs at trace time while the py_function
    fallback draws a fresh autoname per execution, so a mixed-path job
    (one host missing TF headers, or a per-rank opt-out) would diverge the
    name sequence and stall negotiation."""
    ctrl = _controller()
    cached = getattr(ctrl, "_tf_custom_op_agreed", None)
    if cached is not None:
        from . import tf_ops

        return tf_ops if cached else None
    # Serialize the probe+vote: two threads both missing the cache would
    # each issue the agreement collective, but peers answer it exactly once
    # (the second vote would hit the duplicate-name rejection or hang).
    with _custom_op_vote_lock:
        cached = getattr(ctrl, "_tf_custom_op_agreed", None)
        if cached is not None:
            from . import tf_ops

            return tf_ops if cached else None
        return _custom_ops_vote(ctrl)


def _custom_ops_vote(ctrl):
    from ..common.config import tensorflow_custom_op_enabled

    local_ok = True
    if not tensorflow_custom_op_enabled():
        local_ok = False
    else:
        from ..controller.native import NativeController

        if not isinstance(ctrl, NativeController):
            local_ok = False
        else:
            from . import tf_ops

            local_ok = tf_ops.available()
    agreed = bool(local_ok)
    if size() > 1:
        votes = ctrl.allreduce(
            torch.tensor([1 if local_ok else 0], dtype=torch.int32),
            average=False, name="hvd.tf.custom_op.agree")
        agreed = int(votes[0]) == size()
        if local_ok and not agreed:
            from ..common import hvd_logging as logging

            logging.warning(
                "TF custom-op path disabled job-wide: another rank lacks it "
                "(build failure or HOROVOD_TENSORFLOW_CUSTOM_OP=0)")
    ctrl._tf_custom_op_agreed = agreed
    if not agreed:
        return None
    from . import tf_ops

    return tf_ops


def _np_collective(fn, tensor: tf.Tensor, out_dtype=None,
                   same_shape: bool = True) -> tf.Tensor:
    """Run a controller collective (``fn`` on a torch tensor) on a TF
    tensor, staying graph-compatible: under tf.function the call is
    embedded as a py_function node (the TF2 counterpart of the reference's
    AsyncOpKernel enqueue, tensorflow/mpi_ops.cc:276-303). Fallback path —
    the custom-op library (``_custom_ops``) is preferred when available."""
    out_dtype = out_dtype or tensor.dtype

    def runner(t):
        a = t.numpy()
        out = _to_numpy(fn(_to_torch(a)), a.shape if same_shape else None)
        return tf.convert_to_tensor(out, dtype=out_dtype)

    if tf.executing_eagerly():
        return runner(tensor)
    return tf.py_function(runner, [tensor], out_dtype)


def allreduce(tensor, average: bool = True, name: Optional[str] = None,
              compression=Compression.none):
    """Mean/sum across ranks; ``tf.IndexedSlices`` take the sparse
    allgather path (reference ``tensorflow/__init__.py:36-87``)."""
    if isinstance(tensor, tf.IndexedSlices):
        # Gather values+indices everywhere; averaging divides values by size
        # (reference tensorflow/__init__.py:62-78).
        values = allgather(tensor.values,
                           name=None if name is None else f"{name}.values")
        indices = allgather(tensor.indices,
                            name=None if name is None else f"{name}.indices")
        if average:
            values = tf.cast(values, tensor.values.dtype) / size()
        return tf.IndexedSlices(values, indices,
                                dense_shape=tensor.dense_shape)
    tensor = tf.convert_to_tensor(tensor)
    if size() == 1:
        return tf.identity(tensor)
    compressed, ctx = compression.compress(tensor)
    ops = _custom_ops()
    if ops is not None:
        out = ops.allreduce_sum(compressed, name=name)
        if average and out.dtype != tf.bool:
            # Graph-level divide (reference tensorflow/__init__.py:36-87);
            # int dtypes round-trip through the division like the
            # controller's truncate-cast post-divide.
            out = tf.cast(out / size(), out.dtype)
    else:
        ctrl = _controller()
        out = _np_collective(
            lambda a: ctrl.allreduce(a, average=average, name=name),
            compressed)
    return compression.decompress(out, ctx)


def grouped_allreduce(tensors, average: bool = True,
                      name: Optional[str] = None,
                      compression=Compression.none) -> list:
    """Allreduce a list of tensors as one fusion group (later-Horovod API
    surface; executed by the same enqueue-together + Tensor Fusion path).
    In eager mode all members are enqueued before any is joined, so the
    engine sees the whole group in one cycle; inside ``tf.function`` each
    member is its own graph node — custom-op kernels when the fast path is
    live, py_function otherwise — and the executor schedules them
    concurrently, which lands them in the same engine cycle in practice."""
    if not isinstance(tensors, (list, tuple)):
        raise TypeError("grouped_allreduce expects a list/tuple of tensors")
    tensors = list(tensors)
    # Consistent across tiers and BEFORE anything is enqueued: the sparse
    # path is per-tensor allreduce() business.
    if any(isinstance(t, tf.IndexedSlices) for t in tensors):
        raise ValueError(
            "grouped_allreduce does not take IndexedSlices; use "
            "allreduce() for the sparse allgather path")
    if tf.executing_eagerly() and size() > 1:
        ctrl = _controller()
        handles = []
        for i, t in enumerate(tensors):
            tt = tf.convert_to_tensor(t)
            # Compress at the TF level (the controller's compression hooks
            # are numpy-domain; the single-tensor allreduce does the same).
            compressed, cctx = compression.compress(tt)
            h = ctrl.allreduce_async(
                _to_torch(compressed.numpy()), average=average,
                name=None if name is None else f"{name}.{i}")
            handles.append((compressed.dtype, cctx, h, compressed.shape))
        return [
            compression.decompress(
                tf.convert_to_tensor(_to_numpy(h.wait(), shape), dtype=cdt),
                cctx)
            for cdt, cctx, h, shape in handles
        ]
    return [
        allreduce(t, average=average,
                  name=None if name is None else f"{name}.{i}",
                  compression=compression)
        for i, t in enumerate(tensors)
    ]


def allgather(tensor, name: Optional[str] = None):
    tensor = tf.convert_to_tensor(tensor)
    if size() == 1:
        return tf.identity(tensor)
    ops = _custom_ops()
    if ops is not None:
        return ops.allgather(tensor, name=name)
    ctrl = _controller()
    return _np_collective(lambda a: ctrl.allgather(a, name=name), tensor,
                          same_shape=False)


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    tensor = tf.convert_to_tensor(tensor)
    if size() == 1:
        if root_rank != 0:
            raise ValueError(f"root_rank {root_rank} out of range for size 1")
        return tf.identity(tensor)
    if not 0 <= root_rank < size():
        # Fail fast on every rank; an out-of-range root passes validation
        # (all ranks agree on it) and would hang the data phase.
        raise ValueError(
            f"root_rank {root_rank} out of range for size {size()}")
    ops = _custom_ops()
    if ops is not None:
        return ops.broadcast(tensor, root_rank=root_rank, name=name)
    ctrl = _controller()
    return _np_collective(
        lambda a: ctrl.broadcast(a, root_rank=root_rank, name=name), tensor)


def broadcast_variables(variables, root_rank: int = 0) -> None:
    """Assign every variable root's value (reference
    ``broadcast_global_variables``/``broadcast_variables``,
    ``tensorflow/__init__.py:90-109``), async-enqueued then joined so the
    fusion engine can pack them."""
    variables = list(variables)
    if size() == 1:
        if root_rank != 0:
            raise ValueError(f"root_rank {root_rank} out of range for size 1")
        return
    ctrl = _controller()
    handles = [
        ctrl.broadcast_async(_to_torch(v.numpy()), root_rank=root_rank,
                             name=f"broadcast.var.{i}")
        for i, v in enumerate(variables)
    ]
    for v, h in zip(variables, handles):
        v.assign(tf.convert_to_tensor(_to_numpy(h.wait(), v.shape),
                                      dtype=v.dtype))


def _broadcast_group_op(variables, root_rank: int):
    """Grouped assign op: every variable takes root's value. Graph-mode
    analogue of :func:`broadcast_variables` (the reference builds the same
    ``tf.group`` of assigns, ``tensorflow/__init__.py:100-109``)."""
    return tf.group(*[
        v.assign(broadcast(v, root_rank=root_rank,
                           name=f"broadcast.gvar.{i}"))
        for i, v in enumerate(variables)
    ])


def broadcast_global_variables(root_rank: int = 0):
    """TF1-compat (reference ``tensorflow/__init__.py:90-98``): broadcast
    the ``tf.compat.v1`` global-variables collection from ``root_rank``,
    returning the grouped assign op to run in your session. Only meaningful
    under the v1 graph stack — TF2 eager has no global collection; call
    ``broadcast_variables(model.variables, root_rank)`` there."""
    gvars = tf.compat.v1.global_variables()
    if tf.executing_eagerly() or not gvars:
        raise NotImplementedError(
            "no tf.compat.v1 global-variables collection is active; in "
            "TF2 eager call hvd.broadcast_variables(model.variables, "
            "root_rank) instead (session users: build the model inside a "
            "tf.compat.v1 graph so variables register in the collection, "
            "or use hvd.BroadcastGlobalVariablesHook)")
    return _broadcast_group_op(gvars, root_rank)


class BroadcastGlobalVariablesHook(tf.compat.v1.train.SessionRunHook):
    """``SessionRunHook`` broadcasting all global variables from
    ``root_rank`` when the session is created — the TF1 checkpoint/resume
    consistency contract (reference ``tensorflow/__init__.py:112-143``).

    ``device`` is accepted for signature parity and ignored: collective
    placement is the controller's concern here, not a graph device string.
    """

    def __init__(self, root_rank: int = 0, device: str = ""):
        super().__init__()
        self.root_rank = root_rank
        self.bcast_op = None
        self.device = device

    def begin(self):
        # Rebuild if a new graph is active (reference :130-134).
        if (self.bcast_op is None
                or self.bcast_op.graph is not tf.compat.v1.get_default_graph()):
            self.bcast_op = broadcast_global_variables(self.root_rank)

    def after_create_session(self, session, coord):
        session.run(self.bcast_op)


class DistributedGradientTape(tf.GradientTape):
    """``tf.GradientTape`` whose ``gradient()`` averages grads across ranks
    (reference ``tensorflow/__init__.py:247-321``)."""

    def __init__(self, *args, compression=Compression.none,
                 device_dense="", device_sparse="", **kwargs):
        super().__init__(*args, **kwargs)
        self._compression = compression

    def gradient(self, target, sources, output_gradients=None, **kwargs):
        grads = super().gradient(target, sources, output_gradients, **kwargs)
        if size() == 1:
            return grads
        return [
            allreduce(g, average=True, name=f"DistributedGradientTape.{i}",
                      compression=self._compression)
            if g is not None else None
            for i, g in enumerate(grads)
        ]


def _distributed_optimizer_class(base, compression=Compression.none):
    """Subclass ``base`` (a keras optimizer class) so ``apply_gradients``
    first averages the gradients across ranks. Class-level seam shared by
    :func:`DistributedOptimizer` (wraps an instance) and
    ``keras.load_model`` (wraps classes for deserialization, reference
    ``_keras/__init__.py:93-109``)."""

    class _Distributed(base):
        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            grads_and_vars = list(grads_and_vars)
            if size() > 1:
                grads_and_vars = [
                    (allreduce(g, average=True,
                               name=f"DistributedOptimizer.grad.{i}",
                               compression=compression), v)
                    if g is not None else (g, v)
                    for i, (g, v) in enumerate(grads_and_vars)
                ]
            return super().apply_gradients(grads_and_vars, *args, **kwargs)

    _Distributed.__name__ = f"Distributed{base.__name__}"
    _Distributed._hvd_distributed = True  # keras.load_model double-wrap guard
    return _Distributed


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         compression=Compression.none,
                         device_dense: str = "", device_sparse: str = "",
                         backward_passes_per_step: int = 1):
    """Wrap a keras optimizer so ``apply_gradients`` first averages the
    gradients across ranks (reference ``tensorflow/__init__.py:146-244``;
    the reference overrides ``compute_gradients`` on TF1 optimizers — the
    Keras-3 equivalent seam is ``apply_gradients``)."""
    if backward_passes_per_step != 1:
        raise ValueError(
            "backward_passes_per_step > 1 is not supported on the TF tier; "
            "use hvd.torch or hvd.jax for local gradient accumulation")

    cls = _distributed_optimizer_class(optimizer.__class__, compression)
    return cls.from_config(optimizer.get_config())
