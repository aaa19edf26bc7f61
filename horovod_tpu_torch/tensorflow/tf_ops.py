"""Build and load the TF custom-op binding to the port's native engine —
the port's copy of ``horovod_tpu/tensorflow/tf_ops.py``.

Reference: the per-framework shared library the reference builds in
``setup.py`` and loads via ``tf.load_op_library`` semantics
(``horovod/tensorflow/mpi_ops.py:33-58`` ``_load_library``), plus the
gradient registrations for the three ops
(``horovod/tensorflow/mpi_ops.py:82-171``).

The library builds on first use from ``src/tf_ops.cc`` with ``g++`` and
the installed TensorFlow's flags (``tf.sysconfig``) into ``build/`` beside
this file, one artifact per TF version and source, one builder at a time
(a file lock). After ``tf.load_op_library`` the ``HorovodTpuTorchAttach``
op hands it the path of the port's core library, the one the ctypes tier
drives (``core/bindings.py``): the ops then enqueue into that engine.

The ops are named ``HorovodTpuTorch*`` and the core path never travels
through the environment, so this library loads beside the JAX package's
in one process and each drives its own engine. When a piece is missing
(no ``g++``, no TF headers) ``load`` logs why and returns ``None``, and
the front end takes the ``tf.py_function`` path."""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional

import tensorflow as tf

from ..common import basics
from ..common import hvd_logging as logging
from ..core import bindings as core_bindings

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "tf_ops.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

_lock = threading.Lock()
_module = None
_load_failed: Optional[str] = None
_autoname_fallback: dict = {}


def _lib_path() -> str:
    # A TF upgrade changes the ABI and an edited source changes the ops:
    # either makes a fresh artifact (the reference rebuilds per framework
    # install the same way, setup.py probing the live TF).
    digest = hashlib.sha256(("tf:" + tf.__version__).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD_DIR,
                        f"libhvdtftorch-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the op library unless it exists (flock-serialized: N ranks
    starting at once must not each compile against the TF headers)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    lib_path = _lib_path()
    if os.path.exists(lib_path):
        return lib_path
    with open(lib_path + ".lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib_path):  # another rank built it meanwhile
                return lib_path
            tmp_path = f"{lib_path}.tmp.{os.getpid()}"
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-pthread",
                   *tf.sysconfig.get_compile_flags(), _SRC, "-o", tmp_path,
                   *tf.sysconfig.get_link_flags(), "-ldl"]
            logging.debug("building TF op library: %s", " ".join(cmd))
            try:
                try:
                    result = subprocess.run(cmd, capture_output=True,
                                            text=True)
                except OSError as exc:
                    raise RuntimeError(
                        f"TF op library build failed: g++: {exc}") from exc
                if result.returncode != 0:
                    raise RuntimeError(
                        f"TF op library build failed:\n"
                        f"{result.stderr[-4000:]}")
                os.replace(tmp_path, lib_path)
            finally:
                if os.path.exists(tmp_path):
                    os.remove(tmp_path)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return lib_path


def load():
    """Build, ``tf.load_op_library`` and attach to the port's core; the op
    module, or ``None`` (the reason logged once) so callers take the
    ``tf.py_function`` path."""
    global _module, _load_failed
    with _lock:
        if _module is not None:
            return _module
        if _load_failed is not None:
            return None
        try:
            core_path = str(core_bindings.build())
            module = tf.load_op_library(build())
            # Eagerly, even when the first collective is being traced
            # into a tf.function: there it would only add a graph node.
            with tf.init_scope():
                module.horovod_tpu_torch_attach(core_path=core_path)
        except (RuntimeError, FileNotFoundError, tf.errors.OpError) as exc:
            _load_failed = str(exc)
            logging.warning(
                "TF custom-op library unavailable (%s); collectives use the "
                "tf.py_function path", exc)
            return None
        _module = module
        return _module


def available() -> bool:
    return load() is not None


def _names(kind: str, name: Optional[str]) -> str:
    """Cross-rank-consistent tensor name. Explicit names pass through; for
    anonymous tensors the controller's autoname counter is the namespace
    shared with the ctypes tier, so a custom-op collective can never
    collide with a pending controller-enqueued one.

    Inside ``tf.function`` this runs at trace time, fixing the name into
    the graph — the reference's graph-node-name behavior
    (``tensorflow/mpi_ops.py:66-80``): names repeat across step executions
    (legal: uniqueness is only required among concurrently-pending ops)
    and advance on retrace identically on every rank."""
    if name is not None:
        return name
    ctrl = basics.controller() if basics.is_initialized() else None
    if ctrl is not None:
        return ctrl._autoname(kind, None)
    # No controller (size 1, or a SavedModel reloaded before hvd.init): a
    # local counter keeps names unique within the process.
    with _lock:
        n = _autoname_fallback.get(kind, 0)
        _autoname_fallback[kind] = n + 1
    return f"{kind}.tfop.{n}"


def allreduce_sum(tensor: tf.Tensor, name: Optional[str] = None) -> tf.Tensor:
    ops = load()
    return ops.horovod_tpu_torch_allreduce(
        tensor, tensor_name=_names("allreduce", name))


def allgather(tensor: tf.Tensor, name: Optional[str] = None) -> tf.Tensor:
    ops = load()
    return ops.horovod_tpu_torch_allgather(
        tensor, tensor_name=_names("allgather", name))


def broadcast(tensor: tf.Tensor, root_rank: int,
              name: Optional[str] = None) -> tf.Tensor:
    ops = load()
    return ops.horovod_tpu_torch_broadcast(
        tensor, tensor_name=_names("broadcast", name), root_rank=root_rank)


# ---------------------------------------------------------------------------
# Gradients (reference horovod/tensorflow/mpi_ops.py:82-171). Registered at
# import under the port's op names; they fire only when the op library
# loaded and a tape or graph differentiates through these ops.

@tf.RegisterGradient("HorovodTpuTorchAllreduce")
def _allreduce_grad(op, grad):
    # d(sum_r x_r)/dx = 1 on every rank; the upstream grads differ per rank,
    # so the backward is itself a sum-allreduce (mpi_ops.py:82-93).
    return allreduce_sum(grad)


@tf.RegisterGradient("HorovodTpuTorchAllgather")
def _allgather_grad(op, grad):
    # Sum grads across ranks, then slice out this rank's rows using the
    # gathered per-rank first dims (mpi_ops.py:115-138).
    grad = allreduce_sum(grad)
    d0 = tf.shape(op.inputs[0], out_type=tf.int32)[:1]
    dims = tf.reshape(allgather(d0), [basics.size()])
    splits = tf.split(grad, num_or_size_splits=dims, axis=0)
    return splits[basics.rank()]


@tf.RegisterGradient("HorovodTpuTorchBroadcast")
def _broadcast_grad(op, grad):
    # All grads flow to the root's input; other ranks' inputs don't affect
    # the output (mpi_ops.py:158-171).
    root_rank = op.get_attr("root_rank")
    reduced = allreduce_sum(grad)
    if basics.rank() != root_rank:
        return reduced * 0
    return reduced


# Reference-name module surface: horovod/tensorflow/mpi_ops.py re-exports
# the lifecycle basics at module level (mpi_ops.py:42-58).
from ..common.basics import (  # noqa: E402,F401
    local_rank,
    local_size,
    mpi_threads_supported,
    rank,
    shutdown,
    size,
)
