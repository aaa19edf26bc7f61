"""Profiler traces and the ``hvd.*`` labels — the port's counterpart of
``horovod_tpu/common/profiler.py``, built on ``torch.profiler``.

* Every collective of ``torch/mpi_ops.py`` (on both tiers: the process
  group and the controller) and every reduction ``DistributedOptimizer``
  fires runs inside a ``record_function`` range named
  ``hvd.<op>[.<name>]``, the names the JAX package gives its traced
  collectives; ``_cached_attention`` of ``models/llama.py`` labels each
  decode path ``hvd.decode.<path>``, and the model code names its
  projections and norms with :func:`named_scope` at the points where the
  JAX package's flax name stack carries them. The readers of
  ``utils/comm_accounting.py``, ``utils/hlo_phases.py`` and
  ``utils/overlap.py`` key on these names.
* ``trace(log_dir)`` / ``start_trace`` / ``stop_trace`` record CPU
  activity, and CUDA activity when the process holds a card, with tensor
  shapes, and write one Chrome-trace JSON
  (``<log_dir>/hvd.<host>.<pid>.<n>.pt.trace.json``) when the block
  ends. ``HOROVOD_PROFILE_DIR`` switches them on as it does the JAX
  package's.
* ``annotate(name)`` labels a host region, ``step(n)`` a training step.

A label costs one check when no profiler runs
(``torch.autograd._profiler_enabled``), so the labels stay in the
collectives and the models; while ``torch.profiler`` runs, whoever
started it, they are ranges in its trace. A CUDA graph replays its
kernels without the host code that labelled them: profile an eager
step to attribute kernels to labels.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
from typing import Iterator, Optional

import torch

from .config import env_str

__all__ = ["trace", "start_trace", "stop_trace", "annotate", "step",
           "named_scope", "PROFILE_DIR_ENV"]

PROFILE_DIR_ENV = "HOROVOD_PROFILE_DIR"

_OFF = contextlib.nullcontext()
_active = None                 # (profile, path) of start_trace's session
_count = itertools.count()


def enabled() -> bool:
    """Whether a ``torch.profiler`` session records in this process."""
    return torch.autograd._profiler_enabled()


def named_scope(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records; otherwise a shared no-op context (one check)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def collective_label(op: str, name: Optional[str] = None, tensor=None,
                     group_size: int = 0):
    """The ``hvd.<op>[.<name>]`` range around one collective. While a
    profiler records, a marker op inside it carries the collective's
    tensor (its dtype and shape) and group size into the trace, which
    the ``c10d`` ops of list arguments do not show; see
    ``utils/comm_accounting.collectives``."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _labelled(f"hvd.{op}" + (f".{name}" if name else ""), tensor,
                     group_size)


@contextlib.contextmanager
def _labelled(label: str, tensor, group_size: int):
    with torch.profiler.record_function(label):
        if torch.is_tensor(tensor):
            _mark(tensor, group_size)
        yield


_MARK = None


def _mark(tensor: torch.Tensor, group_size: int) -> None:
    global _MARK
    if _MARK is None:
        # An op that does nothing, registered on first use: the profiler
        # records its tensor argument's dtype and dims and its integer.
        lib = torch.library.Library("hvd_profile", "DEF")
        lib.define("mark(Tensor x, int group_size) -> ()")
        lib.impl("mark", lambda x, group_size: None,
                 "CompositeExplicitAutograd")
        _MARK = (lib, torch.ops.hvd_profile.mark)
    _MARK[1](tensor, int(group_size))


@contextlib.contextmanager
def module_scopes(model: torch.nn.Module) -> Iterator[None]:
    """Within the context, every submodule of ``model`` runs its forward
    inside a profiler range named by its attribute name (``query``,
    ``LayerNorm_0``, ``0``), so the kernels of a model whose submodules
    carry flax's names nest under flax's name stack. Hooks, installed
    only for the context: the phase-profile examples use it."""
    stack = []

    def enter(name):
        def hook(module, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)
        return hook

    def leave(module, args, out):
        stack.pop().__exit__(None, None, None)

    handles = []
    for path, module in model.named_modules():
        if path:
            name = path.rsplit(".", 1)[-1]
            handles.append(module.register_forward_pre_hook(enter(name)))
            handles.append(module.register_forward_hook(leave))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _resolve_dir(log_dir: Optional[str]) -> Optional[str]:
    return log_dir or env_str(PROFILE_DIR_ENV) or None


def _new_profile():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, record_shapes=True)


def _trace_path(log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(
        log_dir, f"hvd.{socket.gethostname()}.{os.getpid()}."
        f"{next(_count)}.pt.trace.json")


def _finish(prof, path: str) -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[Optional[str]]:
    """Profile the enclosed block::

        with hvd.profiler.trace("/tmp/prof"):
            for _ in range(3):
                train_step()

    ``log_dir`` defaults to ``$HOROVOD_PROFILE_DIR``; with neither set,
    the block runs unprofiled. The block's end waits for the card, then
    writes the trace; the context yields the trace file's path (None
    when unprofiled)."""
    log_dir = _resolve_dir(log_dir)
    if not log_dir:
        yield None
        return
    path = _trace_path(log_dir)
    prof = _new_profile()
    prof.start()
    try:
        yield path
    finally:
        _finish(prof, path)


def start_trace(log_dir: Optional[str] = None) -> str:
    """Non-context form of :func:`trace` (pair with :func:`stop_trace`);
    returns the path the trace will be written to."""
    global _active
    log_dir = _resolve_dir(log_dir)
    if not log_dir:
        raise ValueError(
            f"start_trace: pass log_dir or set ${PROFILE_DIR_ENV}")
    if _active is not None:
        raise RuntimeError("start_trace: a trace is already running")
    path = _trace_path(log_dir)
    prof = _new_profile()
    prof.start()
    _active = (prof, path)
    return path


def stop_trace() -> Optional[str]:
    """End :func:`start_trace`'s session and write its trace; returns
    the trace file's path."""
    global _active
    if _active is None:
        return None
    prof, path = _active
    _active = None
    _finish(prof, path)
    return path


def annotate(name: str):
    """A host-side range in the trace (data loading, a phase of the
    loop)."""
    return torch.profiler.record_function(name)


def step(step_num: int):
    """Label one training step in the trace: a ``ProfilerStep#<n>``
    range, the name by which torch's trace viewers group a step (the
    JAX package's ``StepTraceAnnotation("train", step_num=n)``)."""
    return torch.profiler.record_function(f"ProfilerStep#{int(step_num)}")
