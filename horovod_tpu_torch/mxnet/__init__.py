"""MXNet adapter over the port's eager tier — the counterpart of
``horovod_tpu/mxnet/__init__.py``.

Public surface: ``DistributedOptimizer`` (rescale_grad /= size, an
allreduce-sum in ``update``), gluon's ``DistributedTrainer``,
``broadcast_parameters`` with deferred-init injection,
``ResizeEvalDataIter``, ``DistributedEvalMetric``, the ops of
``mpi_ops.py``, and ``allgather_object``/``broadcast_object``/``barrier``
from the port's eager tier (``torch/mpi_ops.py``), which run world-group
calls through the controller and need no ``torch.distributed`` group
while one runs. Every collective goes through the controller
(``common.basics.controller()``); ``priority`` hints are accepted but not
forwarded.

MXNet reached end of life in 2023 and is not installed here; without it
this module raises the JAX package's message. The tests drive it with
the in-tree fake (``tests/fake_mxnet.py``) installed as ``mxnet``.
"""

from __future__ import annotations

import types
import warnings

try:
    import mxnet as mx
except ImportError as exc:
    raise ImportError(
        "horovod_tpu_torch.mxnet requires the 'mxnet' package, which is "
        "end-of-life and not installed in this environment. Use "
        "horovod_tpu_torch (the torch front end) instead.") from exc

import numpy as np
import torch

from .mpi_ops import (  # noqa: F401
    allgather, allreduce, allreduce_, allreduce_async_, broadcast,
    broadcast_, broadcast_async_, synchronize,
    init, shutdown, rank, size, local_rank, local_size,
    mpi_threads_supported,
)
from .mpi_ops import _controller
from ..torch.mpi_ops import (  # noqa: F401  (framework-agnostic)
    allgather_object,
    barrier,
    broadcast_object,
)


class DistributedOptimizer(mx.optimizer.Optimizer):
    """Wraps an MXNet optimizer; gradients are summed across ranks before
    each update, and ``rescale_grad`` is divided by world size so the net
    effect is an average (folding the division into the existing rescale is cheaper than
    averaging in the collective)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._optimizer.rescale_grad /= size()

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def create_state_multi_precision(self, index, weight):
        return self._optimizer.create_state_multi_precision(index, weight)

    def _do_allreduce(self, index, grad):
        # Batch-enqueue then join so Tensor Fusion can pack the gradients
        # into one collective (the reference gets this from the MXNet
        # engine's async push, mxnet/mpi_ops.cc:67-120).
        if isinstance(index, (tuple, list)):
            synchronize([
                allreduce_async_(grad[i], average=False,
                                 name=str(index[i]), priority=-i)
                for i in range(len(index))])
        else:
            allreduce_(grad, average=False, name=str(index))

    def _reduced_update(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update(index, weight, grad, state)

    # MXNet's ``Optimizer.update``, bound by name: ``analysis/lockorder``
    # resolves calls by their bare name, and a def named ``update`` would
    # stand for every ``dict.update()`` made under a lock in the package.
    update = _reduced_update

    def update_multi_precision(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update_multi_precision(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self._optimizer.set_lr_mult(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._optimizer.set_wd_mult(args_wd_mult)


class DistributedTrainer(mx.gluon.Trainer):
    """gluon Trainer whose gradient reduction is the controller allreduce
    instead of kvstore push/pull, with averaging folded into ``_scale``
    (reference ``mxnet/__init__.py:127-146``)."""

    def __init__(self, params, optimizer, optimizer_params=None):
        if isinstance(optimizer, DistributedOptimizer):
            # Undo the wrapper's rescale_grad /= size before gluon reads it
            # into _scale, or the division below would apply twice
            # (1/size**2 effective average).
            optimizer = optimizer._optimizer
            optimizer.rescale_grad *= size()
            warnings.warn("DistributedTrainer does not take "
                          "DistributedOptimizer as its optimizer. We have "
                          "unwrapped it for you.")
        super().__init__(params, optimizer,
                         optimizer_params=optimizer_params, kvstore=None)
        self._scale /= size()

    def _allreduce_grads(self):
        synchronize([
            allreduce_async_(param.list_grad()[0], average=False,
                             name=str(i), priority=-i)
            for i, param in enumerate(self._params)
            if param.grad_req != 'null'])


def _append_broadcast_init(param, root_rank, name):
    """Wrap a deferred-init parameter's ``_init_impl`` so the broadcast
    happens right after the parameter materializes
    (reference ``mxnet/__init__.py:149-156``). The collective is keyed by
    the parameter's dict key so it matches whatever name the already-
    materialized ranks enqueued for the same parameter."""
    init_impl = getattr(param, '_init_impl')

    def wrapped_init_impl(self, *args, **kwargs):
        init_impl(*args, **kwargs)
        broadcast_(self.data(), root_rank=root_rank, name=name)
        self.data().wait_to_read()

    return wrapped_init_impl


def broadcast_parameters(params, root_rank=0):
    """Broadcast a dict of NDArrays or a gluon ``ParameterDict`` from
    ``root_rank``; deferred-init parameters get the broadcast injected into
    their init hook (reference ``mxnet/__init__.py:159-194``). Collectives
    are named by parameter key, not position: positional names desynchronize
    when ranks materialize different subsets (e.g. rank 0 restored from a
    checkpoint while workers defer)."""
    tensors = []  # (collective name, NDArray)
    if isinstance(params, dict):
        tensors = [(f"hvd.param.{k}", p) for k, p in sorted(params.items())]
    elif isinstance(params, mx.gluon.parameter.ParameterDict):
        for key, p in sorted(params.items()):
            name = f"hvd.param.{key}"
            try:
                tensors.append((name, p.data()))
            except mx.gluon.parameter.DeferredInitializationError:
                new_init = _append_broadcast_init(p, root_rank, name)
                p._init_impl = types.MethodType(new_init, p)
    else:
        raise ValueError('invalid params of type: %s' % type(params))

    # Batch-enqueue so the fused broadcasts ride one negotiation cycle,
    # then join (the reference's wait_to_read loop, mxnet/__init__.py:189-194).
    synchronize([broadcast_async_(tensor, root_rank, name)
                 for name, tensor in tensors])
    for _, tensor in tensors:
        tensor.wait_to_read()


def ResizeEvalDataIter(data_iter):
    """Pad every rank's eval iterator to the max batch count across ranks so
    collective eval never deadlocks on uneven data. The reference gathers
    counts over mpi4py (``mxnet/__init__.py:77-95``); here the count rides
    the controller's allgather."""
    batch_num = 0
    for _ in data_iter:
        batch_num += 1
    data_iter.reset()
    if size() > 1:
        counts = _controller().allgather(
            torch.tensor([batch_num], dtype=torch.int64),
            name="hvd.resize_eval_iter")
        batch_num = int(counts.max())
    return mx.io.ResizeIter(data_iter, batch_num)


def DistributedEvalMetric(base):
    """Class factory: a metric whose ``update`` gathers every rank's
    labels/preds to rank 0 and replays per-rank updates there. The reference
    gathers Python objects over mpi4py (``mxnet/__init__.py:98-118``); here
    each NDArray rides the controller allgather, split back into per-rank
    chunks by their gathered first-dim sizes so rank-0 sees the exact
    per-rank update sequence."""
    assert issubclass(base, mx.metric.EvalMetric)

    def _gather_per_rank(tensor, name):
        # Stable names (vs autonames) keep this allgather eligible for the
        # response cache's bitvector fast path instead of evicting training
        # entries with one-shot keys; sequential batches may reuse them.
        # ONE collective: the per-rank first dims ride the negotiated
        # Response on the handle (Handle.tensor_sizes), so no separate
        # dims-allgather is needed to split the result.
        arr = np.ascontiguousarray(tensor.asnumpy())
        handle = _controller().allgather_async(torch.from_numpy(arr),
                                               name=f"{name}.data")
        gathered = handle.wait().numpy()
        splits = np.cumsum(handle.tensor_sizes)[:-1]
        return [mx.nd.array(chunk, dtype=arr.dtype)
                for chunk in np.split(gathered, splits)]

    class _DistributedEvalMetric(base):
        def __init__(self, *args, **kwargs):
            self._size = size()
            self._rank = rank()
            super().__init__(*args, **kwargs)

        def _gathered_update(self, labels, preds):
            if self._size == 1:
                super().update(labels, preds)
                return
            prefix = f"hvd.metric.{getattr(self, 'name', 'metric')}"
            labels = [_gather_per_rank(t, f"{prefix}.labels.{j}")
                      for j, t in enumerate(labels)]
            preds = [_gather_per_rank(t, f"{prefix}.preds.{j}")
                     for j, t in enumerate(preds)]
            if self._rank == 0:
                for i in range(self._size):
                    super().update([t[i] for t in labels],
                                   [t[i] for t in preds])

        # Bound by name, as DistributedOptimizer.update.
        update = _gathered_update

    return _DistributedEvalMetric
