"""Keras callbacks over the port's TF front end — the counterpart of
``horovod_tpu/keras/callbacks.py`` (reference
``horovod/_keras/callbacks.py`` shared impl, surfaced via
``horovod/keras/callbacks.py`` and
``horovod/tensorflow/keras/callbacks.py``)."""

from __future__ import annotations

from typing import Callable, Optional, Union

import tensorflow as tf

from .. import tensorflow as hvd_tf


class BroadcastGlobalVariablesCallback(tf.keras.callbacks.Callback):
    """Broadcast all model + optimizer state from root once training starts
    (reference ``_keras/callbacks.py:20-31``: fires after the first batch so
    deferred variables exist)."""

    def __init__(self, root_rank: int = 0):
        super().__init__()
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_train_batch_end(self, batch, logs=None):
        if self.broadcast_done:
            return
        variables = list(self.model.variables)
        opt = getattr(self.model, "optimizer", None)
        if opt is not None:
            variables += list(getattr(opt, "variables", []) or [])
        hvd_tf.broadcast_variables(variables, root_rank=self.root_rank)
        self.broadcast_done = True


class MetricAverageCallback(tf.keras.callbacks.Callback):
    """Average epoch metrics over ranks (reference
    ``_keras/callbacks.py:33-67``) so rank-0 logging/checkpoint decisions see
    global values."""

    def on_epoch_end(self, epoch, logs=None):
        if logs is None or hvd_tf.size() == 1:
            return
        for key in sorted(logs.keys()):
            value = logs[key]
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                averaged = hvd_tf.allreduce(
                    tf.constant(float(value), dtype=tf.float64),
                    average=True, name=f"metric.{key}")
                logs[key] = float(averaged.numpy())


def _set_lr(optimizer, lr: float) -> None:
    optimizer.learning_rate.assign(lr)


def _get_lr(optimizer) -> float:
    return float(tf.convert_to_tensor(optimizer.learning_rate).numpy())


class LearningRateScheduleCallback(tf.keras.callbacks.Callback):
    """Multiply the initial LR by ``multiplier(epoch)`` within
    [start_epoch, end_epoch) (reference ``_keras/callbacks.py:70-146``).
    The reference's momentum-correction dance for pre-TF2 optimizers is
    unnecessary on Keras 3 and omitted."""

    def __init__(self, multiplier: Union[float, Callable[[int], float]],
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True, steps_per_epoch: Optional[int] = None,
                 initial_lr: Optional[float] = None):
        super().__init__()
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        # Explicit initial_lr matters when resuming from a checkpoint: the
        # restored optimizer already carries a DECAYED rate, so the lazy
        # first-use capture below would double-apply the multiplier (the
        # reference's 0.16-era lazy capture, _keras/callbacks.py:119-120,
        # has the same hazard; upstream later made this an explicit arg).
        self.initial_lr = initial_lr
        self.current_epoch = 0
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def _in_range(self, epoch: float) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def _adjust(self, epoch: float) -> None:
        if self.initial_lr is None:
            self.initial_lr = _get_lr(self.model.optimizer)
        if self._in_range(epoch):
            _set_lr(self.model.optimizer,
                    self.initial_lr * self.multiplier(epoch))

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase:
            self._adjust(epoch)

    def on_train_batch_begin(self, batch, logs=None):
        if not self.staircase:
            if not self.steps_per_epoch:
                raise ValueError(
                    "steps_per_epoch is required for smooth (staircase=False) "
                    "LR schedules")
            self._adjust(self.current_epoch + batch / self.steps_per_epoch)

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = _get_lr(self.model.optimizer)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual LR warmup from lr to lr*size over warmup_epochs (reference
    ``_keras/callbacks.py:149-168``, the Goyal et al. linear ramp)."""

    def __init__(self, warmup_epochs: int = 5, momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0,
                 initial_lr: Optional[float] = None):
        del momentum_correction  # Keras-3: no momentum cache to correct
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose

        def multiplier(epoch):
            # epoch is fractional: ramp 1/size -> 1 scaled by size at end.
            size = hvd_tf.size()
            return 1.0 / size + epoch * (size - 1.0) / size / warmup_epochs \
                if warmup_epochs > 0 else 1.0

        super().__init__(multiplier=multiplier, start_epoch=0,
                         end_epoch=warmup_epochs, staircase=False,
                         steps_per_epoch=steps_per_epoch,
                         initial_lr=initial_lr)

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.warmup_epochs - 1 and self.verbose and \
                hvd_tf.rank() == 0:
            print(f"Epoch {epoch + 1}: finished gradual learning rate warmup "
                  f"to {_get_lr(self.model.optimizer)}")
