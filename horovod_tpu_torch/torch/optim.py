"""Optax's optimizers that ``torch.optim`` does not compute the same way.

* :class:`Adafactor` is ``optax.adafactor(learning_rate)`` with its
  defaults: the chain ``scale_by_factored_rms`` (decay 0.8, offset 0,
  ``eps`` 1e-30 added to g², the second moment factored into row and
  column means only when the two largest dims are both at least
  ``MIN_DIM_SIZE_TO_FACTOR``, 128), ``clip_by_block_rms(1.0)``,
  ``scale_by_learning_rate``, ``scale_by_param_block_rms`` (floor 1e-3),
  ``scale(-1)``. ``torch.optim.Adafactor`` is another optimizer: it
  factors every tensor of two or more dims, places its epsilons
  elsewhere, and reads a value on the host in its step.
* :class:`Adagrad` is ``optax.adagrad(learning_rate)``: the accumulator
  starts at 0.1, the update is ``g * rsqrt(acc + eps)`` with ``eps`` 1e-7
  inside the root, and zero where the accumulator is 0.
  ``torch.optim.Adagrad`` divides by ``sqrt(acc) + eps``.

Both step with tensor ops only (no value is read on the host), keep their
state in the parameter's dtype on its device, and are plain
``torch.optim.Optimizer`` subclasses, so ``DistributedOptimizer`` and
``zero_sharded_optimizer`` wrap them. Adagrad is elementwise and equals
itself under ZeRO; Adafactor's moments, clip and parameter scale are
statistics of a whole tensor, so under ZeRO they are taken per slice.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.optim.optimizer import required

__all__ = ["Adafactor", "Adagrad"]


# optax.adafactor's defaults.
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
EPSILON = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_PARAM_SCALE = 1e-3


def factored_dims(shape):
    """``(d1, d0)``: the second-largest and the largest dim of ``shape``
    when the second moment is factored, else None (optax's
    ``_factored_dims``, ties broken by the same ``np.argsort``)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _block_rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)`` with optax's other defaults (see the module
    doc). ``lr`` is required: a parameter group that does not name it
    raises, as ``DistributedOptimizer``'s rebuild from the groups relies
    on."""

    def __init__(self, params, lr: float = required):
        super().__init__(params, dict(lr=lr))

    def _init_state(self, p, state, dims):
        state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
        if dims is None:
            state["v"] = torch.zeros_like(p)
            return
        d1, d0 = dims
        shape = list(p.shape)
        state["v_row"] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
        state["v_col"] = p.new_zeros(shape[:d1] + shape[d1 + 1:])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                self._update(p, p.grad, self.state[p], group)
        return loss

    def _update(self, p, g, state, group):
        dims = factored_dims(tuple(p.shape))
        if not state:
            self._init_state(p, state, dims)
        step = state["step"]
        # optax's _decay_rate_pow at the step count, in float32.
        decay = (1.0 - (step + 1.0) ** (-DECAY_RATE)).to(p.dtype)
        grad_sqr = g * g + EPSILON
        if dims is not None:
            d1, d0 = dims
            v_row = state["v_row"]
            v_col = state["v_col"]
            v_row.copy_(decay * v_row + (1.0 - decay) * grad_sqr.mean(d0))
            v_col.copy_(decay * v_col + (1.0 - decay) * grad_sqr.mean(d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            update = (g * row_factor.unsqueeze(d0)
                      * col_factor.unsqueeze(d1))
        else:
            v = state["v"]
            v.copy_(decay * v + (1.0 - decay) * grad_sqr)
            update = g * v ** -0.5
        update = update / torch.clamp(
            _block_rms(update) / CLIPPING_THRESHOLD, min=1.0)
        update = update * group["lr"]
        # optax's scale_by_param_block_rms: safe_root_mean_squares(p).
        rms = _block_rms(p)
        update = update * torch.where(
            rms <= MIN_PARAM_SCALE, torch.full_like(rms, MIN_PARAM_SCALE),
            rms)
        p.sub_(update)
        step.add_(1.0)


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad`` (see the module doc)."""

    EPS = 1e-7

    def __init__(self, params, lr: float = 1e-2,
                 initial_accumulator_value: float = 0.1):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                acc = state["sum"]
                g = p.grad
                acc.add_(g * g)
                scale = torch.where(acc > 0, torch.rsqrt(acc + self.EPS),
                                    torch.zeros_like(acc))
                p.sub_(group["lr"] * (scale * g))
        return loss
