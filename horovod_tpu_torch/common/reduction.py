"""The mean an averaged allreduce returns, shared by both tiers: the
controller (``controller/controller.py``) and the process group
(``torch/mpi_ops.py``)."""

from __future__ import annotations

import torch


def average(t: torch.Tensor, size: int) -> torch.Tensor:
    """The mean the JAX torch adapter returns: ``sum / size`` in the
    tensor's floating dtype; integers through float64 and back (truncated
    toward zero); bool reduces as logical OR and is left as it is. The
    divisor is a tensor on ``t``'s device: a card divides by a Python
    number as a product with its reciprocal, which rounds differently
    from the host's division."""
    if t.dtype == torch.bool:
        return t
    if t.is_floating_point() or t.is_complex():
        return t / torch.tensor(size, dtype=t.dtype, device=t.device)
    wide = t.to(torch.float64)
    return (wide / torch.tensor(float(size), dtype=torch.float64,
                                device=t.device)).to(t.dtype)


def average_(t: torch.Tensor, size: int) -> torch.Tensor:
    """In-place :func:`average`: floating tensors are divided where they
    lie; integers still round-trip through float64."""
    if t.is_floating_point() or t.is_complex():
        return t.div_(torch.tensor(size, dtype=t.dtype, device=t.device))
    if t.dtype != torch.bool:
        t.copy_(average(t, size))
    return t
