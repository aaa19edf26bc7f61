"""Deterministic fault injection (chaos testing) for the control plane —
the port's copy of ``horovod_tpu/fault/``.

Enable by exporting ``HOROVOD_FAULT_PLAN`` (inline JSON or ``@file``)
before launching; see :mod:`horovod_tpu_torch.fault.plan` for the rule
schema. The hooks sit where the JAX package's do: ``Wire.send_bytes`` /
``recv_bytes`` (``wire_send`` / ``wire_recv``), the controller's cycle
(``cycle``), ``hvd.init``'s card acquisition and process-group join
(``init`` / ``init_distributed``) and the async shard writer
(``ckpt_save``). With no plan configured the hooks are no-ops.
"""

from __future__ import annotations

import os
from typing import Optional

from .plan import FaultInjected, FaultPlan, FaultRule, InitWedged

__all__ = ["FaultInjected", "FaultPlan", "FaultRule", "InitWedged",
           "active_plan", "hook", "install_plan", "reset"]

_UNLOADED = object()
_plan = _UNLOADED  # _UNLOADED -> not read yet; None -> injection disabled
_plan_pid: Optional[int] = None


def active_plan() -> Optional[FaultPlan]:
    """The process-wide plan (None when injection is disabled). Loaded
    once per pid — a forked/spawned child re-reads the env so per-rank
    rules bind to the child's HOROVOD_RANK."""
    global _plan, _plan_pid
    if _plan is _UNLOADED or _plan_pid != os.getpid():
        _plan = FaultPlan.from_env()
        _plan_pid = os.getpid()
    return _plan


def hook(site: str) -> Optional[str]:
    """Record one event at ``site``; returns "drop" when the caller must
    skip the operation. No-op (None) when no plan is configured."""
    p = _plan
    if p is _UNLOADED or _plan_pid != os.getpid():
        p = active_plan()
    if p is None:
        return None
    return p.fire(site)


def install_plan(p: Optional[FaultPlan]) -> None:
    """Install a plan directly (tests); pass None to disable."""
    global _plan, _plan_pid
    _plan = p
    _plan_pid = os.getpid()


def reset() -> None:
    """Forget the cached plan; the next hook re-reads the environment."""
    global _plan, _plan_pid
    _plan = _UNLOADED
    _plan_pid = None
