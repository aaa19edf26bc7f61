"""Backward-order gradient bucket scheduling, the port's copy of
``horovod_tpu/controller/bucket_scheduler.py`` on torch tensors (CPU or
CUDA).

Overlapping gradient reduction with backward compute: each bucket's
allreduce is enqueued the moment its producers complete instead of
waiting for every gradient.

* :func:`partition_buckets` / :func:`plan_from_compiled`: planning.
  Gradients in backward production order, packed into consecutive
  size-bounded buckets. The JAX package reads that order from a compiled
  HLO schedule; eager PyTorch has none, so the port's
  :func:`plan_from_compiled` records it from one backward pass.
* :class:`BucketScheduler`: the driver. Call :meth:`grad_ready` as each
  gradient materializes; a full bucket launches at once (its tensors
  enqueued in one shot, so Tensor Fusion packs them into one wire
  collective); :meth:`finish` flushes the tail, waits, and reports the
  measured ``overlap_efficiency``, the fraction of the backward window
  during which at least one reduction was in flight, by the same union
  formula the scaling model predicts with
  (``utils.scaling_model.overlap_efficiency_from_events``).

It works against either of the port's controllers (they share the async
surface). When the controller's data plane is pipelined (the native
engine's ``pipeline_enabled``) the scheduler launches each gradient the
moment it is produced and keeps buckets as the reporting unit only.
Priority tags (``priority_names``, and the ``finish()`` tail bucket under
batched launch) ride down to the controller, so the optimizer-critical
bucket jumps the launch queue.

Knobs: ``HOROVOD_BUCKET_BYTES`` (0 = auto, joins the autotuner); metrics:
``hvd_overlap_buckets_total``, ``hvd_overlap_efficiency``,
``hvd_overlap_priority_jumps_total``.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import metrics
from ..common.config import resolved_bucket_bytes
from ..utils.scaling_model import (
    BucketEvent,
    GradGroup,
    measured_overlap_report,
)

# Autotuner override (rank 0 pushes the GP's current value here, the way
# it pushes the ring chunk into the native core). None = use the
# env/default resolution.
_autotuned_bucket_bytes: Optional[int] = None


def set_autotuned_bucket_bytes(nbytes: Optional[int]) -> None:
    """Push a tuned bucket size (None restores the env/default value).

    Two callers, one sync contract: on the Python controller the value
    arrives on every rank with the synced cycle reply
    (``Controller._apply_tune``); on the native engine it rides a slot
    of the C++ cycle reply (``hvd_eng_set_tuned_bucket``) and every
    rank's telemetry thread applies it here, so bucket launch grouping
    moves together across the job under either engine. Safe to retune
    live: the size never touches the wire format."""
    global _autotuned_bucket_bytes
    _autotuned_bucket_bytes = int(nbytes) if nbytes else None


def current_bucket_bytes() -> int:
    """The size bound a new scheduler starts with: autotuner override,
    else the HOROVOD_BUCKET_BYTES/default resolution."""
    if _autotuned_bucket_bytes is not None:
        return _autotuned_bucket_bytes
    return resolved_bucket_bytes()


# Most recent measured overlap_efficiency (any scheduler's finish() on
# this process). The tuners sample it into the GP objective; None until
# a first step finishes.
_last_overlap: Optional[float] = None


def last_overlap_efficiency() -> Optional[float]:
    """The last finished step's measured ``overlap_efficiency``, or None
    before any step completed. Feeds the autotuner's overlap term."""
    return _last_overlap


@dataclasses.dataclass
class Bucket:
    """One launch unit: consecutive gradients in backward production
    order whose payload fits the size bound."""

    index: int
    names: List[str]
    payload_bytes: int


def partition_buckets(entries: Sequence[Tuple[str, int]],
                      bucket_bytes: int) -> List[Bucket]:
    """Pack ``(name, payload_bytes)`` pairs — already in backward
    production order — into consecutive size-bounded buckets. A bucket
    closes when adding the next tensor would exceed the bound; a single
    tensor larger than the bound gets its own bucket (it cannot be
    split — the wire layer's chunking handles big payloads). Degenerate
    cases: empty input -> no buckets; bound so large everything fits ->
    one bucket (the unbucketed fall-back, bit-identical by
    construction)."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    buckets: List[Bucket] = []
    names: List[str] = []
    total = 0
    for name, nbytes in entries:
        if names and total + int(nbytes) > bucket_bytes:
            buckets.append(Bucket(len(buckets), names, total))
            names, total = [], 0
        names.append(str(name))
        total += int(nbytes)
    if names:
        buckets.append(Bucket(len(buckets), names, total))
    return buckets


@dataclasses.dataclass
class BucketPlan:
    """A bucket plan plus the scaling model's inputs for the same
    gradients, so measured overlap can be held against the model's
    prediction (``utils.scaling_model.predicted_bucket_events``)."""

    buckets: List[Bucket]
    groups: List[GradGroup]
    bucket_bytes: int

    @property
    def order(self) -> List[str]:
        return [n for b in self.buckets for n in b.names]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def plan_from_compiled(module: torch.nn.Module,
                       step: Callable[[torch.nn.Module], torch.Tensor],
                       bucket_bytes: Optional[int] = None,
                       min_bytes: int = 0) -> BucketPlan:
    """The bucket plan from one recorded backward of ``module``.

    The JAX function reads the gradient all-reduces of a compiled HLO
    schedule, in schedule order, with each one's ``compute_after_frac``
    (the share of the step's compute scheduled after it). Eager PyTorch
    compiles no schedule, so this version runs ``step(module)`` (forward
    and loss, returning a scalar) and its backward once, with a
    ``register_post_accumulate_grad_hook`` on every trainable parameter
    that stamps the gradient's name, bytes and time as it lands. The
    stamps give the same two lists: the ``Bucket`` partition of the
    ``(name, bytes)`` pairs in production order, and one ``GradGroup`` a
    gradient with ``compute_after_frac = (t_end - t_ready) / (t_end -
    t_start)`` over the step from the forward's start to the backward's
    end. Names are the ``named_parameters()`` names (stable across
    steps). Gradients below ``min_bytes`` are left out (every parameter
    gradient is gradient traffic, so the default keeps all). On a CUDA
    module each hook synchronizes the card before stamping, so a time is
    when the gradient exists, not when its kernel was queued; the
    recorded step is a planning pass, not a training step (its gradients
    are left in ``.grad``)."""
    stamps: List[Tuple[str, int, float]] = []
    handles = []
    for name, p in module.named_parameters():
        if not p.requires_grad:
            continue

        def hook(param, _name=name):
            if param.grad.is_cuda:
                torch.cuda.synchronize(param.grad.device)
            stamps.append((_name, _nbytes(param.grad), time.monotonic()))

        handles.append(p.register_post_accumulate_grad_hook(hook))
    try:
        t_start = time.monotonic()
        loss = step(module)
        loss.backward()
        if loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        t_end = time.monotonic()
    finally:
        for h in handles:
            h.remove()
    span = max(t_end - t_start, 1e-12)
    entries: List[Tuple[str, int]] = []
    groups: List[GradGroup] = []
    for name, nbytes, t in stamps:
        if nbytes < min_bytes:
            continue
        entries.append((name, nbytes))
        groups.append(GradGroup(nbytes, min(1.0, max(0.0,
                                                     (t_end - t) / span))))
    size = bucket_bytes if bucket_bytes else current_bucket_bytes()
    return BucketPlan(partition_buckets(entries, size), groups, size)


class _LocalHandle:
    """Immediately-done handle for the size-1 identity path."""

    def __init__(self, tensor):
        self._tensor = tensor

    def done(self) -> bool:
        return True

    def wait(self):
        return self._tensor


class _LocalIdentityController:
    """Size-1 fall-back: allreduce of one rank is the identity (sum of
    one; the average divides by one). Mirrors the async surface the
    schedulers drive."""

    def allreduce_async(self, tensor, average=True, name=None):
        return _LocalHandle(tensor.detach().clone())


_m = None


def _overlap_metrics():
    """Lazy registration (never at import time)."""
    global _m
    if _m is None:
        from types import SimpleNamespace

        _m = SimpleNamespace(
            buckets=metrics.counter(
                "hvd_overlap_buckets_total",
                "Gradient buckets launched by the backward-order bucket "
                "scheduler."),
            efficiency=metrics.gauge(
                "hvd_overlap_efficiency",
                "Measured fraction of the last backward window during "
                "which at least one bucket reduction was in flight "
                "(docs/overlap.md)."),
            priority_jumps=metrics.counter(
                "hvd_overlap_priority_jumps_total",
                "Cycles whose fused-launch order was changed by a "
                "priority tag — python controller reorders counted "
                "here directly, native-engine reorders mirrored from "
                "its priority_jumps counter (docs/overlap.md)."),
        )
    return _m


class BucketScheduler:
    """Launches gradient allreduces in backward order, bucket by bucket,
    while the backward pass still runs.

    Usage::

        sched = BucketScheduler(controller)          # or bucket_bytes=...
        sched.backward_started()                     # optional, tightens
                                                     # the measured window
        for name, grad in backward_in_production_order():
            sched.grad_ready(name, grad)             # may launch a bucket
        results, report = sched.finish()             # waits; name -> array

    Results are bit-identical to one-by-one allreduce of the same named
    tensors: bucketing changes when collectives launch, never what they
    compute. One carve-out, inherited from the wire layer: under the
    int8 wire dtype the quantization blocks span the fused buffer, so a
    different fusion grouping shifts block boundaries and the results
    may differ by a bounded quantization step (the per-name
    error-feedback residuals compensate across steps). The scheduler is
    single-step state: construct (or :meth:`reset`) per step."""

    def __init__(self, controller: Optional[Any] = None,
                 bucket_bytes: Optional[int] = None,
                 average: bool = True,
                 eager: Optional[bool] = None,
                 priority_names: Optional[Sequence[str]] = None):
        if controller is None:
            # The running job's controller: the surface a user script
            # reaches for as hvd.BucketScheduler(). controller() raises
            # the "use hvd.init()" error when uninitialized.
            from ..common import basics

            controller = basics.controller()
            if controller is None:
                if basics.size() == 1:
                    # Single-process eager tier has no controller; the
                    # sum-of-one identity keeps user scripts portable
                    # from 1 to N ranks.
                    controller = _LocalIdentityController()
                else:
                    raise ValueError(
                        "BucketScheduler needs an eager controller: "
                        "launch through horovodrun (which bootstraps "
                        "it), or pass a controller explicitly")
        self._ctl = controller
        self.bucket_bytes = int(bucket_bytes) if bucket_bytes \
            else current_bucket_bytes()
        self._average = average
        # Eager per-tensor launch: enqueue each gradient the
        # moment it is produced instead of holding a bucket's worth —
        # the pipelined engine keeps earlier groups on the wire while
        # later ones are still being packed, so batching at THIS layer
        # would only serialize what the engine can overlap. Auto-on when
        # the controller advertises a pipelined data plane.
        if eager is None:
            eager = bool(getattr(controller, "pipeline_enabled", False))
        self.eager = bool(eager)
        # Names to tag with launch priority 1 (the optimizer-critical
        # bucket — typically the LAST backward bucket, known ahead of
        # time from the plan). Under batched launch the finish() tail
        # bucket is additionally tagged; eager launches can only honor
        # an up-front set (a tensor already on the wire can't jump).
        self._priority_names = frozenset(
            str(n) for n in (priority_names or ()))
        try:
            self._supports_priority = "priority" in inspect.signature(
                controller.allreduce_async).parameters
        except (TypeError, ValueError):
            self._supports_priority = False
        self.reset()

    def reset(self) -> None:
        self._pending: List[Tuple[str, Any]] = []
        self._pending_bytes = 0
        self._pending_ready_s: Optional[float] = None
        # In-flight buckets: list of dicts {handles: [(name, handle)],
        # launch_s, ready_s (last member produced), complete_s (None
        # until observed)}.
        self._inflight: List[dict] = []
        # Eager mode: the bucket currently accepting members (an entry
        # of _inflight), with its accumulated payload bytes.
        self._open: Optional[dict] = None
        self._open_bytes = 0
        self._results: Dict[str, Any] = {}
        self._t_backward_start: Optional[float] = None
        self._t_last_ready: Optional[float] = None
        self._buckets_launched = 0

    # ------------------------------------------------------------- driving

    def backward_started(self) -> None:
        """Mark the start of backward compute. Optional: without it the
        window opens at the first :meth:`grad_ready`, which understates
        the overlappable compute (the pre-first-gradient stretch is
        invisible to the scheduler)."""
        self._t_backward_start = time.monotonic()

    def grad_ready(self, name: str, array: torch.Tensor) -> None:
        """Feed one produced gradient (call in backward production
        order). Batched mode: closes and launches the current bucket
        when adding this tensor would exceed the size bound — so the
        reduction of earlier gradients rides concurrently with the
        production of later ones. Eager mode: enqueues the tensor
        immediately and only tracks bucket boundaries for reporting."""
        now = time.monotonic()
        if self._t_backward_start is None:
            self._t_backward_start = now
        self._t_last_ready = now
        self._poll_inflight(now)
        arr = array.detach()
        if self.eager:
            self._launch_eager(str(name), arr, now)
            return
        if self._pending and \
                self._pending_bytes + _nbytes(arr) > self.bucket_bytes:
            self._launch()
        self._pending.append((str(name), arr))
        self._pending_bytes += _nbytes(arr)
        self._pending_ready_s = now
        if self._pending_bytes >= self.bucket_bytes:
            self._launch()

    def _allreduce(self, name: str, arr, priority: int):
        if priority and self._supports_priority:
            return self._ctl.allreduce_async(
                arr, average=self._average, name=name, priority=priority)
        return self._ctl.allreduce_async(
            arr, average=self._average, name=name)

    def _launch_eager(self, name: str, arr, now: float) -> None:
        # The tensor goes straight to the engine; the open reporting
        # bucket closes by the same would-exceed rule partition_buckets
        # applies, so eager and batched report comparable event counts.
        if self._open is not None and \
                self._open_bytes + _nbytes(arr) > self.bucket_bytes:
            self._open = None
        if self._open is None:
            self._open = {"handles": [], "launch_s": now, "ready_s": now,
                          "complete_s": None}
            self._open_bytes = 0
            self._inflight.append(self._open)
            self._buckets_launched += 1
            if metrics.on():
                _overlap_metrics().buckets.inc()
        prio = 1 if name in self._priority_names else 0
        self._open["handles"].append((name, self._allreduce(name, arr, prio)))
        self._open["ready_s"] = now
        self._open_bytes += _nbytes(arr)
        if self._open_bytes >= self.bucket_bytes:
            self._open = None

    def _launch(self, priority: int = 0) -> None:
        if not self._pending:
            return
        launch_s = time.monotonic()
        handles = [(name, self._allreduce(
            name, arr,
            max(priority, 1 if name in self._priority_names else 0)))
            for name, arr in self._pending]
        self._inflight.append(
            {"handles": handles, "launch_s": launch_s,
             "ready_s": (self._pending_ready_s
                         if self._pending_ready_s is not None else launch_s),
             "complete_s": None})
        self._buckets_launched += 1
        self._pending = []
        self._pending_bytes = 0
        self._pending_ready_s = None
        if metrics.on():
            _overlap_metrics().buckets.inc()

    def _poll_inflight(self, now: float) -> None:
        # Opportunistic completion stamping: the engine resolves handles
        # on its background thread; observing done() here (between
        # gradient productions) bounds the recorded complete time without
        # blocking the backward pass. The OPEN eager bucket is excluded —
        # it will still grow, so "all current handles done" is not
        # "bucket complete".
        for b in self._inflight:
            if b is not self._open and b["complete_s"] is None and \
                    all(h.done() for _, h in b["handles"]):
                b["complete_s"] = now

    # ------------------------------------------------------------ finishing

    def finish(self) -> Tuple[Dict[str, Any], dict]:
        """Flush the tail bucket, wait for every reduction, and return
        ``(results, report)``: reduced tensors by name, and the measured
        overlap report (``overlap_efficiency`` et al, the shape the
        bench row embeds). Also mirrors ``hvd_overlap_efficiency`` and
        publishes the sample for the autotuner's overlap term.

        The tail bucket — the LAST backward bucket, first needed by the
        optimizer — launches with priority 1, so under batched launch it
        jumps the engine's negotiation queue."""
        self._launch(priority=1)
        self._open = None
        t_compute_end = (self._t_last_ready
                         if self._t_last_ready is not None
                         else time.monotonic())
        events: List[BucketEvent] = []
        ready_offsets: List[float] = []
        for b in self._inflight:
            for name, h in b["handles"]:
                self._results[name] = h.wait()
            if b["complete_s"] is None:
                b["complete_s"] = time.monotonic()
            events.append(BucketEvent(b["launch_s"], b["complete_s"]))
            ready_offsets.append(b.get("ready_s", b["launch_s"]))
        start = (self._t_backward_start
                 if self._t_backward_start is not None else t_compute_end)
        report = measured_overlap_report(events, start, t_compute_end)
        report["bucket_bytes"] = self.bucket_bytes
        report["eager"] = self.eager
        report["events"] = [
            {"launch_s": round(e.launch_s - start, 6),
             "ready_s": round(r - start, 6),
             "complete_s": round(e.complete_s - start, 6)}
            for e, r in zip(events, ready_offsets)]
        global _last_overlap
        _last_overlap = report["overlap_efficiency"]
        if metrics.on():
            _overlap_metrics().efficiency.set(report["overlap_efficiency"])
        results = dict(self._results)
        # Full reset: the scheduler is single-step state, and a partial
        # cleanup would let an accidentally-reused instance silently
        # merge stale results and stretch the overlap window across
        # steps.
        self.reset()
        return results, report
