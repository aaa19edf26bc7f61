"""Pipeline parallelism over a process group — the port's counterpart of
``horovod_tpu/parallel/pipeline.py``.

Stages live one per rank of the ``pipe`` group; activations hop stage ->
stage and cotangents come back through ``parallel.exchange``'s ring
exchange, every tick on every rank (bubble ticks send zeros), so the
ranks' exchanges always pair up.

Schedules:

- **GPipe** (``pipeline_apply``, the default) — the microbatches flow
  forward through the stages over ``M + S - 1`` ticks. The call is one
  autograd Function whose backward runs the mirrored schedule
  explicitly (tick by tick in reverse, cotangents exchanged towards
  stage 0), so ``loss.backward()`` on every rank drives it; with
  ``remat`` (default) each tick's stage is recomputed in the backward
  from its stashed input, which keeps one microbatch's activations
  live per stage, and the stash is O(M) inputs.
- **1F1B** (``pipeline_1f1b``; PipeDream-Flush) — forward and backward
  interleave over ``M + 2(S-1)`` rounds: stage ``s`` forwards microbatch
  ``m`` at round ``m + s`` and backwards it at round ``m + 2(S-1) - s``,
  recomputing its VJP from the stashed input. The stash holds only the
  inputs still awaiting their backward, O(S) whatever M. It owns the
  loss and returns ``(loss, grads)``.

Differences from the JAX functions: ``stage_params`` is THIS rank's
stage (a dict/list/tuple tree of tensors, no leading stage axis — the
JAX shard_map hands each device its ``[1, ...]`` slice), and the 1F1B
grads come back in that layout. ``stack_stage_params`` builds the JAX
layout from a list of stages; index it by the stage to get one.

Constraint (the homogeneous-pipeline contract): every stage maps
activations of one shape to the same shape.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from .exchange import group_sum, ring_exchange
from .mesh import group_rank, group_size


def _flatten(tree):
    """(leaves, rebuild) of a dict/list/tuple tree of tensors."""
    leaves: List[torch.Tensor] = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        leaves.append(node)
        return len(leaves) - 1

    skeleton = walk(tree)

    def rebuild(values):
        def fill(node):
            if isinstance(node, dict):
                return {k: fill(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(fill(v) for v in node)
            return values[node]
        return fill(skeleton)

    return leaves, rebuild


def stack_stage_params(params_list):
    """Stack per-stage parameter trees along a new leading (stage) axis:
    stage ``s`` is ``tree_map(lambda a: a[s], stacked)``."""
    leaves0, rebuild = _flatten(params_list[0])
    per = [_flatten(p)[0] for p in params_list]
    return rebuild([torch.stack([p[i] for p in per])
                    for i in range(len(leaves0))])


def _vjp(stage_fn, rebuild, leaves, x, g):
    """``(d params, d x)`` of ``stage_fn(params, x)`` against cotangent
    ``g``, recomputing the stage."""
    with torch.enable_grad():
        pl = [p.detach().requires_grad_() for p in leaves]
        xl = x.detach().requires_grad_()
        y = stage_fn(rebuild(pl), xl)
        grads = torch.autograd.grad(y, pl + [xl], g, allow_unused=True)
    out = [torch.zeros_like(t) if d is None else d
           for t, d in zip(pl + [xl], grads)]
    return out[:-1], out[-1]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, rebuild, group, remat, n_leaves, *args):
        leaves, microbatches = list(args[:n_leaves]), args[n_leaves]
        idx, n = group_rank(group), group_size(group)
        num_mb = microbatches.shape[0]
        params = rebuild([p.detach() for p in leaves])
        recv = torch.zeros_like(microbatches[0])
        xs, ys, graphs = [], [], []
        for t in range(num_mb + n - 1):
            # Stage 0 injects microbatch t (clamped: bubble ticks repeat
            # the last one; their outputs never reach a valid slot).
            x = microbatches[min(t, num_mb - 1)] if idx == 0 else recv
            if remat:
                y = stage_fn(params, x)
                xs.append(x)
            else:
                with torch.enable_grad():
                    pl = [p.detach().requires_grad_() for p in leaves]
                    xl = x.detach().requires_grad_()
                    y = stage_fn(rebuild(pl), xl)
                graphs.append((pl, xl, y))
                y = y.detach()
            ys.append(y)
            if n > 1:
                (recv,) = ring_exchange([y], group)
        ctx.stage_fn, ctx.rebuild, ctx.group = stage_fn, rebuild, group
        ctx.remat, ctx.n_leaves, ctx.graphs = remat, n_leaves, graphs
        ctx.num_mb = num_mb
        ctx.save_for_backward(*leaves, *xs)
        # On the last stage, microbatch m completes at tick m + (S-1).
        return torch.stack(ys[n - 1:n - 1 + num_mb])

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        leaves, xs = list(saved[:ctx.n_leaves]), saved[ctx.n_leaves:]
        group, num_mb = ctx.group, ctx.num_mb
        idx, n = group_rank(group), group_size(group)
        last = idx == n - 1
        d_params = [torch.zeros_like(p) for p in leaves]
        dy_next = torch.zeros_like(g[0])
        for t in reversed(range(num_mb + n - 1)):
            m = t - (n - 1)
            if last:
                dy = g[m] if 0 <= m < num_mb else torch.zeros_like(g[0])
            else:
                dy = dy_next       # the next stage's dx of tick t + 1
            if ctx.remat:
                dp, dx = _vjp(ctx.stage_fn, ctx.rebuild, leaves, xs[t], dy)
            else:
                pl, xl, y = ctx.graphs[t]
                grads = torch.autograd.grad(y, pl + [xl], dy,
                                            allow_unused=True)
                grads = [torch.zeros_like(a) if d is None else d
                         for a, d in zip(pl + [xl], grads)]
                dp, dx = grads[:-1], grads[-1]
            d_params = [a + b for a, b in zip(d_params, dp)]
            if n > 1:
                # dx goes to the previous stage, where it is the
                # cotangent of tick t - 1's output; the wrap edge into
                # the last stage is ignored there.
                (dy_next,) = ring_exchange([dx], group, shift=-1)
        ctx.graphs = None
        return (None, None, None, None, None, *d_params, None)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor,
                   group=None, remat: bool = True,
                   schedule: str = "gpipe",
                   loss_fn: Optional[Callable[..., torch.Tensor]] = None,
                   targets: Optional[torch.Tensor] = None):
    """Run a pipelined forward (GPipe) or fused forward+backward (1F1B)
    over the ranks of ``group`` (one stage each, in group-rank order).
    ``stage_params``: this rank's stage; ``microbatches``: ``[M, mb,
    ...]``, the same on every rank (only stage 0 reads them).

    ``schedule="gpipe"`` returns ``[M, mb, ...]`` outputs that are VALID
    ON THE LAST STAGE ONLY (other stages hold garbage): reduce them with
    :func:`pipeline_loss` (or mask by the stage) and call ``backward()``
    on EVERY rank — the backward is a schedule of exchanges all stages
    take part in. Gradients flow to ``stage_params``, not to the
    microbatches.

    ``schedule="1f1b"`` requires ``loss_fn(y[, target]) -> scalar`` and
    returns ``(loss, grads)``, see :func:`pipeline_1f1b`."""
    if schedule == "1f1b":
        return pipeline_1f1b(stage_fn, stage_params, microbatches, loss_fn,
                             targets, group=group)
    if schedule != "gpipe":
        raise ValueError(
            f"pipeline_apply: unknown schedule {schedule!r}; "
            "expected 'gpipe' or '1f1b'")
    leaves, rebuild = _flatten(stage_params)
    return _GPipe.apply(stage_fn, rebuild, group, remat, len(leaves),
                        *leaves, microbatches)


def pipeline_1f1b(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  stage_params: Any, microbatches: torch.Tensor,
                  loss_fn: Callable[..., torch.Tensor],
                  targets: Optional[torch.Tensor] = None, group=None):
    """1F1B (PipeDream-Flush) training schedule over ``group``: returns
    ``(loss, grads)`` — the mean per-microbatch loss (the same on every
    stage) and this stage's parameter gradients of it, in
    ``stage_params``' tree layout. ``loss_fn(y)`` or ``loss_fn(y,
    target)`` gives one microbatch's scalar loss. No autograd runs
    through the schedule: each stage takes its VJP per round from the
    stashed input."""
    if loss_fn is None:
        raise ValueError("pipeline_1f1b: loss_fn is required (the 1F1B "
                         "schedule computes the backward in-line, so it "
                         "must own the per-microbatch loss)")
    idx, n = group_rank(group), group_size(group)
    num_mb = microbatches.shape[0]
    last = idx == n - 1
    span = 2 * (n - 1)
    leaves, rebuild = _flatten(stage_params)
    params = rebuild([p.detach() for p in leaves])
    zero_act = torch.zeros_like(microbatches[0])
    grads = [torch.zeros_like(p) for p in leaves]
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=microbatches.device)
    stash = {}
    fwd_recv = bwd_recv = zero_act
    dy_last = None
    with torch.no_grad():
        for r in range(num_mb + span):
            # forward slot: microbatch m_f = r - idx
            m_f = r - idx
            y = zero_act
            if 0 <= m_f < num_mb:
                x_in = microbatches[m_f] if idx == 0 else fwd_recv
                stash[m_f] = x_in
                y = stage_fn(params, x_in)
                if last:
                    # The loss and its cotangent, the round the
                    # microbatch completes: its backward starts at once.
                    with torch.enable_grad():
                        yl = y.detach().requires_grad_()
                        l_m = (loss_fn(yl) if targets is None
                               else loss_fn(yl, targets[m_f]))
                        (dy_last,) = torch.autograd.grad(l_m, yl)
                    loss_acc = loss_acc + l_m.detach().float()
            # backward slot: microbatch m_b = r - (2(S-1) - idx)
            m_b = r - (span - idx)
            dx = zero_act
            if 0 <= m_b < num_mb:
                # At the last stage m_b == m_f: the cotangent is this
                # round's dy; upstream stages got theirs from the next
                # stage last round. The mean over microbatches folds in.
                g_in = dy_last / num_mb if last else bwd_recv
                dp, dx = _vjp(stage_fn, rebuild, leaves, stash.pop(m_b),
                              g_in)
                grads = [a + b for a, b in zip(grads, dp)]
            if n > 1:
                # Activations down the ring (the wrap into stage 0 is
                # ignored: it injects), cotangents up (the wrap into the
                # last stage is ignored: it uses its own dy).
                (fwd_recv,) = ring_exchange([y], group)
                (bwd_recv,) = ring_exchange([dx], group, shift=-1)
    loss = group_sum(loss_acc, group) / num_mb
    return loss, rebuild(grads)


def collect_from_last_stage(y: torch.Tensor, group=None) -> torch.Tensor:
    """The last stage's (valid) outputs on every stage, replacing the
    garbage elsewhere. Differentiable: each rank's backward reaches the
    last stage's outputs."""
    last = group_rank(group) == group_size(group) - 1
    return group_sum(torch.where(torch.tensor(last, device=y.device), y,
                                 torch.zeros_like(y)), group)


def pipeline_loss(per_mb_loss: torch.Tensor, group=None) -> torch.Tensor:
    """Reduce per-microbatch losses computed from :func:`pipeline_apply`
    outputs: the last stage's mean, shared with every stage. The other
    stages' garbage enters through a ``where``, so their graphs stay
    connected (zero gradient) and every rank's ``backward()`` runs the
    pipeline's backward schedule."""
    last = group_rank(group) == group_size(group) - 1
    mean = per_mb_loss.mean()
    masked = torch.where(torch.tensor(last, device=mean.device), mean,
                         torch.zeros_like(mean))
    return group_sum(masked, group)
