"""Expert parallelism: mixture-of-experts dispatch — the counterpart of
``horovod_tpu/parallel/moe.py``.

Tokens are packed into ``[experts, capacity, d_model]`` buffers by
index-based routing (``_route``: top-k choices over float32 router
probabilities, capacity slots from an integer cumsum that fills in
(round, token) order), moved by gather-only row permutations
(``_PackRows`` / ``_CombineRows``, whose backward passes are gathers
through the inverse slot -> assignment map, as the JAX package's custom
VJPs are: no ``index_add_``, so the backward is deterministic on the
card), transformed by the experts and combined with the gate weights.

Routing is top-k with capacity dropping (Switch for ``k=1``, GShard for
``k=2``): per expert at most ``capacity = ceil(k*T/E * capacity_factor)``
assignments survive; a dropped assignment contributes zero (add the
residual outside). The Switch load-balancing loss comes back with the
output.

``moe_apply_dense`` runs every expert on this device, the expert axis
batched (``torch.bmm`` in the expert functions) where the JAX package
uses ``vmap``. ``moe_apply`` runs one expert per rank of a
``torch.distributed`` process group (the JAX package's mesh axis) and
exchanges the ``[E, C, D]`` buffers with ``alltoall``. The routing, and
so the numerics, is the same in both.

Expert functions take ``(params, x)`` with a leading expert axis on
both: every tensor of ``params`` is ``[E_local, ...]`` and ``x`` is
``[E_local, rows, D]``; they return ``[E_local, rows, D_out]``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from ..torch.mpi_ops import _alltoall_equal


def switch_aux_loss(probs: torch.Tensor,
                    expert_mask: torch.Tensor) -> torch.Tensor:
    """Load-balancing loss (Switch Transformer eq. 4): E * sum_e
    fraction_of_tokens(e) * mean_router_prob(e), in float32. Equals 1 at
    uniform routing."""
    num_experts = probs.shape[-1]
    fraction = expert_mask.float().mean(dim=0)
    mean_prob = probs.float().mean(dim=0)
    return num_experts * torch.sum(fraction * mean_prob)


class _Routing:
    """Per round (lists of length ``num_selected``): each token's expert
    id, capacity slot (``>= capacity``: dropped) and combine weight."""

    def __init__(self, expert_idx, slot, combine_w):
        self.expert_idx = expert_idx    # k x [T] int64
        self.slot = slot                # k x [T] int32
        self.combine_w = combine_w      # k x [T] in the stream dtype


def _route(probs: torch.Tensor, capacity: int, num_selected: int,
           normalize_gates: bool, dtype: torch.dtype
           ) -> Tuple[_Routing, torch.Tensor]:
    """Top-k routing with capacity dropping. ``probs`` [T, E] float32.
    Decisions (argmax, first index on ties, chosen experts masked with
    -inf) and gates run in float32; combine weights drop to ``dtype`` at
    the end. Returns ``(routing, aux)``."""
    tokens, num_experts = probs.shape
    choices, slots, gates = [], [], []
    avail = torch.ones_like(probs)
    total_mask = torch.zeros_like(probs)
    # Assignments kept per expert so far; int32, as a bf16 cumsum cannot
    # count past 256.
    fill = torch.zeros((num_experts,), dtype=torch.int32,
                       device=probs.device)
    # A fill on the device, not a host-to-device copy: the serving
    # engine captures the decode step in a CUDA graph.
    neg_inf = torch.full((), float("-inf"), dtype=probs.dtype,
                         device=probs.device)
    for _ in range(num_selected):
        masked = torch.where(avail > 0, probs, neg_inf)
        choice = torch.argmax(masked, dim=-1)                  # [T]
        gate = torch.gather(probs, 1, choice[:, None])[:, 0]
        onehot = torch.nn.functional.one_hot(
            choice, num_experts).to(torch.int32)
        # The running count along the tokens, scanned over the last dim of
        # the [E, T] transpose: a scan over dim 0 of [T, E] runs E threads
        # wide on the card (1.3 ms a call at T=8192, E=8, H100).
        pos = (torch.cumsum(onehot.t().contiguous(), dim=1,
                            dtype=torch.int32).t() - 1 + fill[None])
        slot = torch.sum(pos * onehot, dim=-1, dtype=torch.int32)
        fill = fill + torch.sum(onehot * (slot < capacity)[:, None].to(
            torch.int32), dim=0, dtype=torch.int32)
        avail = avail * (1 - onehot).to(probs.dtype)
        total_mask = total_mask + onehot.to(probs.dtype)
        choices.append(choice)
        slots.append(slot)
        gates.append(gate)

    if normalize_gates and num_selected > 1:
        # GShard: the selected gates sum to 1 per token, over ALL k
        # choices, dropped or not.
        denom = torch.clamp_min(sum(gates), 1e-9)
        gates = [g / denom for g in gates]
    combine_w = [torch.where(s < capacity, g, torch.zeros_like(g)).to(dtype)
                 for s, g in zip(slots, gates)]
    aux = switch_aux_loss(probs, total_mask / num_selected)
    return _Routing(choices, slots, combine_w), aux


def _routing_indices(routing: _Routing, num_experts: int, capacity: int,
                     tokens: int):
    """Stacked per-round destinations and the inverse map.

    ``dests/keeps [k, T]``: each assignment's flat buffer slot (0 when
    dropped) and whether it was kept. ``inv_token/inv_round/inv_valid
    [E*C]``: which (round, token) assignment owns each buffer slot. The
    inverse is built by an integer scatter. A dropped assignment's slot
    would land past its expert's capacity, in the next expert's slots: its
    index is masked to one sink slot past the buffer (the JAX package's
    out-of-range index under ``mode="drop"``), which is cut off after.
    Kept slots are unique by construction, so no two kept writes meet;
    and nothing here waits for the device (a boolean-mask index would)."""
    ec = num_experts * capacity
    device = routing.slot[0].device
    dests, keeps = [], []
    inv = torch.full((ec + 1,), -1, dtype=torch.int64, device=device)
    ids = torch.arange(tokens, device=device)
    for r, (e_idx, slot) in enumerate(zip(routing.expert_idx,
                                          routing.slot)):
        keep = slot < capacity
        flat = e_idx * capacity + slot.long()
        inv[torch.where(keep, flat, ec)] = r * tokens + ids
        dests.append(torch.where(keep, flat, torch.zeros_like(flat)))
        keeps.append(keep)
    inv = inv[:ec]
    inv_valid = inv >= 0
    safe_inv = torch.where(inv_valid, inv, torch.zeros_like(inv))
    return (torch.stack(dests), torch.stack(keeps),
            safe_inv % tokens, safe_inv // tokens, inv_valid)


class _PackRows(torch.autograd.Function):
    """[T, D] token rows -> [E*C, D] buffer rows (zeros in unowned
    slots): one gather through the inverse map. Backward: dx[t] = the
    sum over the <= k slots that read token t, per-round gathers."""

    @staticmethod
    def forward(ctx, x, inv_token, inv_valid, dests, keeps):
        ctx.save_for_backward(dests, keeps)
        return torch.where(inv_valid[:, None], x[inv_token],
                           torch.zeros((), dtype=x.dtype, device=x.device))

    @staticmethod
    def backward(ctx, g):
        dests, keeps = ctx.saved_tensors
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        dx = None
        for r in range(dests.shape[0]):
            term = torch.where(keeps[r][:, None], g[dests[r]], zero)
            dx = term if dx is None else dx + term
        return dx, None, None, None, None


class _CombineRows(torch.autograd.Function):
    """Gate-weighted combine, y[t] = sum_r w[r, t] * out_flat[dests[r, t]]
    (dropped assignments carry weight 0). Backward: d_out through the
    inverse map (one gather), dw[r, t] = <dy[t], out_flat[dests[r, t]]>
    for kept assignments, recomputing the forward's gathers."""

    @staticmethod
    def forward(ctx, out_flat, w, dests, keeps, inv_token, inv_round,
                inv_valid):
        ctx.save_for_backward(out_flat, w, dests, keeps, inv_token,
                              inv_round, inv_valid)
        y = None
        for r in range(dests.shape[0]):
            term = out_flat[dests[r]] * w[r][:, None]
            y = term if y is None else y + term
        return y

    @staticmethod
    def backward(ctx, dy):
        out_flat, w, dests, keeps, inv_token, inv_round, inv_valid = \
            ctx.saved_tensors
        zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
        w_at_slot = w[inv_round, inv_token]                     # [E*C]
        dout = torch.where(inv_valid[:, None],
                           dy[inv_token] * w_at_slot[:, None], zero)
        dw = torch.stack([
            torch.where(keeps[r],
                        torch.sum(dy * out_flat[dests[r]].to(dy.dtype), -1),
                        zero).to(w.dtype)
            for r in range(dests.shape[0])])
        return (dout.to(out_flat.dtype), dw, None, None, None, None, None)


def _pack_to_experts(x, idx, num_experts: int, capacity: int):
    dests, keeps, inv_token, inv_round, inv_valid = idx
    buf = _PackRows.apply(x, inv_token, inv_valid, dests, keeps)
    return buf.reshape(num_experts, capacity, x.shape[1])


def _gather_from_experts(expert_out, routing: _Routing, idx):
    num_experts, capacity, d = expert_out.shape
    dests, keeps, inv_token, inv_round, inv_valid = idx
    w = torch.stack(routing.combine_w)                          # [k, T]
    return _CombineRows.apply(expert_out.reshape(num_experts * capacity, d),
                              w, dests, keeps, inv_token, inv_round,
                              inv_valid)


def _capacity(tokens: int, num_experts: int, capacity_factor: float,
              num_selected: int) -> int:
    # GShard top-k: k*T assignments, so k*T/E * factor slots per expert.
    # The JAX package's expression, floor division of a float included.
    return max(int(-(-tokens * num_selected * capacity_factor
                     // num_experts)),
               num_selected)


def _leading(params: Dict[str, torch.Tensor]) -> int:
    return next(iter(params.values())).shape[0]


def moe_apply(expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
              expert_params: Dict[str, torch.Tensor],
              x: torch.Tensor,
              gate_logits: torch.Tensor,
              group=None,
              capacity_factor: float = 1.25,
              num_selected: int = 1,
              normalize_gates: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run an MoE layer with one expert per rank of ``group`` (a
    ``torch.distributed`` process group; None: the whole job).
    ``expert_params``: this rank's expert, every tensor ``[1, ...]``;
    ``x`` [T, D] and ``gate_logits`` [T, E] this rank's tokens, E the
    group's size. Capacity comes from the local T. Returns ``(y, aux)``:
    y [T, D] (zero for dropped assignments: add the residual outside)
    and the local balancing loss."""
    num_experts = dist.get_world_size(group)
    if gate_logits.shape[-1] != num_experts or _leading(expert_params) != 1:
        raise ValueError(
            f"moe_apply: one expert per rank: the gate has "
            f"{gate_logits.shape[-1]} experts and this rank "
            f"{_leading(expert_params)}, for a group of {num_experts}")
    tokens, d_model = x.shape
    capacity = _capacity(tokens, num_experts, capacity_factor, num_selected)
    probs = torch.softmax(gate_logits, dim=-1)
    routing, aux = _route(probs, capacity, num_selected, normalize_gates,
                          x.dtype)
    idx = _routing_indices(routing, num_experts, capacity, tokens)
    # [E, C, D] -> every rank receives its expert's buffer from each peer,
    # [E_src, C, D], runs it, and sends each peer its rows back.
    expert_in = _alltoall_equal(
        _pack_to_experts(x, idx, num_experts, capacity), group)
    expert_out = expert_fn(expert_params,
                           expert_in.reshape(1, num_experts * capacity,
                                             d_model))
    expert_out = _alltoall_equal(
        expert_out.reshape(num_experts, capacity, -1), group)
    return _gather_from_experts(expert_out, routing, idx), aux


def moe_apply_dense(expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    stacked_params: Dict[str, torch.Tensor],
                    x: torch.Tensor,
                    gate_logits: torch.Tensor,
                    capacity_factor: float = 1.25,
                    num_selected: int = 1,
                    normalize_gates: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device twin of :func:`moe_apply`: the same routing and
    capacity drops, every expert resident, the expert axis batched."""
    num_experts = _leading(stacked_params)
    tokens = x.shape[0]
    capacity = _capacity(tokens, num_experts, capacity_factor, num_selected)
    probs = torch.softmax(gate_logits, dim=-1)
    routing, aux = _route(probs, capacity, num_selected, normalize_gates,
                          x.dtype)
    idx = _routing_indices(routing, num_experts, capacity, tokens)
    expert_in = _pack_to_experts(x, idx, num_experts, capacity)  # [E, C, D]
    expert_out = expert_fn(stacked_params, expert_in)
    return _gather_from_experts(expert_out, routing, idx), aux


__all__: List[str] = ["moe_apply", "moe_apply_dense", "switch_aux_loss"]
