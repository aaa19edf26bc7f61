"""Mixture-of-experts transformer LM — the counterpart of
``horovod_tpu/models/moe_lm.py``: the Llama-style LM with a top-k routed
feed-forward on every ``moe_every``-th layer, over ``parallel.moe``.

- ``expert_group=None`` (default): every expert is resident and dispatch
  runs densely (``moe_apply_dense``): one card, tests, eval.
- ``expert_group=<process group>``, ``local_experts=1``: each rank of
  the group holds one expert (``wi``/``wo`` of shape ``[1, ...]``) and
  tokens ride ``alltoall`` (``moe_apply``). The routing, and so the
  numerics, is the same in both modes.

Numerics mirrored from the JAX module: the router runs in float32
(``tokens.float() @ gate`` with a float32 gate) in every dtype; the
expert weights ``wi``/``wo`` are float32 parameters cast to the compute
dtype at use (in serving storage, ``param_dtype=None``, they are stored
cast once, as ``LlamaLM``'s dense weights are); decoding runs the
experts at no-drop capacity (capacity factor E/k), so a single-token
step drops nothing a full forward would keep.

Auxiliary (load-balancing) losses come back explicitly: ``forward(...,
return_aux=True)`` returns ``(result, aux_sum)``, the sum over routed
layers, float32. No module state holds them (flax's ``sow`` has no
counterpart). Dense layers are ``LlamaBlock``s; both kinds share
``attention_sublayer``, so the cache protocol and the attention
parameters' names are one. ``generate`` and the serving engine take
``MoeLM`` as they take ``LlamaLM``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, default_device
from ..common.profiler import named_scope
from ..parallel.moe import moe_apply, moe_apply_dense
from .llama import (CausalLM, LlamaBlock, LlamaConfig, RMSNorm, _param,
                    attention_sublayer, init_attention_sublayer)


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    vocab_size: int = 32000
    dim: int = 2048
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    ffn_hidden: int = 5632
    num_experts: int = 8
    expert_hidden: int = 5632
    num_selected: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 2           # every moe_every-th layer is routed
    norm_eps: float = 1e-5
    rope_theta: float = 1e4
    dtype: torch.dtype = torch.bfloat16
    # lm_head compute dtype; None = model dtype.
    head_dtype: Optional[torch.dtype] = None
    # Recompute each block's activations in the backward pass.
    remat: bool = False

    def llama(self) -> LlamaConfig:
        """The dense layers' config (no ``max_seq_len`` is declared by
        this model: RoPE-only positions)."""
        return LlamaConfig(
            vocab_size=self.vocab_size, dim=self.dim,
            num_layers=self.num_layers, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, ffn_hidden=self.ffn_hidden,
            norm_eps=self.norm_eps, rope_theta=self.rope_theta,
            dtype=self.dtype, head_dtype=self.head_dtype)

    def routed(self, layer: int) -> bool:
        """Whether layer ``layer`` has the routed feed-forward."""
        return layer % self.moe_every == self.moe_every - 1


MOE_TINY = MoeConfig(vocab_size=512, dim=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, ffn_hidden=128, num_experts=4,
                     expert_hidden=128, moe_every=2)
# 249.7M parameters (151M routed across 8 experts + 98.7M dense): the
# single-card MoE config (top-2 of 8 experts, every other layer routed).
MOE_SMALL = MoeConfig(vocab_size=32000, dim=768, num_layers=12,
                      num_heads=12, num_kv_heads=6, ffn_hidden=2048,
                      num_experts=8, expert_hidden=2048, moe_every=2)


class MoeFFN(nn.Module):
    """Top-k routed feed-forward: gate -> dispatch -> per-expert SiLU MLP
    -> combine. ``wi``/``wo`` carry a leading expert axis: every
    expert in dense mode, ``local_experts`` under ``expert_group``."""

    def __init__(self, cfg: MoeConfig, generator, expert_group=None,
                 local_experts: Optional[int] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = cfg
        self.expert_group = expert_group
        d, hidden, e = cfg.dim, cfg.expert_hidden, cfg.num_experts
        self.gate = _param((d, e), torch.float32, 0.02, generator,
                           param_dtype)
        # Every expert is drawn, so that a seed gives the dense model's
        # weights in both modes; a rank of an expert group keeps its own.
        self.wi = _param((e, d, hidden), cfg.dtype, d ** -0.5, generator,
                         param_dtype)
        self.wo = _param((e, hidden, d), cfg.dtype, hidden ** -0.5,
                         generator, param_dtype)
        if expert_group is not None:
            rows = slice(dist.get_rank(expert_group) * local_experts,
                         (dist.get_rank(expert_group) + 1) * local_experts)
            self.wi = nn.Parameter(self.wi.data[rows].clone(),
                                   requires_grad=self.wi.requires_grad)
            self.wo = nn.Parameter(self.wo.data[rows].clone(),
                                   requires_grad=self.wo.requires_grad)

    def forward(self, x, no_drop: bool = False):
        """``x`` (B, S, D) -> ``(y (B, S, D), aux)``. ``no_drop``: capacity
        for the all-tokens-to-one-expert worst case (decoding)."""
        cfg = self.config
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        # Router in float32 (Switch: routing is precision-sensitive).
        with named_scope("router"):
            logits = tokens.float() @ self.gate.float()
        dt = cfg.dtype

        def expert_fn(p, t):
            h = F.silu(torch.bmm(t, p["wi"].to(dt)))
            return torch.bmm(h, p["wo"].to(dt))

        kwargs = dict(
            capacity_factor=(cfg.num_experts / cfg.num_selected if no_drop
                             else cfg.capacity_factor),
            num_selected=cfg.num_selected)
        experts = {"wi": self.wi, "wo": self.wo}
        if self.expert_group is None:
            y, aux = moe_apply_dense(expert_fn, experts, tokens.to(dt),
                                     logits, **kwargs)
        else:
            y, aux = moe_apply(expert_fn, experts, tokens.to(dt), logits,
                               group=self.expert_group, **kwargs)
        return y.reshape(b, s, d), aux


class MoeBlock(nn.Module):
    """Transformer block with a routed FFN (dense layers are
    ``LlamaBlock``s). Returns ``(x, aux)``."""

    def __init__(self, cfg: MoeConfig, generator,
                 attention_fn: Optional[Callable] = None,
                 param_dtype: Optional[torch.dtype] = None,
                 expert_group=None, local_experts: Optional[int] = None):
        super().__init__()
        init_attention_sublayer(self, cfg.llama(), generator, attention_fn,
                                param_dtype)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                param_dtype)
        self.moe_ffn = MoeFFN(cfg, generator, expert_group, local_experts,
                              param_dtype)

    def forward(self, x, positions=None, cache=None, cache_index=None):
        x = attention_sublayer(self, x, positions, cache, cache_index)
        # Decoding runs the experts at no-drop capacity: a training-time
        # capacity drop depends on the per-call token pool, and a
        # single-token step's pool would bind differently.
        with named_scope("ffn_norm"):
            h = self.ffn_norm(x)
        with named_scope("moe_ffn"):
            y, aux = self.moe_ffn(h, no_drop=cache is not None)
        return x + y, aux


class MoeLM(CausalLM):
    """Causal MoE LM with ``LlamaLM``'s call contract (``device``,
    ``seed``, ``attention_fn``, ``param_dtype`` as there), plus
    ``return_aux``. For expert parallelism give ``expert_group`` (a
    process group whose size is ``num_experts``) and ``local_experts=1``:
    rank r of the group holds expert r of the dense model the same seed
    draws."""

    def __init__(self, config: MoeConfig, device: DeviceLike = None,
                 seed: int = 0, attention_fn: Optional[Callable] = None,
                 param_dtype: Optional[torch.dtype] = None,
                 expert_group=None, local_experts: Optional[int] = None):
        super().__init__()
        device = default_device(device)
        if expert_group is not None:
            size = (dist.get_world_size(expert_group) if local_experts == 1
                    else None)
            if size != config.num_experts:
                raise ValueError(
                    "MoeLM: expert parallelism holds one expert per rank: "
                    f"local_experts must be 1 (got {local_experts}) and "
                    f"the group's size num_experts={config.num_experts} "
                    f"(got {size})")
        self.config = cfg = config
        self.expert_group = expert_group
        gen = torch.Generator().manual_seed(seed)
        self._init_embedding(cfg, gen, param_dtype)
        layers = []
        for i in range(cfg.num_layers):
            if cfg.routed(i):
                layers.append(MoeBlock(cfg, gen, attention_fn, param_dtype,
                                       expert_group, local_experts))
            else:
                layers.append(LlamaBlock(cfg.llama(), gen, attention_fn,
                                         param_dtype))
        self.layers = nn.ModuleList(layers)
        self._init_head(cfg, gen, param_dtype)
        self.to(device)

    def forward(self, input_ids, positions=None, cache=None,
                cache_index=None, return_hidden: bool = False,
                return_aux: bool = False):
        """As ``LlamaLM.forward``; with ``return_aux`` the result comes as
        ``(result, aux_sum)``, the balancing losses of every routed layer
        summed (float32). Fold ``aux_sum * aux_weight`` into the
        objective."""
        result, aux = self._forward(input_ids, positions, cache,
                                    cache_index, return_hidden)
        if not return_aux:
            return result
        total = sum(aux) if aux else torch.zeros((), device=self.device)
        return result, total
