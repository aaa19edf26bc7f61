"""Plain attention in torch: the counterpart of ``NEG_INF``,
``repeat_kv`` and ``reference_attention`` in
``horovod_tpu/ops/attention.py``. The no-cache ``LlamaLM`` forward runs
on these. The flash kernels of that module (forward and its two
backward kernels) belong to the training slice and are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _check_gqa_heads(q, k, v, name: str) -> None:
    if (v.shape[2] != k.shape[2]) or (q.shape[2] % k.shape[2]):
        raise ValueError(
            f"{name}: query heads ({q.shape[2]}) must be a multiple of "
            f"K/V heads ({k.shape[2]}, v {v.shape[2]}) — grouped-query "
            "attention folds each group of H/Hkv query heads onto one "
            "K/V head")


def repeat_kv(q, k, v):
    """Repeat grouped K/V heads (dim 2) up to q's head count: query head
    h reads K/V head h // group (group-contiguous, as in the JAX
    package)."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def reference_attention(q, k, v, key_mask=None, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Plain attention. q (B, Sq, H, D); k/v (B, Sk, Hkv, D) with
    H % Hkv == 0; key_mask (B, Sk) bool. Logits and softmax in f32, the
    probabilities cast to q's dtype before P·V; causal uses the decode
    convention (query row i attends keys <= i + Sk - Sq)."""
    d = q.shape[-1]
    _check_gqa_heads(q, k, v, "reference_attention")
    k, v = repeat_kv(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(ki <= qi)[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
