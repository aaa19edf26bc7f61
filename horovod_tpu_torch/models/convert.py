"""Weights across the two packages: the JAX ``LlamaLM`` parameter tree,
given as nested dicts of numpy arrays, into the port's ``LlamaLM``.

Every leaf is mapped; a missing key, a wrong shape or a leaf nothing
maps raises. Weights land in the port's storage dtypes (dense kernels
in the compute dtype — the cast flax makes at every call, made once).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import DeviceLike
from .llama import LlamaConfig, LlamaLM


def _leaves(tree, prefix=()) -> List[Tuple[str, ...]]:
    if isinstance(tree, dict):
        out = []
        for key in tree:
            out.extend(_leaves(tree[key], prefix + (str(key),)))
        return out
    return [prefix]


def llama_from_flax(params_np: Dict, cfg: LlamaConfig,
                    device: DeviceLike = None) -> LlamaLM:
    """``params_np``: ``variables["params"]`` of the JAX ``LlamaLM`` with
    numpy leaves (``jax.tree_util.tree_map(np.asarray, ...)``);
    ``cfg``: the port's config of the same model."""
    model = LlamaLM(cfg, device=device)
    hd = cfg.dim // cfg.num_heads
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    used = set()

    def put(param: torch.nn.Parameter, path: Tuple[str, ...],
            shape: Tuple[int, ...]) -> None:
        node = params_np
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(
                    f"llama_from_flax: missing parameter {'/'.join(path)}")
            node = node[key]
        arr = np.asarray(node)
        if arr.shape != shape:
            raise ValueError(
                f"llama_from_flax: {'/'.join(path)} has shape {arr.shape}, "
                f"expected {shape}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(
                np.array(arr, dtype=np.float32)).reshape(param.shape))
        used.add(path)

    put(model.tok_embeddings, ("tok_embeddings", "embedding"),
        (cfg.vocab_size, cfg.dim))
    for i, block in enumerate(model.layers):
        layer = f"layer_{i}"
        attn = block.attention
        put(block.attention_norm.scale, (layer, "attention_norm", "scale"),
            (cfg.dim,))
        put(attn.wq, (layer, "attention", "wq", "kernel"), (cfg.dim, h, hd))
        put(attn.wk, (layer, "attention", "wk", "kernel"),
            (cfg.dim, hkv, hd))
        put(attn.wv, (layer, "attention", "wv", "kernel"),
            (cfg.dim, hkv, hd))
        put(attn.wo, (layer, "attention", "wo", "kernel"), (h, hd, cfg.dim))
        put(block.ffn_norm.scale, (layer, "ffn_norm", "scale"), (cfg.dim,))
        put(block.w_gate, (layer, "w_gate", "kernel"),
            (cfg.dim, cfg.ffn_hidden))
        put(block.w_up, (layer, "w_up", "kernel"), (cfg.dim, cfg.ffn_hidden))
        put(block.w_down, (layer, "w_down", "kernel"),
            (cfg.ffn_hidden, cfg.dim))
    put(model.final_norm.scale, ("final_norm", "scale"), (cfg.dim,))
    put(model.lm_head, ("lm_head", "kernel"), (cfg.dim, cfg.vocab_size))
    extra = sorted("/".join(p) for p in _leaves(params_np)
                   if p not in used)
    if extra:
        raise ValueError(
            f"llama_from_flax: parameters nothing maps: {extra[:8]}"
            f"{' ...' if len(extra) > 8 else ''} (does cfg match the "
            "checkpoint?)")
    return model
