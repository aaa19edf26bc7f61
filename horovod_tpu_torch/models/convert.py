"""Weights across the two packages: the JAX ``LlamaLM`` and ``MoeLM``
parameter trees, given as nested dicts of numpy arrays, into the port's
models (``llama_from_flax``, ``moe_from_flax``) and back
(``llama_to_flax``, ``moe_to_flax``, from the parameters or from their
gradients, so the two packages compare leaf by leaf).

Every leaf is mapped; a missing key, a wrong shape or a leaf nothing
maps raises. Weights land in the port's storage dtypes: with
``param_dtype=None`` dense kernels in the compute dtype (the cast flax
makes at every call, made once), with ``param_dtype=torch.float32`` all
f32 and trainable.

The model zoo (``resnet``, ``vgg``, ``inception``, ``mlp``, ``bert``,
``vit``) names its submodules as flax does, so one rule maps any of
their trees (``zoo_state_dict``, and ``resnet_from_flax`` and its
siblings, which load it): a flax module path is the state_dict prefix,
``kernel``/``scale``/``embedding`` become ``weight`` (conv kernels HWIO ->
OIHW, dense and ``DenseGeneral`` kernels flattened to (in, out) and
transposed), and the ``batch_stats`` leaves ``mean``/``var`` become
``running_mean``/``running_var``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike
from .llama import CausalLM, LlamaConfig, LlamaLM
from .moe_lm import MoeBlock, MoeConfig, MoeLM


def _flat_leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...],
                                                      np.ndarray]]:
    """(path, array) for every leaf of a nested dict."""
    for key in tree:
        if isinstance(tree[key], dict):
            yield from _flat_leaves(tree[key], prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(tree[key])


_Leaf = Tuple[torch.nn.Parameter, Tuple[str, ...], Tuple[int, ...],
              Optional[slice]]


def _mapping(model: CausalLM) -> Iterator[_Leaf]:
    """(port parameter, JAX tree path, JAX leaf shape, rows) for every
    leaf of a ``LlamaLM`` or ``MoeLM``; ``rows``: the slice of the leaf's
    dim 0 the parameter holds (an expert group's rank), else None."""
    cfg = model.config
    hd = cfg.dim // cfg.num_heads
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    yield (model.tok_embeddings, ("tok_embeddings", "embedding"),
           (cfg.vocab_size, cfg.dim), None)
    for i, block in enumerate(model.layers):
        layer = f"layer_{i}"
        attn = block.attention
        yield (block.attention_norm.scale, (layer, "attention_norm", "scale"),
               (cfg.dim,), None)
        yield (attn.wq, (layer, "attention", "wq", "kernel"),
               (cfg.dim, h, hd), None)
        yield (attn.wk, (layer, "attention", "wk", "kernel"),
               (cfg.dim, hkv, hd), None)
        yield (attn.wv, (layer, "attention", "wv", "kernel"),
               (cfg.dim, hkv, hd), None)
        yield (attn.wo, (layer, "attention", "wo", "kernel"),
               (h, hd, cfg.dim), None)
        yield (block.ffn_norm.scale, (layer, "ffn_norm", "scale"), (cfg.dim,),
               None)
        if isinstance(block, MoeBlock):
            ffn = block.moe_ffn
            e, x = cfg.num_experts, cfg.expert_hidden
            rows = None
            if ffn.expert_group is not None:
                n = ffn.wi.shape[0]
                r = torch.distributed.get_rank(ffn.expert_group)
                rows = slice(r * n, (r + 1) * n)
            yield ffn.gate, (layer, "moe_ffn", "gate"), (cfg.dim, e), None
            yield ffn.wi, (layer, "moe_ffn", "wi"), (e, cfg.dim, x), rows
            yield ffn.wo, (layer, "moe_ffn", "wo"), (e, x, cfg.dim), rows
            continue
        f = block.w_gate.shape[1]
        yield block.w_gate, (layer, "w_gate", "kernel"), (cfg.dim, f), None
        yield block.w_up, (layer, "w_up", "kernel"), (cfg.dim, f), None
        yield block.w_down, (layer, "w_down", "kernel"), (f, cfg.dim), None
    yield model.final_norm.scale, ("final_norm", "scale"), (cfg.dim,), None
    yield (model.lm_head, ("lm_head", "kernel"), (cfg.dim, cfg.vocab_size),
           None)


def _load(model: CausalLM, params_np: Dict, what: str):
    """Copy every leaf of ``params_np`` into ``model``; raise for a
    missing leaf, a wrong shape or a leaf nothing maps."""
    used = set()
    for param, path, shape, _ in _mapping(model):
        node = params_np
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(
                    f"{what}: missing parameter {'/'.join(path)}")
            node = node[key]
        arr = np.asarray(node)
        if arr.shape != shape:
            raise ValueError(
                f"{what}: {'/'.join(path)} has shape {arr.shape}, "
                f"expected {shape}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(
                np.array(arr, dtype=np.float32)).reshape(param.shape))
        used.add(path)
    extra = sorted("/".join(p) for p, _ in _flat_leaves(params_np)
                   if p not in used)
    if extra:
        raise ValueError(
            f"{what}: parameters nothing maps: {extra[:8]}"
            f"{' ...' if len(extra) > 8 else ''} (does cfg match the "
            "checkpoint?)")
    return model


def _to_flax(model: CausalLM, grads: bool) -> Dict:
    tree: Dict = {}
    for param, path, shape, rows in _mapping(model):
        if rows is not None:
            shape = tuple(param.shape)
        t = param.grad if grads else param
        if t is None:
            arr = np.zeros(shape, np.float32)
        else:
            arr = t.detach().float().cpu().numpy().reshape(shape)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def llama_from_flax(params_np: Dict, cfg: LlamaConfig,
                    device: DeviceLike = None,
                    attention_fn: Optional[Callable] = None,
                    param_dtype: Optional[torch.dtype] = None) -> LlamaLM:
    """``params_np``: ``variables["params"]`` of the JAX ``LlamaLM`` with
    numpy leaves (``jax.tree_util.tree_map(np.asarray, ...)``);
    ``cfg``: the port's config of the same model; ``attention_fn`` and
    ``param_dtype`` as for ``LlamaLM``."""
    return _load(LlamaLM(cfg, device=device, attention_fn=attention_fn,
                         param_dtype=param_dtype),
                 params_np, "llama_from_flax")


def llama_to_flax(model: LlamaLM, grads: bool = False) -> Dict:
    """The JAX ``LlamaLM`` parameter tree of ``model`` as nested dicts of
    float32 numpy arrays in the JAX shapes: the parameters, or with
    ``grads=True`` their ``.grad`` (zeros where a parameter has none,
    as ``jax.grad`` reports an unused leaf)."""
    return _to_flax(model, grads)


def moe_from_flax(params_np: Dict, cfg: MoeConfig, device: DeviceLike = None,
                  attention_fn: Optional[Callable] = None,
                  param_dtype: Optional[torch.dtype] = None) -> MoeLM:
    """As :func:`llama_from_flax` for the JAX ``MoeLM`` (dense mode):
    routed layers hold ``layer_i/moe_ffn/{gate,wi,wo}`` and
    ``layer_i/ffn_norm``, the others ``LlamaBlock``'s names."""
    return _load(MoeLM(cfg, device=device, attention_fn=attention_fn,
                       param_dtype=param_dtype),
                 params_np, "moe_from_flax")


def moe_to_flax(model: MoeLM, grads: bool = False) -> Dict:
    """As :func:`llama_to_flax` for ``MoeLM``. An expert group's rank
    gives its own rows of ``wi``/``wo`` (shape ``[1, ...]``)."""
    return _to_flax(model, grads)


# ---------------------------------------------------------------------------
# The model zoo

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight",
                 "embedding": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _kernel(arr: np.ndarray, shape: torch.Size, name: str) -> np.ndarray:
    """A flax kernel in the port's layout: conv HWIO -> OIHW; dense
    (in, out) and ``DenseGeneral`` (in..., out...) -> (out, in)."""
    if arr.ndim == 4:
        out = arr.transpose(3, 2, 0, 1)
    else:
        n_out, n_in = shape
        splits = np.cumprod(arr.shape)[:-1]
        if n_in not in splits or arr.size != n_in * n_out:
            raise ValueError(
                f"zoo_state_dict: {name} has a kernel of shape {arr.shape}, "
                f"which does not flatten to (in={n_in}, out={n_out})")
        out = arr.reshape(n_in, n_out).T
    if out.shape != tuple(shape):
        raise ValueError(f"zoo_state_dict: {name} has shape {out.shape} "
                         f"after conversion, expected {tuple(shape)}")
    return out


def zoo_state_dict(model: torch.nn.Module, params: Dict,
                   batch_stats: Optional[Dict] = None
                   ) -> Dict[str, torch.Tensor]:
    """The port's state_dict entries for a flax zoo model's ``params``
    (or gradients of the same tree) and ``batch_stats``, as nested dicts
    of numpy arrays, in ``model``'s layouts (float32, on the CPU). Raises
    for a leaf the model does not have or a shape that does not fit."""
    target = model.state_dict()
    out = {}
    leaves = [(path, arr, _PARAM_LEAVES) for path, arr in
              _flat_leaves(params)]
    leaves += [(path, arr, _STAT_LEAVES) for path, arr in
               _flat_leaves(batch_stats or {})]
    for path, arr, names in leaves:
        name = ".".join(path[:-1] + (names.get(path[-1], path[-1]),))
        if name not in target:
            raise ValueError(f"zoo_state_dict: flax leaf {'/'.join(path)} "
                             f"has no counterpart {name!r} in the model")
        shape = target[name].shape
        if path[-1] == "kernel":
            arr = _kernel(arr, shape, name)
        elif arr.size != target[name].numel():
            raise ValueError(f"zoo_state_dict: {name} has {arr.size} "
                             f"values, expected {tuple(shape)}")
        out[name] = torch.from_numpy(
            np.array(arr, dtype=np.float32).reshape(shape))
    return out


def zoo_from_flax(model: torch.nn.Module, params: Dict,
                  batch_stats: Optional[Dict] = None) -> torch.nn.Module:
    """Load a flax zoo model's ``params`` and ``batch_stats`` (numpy
    trees: ``jax.tree_util.tree_map(np.asarray, variables[...])``) into
    the port's ``model`` of the same configuration; every parameter and
    statistic must be given. Returns ``model``."""
    model.load_state_dict(zoo_state_dict(model, params, batch_stats))
    return model


resnet_from_flax = zoo_from_flax
vgg_from_flax = zoo_from_flax
inception_from_flax = zoo_from_flax
mlp_from_flax = zoo_from_flax
bert_from_flax = zoo_from_flax
vit_from_flax = zoo_from_flax
