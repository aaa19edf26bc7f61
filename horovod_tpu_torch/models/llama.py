"""Decoder-only transformer LM (Llama-style: RMSNorm, rotary embeddings,
SwiGLU, grouped-query attention) — ``horovod_tpu/models/llama.py`` in
PyTorch: the serving and training slices.

``LlamaLM`` is an ``nn.Module`` that owns its weights; dense weights keep
the JAX kernels' ``(in, out)`` layout. Two storages, chosen by
``param_dtype`` (flax's argument of that name):

* ``param_dtype=None`` (serving): dense weights stored in the compute
  dtype, no gradients. flax's ``Dense(dtype=bf16, param_dtype=f32)``
  casts its f32 kernel to bf16 at every call; casting once at load gives
  the same values and the decode step no cast launches.
* ``param_dtype=torch.float32`` (training): every parameter f32 and
  trainable, cast to the compute dtype at each use, as flax does — the
  gradients and the optimizer update run on f32, as in the JAX package.

Norm scales and the embedding table are f32 in both.

Numerics mirrored from the JAX module: RMSNorm is an all-f32 chain then
a cast; RoPE angles are f32 and applied in the activation dtype; the
embedding is gathered in f32 then cast; the cache einsums run softmax in
f32 with ``finfo(f32).min`` masking and cast the probabilities to q's
dtype. Single-token cached attention runs the hand-written decode
kernels (``ops.decode_attention``) unless ``decode_kernel_disabled()``.

Training: the ``attention_fn`` seam (``ops.attention.make_attention_fn``
plugs the flash kernels in; K/V are repeated only for fns without
``supports_gqa``), ``LlamaConfig.remat`` (``torch.utils.checkpoint`` per
block), ``return_hidden``, and the losses ``token_nll``,
``causal_lm_loss`` and ``chunked_causal_lm_loss``.

Ported here: the single-device decode paths (paged, contiguous kernel,
prefill at index 0, general einsum), ``generate`` and the training
surface above. The TP paths (``kernel_tp``, ``sharded_*``) and the
sequence-parallel loss wait for later slices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import DeviceLike, default_device
from ..ops.attention import reference_attention, repeat_kv
from ..ops.decode_attention import (
    decode_attention,
    paged_cache_write,
    paged_decode_attention,
    paged_gather_attention,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    ffn_hidden: int = 14336
    rope_theta: float = 500000.0
    max_seq_len: int = 8192
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # lm_head compute dtype; None = model dtype.
    head_dtype: Optional[torch.dtype] = None
    # Recompute each block's activations in the backward pass
    # (torch.utils.checkpoint): live activations drop from O(layers) to
    # O(1) layers' worth for ~1/3 extra FLOPs.
    remat: bool = False


LLAMA_8B = LlamaConfig()
LLAMA_1B = LlamaConfig(dim=2048, num_layers=16, num_heads=32, num_kv_heads=8,
                       ffn_hidden=8192)
LLAMA_300M = LlamaConfig(vocab_size=32000, dim=1024, num_layers=16,
                         num_heads=16, num_kv_heads=8, ffn_hidden=4096)
LLAMA_TINY = LlamaConfig(vocab_size=512, dim=64, num_layers=2, num_heads=4,
                         num_kv_heads=2, ffn_hidden=128, max_seq_len=256)


def _param(shape, dtype, std: Optional[float], generator,
           param_dtype: Optional[torch.dtype] = None):
    """A parameter drawn from N(0, std^2) on the CPU generator (so a seed
    gives the same weights on every device), or ones when std is None.
    Stored in ``param_dtype`` and trainable when one is given (training),
    else in ``dtype`` without gradients (serving)."""
    if std is None:
        data = torch.ones(shape, dtype=torch.float32)
    else:
        data = torch.randn(shape, generator=generator) * std
    return nn.Parameter(data.to(param_dtype or dtype),
                        requires_grad=param_dtype is not None)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = _param((dim,), torch.float32, None, None, param_dtype)

    def forward(self, x):
        # All-f32 chain, then the cast (llama.py RMSNorm).
        x32 = x.float()
        norm = x32 * torch.reciprocal(
            torch.sqrt(torch.mean(x32 ** 2, dim=-1, keepdim=True)
                       + self.eps))
        return (norm * self.scale).to(self.dtype)


@functools.lru_cache(maxsize=32)
def _rope_freqs(theta: float, half: int, device: torch.device):
    """RoPE inverse frequencies, computed in numpy float32 exactly as the
    JAX package does, copied to ``device`` once per (theta, half, device)
    — a host-to-device copy per call would stall the decode step on the
    card."""
    return torch.from_numpy(
        1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    ).to(device)


def rotary_embedding(x, theta: float, positions=None):
    """Apply RoPE to (B, S, H, D). ``positions``: None (0..S-1), (S,) for
    every row alike, or (B, S) per sequence (serving decode batches mix
    positions). Angles, cos and sin in f32; the rotation applies in the
    activation dtype."""
    b, s, h, d = x.shape
    half = d // 2
    freqs = _rope_freqs(float(theta), half, x.device)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    angles = positions.float()[..., :, None] * freqs
    if angles.ndim == 2:                               # (S, half)
        cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
        sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    else:                                              # (B, S, half)
        cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
        sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# Switch for the hand-written decode kernels, per thread. Default on;
# within ``decode_kernel_disabled()`` single-token cached attention takes
# the plain einsum path instead. Per thread because serving replicas run
# their loops side by side in one process: a process-wide switch that each
# context saves and restores lets one thread restore a value over
# another's, and leaves every later engine on a path nobody chose (the
# JAX package passes the path as a static argument of the compiled
# program instead).
_SWITCH = threading.local()


def _decode_kernel_on() -> bool:
    return getattr(_SWITCH, "kernel", True)


@contextlib.contextmanager
def decode_kernel_disabled():
    """Within this context (in this thread), single-token cached
    attention uses the plain einsum path instead of the CUDA decode
    kernels."""
    with _decode_kernel_override(False):
        yield


@contextlib.contextmanager
def _decode_kernel_override(value: bool):
    prev = _decode_kernel_on()
    _SWITCH.kernel = value
    try:
        yield
    finally:
        _SWITCH.kernel = prev


@dataclasses.dataclass(frozen=True)
class DecodePath:
    """Which single-token decode path ran, and why: ``"kernel"`` (the
    hand-written decode kernels) or ``"einsum"`` (plain torch)."""

    path: str
    reason: str


def current_decode_path() -> DecodePath:
    if _decode_kernel_on():
        return DecodePath("kernel", "single device: decode kernels")
    return DecodePath("einsum", "decode_kernel_disabled()")


def decode_path_context(path: str):
    """The path -> context switch shared by ``generate`` and the serving
    engine: run under exactly the verdict that was recorded."""
    return _decode_kernel_override(path == "kernel")


#: Last :class:`DecodePath` chosen by :func:`generate` (None before any
#: call). Read-only attribution for harnesses; not used for dispatch.
LAST_DECODE_PATH: Optional[DecodePath] = None


def _cached_attention(q, k, v, cache, cache_index):
    """Decode-mode attention: write the s new K/V rows at ``cache_index``
    (in place) and attend every query (global position
    ``cache_index + i``) over keys at positions <= it. Returns ctx
    (B, S, H, D).

    Four paths, one semantics: the paged cache (``"tables"`` in the
    cache; ``cache_index`` a (B,) tensor) runs the paged kernel or the
    gather einsum; a contiguous single-token step runs the decode kernel;
    prefill at index 0 attends over the fresh rows only; anything else
    (warm prefill at a nonzero index, or the kernel disabled) runs the
    masked einsum over the whole window."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    kc = k.to(cache["k"].dtype)
    vc = v.to(cache["v"].dtype)
    scale = 1.0 / math.sqrt(d)
    f32_min = torch.finfo(torch.float32).min
    if "tables" in cache:
        if s != 1:
            raise ValueError(
                f"paged cache is single-token decode only (s={s})")
        tables = cache["tables"]
        paged_cache_write(cache["k"], cache["v"], kc, vc, tables,
                          cache_index)
        if _decode_kernel_on():
            return paged_decode_attention(q, cache["k"], cache["v"], tables,
                                          cache_index, hkv, sm_scale=scale)
        return paged_gather_attention(q, cache["k"], cache["v"], tables,
                                      cache_index, hkv, sm_scale=scale)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, cache_index:cache_index + s] = kc.reshape(b, s, hkv * d)
    v_cache[:, cache_index:cache_index + s] = vc.reshape(b, s, hkv * d)
    if s == 1 and _decode_kernel_on():
        return decode_attention(q, k_cache, v_cache, cache_index, hkv,
                                sm_scale=scale)
    qg = q.reshape(b, s, hkv, group, d)
    if s > 1 and isinstance(cache_index, int) and cache_index == 0:
        # Prefill at index 0: attend over the cache-dtype fresh rows.
        logits = torch.einsum("bshgd,blhd->bshgl", qg, kc).float() * scale
        pos = torch.arange(s, device=q.device)
        causal = pos[None, :] <= pos[:, None]
        logits = logits.masked_fill(~causal[None, :, None, None, :], f32_min)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        ctx = torch.einsum("bshgl,blhd->bshgd", probs, vc)
        return ctx.reshape(b, s, h, d)
    window = k_cache.shape[1]
    k4 = k_cache.view(b, window, hkv, d)
    v4 = v_cache.view(b, window, hkv, d)
    logits = torch.einsum("bshgd,blhd->bshgl", qg, k4).float() * scale
    q_pos = cache_index + torch.arange(s, device=q.device)
    key_pos = torch.arange(window, device=q.device)
    mask = key_pos[None, :] <= q_pos[:, None]              # (s, window)
    logits = logits.masked_fill(~mask[None, :, None, None, :], f32_min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bshgl,blhd->bshgd", probs, v4).reshape(b, s, h, d)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, generator,
                 attention_fn: Optional[Callable] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = cfg
        self.attention_fn = attention_fn
        head_dim = cfg.dim // cfg.num_heads
        std = cfg.dim ** -0.5
        self.wq = _param((cfg.dim, cfg.num_heads * head_dim), cfg.dtype, std,
                         generator, param_dtype)
        self.wk = _param((cfg.dim, cfg.num_kv_heads * head_dim), cfg.dtype,
                         std, generator, param_dtype)
        self.wv = _param((cfg.dim, cfg.num_kv_heads * head_dim), cfg.dtype,
                         std, generator, param_dtype)
        self.wo = _param((cfg.num_heads * head_dim, cfg.dim), cfg.dtype,
                         (cfg.num_heads * head_dim) ** -0.5, generator,
                         param_dtype)

    def forward(self, x, positions=None, cache=None, cache_index=None):
        """``cache``/``cache_index``: decoding mode (see
        :func:`init_kv_cache`); the cache is updated in place."""
        cfg = self.config
        b, s, _ = x.shape
        hd = cfg.dim // cfg.num_heads
        dt = cfg.dtype
        q = rotary_embedding(
            (x @ self.wq.to(dt)).view(b, s, cfg.num_heads, hd),
            cfg.rope_theta, positions)
        k = rotary_embedding(
            (x @ self.wk.to(dt)).view(b, s, cfg.num_kv_heads, hd),
            cfg.rope_theta, positions)
        v = (x @ self.wv.to(dt)).view(b, s, cfg.num_kv_heads, hd)
        if cache is not None:
            ctx = _cached_attention(q, k, v, cache, cache_index)
        else:
            fn = self.attention_fn
            if fn is not None and not getattr(fn, "supports_gqa", False):
                k, v = repeat_kv(q, k, v)
            if fn is not None:
                ctx = fn(q, k, v, None)
            else:
                ctx = reference_attention(q, k, v, causal=True)
        return ctx.reshape(b, s, cfg.num_heads * hd) @ self.wo.to(dt)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, generator,
                 attention_fn: Optional[Callable] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = cfg.dtype
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                      param_dtype)
        self.attention = LlamaAttention(cfg, generator, attention_fn,
                                        param_dtype)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                param_dtype)
        self.w_gate = _param((cfg.dim, cfg.ffn_hidden), cfg.dtype,
                             cfg.dim ** -0.5, generator, param_dtype)
        self.w_up = _param((cfg.dim, cfg.ffn_hidden), cfg.dtype,
                           cfg.dim ** -0.5, generator, param_dtype)
        self.w_down = _param((cfg.ffn_hidden, cfg.dim), cfg.dtype,
                             cfg.ffn_hidden ** -0.5, generator, param_dtype)

    def forward(self, x, positions=None, cache=None, cache_index=None):
        x = x + self.attention(self.attention_norm(x), positions, cache,
                               cache_index)
        h = self.ffn_norm(x)
        dt = self.dtype
        gated = F.silu(h @ self.w_gate.to(dt)) * (h @ self.w_up.to(dt))
        return x + gated @ self.w_down.to(dt)


class LlamaLM(nn.Module):
    """Causal LM: embeddings + blocks + untied output head, owning its
    weights (random from ``seed`` on a CPU generator; load real ones with
    ``models.convert.llama_from_flax``). ``device=None`` means CUDA and
    raises without a card. ``attention_fn``: the no-cache attention, as
    in the JAX package (None = ``reference_attention``, causal).
    ``param_dtype``: None for serving storage, ``torch.float32`` to
    train (see the module doc)."""

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 seed: int = 0, attention_fn: Optional[Callable] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        device = default_device(device)
        self.config = cfg = config
        gen = torch.Generator().manual_seed(seed)
        self.tok_embeddings = _param((cfg.vocab_size, cfg.dim),
                                     torch.float32, cfg.dim ** -0.5, gen,
                                     param_dtype)
        self.layers = nn.ModuleList(
            [LlamaBlock(cfg, gen, attention_fn, param_dtype)
             for _ in range(cfg.num_layers)])
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                  param_dtype)
        self.lm_head = _param((cfg.dim, cfg.vocab_size),
                              cfg.head_dtype or cfg.dtype, cfg.dim ** -0.5,
                              gen, param_dtype)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.tok_embeddings.device

    def forward(self, input_ids, positions=None, cache=None,
                cache_index=None, return_hidden: bool = False):
        """``input_ids`` (B, S). ``positions``: global token positions,
        default 0..S-1, or ``cache_index + 0..S-1`` in decoding mode
        (``cache_index`` an int, or a (B,) tensor of per-sequence
        positions for the paged cache). Returns logits, or
        ``(logits, cache)`` when a cache is given (updated in place).
        ``return_hidden``: skip the lm_head and return the final-norm
        hidden states (B, S, dim), for :func:`chunked_causal_lm_loss`."""
        cfg = self.config
        if cache is not None and positions is None:
            steps = torch.arange(input_ids.shape[1], device=input_ids.device)
            if torch.is_tensor(cache_index) and cache_index.ndim:
                positions = cache_index[:, None] + steps
            else:
                positions = int(cache_index) + steps
        x = F.embedding(input_ids, self.tok_embeddings).to(cfg.dtype)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint(layer, x, positions, use_reentrant=False)
            else:
                x = layer(x, positions,
                          None if cache is None else cache[f"layer_{i}"],
                          cache_index)
        x = self.final_norm(x)
        if return_hidden:
            return x
        head = cfg.head_dtype or cfg.dtype
        logits = x.to(head) @ self.lm_head.to(head)
        return logits if cache is None else (logits, cache)


def init_kv_cache(cfg: LlamaConfig, batch_size: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None):
    """Per-layer K/V cache for decoding:
    ``{layer_i: {"k"/"v": (B, max_len, num_kv_heads * head_dim)}}``, each
    position's GQA heads stored ROW-FLAT (the decode kernel's layout).
    Windows above 1024 round up to a multiple of 128, as in the JAX
    package, so both hold the same window."""
    dtype = dtype or cfg.dtype
    device = default_device(device)
    head_dim = cfg.dim // cfg.num_heads
    if max_len > 1024:
        max_len = (max_len + 127) // 128 * 128
    shape = (batch_size, max_len, cfg.num_kv_heads * head_dim)
    return {
        f"layer_{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}
        for i in range(cfg.num_layers)
    }


def pick_tokens(logits, temperature: float, generator):
    """Greedy argmax at temperature 0, else a draw from
    softmax(logits / temperature) with ``generator``."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(model: LlamaLM, prompt_ids, max_new_tokens: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None):
    """Autoregressive decoding with the KV cache: prefill the prompt in
    one call, then single-token steps in a Python loop (the JAX
    package's ``lax.scan``). ``temperature`` 0.0 = greedy argmax;
    > 0 samples with ``generator`` (a ``torch.Generator`` on the model's
    device). Returns ``(B, prompt + max_new_tokens)`` int64 ids, prompt
    included, on the model's device."""
    global LAST_DECODE_PATH
    cfg = model.config
    device = model.device
    prompt = torch.as_tensor(prompt_ids, device=device).long()
    b, s = prompt.shape
    if max_len is None:
        max_len = min(cfg.max_seq_len, s + max_new_tokens)
    if s + max_new_tokens > max_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"cache window max_len={max_len}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    if max_new_tokens <= 0:
        return prompt
    LAST_DECODE_PATH = current_decode_path()
    with torch.inference_mode():
        cache = init_kv_cache(cfg, b, max_len, device=device)
        logits, cache = model(prompt, cache=cache, cache_index=0)
        token = pick_tokens(logits[:, -1], temperature, generator)
        new = [token]
        for i in range(max_new_tokens - 1):
            logits, cache = model(token[:, None], cache=cache,
                                  cache_index=s + i)
            token = pick_tokens(logits[:, -1], temperature, generator)
            new.append(token)
        return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)


def token_nll(logits, targets):
    """Per-token negative log-likelihood, ``lse(logits) - logits[target]``:
    the target logit is gathered before the f32 upcast, the logsumexp
    runs in f32."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    target_logit = torch.gather(logits, -1, targets[..., None].long())[
        ..., 0].float()
    return lse - target_logit


def causal_lm_loss(logits, input_ids):
    """Next-token cross entropy (shifted)."""
    return token_nll(logits[:, :-1], input_ids[:, 1:]).mean()


def chunked_causal_lm_loss(hidden, head_kernel, input_ids,
                           num_chunks: int = 8):
    """:func:`causal_lm_loss` with the lm_head fused in, one sequence
    chunk at a time under ``torch.utils.checkpoint``: the (B, S, V) logits
    and their gradient never exist whole. ``hidden``: ``model(ids,
    return_hidden=True)``; ``head_kernel``: ``model.lm_head`` (dim, V),
    cast to the hidden dtype."""
    b, s, _ = hidden.shape
    if s % num_chunks:
        raise ValueError(
            f"chunked_causal_lm_loss: seq len {s} must be divisible by "
            f"num_chunks {num_chunks}")
    c = s // num_chunks
    # Shifted targets over the full sequence; the last position wraps to
    # a garbage target and is dropped below.
    targets = torch.cat([input_ids[:, 1:], input_ids[:, :1]], dim=1)
    w = head_kernel.to(hidden.dtype)

    def chunk_nll(h_c, t_c):
        return token_nll(h_c @ w, t_c)

    nll = torch.cat([
        checkpoint(chunk_nll, hidden[:, i * c:(i + 1) * c],
                   targets[:, i * c:(i + 1) * c], use_reentrant=False)
        for i in range(num_chunks)], dim=1)
    return nll[:, :-1].mean()
