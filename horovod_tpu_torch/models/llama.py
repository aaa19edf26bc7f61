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

Ported here: the decode paths (paged, contiguous kernel, prefill at
index 0, general einsum, and ``kernel_tp``), ``generate`` (for any
``CausalLM``: ``LlamaLM`` and ``models.moe_lm.MoeLM``),
``attention_sublayer`` (the one cache protocol of both models' blocks),
the training surface above and the sequence-parallel loss
``sp_causal_lm_loss``.

Tensor parallelism (the counterpart of ``llama_tp_param_specs``):
``LlamaLM(cfg, mesh=m, tp_axis="model")`` draws the full weights from
the seed, as the unsharded model does, and keeps this rank's share on
the ``model`` axis of ``m`` — its query and K/V heads of ``wq``/``wk``/
``wv`` and rows of ``wo``, its slice of the FFN hidden width, and its
vocabulary slice of ``tok_embeddings`` (masked lookup, then a sum over
the axis) and of ``lm_head`` (logits gathered along the vocabulary).
One allreduce follows attention and one follows the FFN (Megatron's
column -> row pairing); the identity-forward / sum-backward at the
entry of each sharded sublayer keeps the gradients of the replicated
stream whole. Where the K/V heads do not split evenly, attention stays
replicated and only the FFN and vocabulary shard; the decode-path
classifier then says ``"einsum"``, as the JAX one does for an uneven
head split. ``classify_decode_sharding`` reads the verdict from the
model's mesh, the port's counterpart of reading the variables'
shardings.
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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import DeviceLike, default_device
from ..common.profiler import named_scope
from ..ops.attention import reference_attention, repeat_kv
from ..ops.decode_attention import (
    decode_attention,
    paged_cache_write,
    paged_decode_attention,
    paged_gather_attention,
)
from ..parallel.exchange import (
    group_copy,
    group_gather_last,
    group_sum,
    ring_exchange,
)
from ..parallel.mesh import group_rank, group_size


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


# ---------------------------------------------------------------------------
# Tensor parallelism


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """A model's tensor-parallel axis: ``axis`` of ``mesh``, with this
    rank's ``group`` along it, its ``size`` and this rank's ``rank``."""

    mesh: object
    axis: str

    @property
    def group(self):
        return self.mesh.group(self.axis)

    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def rank(self) -> int:
        return self.mesh.axis_index(self.axis)


def _tp_enter(x, tp: Optional[TensorParallel]):
    return x if tp is None else group_copy(x, tp.group)


def _tp_sum(x, tp: Optional[TensorParallel]):
    return x if tp is None else group_sum(x, tp.group)


def _keep_slice(module: nn.Module, name: str, dim: int, parts: int,
                index: int) -> None:
    """Replace parameter ``name`` of ``module`` by its ``index``-th of
    ``parts`` equal slices along ``dim``."""
    p = getattr(module, name)
    width = p.shape[dim] // parts
    setattr(module, name, nn.Parameter(
        p.data.narrow(dim, index * width, width).clone(),
        requires_grad=p.requires_grad))


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
    hand-written decode kernels), ``"kernel_tp"`` (the same kernels on
    each rank's heads of a tensor-parallel model, whose caches hold
    only those heads) or ``"einsum"`` (plain torch)."""

    path: str
    reason: str


def current_decode_path() -> DecodePath:
    if _decode_kernel_on():
        return DecodePath("kernel", "single device: decode kernels")
    return DecodePath("einsum", "decode_kernel_disabled()")


def decode_path_context(path: str):
    """The path -> context switch shared by ``generate`` and the serving
    engine: run under exactly the verdict that was recorded. ``kernel``
    and ``kernel_tp`` run the same kernels: under tensor parallelism a
    rank's q and K/V already hold only its heads."""
    return _decode_kernel_override(path in ("kernel", "kernel_tp"))


def classify_decode_sharding(model, prompt_ids,
                             num_kv_heads: int) -> DecodePath:
    """Pick the single-token decode path from the model's sharding — the
    counterpart of the JAX classifier, which reads the variables'
    ``NamedSharding``s; here the model carries its tensor-parallel axis
    (``model.tp``). Three verdicts, with the JAX reasons:

    * not sharded (no TP axis, or one of size 1) -> ``"kernel"``;
    * heads split on the TP axis, whose size divides ``num_kv_heads``
      -> ``"kernel_tp"``: attention is per-head independent, so each
      rank writes its own cache row and runs the unmodified kernel on
      its heads (what ``ops.decode_attention.sharded_decode_step``
      does);
    * an uneven split (the axis does not divide ``num_kv_heads``; the
      model then keeps attention replicated) -> ``"einsum"``.

    ``prompt_ids`` are this rank's (a dp replica's own batch): eager
    tensors carry no sharding, so the JAX verdicts on sequence-sharded
    prompts have no counterpart here."""
    tp = getattr(model, "tp", None)
    if tp is None or tp.size == 1:
        return DecodePath("kernel", "replicated: single-device kernel")
    if num_kv_heads % tp.size:
        return DecodePath(
            "einsum", f"uneven head split: Hkv ({num_kv_heads}) % "
            f"tp ({tp.size}) != 0")
    return DecodePath(
        "kernel_tp",
        f"heads sharded on {tp.axis!r} (tp={tp.size}): per-rank kernel")


#: Last :class:`DecodePath` chosen by :func:`generate` (None before any
#: call). Read-only attribution for harnesses; not used for dispatch.
LAST_DECODE_PATH: Optional[DecodePath] = None


def _cached_attention(q, k, v, cache, cache_index, tp: bool = False):
    """Decode-mode attention: write the s new K/V rows at ``cache_index``
    (in place) and attend every query (global position
    ``cache_index + i``) over keys at positions <= it. Returns ctx
    (B, S, H, D). Each path runs inside the JAX package's profiler
    label: ``hvd.decode.paged`` (``paged_tp`` when ``tp``: this rank
    holds only its heads), ``kernel`` (``kernel_tp``), ``prefill`` and
    ``einsum`` (the paged gather path shares it); the cache writes run
    inside ``cache_update``.

    Four paths, one semantics: the paged cache (``"tables"`` in the
    cache; ``cache_index`` a (B,) tensor) runs the paged kernel or the
    gather einsum; a contiguous single-token step runs the decode kernel;
    prefill at index 0 attends over the fresh rows only; anything else
    (warm prefill at a nonzero index, or the kernel disabled) runs the
    masked einsum over the whole window. Under tensor parallelism the
    heads (and the caches) are this rank's, and the paths are the
    same."""
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
        with named_scope("cache_update"):
            paged_cache_write(cache["k"], cache["v"], kc, vc, tables,
                              cache_index)
        if _decode_kernel_on():
            with named_scope("hvd.decode.paged_tp" if tp
                             else "hvd.decode.paged"):
                return paged_decode_attention(q, cache["k"], cache["v"],
                                              tables, cache_index, hkv,
                                              sm_scale=scale)
        with named_scope("hvd.decode.einsum"):
            return paged_gather_attention(q, cache["k"], cache["v"], tables,
                                          cache_index, hkv, sm_scale=scale)
    k_cache, v_cache = cache["k"], cache["v"]
    with named_scope("cache_update"):
        k_cache[:, cache_index:cache_index + s] = kc.reshape(b, s, hkv * d)
        v_cache[:, cache_index:cache_index + s] = vc.reshape(b, s, hkv * d)
    if s == 1 and _decode_kernel_on():
        with named_scope("hvd.decode.kernel_tp" if tp
                         else "hvd.decode.kernel"):
            return decode_attention(q, k_cache, v_cache, cache_index, hkv,
                                    sm_scale=scale)
    qg = q.reshape(b, s, hkv, group, d)
    if s > 1 and isinstance(cache_index, int) and cache_index == 0:
        # Prefill at index 0: attend over the cache-dtype fresh rows.
        with named_scope("hvd.decode.prefill"):
            logits = torch.einsum("bshgd,blhd->bshgl", qg,
                                  kc).float() * scale
            pos = torch.arange(s, device=q.device)
            causal = pos[None, :] <= pos[:, None]
            logits = logits.masked_fill(~causal[None, :, None, None, :],
                                        f32_min)
            probs = torch.softmax(logits, dim=-1).to(q.dtype)
            ctx = torch.einsum("bshgl,blhd->bshgd", probs, vc)
            return ctx.reshape(b, s, h, d)
    with named_scope("hvd.decode.einsum"):
        window = k_cache.shape[1]
        k4 = k_cache.view(b, window, hkv, d)
        v4 = v_cache.view(b, window, hkv, d)
        logits = torch.einsum("bshgd,blhd->bshgl", qg, k4).float() * scale
        q_pos = cache_index + torch.arange(s, device=q.device)
        key_pos = torch.arange(window, device=q.device)
        mask = key_pos[None, :] <= q_pos[:, None]          # (s, window)
        logits = logits.masked_fill(~mask[None, :, None, None, :], f32_min)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bshgl,blhd->bshgd", probs,
                            v4).reshape(b, s, h, d)


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
        # The tensor-parallel axis when this rank holds only its heads.
        self.tp: Optional[TensorParallel] = None

    def forward(self, x, positions=None, cache=None, cache_index=None):
        """``cache``/``cache_index``: decoding mode (see
        :func:`init_kv_cache`); the cache is updated in place. Under
        tensor parallelism the heads are this rank's and the output is
        summed over the axis."""
        cfg = self.config
        b, s, _ = x.shape
        hd = cfg.dim // cfg.num_heads
        heads, kv_heads = self.wq.shape[1] // hd, self.wk.shape[1] // hd
        dt = cfg.dtype
        x = _tp_enter(x, self.tp)
        q = _dense(x, self.wq, dt, "wq").view(b, s, heads, hd)
        k = _dense(x, self.wk, dt, "wk").view(b, s, kv_heads, hd)
        v = _dense(x, self.wv, dt, "wv").view(b, s, kv_heads, hd)
        with named_scope("rotary"):
            q = rotary_embedding(q, cfg.rope_theta, positions)
            k = rotary_embedding(k, cfg.rope_theta, positions)
        if cache is not None:
            ctx = _cached_attention(q, k, v, cache, cache_index,
                                    self.tp is not None)
        else:
            fn = self.attention_fn
            if fn is not None and not getattr(fn, "supports_gqa", False):
                k, v = repeat_kv(q, k, v)
            if fn is not None:
                ctx = fn(q, k, v, None)
            else:
                ctx = reference_attention(q, k, v, causal=True)
        return _tp_sum(_dense(ctx.reshape(b, s, heads * hd), self.wo, dt,
                              "wo"), self.tp)


def _dense(x, w, dtype, name: str):
    """``x @ w`` in ``dtype`` inside the profiler scope ``name`` (the
    flax Dense's name in the JAX model)."""
    with named_scope(name):
        return x @ w.to(dtype)


def init_attention_sublayer(block: nn.Module, cfg: LlamaConfig, generator,
                            attention_fn: Optional[Callable] = None,
                            param_dtype: Optional[torch.dtype] = None):
    """Give ``block`` the pre-norm attention of :func:`attention_sublayer`
    (submodules ``attention_norm`` and ``attention``, flax's names)."""
    block.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                   param_dtype)
    block.attention = LlamaAttention(cfg, generator, attention_fn,
                                     param_dtype)


def attention_sublayer(block: nn.Module, x, positions=None, cache=None,
                       cache_index=None):
    """Pre-norm attention + residual, shared by ``LlamaBlock`` and
    ``MoeBlock`` so that one place owns the cache protocol (the cache is
    updated in place), as ``horovod_tpu/models/llama.py``'s
    ``attention_sublayer`` does. The profiler scopes carry flax's
    submodule names."""
    with named_scope("attention_norm"):
        h = block.attention_norm(x)
    with named_scope("attention"):
        h = block.attention(h, positions, cache, cache_index)
    return x + h


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, generator,
                 attention_fn: Optional[Callable] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = cfg.dtype
        init_attention_sublayer(self, cfg, generator, attention_fn,
                                param_dtype)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                param_dtype)
        self.w_gate = _param((cfg.dim, cfg.ffn_hidden), cfg.dtype,
                             cfg.dim ** -0.5, generator, param_dtype)
        self.w_up = _param((cfg.dim, cfg.ffn_hidden), cfg.dtype,
                           cfg.dim ** -0.5, generator, param_dtype)
        self.w_down = _param((cfg.ffn_hidden, cfg.dim), cfg.dtype,
                             cfg.ffn_hidden ** -0.5, generator, param_dtype)
        # The tensor-parallel axis when this rank holds a slice of the
        # FFN's hidden width.
        self.tp: Optional[TensorParallel] = None

    def forward(self, x, positions=None, cache=None, cache_index=None):
        x = attention_sublayer(self, x, positions, cache, cache_index)
        with named_scope("ffn_norm"):
            h = _tp_enter(self.ffn_norm(x), self.tp)
        dt = self.dtype
        gated = (F.silu(_dense(h, self.w_gate, dt, "w_gate"))
                 * _dense(h, self.w_up, dt, "w_up"))
        return x + _tp_sum(_dense(gated, self.w_down, dt, "w_down"), self.tp)


class CausalLM(nn.Module):
    """What ``LlamaLM`` and ``MoeLM`` share: the embedding table, the
    blocks (``layers``), the final norm and the untied head, owning their
    weights, and the call contract of :meth:`LlamaLM.forward` (the cache
    protocol that ``generate`` and the serving engine rely on). Blocks
    return the stream, or ``(stream, aux)`` where they add a loss."""

    def _init_embedding(self, cfg, gen, param_dtype) -> None:
        """The embedding table: drawn before the blocks, and the norm and
        head (:meth:`_init_head`) after them."""
        self.tok_embeddings = _param((cfg.vocab_size, cfg.dim),
                                     torch.float32, cfg.dim ** -0.5, gen,
                                     param_dtype)

    def _init_head(self, cfg, gen, param_dtype) -> None:
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype,
                                  param_dtype)
        self.lm_head = _param((cfg.dim, cfg.vocab_size),
                              cfg.head_dtype or cfg.dtype, cfg.dim ** -0.5,
                              gen, param_dtype)

    #: The tensor-parallel axis of a sharded model (``LlamaLM(mesh=)``).
    tp: Optional[TensorParallel] = None

    @property
    def device(self) -> torch.device:
        return self.tok_embeddings.device

    @property
    def kv_heads(self) -> int:
        """The K/V heads this rank's caches hold: all of them, or its
        share under tensor parallelism."""
        cfg = self.config
        attn = self.layers[0].attention
        return attn.wk.shape[1] // (cfg.dim // cfg.num_heads)

    def _embed(self, input_ids):
        """The f32 embedding rows; under tensor parallelism this rank
        holds a vocabulary slice: ids outside it give zero rows, and the
        sum over the axis has exactly one nonzero term per token."""
        if self.tp is None:
            return F.embedding(input_ids, self.tok_embeddings)
        rows = self.tok_embeddings.shape[0]
        local = input_ids - self.tp.rank * rows
        inside = (local >= 0) & (local < rows)
        e = F.embedding(local.clamp(0, rows - 1), self.tok_embeddings)
        return _tp_sum(e * inside[..., None], self.tp)

    def _shard(self, tp: TensorParallel) -> None:
        """Keep this rank's share of every weight on ``tp``'s axis (see
        the module doc). Attention shards only where the K/V heads
        split evenly."""
        cfg = self.config
        n, r = tp.size, tp.rank
        for what, value in (("vocab_size", cfg.vocab_size),
                            ("ffn_hidden", cfg.ffn_hidden),
                            ("num_heads", cfg.num_heads)):
            if value % n:
                raise ValueError(
                    f"tensor parallelism over {n} ranks needs {what} "
                    f"({value}) divisible by {n}")
        heads = cfg.num_kv_heads % n == 0
        _keep_slice(self, "tok_embeddings", 0, n, r)
        _keep_slice(self, "lm_head", 1, n, r)
        for block in self.layers:
            if heads:
                attn = block.attention
                for name in ("wq", "wk", "wv"):
                    _keep_slice(attn, name, 1, n, r)
                _keep_slice(attn, "wo", 0, n, r)
                attn.tp = tp
            _keep_slice(block, "w_gate", 1, n, r)
            _keep_slice(block, "w_up", 1, n, r)
            _keep_slice(block, "w_down", 0, n, r)
            block.tp = tp
        self.tp = tp

    def _forward(self, input_ids, positions, cache, cache_index,
                 return_hidden: bool):
        """``(result, aux)``: the result of :meth:`LlamaLM.forward` and
        the list of the blocks' auxiliary losses."""
        cfg = self.config
        if cache is not None and positions is None:
            steps = torch.arange(input_ids.shape[1], device=input_ids.device)
            if torch.is_tensor(cache_index) and cache_index.ndim:
                positions = cache_index[:, None] + steps
            else:
                positions = int(cache_index) + steps
        with named_scope("embed"):
            x = self._embed(input_ids).to(cfg.dtype)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        aux = []
        for i, layer in enumerate(self.layers):
            if remat:
                out = checkpoint(layer, x, positions, use_reentrant=False)
            else:
                out = layer(x, positions,
                            None if cache is None else cache[f"layer_{i}"],
                            cache_index)
            if isinstance(out, tuple):
                x, a = out
                aux.append(a)
            else:
                x = out
        with named_scope("final_norm"):
            x = self.final_norm(x)
        if return_hidden:
            return x, aux
        head = cfg.head_dtype or cfg.dtype
        logits = _dense(_tp_enter(x, self.tp).to(head), self.lm_head, head,
                        "lm_head")
        if self.tp is not None:
            logits = group_gather_last(logits, self.tp.group)
        return (logits if cache is None else (logits, cache)), aux


class LlamaLM(CausalLM):
    """Causal LM: embeddings + blocks + untied output head, owning its
    weights (random from ``seed`` on a CPU generator; load real ones with
    ``models.convert.llama_from_flax``). ``device=None`` means CUDA and
    raises without a card. ``attention_fn``: the no-cache attention, as
    in the JAX package (None = ``reference_attention``, causal).
    ``param_dtype``: None for serving storage, ``torch.float32`` to
    train (see the module doc). ``mesh`` with an axis ``tp_axis`` of
    size above 1: tensor parallelism over that axis (module doc); every
    rank of the axis passes the same seed, or loads the same
    checkpoint."""

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 seed: int = 0, attention_fn: Optional[Callable] = None,
                 param_dtype: Optional[torch.dtype] = None, mesh=None,
                 tp_axis: str = "model"):
        super().__init__()
        device = default_device(device)
        self.config = cfg = config
        gen = torch.Generator().manual_seed(seed)
        self._init_embedding(cfg, gen, param_dtype)
        self.layers = nn.ModuleList(
            [LlamaBlock(cfg, gen, attention_fn, param_dtype)
             for _ in range(cfg.num_layers)])
        self._init_head(cfg, gen, param_dtype)
        if mesh is not None and mesh.shape.get(tp_axis, 1) > 1:
            self._shard(TensorParallel(mesh, tp_axis))
        self.to(device)

    def forward(self, input_ids, positions=None, cache=None,
                cache_index=None, return_hidden: bool = False):
        """``input_ids`` (B, S). ``positions``: global token positions,
        default 0..S-1, or ``cache_index + 0..S-1`` in decoding mode
        (``cache_index`` an int, or a (B,) tensor of per-sequence
        positions for the paged cache). Returns logits, or
        ``(logits, cache)`` when a cache is given (updated in place).
        ``return_hidden``: skip the lm_head and return the final-norm
        hidden states (B, S, dim), for :func:`chunked_causal_lm_loss`."""
        return self._forward(input_ids, positions, cache, cache_index,
                             return_hidden)[0]


_TP_RULES = {"wq": (None, 0), "wk": (None, 0), "wv": (None, 0),
             "wo": (0, None), "w_gate": (None, 0), "w_up": (None, 0),
             "w_down": (0, None), "lm_head": (None, 0),
             "tok_embeddings": (0, None)}


def llama_tp_param_specs(params, axis: str = "model"):
    """The tensor-parallel layout of ``LlamaLM(mesh=, tp_axis=axis)`` as
    specs (``torch.partition.PartitionSpec``) by parameter name, the
    counterpart of the JAX function of this name: the heads of
    ``wq``/``wk``/``wv`` and the rows of ``wo``, the FFN hidden width,
    and the vocabulary of the embedding and the head; norm scales
    replicated. ``params``: ``dict(model.named_parameters())`` (tensors
    or shapes). Where the K/V heads do not split evenly the model keeps
    attention replicated; this layout assumes they do. The base spec of
    ``fsdp_param_specs`` for dp x tp."""
    from ..torch.partition import PartitionSpec

    out = {}
    for name in params:
        rule = _TP_RULES.get(name.rpartition(".")[2])
        out[name] = (PartitionSpec() if rule is None else PartitionSpec(
            *(None if e is None else axis for e in rule)))
    return out


def init_kv_cache(cfg: LlamaConfig, batch_size: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None,
                  kv_heads: Optional[int] = None):
    """Per-layer K/V cache for decoding:
    ``{layer_i: {"k"/"v": (B, max_len, kv_heads * head_dim)}}``, each
    position's GQA heads stored ROW-FLAT (the decode kernel's layout).
    ``kv_heads``: the heads this rank holds (``model.kv_heads``; default
    all of ``cfg.num_kv_heads``). Windows above 1024 round up to a
    multiple of 128, as in the JAX package, so both hold the same
    window."""
    dtype = dtype or cfg.dtype
    device = default_device(device)
    head_dim = cfg.dim // cfg.num_heads
    if max_len > 1024:
        max_len = (max_len + 127) // 128 * 128
    shape = (batch_size, max_len, (kv_heads or cfg.num_kv_heads) * head_dim)
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


def generate(model: CausalLM, prompt_ids, max_new_tokens: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None):
    """Autoregressive decoding with the KV cache: prefill the prompt in
    one call, then single-token steps in a Python loop (the JAX
    package's ``lax.scan``). ``model`` is any causal LM with the cache
    call contract (``LlamaLM``, ``MoeLM``). ``temperature`` 0.0 = greedy argmax;
    > 0 samples with ``generator`` (a ``torch.Generator`` on the model's
    device). Returns ``(B, prompt + max_new_tokens)`` int64 ids, prompt
    included, on the model's device.

    The path follows :func:`classify_decode_sharding`. A tensor-parallel
    model runs on every rank of its axis with the same prompt (and the
    same generator seed when sampling): the gathered logits are the same
    bytes on every rank, so every rank picks the same tokens."""
    global LAST_DECODE_PATH
    cfg = model.config
    device = model.device
    prompt = torch.as_tensor(prompt_ids, device=device).long()
    b, s = prompt.shape
    if max_len is None:
        # A config with no max_seq_len (MoeConfig: RoPE-only positions)
        # caps nothing, as in the JAX package.
        max_len = min(getattr(cfg, "max_seq_len", s + max_new_tokens),
                      s + max_new_tokens)
    if s + max_new_tokens > max_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"cache window max_len={max_len}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    if max_new_tokens <= 0:
        return prompt
    info = classify_decode_sharding(model, prompt, cfg.num_kv_heads)
    if not _decode_kernel_on():
        info = DecodePath("einsum", "decode_kernel_disabled()")
    LAST_DECODE_PATH = info
    with torch.inference_mode(), decode_path_context(info.path):
        cache = init_kv_cache(cfg, b, max_len, device=device,
                              kv_heads=model.kv_heads)
        with named_scope("prefill"):
            logits, cache = model(prompt, cache=cache, cache_index=0)
            token = pick_tokens(logits[:, -1], temperature, generator)
        new = [token]
        for i in range(max_new_tokens - 1):
            # The profiler scope of one step of the JAX package's scan.
            with named_scope("decode_step"):
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


def sp_causal_lm_loss(logits, input_ids, group=None):
    """Sequence-parallel twin of :func:`causal_lm_loss`: ``logits`` /
    ``input_ids`` are this rank's (contiguous-layout) sequence shards of
    ``group``. The next-token shift crosses shard boundaries, so each
    shard fetches its right neighbour's first token over one exchange,
    and the global last position is masked out; every rank returns the
    global mean. Its gradient on each rank is that rank's share of the
    global loss's gradient: the sum over the group (the example's
    gradient sum over ``seq``) is the whole."""
    n = group_size(group)
    idx = group_rank(group)
    (nxt,) = ring_exchange([input_ids[:, :1]], group, shift=-1)
    targets = torch.cat([input_ids[:, 1:], nxt.to(input_ids.device)], dim=1)
    nll = token_nll(logits, targets)
    valid = torch.ones(input_ids.shape, dtype=torch.bool,
                       device=logits.device)
    valid[:, -1] = idx != n - 1
    total = torch.where(valid, nll, 0.0).sum()
    count = valid.sum().to(torch.float32)
    if n > 1:
        total = group_sum(total, group)
        dist.all_reduce(count, group=group)
    return total / count
