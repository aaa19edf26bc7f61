"""BERT encoder — the counterpart of ``horovod_tpu/models/bert.py``, the
JAX package's flagship language benchmark model: learned token, position
and type embeddings, post-LN transformer blocks, an untied MLM head.

Numerics mirrored from the JAX module: parameters float32, activations
``cfg.dtype``; the embeddings are summed in float32 then cast; LayerNorm
in float32 with epsilon 1e-6; GELU is the tanh approximation
(``flax.linen.gelu``). ``SelfAttention``'s ``attention_fn(q, k, v,
mask)`` seam takes ``ops.attention.make_attention_fn`` (the flash kernels
from ``FLASH_AUTO_MIN_SEQ`` query rows upward); without one the plain
path takes the logits in the activation dtype, scales and masks them
in float32 (``finfo(float32).min``), runs the softmax in float32 and
casts the probabilities back. ``BertEncoder`` always passes a (B, S) key mask, all
true when the caller gives none, as the JAX package does.

Dropout draws from the encoder's own generator (``deterministic=False``);
under ``cfg.remat`` each block runs in ``torch.utils.checkpoint`` and its
recomputation replays the generator, so it draws the same masks.
Submodules carry flax's names (``layer_3``, ``SelfAttention_0``,
``query``, ``LayerNorm_1``, ``mlm_head``, ...).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import DeviceLike, default_device
from .layers import (Dense, Embed, LayerNorm, cpu_generator,
                     device_generator, dropout, place)
from .llama import token_nll


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    # mlm_head compute dtype; None = model dtype.
    head_dtype: Optional[torch.dtype] = None
    # Recompute each block's activations in the backward pass.
    remat: bool = False


BERT_BASE = BertConfig()
BERT_LARGE = BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                        intermediate_size=4096)
BERT_TINY = BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                       num_heads=2, intermediate_size=128,
                       max_position_embeddings=128)


class SelfAttention(nn.Module):
    """Multi-head self-attention. ``config`` needs ``hidden_size``,
    ``num_heads``, ``dtype`` and ``dropout_rate`` (a ``BertConfig`` or a
    ``ViTConfig``). The projections are flax's ``DenseGeneral`` over
    flattened heads: ``query``/``key``/``value`` (hidden -> H*D) and
    ``out`` (H*D -> hidden)."""

    def __init__(self, config, generator,
                 attention_fn: Optional[Callable] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        self.attention_fn = attention_fn
        self.dropout_generator = dropout_generator
        hidden, dt = cfg.hidden_size, cfg.dtype
        self.query = Dense(hidden, hidden, dt, generator)
        self.key = Dense(hidden, hidden, dt, generator)
        self.value = Dense(hidden, hidden, dt, generator)
        self.out = Dense(hidden, hidden, dt, generator)

    def forward(self, x, mask, deterministic: bool = True):
        cfg = self.config
        b, s, _ = x.shape
        h = cfg.num_heads
        d = cfg.hidden_size // h
        q, k, v = (proj(x).view(b, s, h, d)
                   for proj in (self.query, self.key, self.value))
        if self.attention_fn is not None:
            ctx = self.attention_fn(q, k, v, mask)
        else:
            # The JAX product is in the activation dtype; its float64
            # scale promotes it to float32 before the scaling.
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (
                1.0 / math.sqrt(d))
            if mask is not None:
                logits = logits.masked_fill(~mask[:, None, None, :],
                                            torch.finfo(torch.float32).min)
            probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
            probs = dropout(probs, cfg.dropout_rate, deterministic,
                            self.dropout_generator)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(ctx.reshape(b, s, h * d))


class TransformerBlock(nn.Module):
    """Post-LN block: LN(x + attn), then LN(x + FFN) with a GELU FFN."""

    def __init__(self, config: BertConfig, generator,
                 attention_fn: Optional[Callable] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        self.dropout_generator = dropout_generator
        self.SelfAttention_0 = SelfAttention(cfg, generator, attention_fn,
                                             dropout_generator)
        self.LayerNorm_0 = LayerNorm(cfg.hidden_size, cfg.dtype)
        self.Dense_0 = Dense(cfg.hidden_size, cfg.intermediate_size,
                             cfg.dtype, generator)
        self.Dense_1 = Dense(cfg.intermediate_size, cfg.hidden_size,
                             cfg.dtype, generator)
        self.LayerNorm_1 = LayerNorm(cfg.hidden_size, cfg.dtype)

    def forward(self, x, mask, deterministic: bool = True):
        rate, gen = self.config.dropout_rate, self.dropout_generator
        attn = self.SelfAttention_0(x, mask, deterministic)
        x = self.LayerNorm_0(x + dropout(attn, rate, deterministic, gen))
        h = self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))
        return self.LayerNorm_1(x + dropout(h, rate, deterministic, gen))


def replaying(generator: torch.Generator):
    """``context_fn`` for ``torch.utils.checkpoint``: the recomputation
    runs with ``generator`` at the state the forward started from (and
    leaves it where it was), so dropout draws the same masks."""
    start = generator.get_state()

    @contextlib.contextmanager
    def recompute():
        now = generator.get_state()
        generator.set_state(start)
        try:
            yield
        finally:
            generator.set_state(now)

    return contextlib.nullcontext(), recompute()


def run_blocks(blocks, x, args, remat: bool, generator):
    """Apply ``blocks`` in turn, each under ``torch.utils.checkpoint``
    when ``remat`` and gradients are on."""
    remat = remat and torch.is_grad_enabled()
    for block in blocks:
        if remat:
            x = checkpoint(block, x, *args, use_reentrant=False,
                           context_fn=lambda: replaying(generator))
        else:
            x = block(x, *args)
    return x


class BertEncoder(nn.Module):
    """Embeddings + transformer stack + MLM head, owning its weights
    (random from ``seed`` on a CPU generator; load a JAX checkpoint with
    ``convert.bert_from_flax``). ``device=None`` means CUDA and raises
    without a card."""

    def __init__(self, config: BertConfig,
                 attention_fn: Optional[Callable] = None,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        self.config = cfg = config
        gen = cpu_generator(seed)
        self.generator = device_generator(device, seed + 1)
        self.token_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, gen)
        self.position_embeddings = Embed(cfg.max_position_embeddings,
                                         cfg.hidden_size, gen)
        self.type_embeddings = Embed(cfg.type_vocab_size, cfg.hidden_size,
                                     gen)
        self.embed_norm = LayerNorm(cfg.hidden_size, cfg.dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", TransformerBlock(
                cfg, gen, attention_fn, self.generator))
        self.mlm_head = Dense(cfg.hidden_size, cfg.vocab_size,
                              cfg.head_dtype or cfg.dtype, gen)
        place(self, device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                deterministic: bool = True, positions=None):
        """``input_ids`` (B, S); ``attention_mask`` (B, S), true/1 where a
        key may be attended; ``positions``: the global positions of the
        rows (S,), default 0..S-1 (within ``max_position_embeddings``).
        Returns (B, S, vocab) logits in the head dtype."""
        cfg = self.config
        b, s = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.bool, device=dev)
        else:
            attention_mask = attention_mask.bool()
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.long, device=dev)
        if positions is None:
            positions = torch.arange(s, device=dev)
        x = (self.token_embeddings(input_ids)
             + self.position_embeddings(positions[None, :])
             + self.type_embeddings(token_type_ids)).to(cfg.dtype)
        x = self.embed_norm(x)
        x = dropout(x, cfg.dropout_rate, deterministic, self.generator)
        blocks = [getattr(self, f"layer_{i}") for i in range(cfg.num_layers)]
        x = run_blocks(blocks, x, (attention_mask, deterministic), cfg.remat,
                       self.generator)
        return self.mlm_head(x)


def mlm_loss(logits, labels, label_mask):
    """Masked-LM cross entropy over the positions where ``label_mask`` is
    1 (``token_nll``: no (B, S, V) float32 array)."""
    nll = token_nll(logits, labels)
    label_mask = label_mask.float()
    return (nll * label_mask).sum() / label_mask.sum().clamp_min(1.0)
