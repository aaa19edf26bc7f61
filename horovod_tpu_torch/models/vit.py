"""Vision Transformer — the counterpart of ``horovod_tpu/models/vit.py``:
the patch embedding as one strided convolution, a CLS token, learned
position embeddings, pre-LN blocks over ``bert.SelfAttention`` (the same
``attention_fn`` seam, no key mask) and a classification head on the CLS
row.

NHWC images, float32 parameters, ``cfg.dtype`` activations, LayerNorm
epsilon 1e-6, tanh GELU, as in the JAX package. Dropout and remat as in
``bert``. Submodules carry flax's names (``patch_embed``, ``cls_token``,
``position_embeddings``, ``layer_0`` ... ``final_norm``, ``head``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, default_device
from .bert import SelfAttention, run_blocks
from .layers import (IMAGE_CHANNELS, Conv, Dense, LayerNorm, cpu_generator,
                     device_generator, dropout, nchw, place)
from .llama import token_nll


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # Classification-head compute dtype; None = model dtype.
    head_dtype: Optional[torch.dtype] = None
    # Recompute each block's activations in the backward pass.
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


VIT_B16 = ViTConfig()
VIT_S16 = ViTConfig(hidden_size=384, num_heads=6, intermediate_size=1536)
VIT_TINY = ViTConfig(image_size=32, patch_size=8, num_classes=10,
                     hidden_size=64, num_layers=2, num_heads=2,
                     intermediate_size=128)


class ViTBlock(nn.Module):
    """Pre-LN block: x + attn(LN(x)), then x + FFN(LN(x))."""

    def __init__(self, config: ViTConfig, generator,
                 attention_fn: Optional[Callable] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        self.dropout_generator = dropout_generator
        self.LayerNorm_0 = LayerNorm(cfg.hidden_size, cfg.dtype)
        self.SelfAttention_0 = SelfAttention(cfg, generator, attention_fn,
                                             dropout_generator)
        self.LayerNorm_1 = LayerNorm(cfg.hidden_size, cfg.dtype)
        self.Dense_0 = Dense(cfg.hidden_size, cfg.intermediate_size,
                             cfg.dtype, generator)
        self.Dense_1 = Dense(cfg.intermediate_size, cfg.hidden_size,
                             cfg.dtype, generator)

    def forward(self, x, deterministic: bool = True):
        rate, gen = self.config.dropout_rate, self.dropout_generator
        h = self.SelfAttention_0(self.LayerNorm_0(x), None, deterministic)
        x = x + dropout(h, rate, deterministic, gen)
        h = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x)),
                                approximate="tanh"))
        return x + dropout(h, rate, deterministic, gen)


class VisionTransformer(nn.Module):
    """Patch embed + CLS token + pre-LN encoder + classification head.
    ``device=None`` means CUDA and raises without a card."""

    def __init__(self, config: ViTConfig,
                 attention_fn: Optional[Callable] = None,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        self.config = cfg = config
        gen = cpu_generator(seed)
        self.generator = device_generator(device, seed + 1)
        p = cfg.patch_size
        self.patch_embed = Conv(IMAGE_CHANNELS, cfg.hidden_size, p,
                                cfg.dtype, gen, strides=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.randn(1, cfg.num_patches + 1, cfg.hidden_size,
                        generator=gen) * 0.02)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", ViTBlock(cfg, gen, attention_fn,
                                                   self.generator))
        self.final_norm = LayerNorm(cfg.hidden_size, cfg.dtype)
        self.head = Dense(cfg.hidden_size, cfg.num_classes,
                          cfg.head_dtype or cfg.dtype, gen)
        place(self, device)

    def forward(self, images, deterministic: bool = True):
        """``images`` (B, H, W, C); returns (B, classes) logits in the head
        dtype."""
        cfg = self.config
        b = images.shape[0]
        x = self.patch_embed(nchw(images.to(cfg.dtype)))
        x = x.permute(0, 2, 3, 1).reshape(b, -1, cfg.hidden_size)
        cls = self.cls_token.expand(b, 1, cfg.hidden_size).to(cfg.dtype)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings.to(
            cfg.dtype)
        x = dropout(x, cfg.dropout_rate, deterministic, self.generator)
        blocks = [getattr(self, f"layer_{i}") for i in range(cfg.num_layers)]
        x = run_blocks(blocks, x, (deterministic,), cfg.remat,
                       self.generator)
        # LayerNorm is per row: normalising the CLS row alone is the same.
        return self.head(self.final_norm(x[:, 0]))


def classification_loss(logits, labels):
    """Mean cross entropy over the batch (``token_nll``)."""
    return token_nll(logits, labels).mean()
