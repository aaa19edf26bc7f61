"""VGG-11/13/16/19 — the counterpart of ``horovod_tpu/models/vgg.py``:
3x3 SAME convolutions with bias, a 2x2 max-pool after each stage, then two
dropout-regularised dense layers and a float32 head.

NHWC images, ``channels_last`` convolutions on the card, float32
parameters and ``dtype`` activations. The classifier flattens in H, W, C
order, as the JAX package does, so ``fc0`` takes a flax checkpoint's
rows unchanged; a torch module needs the input size for that flattened
width (``image_size``). Dropout draws from the model's own generator.
Submodules carry flax's names (``conv{i}_{j}``, ``fc0``, ``fc1``,
``head``).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, default_device
from .layers import (IMAGE_CHANNELS, Conv, Dense, cpu_generator,
                     device_generator, dropout, max_pool, nchw, place)


class VGG(nn.Module):
    """``stage_sizes`` 3x3 convolutions per stage; ``num_filters`` doubles
    per stage, capped at 512."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, classifier_width: int = 4096,
                 dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 224,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        gen = cpu_generator(seed)
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.conv_names = []
        channels, size = IMAGE_CHANNELS, image_size
        for i, n_convs in enumerate(stage_sizes):
            filters = min(num_filters * 2 ** i, 512)
            for j in range(n_convs):
                name = f"conv{i}_{j}"
                self.add_module(name, Conv(channels, filters, 3, dtype, gen))
                self.conv_names.append((name, j == n_convs - 1))
                channels = filters
            size //= 2
        self.fc0 = Dense(size * size * channels, classifier_width, dtype, gen)
        self.fc1 = Dense(classifier_width, classifier_width, dtype, gen)
        self.head = Dense(classifier_width, num_classes, torch.float32, gen)
        self.generator = device_generator(device, seed + 1)
        place(self, device)

    def forward(self, x, train: bool = True):
        """``x`` (B, H, W, C) images; returns float32 logits."""
        x = nchw(x).to(self.dtype)
        for name, stage_end in self.conv_names:
            x = F.relu(getattr(self, name)(x))
            if stage_end:
                x = max_pool(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # H, W, C order
        for fc in (self.fc0, self.fc1):
            x = dropout(F.relu(fc(x)), self.dropout_rate, not train,
                        self.generator)
        return self.head(x)


VGG11 = partial(VGG, stage_sizes=[1, 1, 2, 2, 2])
VGG13 = partial(VGG, stage_sizes=[2, 2, 2, 2, 2])
VGG16 = partial(VGG, stage_sizes=[2, 2, 3, 3, 3])
VGG19 = partial(VGG, stage_sizes=[2, 2, 4, 4, 4])
# Tiny variant for CPU tests.
VGGTiny = partial(VGG, stage_sizes=[1, 1], num_filters=8,
                  classifier_width=32, num_classes=10)
