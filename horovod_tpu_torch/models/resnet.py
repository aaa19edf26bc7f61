"""ResNet v1.5 (bottleneck blocks, stride on the 3x3) — the counterpart of
``horovod_tpu/models/resnet.py``, the JAX package's flagship vision
benchmark model.

Images are NHWC, as in the JAX package; on the card the convolutions run
in ``channels_last`` (cuDNN's NHWC path). Parameters and BatchNorm
statistics are float32, activations ``dtype`` (bfloat16 by default). The
stride-2 3x3 convolution pads by XLA's SAME rule, (0, 1) at an even size
(``layers.same_padding``), and the third norm of each block starts at
zero scale. Submodules carry flax's names (``conv_init``,
``BottleneckBlock_3``, ``Conv_1``, ``norm_proj``, ...), so a JAX
checkpoint maps onto them leaf by leaf (``convert.resnet_from_flax``).

``forward(x, train=True)``, as in the JAX package: in training the batch
statistics normalise and update the running ones in place (each rank
keeps its own; ``DistributedOptimizer`` averages gradients only).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, default_device
from .layers import (IMAGE_CHANNELS, BatchNorm, Conv, Dense, cpu_generator,
                     max_pool, nchw, place)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 with a projection shortcut when the
    shape changes."""

    def __init__(self, in_channels: int, filters: int, strides: int,
                 dtype: torch.dtype, generator):
        super().__init__()
        conv = partial(Conv, dtype=dtype, generator=generator, use_bias=False)
        norm = partial(BatchNorm, dtype=dtype, momentum=0.9, epsilon=1e-5)
        out = filters * 4
        self.Conv_0 = conv(in_channels, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, strides=strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, out, 1)
        self.BatchNorm_2 = norm(out, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if in_channels != out or strides != 1:
            self.conv_proj = conv(in_channels, out, 1, strides=strides)
            self.norm_proj = norm(out)

    def forward(self, x, train: bool = True):
        avg = not train
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), avg))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), avg))
        y = self.BatchNorm_2(self.Conv_2(y), avg)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), avg)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 classifier over NHWC RGB images. Weights are drawn
    from ``seed`` on the CPU; ``device=None`` means CUDA and raises
    without a card."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        gen = cpu_generator(seed)
        self.dtype = dtype
        self.conv_init = Conv(IMAGE_CHANNELS, num_filters, 7, dtype, gen,
                              strides=2, padding=[(3, 3), (3, 3)],
                              use_bias=False)
        self.bn_init = BatchNorm(num_filters, dtype, momentum=0.9,
                                 epsilon=1e-5)
        self.block_names = []
        channels = num_filters
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                filters = num_filters * 2 ** i
                name = f"BottleneckBlock_{len(self.block_names)}"
                self.add_module(name, BottleneckBlock(
                    channels, filters, 2 if i > 0 and j == 0 else 1, dtype,
                    gen))
                self.block_names.append(name)
                channels = filters * 4
        self.head = Dense(channels, num_classes, torch.float32, gen)
        place(self, device)

    def forward(self, x, train: bool = True):
        """``x`` (B, H, W, C) images; returns float32 logits."""
        x = nchw(x).to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x), not train))
        x = max_pool(x, 3, 2, padding=(1, 1))
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        # The mean over H and W in the activation dtype, then the float32
        # head.
        return self.head(x.mean(dim=(2, 3)))


ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])
# Tiny variant for CPU tests.
ResNetTiny = partial(ResNet, stage_sizes=[1, 1], num_filters=8,
                     num_classes=10)
