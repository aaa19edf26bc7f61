"""Inception V3 — the counterpart of ``horovod_tpu/models/inception.py``
(Szegedy et al. 2015): every convolution bias-free and followed by
BatchNorm (epsilon 1e-3) and ReLU, mixed blocks A-E concatenating their
towers on the channel axis, and the optional aux-logits head.

NHWC images, ``channels_last`` convolutions on the card, float32
parameters and BatchNorm statistics, ``dtype`` activations. Submodules
carry flax's automatic names, which number the modules of each block in
the order the JAX code constructs them: in ``cbn(96, 3)(cbn(96, 3)(
cbn(64)(x)))`` the outermost call is built first, so ``ConvBN_3`` is the
last convolution of that tower and ``ConvBN_5`` its first. Each block
below lists its modules in that order and applies them in data order.

The aux head's second convolution spans the whole grid it sees, so a
torch module needs the input size (``image_size``, 299 by default; any
size >= 75 works, as in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, default_device
from .layers import (IMAGE_CHANNELS, BatchNorm, Conv, Dense, Ints, Padding,
                     avg_pool, cpu_generator, device_generator, dropout,
                     max_pool, nchw, place)


class ConvBN(nn.Module):
    """Conv -> BatchNorm -> ReLU."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype,
                 generator, kernel: Ints = 1, strides: Ints = 1,
                 padding: Padding = "SAME"):
        super().__init__()
        self.Conv_0 = Conv(in_channels, features, kernel, dtype, generator,
                           strides=strides, padding=padding, use_bias=False)
        self.BatchNorm_0 = BatchNorm(features, dtype, momentum=0.9,
                                     epsilon=1e-3)

    def forward(self, x, train: bool = True):
        return F.relu(self.BatchNorm_0(self.Conv_0(x), not train))


def _avg_pool_same(x):
    return avg_pool(x, 3, 1, padding=(1, 1))


class _Mixed(nn.Module):
    """A block whose ConvBNs are named ``ConvBN_0``, ``ConvBN_1``, ...
    in the order ``specs`` gives: ``(in, out, kernel[, strides,
    padding])``."""

    def __init__(self, specs, dtype, generator):
        super().__init__()
        for i, spec in enumerate(specs):
            self.add_module(f"ConvBN_{i}",
                            ConvBN(spec[0], spec[1], dtype, generator,
                                   *spec[2:]))

    def c(self, i: int, x, train: bool):
        return getattr(self, f"ConvBN_{i}")(x, train)


class InceptionA(_Mixed):
    """35x35 block: 1x1 / 5x5 / double-3x3 / pool towers."""

    def __init__(self, in_channels: int, pool_features: int, dtype,
                 generator):
        super().__init__([(in_channels, 64, 1), (48, 64, 5),
                          (in_channels, 48, 1), (96, 96, 3), (64, 96, 3),
                          (in_channels, 64, 1),
                          (in_channels, pool_features, 1)], dtype, generator)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x, train: bool = True):
        c = self.c
        t1 = c(0, x, train)
        t5 = c(1, c(2, x, train), train)
        t3 = c(3, c(4, c(5, x, train), train), train)
        tp = c(6, _avg_pool_same(x), train)
        return torch.cat([t1, t5, t3, tp], dim=1)


class InceptionB(_Mixed):
    """35x35 -> 17x17 grid reduction."""

    def __init__(self, in_channels: int, dtype, generator):
        super().__init__([(in_channels, 384, 3, 2, "VALID"),
                          (96, 96, 3, 2, "VALID"), (64, 96, 3),
                          (in_channels, 64, 1)], dtype, generator)
        self.out_channels = 384 + 96 + in_channels

    def forward(self, x, train: bool = True):
        c = self.c
        t3 = c(0, x, train)
        td = c(1, c(2, c(3, x, train), train), train)
        return torch.cat([t3, td, max_pool(x, 3, 2)], dim=1)


class InceptionC(_Mixed):
    """17x17 block with factorised 7x7 (1x7 + 7x1) towers."""

    def __init__(self, in_channels: int, channels_7x7: int, dtype,
                 generator):
        c7 = channels_7x7
        super().__init__([(in_channels, 192, 1), (c7, 192, (1, 7)),
                          (c7, c7, (7, 1)), (in_channels, c7, 1),
                          (in_channels, c7, 1), (c7, c7, (7, 1)),
                          (c7, c7, (1, 7)), (c7, c7, (7, 1)),
                          (c7, 192, (1, 7)), (in_channels, 192, 1)],
                         dtype, generator)
        self.out_channels = 4 * 192

    def forward(self, x, train: bool = True):
        c = self.c
        t1 = c(0, x, train)
        t7 = c(1, c(2, c(3, x, train), train), train)
        td = c(4, x, train)
        for i in (5, 6, 7, 8):
            td = c(i, td, train)
        tp = c(9, _avg_pool_same(x), train)
        return torch.cat([t1, t7, td, tp], dim=1)


class InceptionD(_Mixed):
    """17x17 -> 8x8 grid reduction."""

    def __init__(self, in_channels: int, dtype, generator):
        super().__init__([(192, 320, 3, 2, "VALID"), (in_channels, 192, 1),
                          (192, 192, 3, 2, "VALID"), (192, 192, (7, 1)),
                          (192, 192, (1, 7)), (in_channels, 192, 1)],
                         dtype, generator)
        self.out_channels = 320 + 192 + in_channels

    def forward(self, x, train: bool = True):
        c = self.c
        t3 = c(0, c(1, x, train), train)
        t7 = c(2, c(3, c(4, c(5, x, train), train), train), train)
        return torch.cat([t3, t7, max_pool(x, 3, 2)], dim=1)


class InceptionE(_Mixed):
    """8x8 block with expanded-filterbank (split 1x3 / 3x1) towers."""

    def __init__(self, in_channels: int, dtype, generator):
        super().__init__([(in_channels, 320, 1), (in_channels, 384, 1),
                          (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (448, 384, 3), (in_channels, 448, 1),
                          (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (in_channels, 192, 1)], dtype, generator)
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x, train: bool = True):
        c = self.c
        t1 = c(0, x, train)
        a = c(1, x, train)
        t3 = torch.cat([c(2, a, train), c(3, a, train)], dim=1)
        b = c(4, c(5, x, train), train)
        td = torch.cat([c(6, b, train), c(7, b, train)], dim=1)
        tp = c(8, _avg_pool_same(x), train)
        return torch.cat([t1, t3, td, tp], dim=1)


def _valid(n: int, k: int, s: int) -> int:
    return (n - k) // s + 1


class InceptionV3(nn.Module):
    """Inception V3 classifier over NHWC images of ``image_size`` squared.
    With ``aux_logits``, ``forward(x, train=True)`` returns ``(logits,
    aux_logits)``; otherwise logits (float32)."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = False,
                 dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 299,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        gen = cpu_generator(seed)
        self.dtype = dtype
        self.aux_logits = aux_logits
        self.dropout_rate = dropout_rate
        stem = [(IMAGE_CHANNELS, 32, 3, 2, "VALID"), (32, 32, 3, 1, "VALID"),
                (32, 64, 3), (64, 80, 1, 1, "VALID"),
                (80, 192, 3, 1, "VALID")]
        for i, spec in enumerate(stem):
            self.add_module(f"ConvBN_{i}", ConvBN(spec[0], spec[1], dtype,
                                                  gen, *spec[2:]))
        self.mixed_17 = []      # A x3, B, C x4: before the aux head
        self.mixed_8 = []       # D, E x2: after it
        channels = 192
        for i, pool_features in enumerate((32, 64, 64)):
            channels = self._mixed(self.mixed_17, f"InceptionA_{i}",
                                   InceptionA(channels, pool_features, dtype,
                                              gen))
        channels = self._mixed(self.mixed_17, "InceptionB_0",
                               InceptionB(channels, dtype, gen))
        for i, c7 in enumerate((128, 160, 160, 192)):
            channels = self._mixed(self.mixed_17, f"InceptionC_{i}",
                                   InceptionC(channels, c7, dtype, gen))
        if aux_logits:
            # The 17x17 grid (at 299) and the 5x5/3 pool over it, clamped
            # as the JAX package clamps it for small inputs.
            n = _valid(_valid(image_size, 3, 2) - 2, 3, 2)
            n = _valid(_valid(n - 2, 3, 2), 3, 2)
            self.aux_window = min(5, n)
            grid = _valid(n, self.aux_window, 3)
            self.ConvBN_5 = ConvBN(channels, 128, dtype, gen)
            self.ConvBN_6 = ConvBN(128, 768, dtype, gen, kernel=grid,
                                   padding="VALID")
            self.aux_head = Dense(768, num_classes, torch.float32, gen)
        channels = self._mixed(self.mixed_8, "InceptionD_0",
                               InceptionD(channels, dtype, gen))
        for i in range(2):
            channels = self._mixed(self.mixed_8, f"InceptionE_{i}",
                                   InceptionE(channels, dtype, gen))
        self.head = Dense(channels, num_classes, torch.float32, gen)
        self.generator = device_generator(device, seed + 1)
        place(self, device)

    def _mixed(self, names, name, block) -> int:
        self.add_module(name, block)
        names.append(name)
        return block.out_channels

    def forward(self, x, train: bool = True):
        """``x`` (B, H, W, C) images."""
        x = nchw(x).to(self.dtype)
        for i in range(3):
            x = getattr(self, f"ConvBN_{i}")(x, train)
        x = max_pool(x, 3, 2)
        x = self.ConvBN_4(self.ConvBN_3(x, train), train)
        x = max_pool(x, 3, 2)
        for name in self.mixed_17:
            x = getattr(self, name)(x, train)
        aux = None
        if self.aux_logits and train:
            a = avg_pool(x, self.aux_window, 3)
            a = self.ConvBN_6(self.ConvBN_5(a, train), train)
            aux = self.aux_head(a.mean(dim=(2, 3)))
        for name in self.mixed_8:
            x = getattr(self, name)(x, train)
        x = dropout(x.mean(dim=(2, 3)), self.dropout_rate, not train,
                    self.generator)
        x = self.head(x)
        return x if aux is None else (x, aux)
