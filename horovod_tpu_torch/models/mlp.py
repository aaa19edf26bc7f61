"""MNIST MLP — the counterpart of ``horovod_tpu/models/mlp.py``, the
smallest end-to-end model: flatten, ReLU dense layers, a float32 head.

Inputs are flattened in their own (H, W, C) order, as in the JAX
package: 28x28x1 MNIST images (a torch layer needs its input width when
it is built, where flax reads it off the first input). Submodules carry
flax's names (``Dense_0``, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, default_device
from .layers import Dense, cpu_generator, place

MNIST_PIXELS = 28 * 28


class MnistMLP(nn.Module):
    def __init__(self, features: Sequence[int] = (128, 64),
                 num_classes: int = 10, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        gen = cpu_generator(seed)
        self.dtype = dtype
        widths = [MNIST_PIXELS, *features]
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            self.add_module(f"Dense_{i}", Dense(a, b, dtype, gen))
        self.num_hidden = len(features)
        self.add_module(f"Dense_{self.num_hidden}",
                        Dense(widths[-1], num_classes, torch.float32, gen))
        place(self, device)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.num_hidden):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.num_hidden}")(x)
