"""Layers of the port's model zoo: flax.linen's ``Dense``, ``Conv``,
``BatchNorm``, ``LayerNorm``, ``Embed`` and ``Dropout`` in torch, with
flax's numerics and initialisers, for ``resnet``, ``vgg``, ``inception``,
``mlp``, ``bert`` and ``vit``.

Parameters and BatchNorm statistics are float32; each layer computes in
its ``dtype`` (flax's ``dtype=..., param_dtype=jnp.float32``): the input
and the parameters are cast at each call, as flax does. Weights keep
torch's layouts (``Dense`` ``(out, in)``, ``Conv`` OIHW); the conversion
from flax's (``models.convert``) transposes them.

Images enter the models as NHWC, the JAX package's layout;
:func:`nchw` gives the NCHW view torch's convolutions take, which for an
NHWC-contiguous tensor is a ``channels_last`` tensor without a copy.
:func:`place` moves a model to its device with every conv weight in
``channels_last``, so cuDNN takes its NHWC path on the card.

What differs from torch's own layers, and why:

* SAME padding follows XLA: ``total = max((ceil(n/s) - 1)·s + k - n, 0)``
  with ``total // 2`` before and the rest after. At stride 2 and an even
  size that is (0, 1), where torch's ``padding=1`` would give (1, 1).
* BatchNorm updates its running variance with the biased batch variance
  and ``running = momentum·running + (1 - momentum)·batch`` (flax's
  momentum 0.9 is torch's 0.1); the statistics and the normalisation run
  in float32.
* LayerNorm's epsilon is flax's 1e-6, in float32.
* Dropout draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Ints = Union[int, Tuple[int, int]]
Padding = Union[str, Sequence[Tuple[int, int]]]

# The images' channels: RGB, as every caller of the JAX models gives
# them. A torch layer needs its input width when it is built, where flax
# reads it off the first input.
IMAGE_CHANNELS = 3

# stddev of a standard normal truncated to [-2, 2] (flax's
# variance_scaling divides by it for "truncated_normal").
_TRUNC_STD = 0.87962566103423978


def pair(v: Ints) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def lecun_normal(shape, fan_in: int, generator) -> torch.Tensor:
    """flax's default kernel initialiser: a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=generator)
    return t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> the NCHW view torch's convolutions take."""
    return x.permute(0, 3, 1, 2)


def place(module: nn.Module, device: torch.device) -> None:
    """Move ``module`` to ``device``, conv weights in ``channels_last``."""
    module.to(device=device, memory_format=torch.channels_last)


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dimension: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def dropout(x, rate: float, deterministic: bool, generator):
    """flax's ``Dropout``: keep with probability ``1 - rate`` and divide
    by it; the mask is drawn from ``generator``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def max_pool(x, window: Ints, strides: Ints,
             padding: Tuple[int, int] = (0, 0)):
    """flax's ``max_pool`` on NCHW; ``padding`` symmetric per dimension
    (padded entries never win)."""
    return F.max_pool2d(x, pair(window), pair(strides), padding)


def avg_pool(x, window: Ints, strides: Ints,
             padding: Tuple[int, int] = (0, 0)):
    """flax's ``avg_pool`` on NCHW: padded entries count as zeros in the
    mean (``count_include_pad``, flax's default)."""
    return F.avg_pool2d(x, pair(window), pair(strides), padding,
                        count_include_pad=True)


class Dense(nn.Module):
    """``nn.Dense``: ``weight`` (out, in) and ``bias`` in float32, the
    product in ``dtype``. Also flax's ``DenseGeneral`` over flattened
    feature axes (the attention projections)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, generator, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(lecun_normal(
            (out_features, in_features), in_features, generator))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Conv(nn.Module):
    """``nn.Conv`` on NCHW: ``weight`` OIHW float32, the convolution in
    ``dtype``. ``padding``: ``"SAME"`` (XLA's rule, from the input's
    size at each call), ``"VALID"``, or explicit ``[(lo, hi), (lo, hi)]``.
    Asymmetric padding is applied with ``F.pad`` before the convolution."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Ints,
                 dtype: torch.dtype, generator, strides: Ints = 1,
                 padding: Padding = "SAME", use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = pair(kernel)
        self.strides = pair(strides)
        self.padding = padding
        kh, kw = self.kernel
        self.weight = nn.Parameter(lecun_normal(
            (out_channels, in_channels, kh, kw), in_channels * kh * kw,
            generator))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def pads(self, h: int, w: int) -> Tuple[Tuple[int, int], ...]:
        if self.padding == "SAME":
            return tuple(same_padding(n, k, s) for n, k, s in
                         zip((h, w), self.kernel, self.strides))
        if self.padding == "VALID":
            return ((0, 0), (0, 0))
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x):
        dt = self.dtype
        (top, bottom), (left, right) = self.pads(x.shape[2], x.shape[3])
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
        return F.conv2d(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt),
                        self.strides, padding)


class BatchNorm(nn.Module):
    """``nn.BatchNorm`` over the channels of NCHW: ``weight`` (flax's
    scale), ``bias`` and the buffers ``running_mean``/``running_var``,
    all float32. In training the batch statistics normalise and update
    the running ones with flax's rule (biased variance, see the module
    doc); ``use_running_average`` normalises with the running ones. The
    output is in ``dtype``. ``zero_scale``: flax's ``scale_init=zeros``."""

    def __init__(self, features: int, dtype: torch.dtype,
                 momentum: float = 0.9, epsilon: float = 1e-5,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.zeros(features) if zero_scale
                                   else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, use_running_average: bool):
        # Statistics and parameters in float32, or wider for wider input.
        ct = torch.promote_types(x.dtype, torch.float32)
        weight, bias = self.weight.to(ct), self.bias.to(ct)
        if use_running_average:
            out = F.batch_norm(x, self.running_mean.to(ct),
                               self.running_var.to(ct), weight, bias, False,
                               0.0, self.epsilon)
            return out.to(self.dtype)
        # The batch statistics come back with the output (mean and
        # 1 / sqrt(var + eps)); torch's own update would use the unbiased
        # variance, so the running statistics are updated here.
        out, mean, invstd = torch.native_batch_norm(
            x, weight, bias, None, None, True, 0.0, self.epsilon)
        with torch.no_grad():
            var = (invstd.pow(-2) - self.epsilon).clamp_min_(0.0)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return out.to(self.dtype)


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` over the last axis: statistics and normalisation
    in float32 with flax's epsilon 1e-6, the output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype,
                 epsilon: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        ct = torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.to(ct), self.weight.shape, self.weight.to(ct),
                            self.bias.to(ct), self.epsilon).to(self.dtype)


class Embed(nn.Module):
    """``nn.Embed``: a float32 table drawn from N(0, 1/features), gathered
    in float32."""

    def __init__(self, num_embeddings: int, features: int, generator):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(num_embeddings, features, generator=generator)
            * features ** -0.5)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


def cpu_generator(seed: int) -> torch.Generator:
    """The generator a model draws its initial weights from: on the CPU,
    so a seed gives the same weights on every device."""
    return torch.Generator().manual_seed(seed)


def device_generator(device: torch.device, seed: int) -> torch.Generator:
    """The generator a model draws its dropout masks from, on ``device``."""
    return torch.Generator(device=device).manual_seed(seed)
