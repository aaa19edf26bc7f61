"""Gradient compression: the port's copy of ``horovod_tpu/compression.py``
and ``horovod_tpu/torch/compression.py``. ``compress`` returns
``(tensor, ctx)`` and ``decompress(tensor, ctx)`` restores the dtype;
``fp16`` and ``bf16`` halve the bytes a collective moves."""

from __future__ import annotations

import torch


class Compressor:
    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = None

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.dtype.is_floating_point and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), ctx
        return tensor, ctx

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            return tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class Compression:
    """Optional compression of the allreduce wire format."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
