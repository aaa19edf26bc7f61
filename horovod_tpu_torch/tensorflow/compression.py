"""TF-tensor gradient compression — the port's copy of
``horovod_tpu/tensorflow/compression.py``: the same interface, ``none``,
``fp16`` and ``bf16`` casts applied before the collective and undone
after it."""

from __future__ import annotations

import tensorflow as tf


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
    wire_dtype = None

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.dtype.is_floating and tensor.dtype != cls.wire_dtype:
            return tf.cast(tensor, cls.wire_dtype), ctx
        return tensor, ctx

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            return tf.cast(tensor, ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    wire_dtype = tf.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = tf.bfloat16


class Compression:
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
