"""Gradient compression (counterpart of ``horovod_tpu/compression.py``;
reference: horovod/torch/compression.py NoneCompressor / FP16Compressor).

The mapping follows the JAX package so that one setting means the same in
both: ``Compression.fp16`` is bfloat16 (same exponent range as fp32),
``Compression.fp16_strict`` is IEEE float16. The allreduce accumulates half
members in fp32 (collectives.py), so on this data plane compression rounds
the gradient without shrinking the wire. int8 with error feedback is not
ported yet.
"""

import torch


class Compressor:
    """Interface: compress(tensor) -> (compressed, ctx);
    decompress(compressed, ctx) -> tensor."""

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


class _HalfCompressor(Compressor):
    target = None  # set in subclasses

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point():
            tensor = tensor.to(cls.target)
        return tensor, ctx

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            tensor = tensor.to(ctx)
        return tensor


class BF16Compressor(_HalfCompressor):
    """Compress float gradients to bfloat16."""
    target = torch.bfloat16


class FP16Compressor(_HalfCompressor):
    """Compress float gradients to IEEE float16."""
    target = torch.float16


class Compression:
    """Optional gradient compression algorithms (reference API:
    hvd.Compression.none / hvd.Compression.fp16)."""
    none = NoneCompressor
    fp16 = BF16Compressor
    fp16_strict = FP16Compressor
    bf16 = BF16Compressor
