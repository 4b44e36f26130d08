"""Gradient compression (counterpart of ``horovod_tpu/compression.py``;
reference: horovod/torch/compression.py NoneCompressor / FP16Compressor).

The mapping follows the JAX package so that one setting means the same in
both: ``Compression.fp16`` is bfloat16 (same exponent range as fp32),
``Compression.fp16_strict`` is IEEE float16. Its consumers:

* **Eager** (``DistributedOptimizer`` without ``axis_name``):
  ``compress``/``decompress`` bracket the bucket's allreduce per tensor.
  The allreduce accumulates half members in fp32 (collectives.py), so
  there compression rounds the gradient without shrinking the wire.
* **Compiled packed** (``axis_name=..., packing='packed'``): the packed
  buffers read the class-level wire metadata instead: ``wire_dtype`` is
  what a bucket is cast to before its wire call, and ``sum_safe_wire``
  says whether the sum may run in that dtype (bf16 may; fp16 is summed
  in fp32, as the JAX package's upcast-psum does).
* **int8** (:class:`Int8Compressor`, ``stateful``) is compiled-packed
  only: a shared per-bucket scale and an error-feedback residual the
  optimizer carries as state; :func:`int8_pack_reduce` reduces one
  bucket.
"""

import torch


class Compressor:
    """Interface: compress(tensor) -> (compressed, ctx);
    decompress(compressed, ctx) -> tensor. Class-level wire metadata
    drives the compiled packed path: ``wire_dtype`` (None: the native
    dtype on the wire), ``sum_safe_wire`` (False: summed in fp32),
    ``stateful`` (True: needs an error-feedback residual)."""

    wire_dtype = None
    sum_safe_wire = True
    stateful = False

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
    """Compress float gradients to bfloat16. Packed: the bucket is summed
    in bf16 on the wire (fp32's exponent range: the sum cannot
    overflow)."""
    target = wire_dtype = torch.bfloat16


class FP16Compressor(_HalfCompressor):
    """Compress float gradients to IEEE float16. Packed: rounded to fp16,
    summed in fp32 (fp16's exponent overflows under a cross-rank sum)."""
    target = wire_dtype = torch.float16
    sum_safe_wire = False


class Int8Compressor(Compressor):
    """Per-bucket symmetric int8 quantization with error feedback, on the
    compiled packed path only (:func:`int8_pack_reduce`). Every process
    takes its bucket's absmax, the group's MAX of it is the shared scale,
    the int8 values travel by all-gather and are summed exactly in int32,
    and each process keeps its quantization error as a residual that is
    added to its next gradient (EF-SGD). The eager ``compress`` raises:
    process-local scales cannot be summed."""

    stateful = True

    @staticmethod
    def compress(tensor):
        raise NotImplementedError(
            "Compression.int8 is a compiled-plane wire compressor: use "
            "DistributedOptimizer(axis_name=..., packing='packed', "
            "compression=Compression.int8) so the shared per-bucket "
            "scale and the error-feedback state exist.")

    decompress = compress


def true_divide(t: torch.Tensor, d) -> torch.Tensor:
    """``t / d`` by IEEE division, as XLA divides: a divisor given as a
    Python number becomes a reciprocal multiply in PyTorch's CUDA kernel,
    which differs in the last bit where ``d`` is not a power of two."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


def int8_pack_reduce(flat: torch.Tensor, residual, group=None,
                     average: bool = True):
    """One int8 bucket: error feedback -> shared scale (MAX over
    ``group``) -> int8 quantize -> all-gather -> exact int32 sum ->
    dequantize in fp32. Returns ``(reduced_fp32, new_residual_fp32)``.

    ``group`` None, or a group of one, quantizes and dequantizes locally,
    so the residual is still exercised. ``average`` divides by the group's
    size after the exact integer sum. The wire calls run through
    ``collectives.run_in_order``; while torch.compile traces, they are
    in-graph collectives (the group's size a constant of the graph) and
    the numerics stay these."""
    from .mesh import group_allgather, group_allreduce, group_size
    x = flat.to(torch.float32)
    if residual is not None:
        x = x + residual.to(torch.float32)
    absmax = torch.max(torch.abs(x))
    n = 1 if group is None else group_size(group)
    if n > 1:
        absmax, = group_allreduce([absmax], group, "max")
    scale = torch.maximum(true_divide(absmax, 127.0), torch.full(
        (), torch.finfo(torch.float32).tiny, device=x.device))
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    # x - q * scale rounded once, as XLA computes it (it contracts the
    # product and the difference into one FMA; rounding the product
    # first moves the residual, then the next step's scale, by an ulp).
    # In fp64 both are exact: the product has at most 7 + 24 bits, and
    # x lies within half a scale of it; the cast back is the one rounding.
    new_residual = (x.double() - q.double() * scale.double()).float()
    if n > 1:
        summed = group_allgather(q, group).to(torch.int32).sum(
            dim=0, dtype=torch.int32)
    else:
        summed = q.to(torch.int32)
    out = summed.to(torch.float32) * scale
    if average and n > 1:
        out = true_divide(out, n)
    return out, new_residual


class Compression:
    """Optional gradient compression algorithms (reference API:
    hvd.Compression.none / hvd.Compression.fp16; int8 is the packed
    compiled-plane extension)."""
    none = NoneCompressor
    fp16 = BF16Compressor
    fp16_strict = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
