"""flax.linen's convolution, batch-norm and dense layers, as the JAX
package's CNN zoo uses them, on NCHW tensors.

Each layer keeps flax's parameter names (``kernel``, ``bias``, ``scale``;
the batch statistics ``mean`` and ``var`` are buffers), so a flax tree
converts by name (:mod:`.convert`). Kernels are stored in torch's layout:
a conv kernel OIHW (flax: HWIO), a dense kernel (out, in) (flax: (in,
out)). Parameters are fp32 and are cast to the layer's ``dtype`` on every
call, with the input, as ``dtype=bf16, param_dtype=float32`` does in
flax; the accumulation is fp32 on the card either way.

:class:`Conv` pads as flax does. ``"SAME"`` is XLA's rule
(``lax.padtype_to_pads``): the total pad a dim needs is split with the
odd pixel at the high end, so a 3x3 stride-2 conv on an even input pads
(0, 1), not torch's (1, 1); the pads are worked out from the input's
size on every call, and an asymmetric pair goes through ``F.pad``.

:class:`BatchNorm` is flax's: statistics in fp32, the output cast to
``dtype``, and running statistics that move by ``momentum`` toward the
batch mean and the batch's *biased* variance (``torch.nn.BatchNorm2d``
uses the unbiased one). With ``sync`` set, the batch is the global batch
over ``process_set`` (the world when None), through the port's
SyncBatchNorm function, as XLA computes it when the batch is sharded
over the data-parallel axis.
"""

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Padding = Union[str, Sequence[Tuple[int, int]]]

# lecun_normal: a normal truncated at two standard deviations, scaled so
# that its variance is 1 / fan_in (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's default kernel initializer, drawn with ``generator``."""
    if t.device.type == "meta":
        return t
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one dim: (low, high), the odd pixel high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``flax.linen.Conv`` on NCHW: ``padding`` is "SAME", "VALID" or
    flax's ((low, high), (low, high))."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Padding = "SAME", use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.padding = padding if isinstance(padding, str) else tuple(
            tuple(p) for p in padding)
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(features, in_features, kh, kw, device=device),
            in_features * kh * kw, generator))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None

    def pads(self, h: int, w: int) -> Tuple[Tuple[int, int], ...]:
        """((top, bottom), (left, right)) for an h x w input."""
        if self.padding == "SAME":
            kh, kw = self.kernel.shape[2:]
            return (same_pads(h, kh, self.strides[0]),
                    same_pads(w, kw, self.strides[1]))
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        return self.padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = self.pads(*x.shape[2:])
        x = x.to(self.dtype)
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.kernel.to(self.dtype), bias, self.strides,
                        padding)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum, epsilon, dtype, param_dtype=
    float32)`` over the channels of NCHW; see the module docstring.
    ``zero_scale``: the scale starts at 0 (``scale_init=zeros``)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False, device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.sync = False
        self.process_set = None
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0,
                                self.epsilon).to(self.dtype)
        if self.sync:
            from ..sync_batch_norm import _SyncBatchNormFn
            out, mean, var, _ = _SyncBatchNormFn.apply(
                x, self.scale, self.bias, self.epsilon, self.process_set)
            var = torch.clamp(var, min=0.0)
        else:
            # torch's batch norm moves running statistics by the unbiased
            # variance: with momentum 1 they are this batch's mean and
            # unbiased variance, which n-1/n makes biased
            mean = torch.zeros_like(self.mean)
            var = torch.zeros_like(self.var)
            out = F.batch_norm(x, mean, var, self.scale, self.bias, True,
                               1.0, self.epsilon)
            n = x.numel() // x.shape[1]
            var = var * ((n - 1) / n)
        with torch.no_grad():
            m = self.momentum
            self.mean.mul_(m).add_(mean, alpha=1 - m)
            self.var.mul_(m).add_(var, alpha=1 - m)
        return out.to(self.dtype)


class Dense(nn.Module):
    """``flax.linen.Dense(features, dtype, param_dtype=float32)``; the
    kernel is stored (out, in)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(features, in_features, device=device), in_features,
            generator))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype),
                        self.bias.to(self.dtype))


def nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W*C) in flax's NHWC order, so the next dense
    kernel's rows are the JAX module's."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def sync_batch_norm_(model: nn.Module, process_set=None) -> nn.Module:
    """Make every :class:`BatchNorm` of ``model`` take its training
    statistics over the global batch of ``process_set`` (the world when
    None)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync = True
            m.process_set = process_set
    return model
