"""The precisions a reference computes its products in.

``fp32`` is exact float32. ``fp8`` is the control of the check that
decides ``correct``: the nearest precision below the configurations'
bfloat16, at the places where the program keeps bfloat16. Every
product's operands, and every activation the program keeps in bfloat16
(a product's output, a normalisation's, a residual sum, a nonlinearity's
output), are rounded to float8 e4m3 with one scale per tensor (its
largest magnitude onto e4m3's largest finite value, 448), as an fp8
training recipe does, and the arithmetic between runs in float32; in the
backward the gradient flowing into each activation is rounded to float8
e5m2 (largest finite 57344) the same way.
"""

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    """Forward: the operand rounded to e4m3. Backward: the gradient passes
    through as it is (the product's own backward rounds it)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Activation(torch.autograd.Function):
    """Forward: the activation rounded to e4m3. Backward: the incoming
    gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return _round(y, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """``op(x)`` wraps a product's operand, ``act(y)`` an activation
    (a product's output among them)."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "fp32" else _Operand.apply(x)

    def act(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.name == "fp32" else _Activation.apply(y)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return self.act(torch.einsum(eq, self.op(a), self.op(b)))
