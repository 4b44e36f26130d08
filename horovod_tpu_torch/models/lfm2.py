"""LFM2-MoE decoder in PyTorch (Liquid AI's ``lfm2_moe``, LFM2-8B-A1B):
a hybrid of gated short convolutions and grouped-query attention, with
dense SwiGLU feed-forwards in the first layers and sparse ones of
sigmoid-routed experts after them.

Every layer is pre-norm: ``h = x + op(RMSNorm(x))`` with ``op`` by the
config's ``layer_types``, then ``h + ffn(RMSNorm(h))``.

- ``conv``: ``in_proj`` to 3 x hidden giving B, C and x; ``y = C *
  causal_depthwise_conv(B * x)`` with ``conv_L_cache`` taps, the last tap
  on the current token; then ``out_proj``. The gates and the taps run in
  :class:`ShortConvFunction` inside the range ``hvd.conv.short``.
- ``full_attention``: q, k, v projections (``num_key_value_heads`` K/V
  heads), RMSNorm on q and k per head, rotary positions (rotate-half,
  ``rope_theta``), causal attention through ``cfg.attention_fn`` with K
  and V repeated to the query heads (head h reads K/V head h // group),
  ``out_proj``.
- the first ``num_dense_layers`` feed-forwards are SwiGLU of
  ``intermediate_size``; the rest are ``parallel.moe.dropless_moe`` over
  ``num_experts`` router outputs, of which this process holds
  ``experts_held`` (each a SwiGLU of ``moe_intermediate_size``), with a
  fixed ``expert_bias`` buffer that only selects.
- a final RMSNorm, then fp32 logits against the tied embedding.

Parameters are fp32 (N(0, 0.02) matrices and taps, RMSNorm scales 1,
the expert bias 0 unless set); activations run in ``cfg.dtype``; RMSNorm
statistics, q and k through their norm and rotary positions, and the
router's product are fp32. Parameter names: ``embedding`` (V, D); per
layer ``layer_<i>.operator_norm.scale`` and ``ffn_norm.scale`` (D,);
``conv.in_proj`` (D, 3D), ``conv.weight`` (D, L), ``conv.out_proj`` (D,
D); ``attn.wq`` (D, H*Dh), ``attn.wk``/``wv`` (D, KV*Dh), ``attn.wo``
(H*Dh, D), ``attn.q_norm.scale``/``k_norm.scale`` (Dh,); ``mlp.w1``/``w3``
(D, F) and ``mlp.w2`` (F, D); ``moe.router`` (D, E), ``moe.w1``/``w3``
(G, D, Fm), ``moe.w2`` (G, Fm, D) and the buffer ``moe.expert_bias``
(E,); ``norm_f.scale``.

No mesh: the model runs whole on each process (Horovod's data
parallelism); ``parallel.train`` refuses a mesh.
"""

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing as _tracing
from ..basics import resolve_device
from ..parallel.moe import SwiGLUFunction, dropless_moe
from .transformer import _default_attention, _normal

LFM2_8B_A1B_LAYER_TYPES = (
    "conv", "conv", "full_attention", "conv", "conv", "conv",
    "full_attention", "conv", "conv", "conv", "full_attention", "conv",
    "conv", "conv", "full_attention", "conv", "conv", "conv",
    "full_attention", "conv", "conv", "full_attention", "conv", "conv")


@dataclasses.dataclass(frozen=True)
class Lfm2MoeConfig:
    """The published ``lfm2_moe`` keys (defaults: LFM2-8B-A1B) and the
    port's: ``experts_held`` (first, stop) of the router's
    ``num_experts`` outputs (None: all), ``max_seq_len``, ``dtype`` and
    the injected ``attention_fn``."""
    vocab_size: int = 65536
    hidden_size: int = 2048
    intermediate_size: int = 7168
    moe_intermediate_size: int = 1792
    num_hidden_layers: int = 24
    layer_types: Tuple[str, ...] = LFM2_8B_A1B_LAYER_TYPES
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    conv_L_cache: int = 3
    conv_bias: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    num_dense_layers: int = 2
    num_experts: int = 32
    num_experts_per_tok: int = 4
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    use_expert_bias: bool = True
    experts_held: Optional[Tuple[int, int]] = None
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    attention_fn: Optional[Callable] = None

    def __post_init__(self):
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(f"{len(self.layer_types)} layer_types for "
                             f"{self.num_hidden_layers} layers")
        bad = set(self.layer_types) - {"conv", "full_attention"}
        if bad:
            raise ValueError(f"unknown layer types {sorted(bad)}")
        if self.conv_bias:
            raise ValueError("the port's short convolution has no bias")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("query heads must be a multiple of K/V heads")
        first, stop = self.held
        if not 0 <= first < stop <= self.num_experts:
            raise ValueError(f"experts_held {self.experts_held} outside "
                             f"the router's {self.num_experts} experts")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def held(self) -> Tuple[int, int]:
        return tuple(self.experts_held or (0, self.num_experts))


class RMSNormFunction(torch.autograd.Function):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis with the
    statistics in fp32 (fp64 for fp64 inputs), the output in
    ``out_dtype``; it saves the input and each row's reciprocal root and
    nothing in fp32 of the input's size."""

    @staticmethod
    def forward(ctx, x, scale, eps, out_dtype):
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, rstd)
        return (xf * rstd * scale).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        xhat = x.to(rstd.dtype) * rstd
        g = g.to(rstd.dtype)
        gs = g * scale
        dx = rstd * (gs - xhat * (gs * xhat).mean(-1, keepdim=True))
        dscale = (g * xhat).reshape(-1, x.shape[-1]).sum(0)
        return dx.to(x.dtype), dscale.to(scale.dtype), None, None


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * scale`` with fp32 statistics; the
    output in ``dtype`` (None: fp32)."""

    def __init__(self, features: int, eps: float, dtype, device):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x):
        return RMSNormFunction.apply(x, self.scale, self.eps,
                                     self.dtype or self.scale.dtype)


def rotary_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos and sin (S, head_dim) in fp32 of rotate-half rotary positions,
    the angles computed in fp64."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                       device=positions.device) / head_dim)
    ang = positions.double()[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float(), ang.sin().float()


def apply_rotary(x, cos, sin):
    """Rotate-half rotary positions on (B, S, H, Dh): the first half of
    each head pairs with the second."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


class ShortConvFunction(torch.autograd.Function):
    """``y = c * conv(b * x)`` on (B, S, D) gates ``b``, ``c`` and input
    ``x``, with a causal depthwise convolution of ``w`` (D, L) taps:
    ``conv(z)[t] = sum_j w[:, j] * z[t - (L - 1) + j]`` (zeros before the
    row). The products and sums run in fp32 (fp64 for fp64 inputs), in
    place where they can, the output in ``x``'s dtype; the backward
    recomputes ``b * x`` from the saved inputs."""

    @staticmethod
    def _taps(z, w, transpose: bool = False):
        """The taps over the sequence axis of ``z`` (fp32); with
        ``transpose``, their adjoint (the shifts run the other way)."""
        L = w.shape[1]
        out = z * w[:, L - 1]
        for j in range(L - 1):
            lag = L - 1 - j
            if transpose:
                out[:, :-lag].addcmul_(z[:, lag:], w[:, j])
            else:
                out[:, lag:].addcmul_(z[:, :-lag], w[:, j])
        return out

    @staticmethod
    def forward(ctx, b, c, x, w):
        ctx.save_for_backward(b, c, x, w)
        acc = torch.promote_types(x.dtype, torch.float32)
        z = b.to(acc, copy=True).mul_(x)
        return ShortConvFunction._taps(z, w.to(acc)).mul_(c).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        b, c, x, w = ctx.saved_tensors
        acc = torch.promote_types(x.dtype, torch.float32)
        wa, L = w.to(acc), w.shape[1]
        z = b.to(acc, copy=True).mul_(x)
        dc = ShortConvFunction._taps(z, wa).mul_(g)
        gconv = g.to(acc, copy=True).mul_(c)
        dz = ShortConvFunction._taps(gconv, wa, transpose=True)
        dw = torch.empty_like(wa)
        for j in range(L):
            lag = L - 1 - j
            dw[:, j] = torch.einsum("bsd,bsd->d", gconv[:, lag:],
                                    z[:, :z.shape[1] - lag])
        return (dz * x).to(b.dtype), dc.to(c.dtype), dz.mul_(b).to(x.dtype), \
            dw.to(w.dtype)


class ShortConv(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        D, L = cfg.hidden_size, cfg.conv_L_cache
        self.in_proj = _normal((D, 3 * D), device, generator)
        self.weight = _normal((D, L), device, generator)
        self.out_proj = _normal((D, D), device, generator)

    def forward(self, x):
        dt = self.cfg.dtype
        b, c, xx = torch.matmul(x, self.in_proj.to(dt)).chunk(3, dim=-1)
        with _tracing.span("conv.short"):
            y = ShortConvFunction.apply(b, c, xx, self.weight)
        return torch.matmul(y, self.out_proj.to(dt))


class GQAttention(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        D, H, KV, Dh = (cfg.hidden_size, cfg.num_attention_heads,
                        cfg.num_key_value_heads, cfg.head_dim)
        self.wq = _normal((D, H * Dh), device, generator)
        self.wk = _normal((D, KV * Dh), device, generator)
        self.wv = _normal((D, KV * Dh), device, generator)
        self.wo = _normal((H * Dh, D), device, generator)
        self.q_norm = RMSNorm(Dh, cfg.norm_eps, None, device)
        self.k_norm = RMSNorm(Dh, cfg.norm_eps, None, device)

    def forward(self, x, mask, cos, sin):
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, _ = x.shape
        H, KV, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        q = torch.matmul(x, self.wq.to(dt)).view(B, S, H, Dh)
        k = torch.matmul(x, self.wk.to(dt)).view(B, S, KV, Dh)
        v = torch.matmul(x, self.wv.to(dt)).view(B, S, KV, Dh)
        q = apply_rotary(self.q_norm(q), cos, sin).to(dt)
        k = apply_rotary(self.k_norm(k), cos, sin).to(dt)
        # K/V head j serves query heads j * group .. (j + 1) * group - 1
        group = H // KV
        k = k[:, :, :, None].expand(B, S, KV, group, Dh).reshape(B, S, H, Dh)
        v = v[:, :, :, None].expand(B, S, KV, group, Dh).reshape(B, S, H, Dh)
        attn = cfg.attention_fn or _default_attention
        out = attn(q, k, v, mask, dt).reshape(B, S, H * Dh)
        return torch.matmul(out, self.wo.to(dt))


class SwiGLU(nn.Module):
    """``w2(silu(x w1) * (x w3))``."""

    def __init__(self, cfg: Lfm2MoeConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        D, Fd = cfg.hidden_size, cfg.intermediate_size
        self.w1 = _normal((D, Fd), device, generator)
        self.w3 = _normal((D, Fd), device, generator)
        self.w2 = _normal((Fd, D), device, generator)

    def forward(self, x):
        dt = self.cfg.dtype
        h = torch.matmul(x, torch.cat([self.w1.to(dt), self.w3.to(dt)], 1))
        return torch.matmul(SwiGLUFunction.apply(h), self.w2.to(dt))


class SparseMoeBlock(nn.Module):
    """The held experts' part of a sparse feed-forward
    (``parallel.moe.dropless_moe``)."""

    def __init__(self, cfg: Lfm2MoeConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        D, Fm, E = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
        first, stop = cfg.held
        G = stop - first
        self.router = _normal((D, E), device, generator)
        self.w1 = _normal((G, D, Fm), device, generator)
        self.w3 = _normal((G, D, Fm), device, generator)
        self.w2 = _normal((G, Fm, D), device, generator)
        self.register_buffer("expert_bias",
                             torch.zeros(E, device=device)
                             if cfg.use_expert_bias else None)

    def forward(self, x):
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, D = x.shape
        y = dropless_moe(
            x.reshape(B * S, D), self.router, self.expert_bias,
            torch.cat([self.w1.to(dt), self.w3.to(dt)], dim=2), self.w2.to(dt),
            cfg.held, cfg.num_experts_per_tok, cfg.norm_topk_prob,
            cfg.routed_scaling_factor)
        return y.view(B, S, D)


class Lfm2Layer(nn.Module):
    def __init__(self, cfg: Lfm2MoeConfig, index: int, device, generator):
        super().__init__()
        D, eps, dt = cfg.hidden_size, cfg.norm_eps, cfg.dtype
        self.operator_norm = RMSNorm(D, eps, dt, device)
        if cfg.layer_types[index] == "conv":
            self.conv = ShortConv(cfg, device, generator)
        else:
            self.attn = GQAttention(cfg, device, generator)
        self.ffn_norm = RMSNorm(D, eps, dt, device)
        if index < cfg.num_dense_layers:
            self.mlp = SwiGLU(cfg, device, generator)
        else:
            self.moe = SparseMoeBlock(cfg, device, generator)

    def forward(self, x, mask, cos, sin):
        h = self.operator_norm(x)
        if hasattr(self, "conv"):
            x = x + self.conv(h)
        else:
            x = x + self.attn(h, mask, cos, sin)
        ffn = self.mlp if hasattr(self, "mlp") else self.moe
        return x + ffn(self.ffn_norm(x))


class Lfm2Moe(nn.Module):
    """Full-sequence forward: tokens (B, S) -> fp32 logits (B, S, vocab).

    Parameters are created on ``device`` (cuda unless asked otherwise) and
    drawn with ``generator`` (one on that device)."""

    def __init__(self, cfg: Lfm2MoeConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.embedding = _normal((cfg.vocab_size, cfg.hidden_size), dev,
                                 generator)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layer_{i}", Lfm2Layer(cfg, i, dev, generator))
        self.norm_f = RMSNorm(cfg.hidden_size, cfg.norm_eps, cfg.dtype, dev)

    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.cfg.num_hidden_layers)]

    def forward(self, tokens):
        cfg = self.cfg
        S = tokens.shape[1]
        if S > cfg.max_seq_len:
            raise ValueError(f"{S} tokens exceed max_seq_len "
                             f"{cfg.max_seq_len}")
        x = self.embedding.to(cfg.dtype)[tokens]
        positions = torch.arange(S, device=tokens.device)
        cos, sin = rotary_tables(positions, cfg.head_dim, cfg.rope_theta)
        mask = None   # an injected attention masks causally itself
        if cfg.attention_fn is None:
            mask = torch.ones(S, S, dtype=torch.bool,
                              device=tokens.device).tril()[None, None]
        for layer in self.layers():
            x = layer(x, mask, cos, sin)
        # logits in fp32, weight-tied to the embedding
        return torch.matmul(self.norm_f(x).float(), self.embedding.t())
