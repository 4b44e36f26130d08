"""The LFM2-MoE decoder (Liquid AI's ``lfm2_moe``, LFM2-8B-A1B) in plain
PyTorch, float32, as the configuration file states it, with the chip's
share of the experts.

Every layer is pre-norm, ``h = x + op(RMSNorm(x))`` then ``h +
ffn(RMSNorm(h))``, RMSNorm ``x * rsqrt(mean(x^2) + eps) * scale``:

- ``conv`` layers: ``in_proj`` to 3 x hidden, split into B, C and x in
  that order; ``y = C * conv(B * x)``, a depthwise ``Conv1d`` of
  ``conv_L_cache`` taps padded by L - 1 on both sides and cut to the
  row's length (causal: the last tap on the current token); ``out_proj``.
- ``full_attention`` layers: q, k, v projections, RMSNorm of q and k over
  each head's features, rotary positions in the rotate-half form (the
  first half of a head pairs with the second) with base ``rope_theta``,
  causal softmax attention scaled by 1/sqrt(head_dim) in which query head
  h reads K/V head h // (heads / K/V heads), ``out_proj``.
- feed-forwards: SwiGLU ``w2(silu(x w1) * (x w3))``, dense on the first
  ``num_dense_layers`` layers; after them a router ``sigmoid(x W_r)`` over
  the ``router_experts`` experts, the top ``num_experts_per_tok`` picked
  on score plus ``expert_bias``, weighted by their unbiased scores over
  their sum plus 1e-6 (``norm_topk_prob``) times
  ``routed_scaling_factor``, each picked expert a SwiGLU of
  ``moe_intermediate_size``.
- a final RMSNorm and logits against the tied token embedding.

Departures, also listed under the configuration's ``departures``:

- the chip's share of the experts: only the experts of ``experts_held``
  have weights here, and a token's picks outside them add nothing, as in
  the program; the router still scores every expert, and the weights of
  the picks are normalised over all of them;
- ``expert_bias`` is a fixed leaf: it selects and takes no gradient (the
  published aux-loss-free update of the bias is not run); the
  benchmark's written-out AdamW (``optim.py``) still applies its weight
  decay to it, 1e-7 of its value a step, where the program leaves it;
- the router's product, and every other, runs in float32 (the program
  runs its router in float32 too).

Computed in blocks so that it fits beside the optimizer state at the
cell's sizes: each layer is recomputed in the backward
(``torch.utils.checkpoint``), and attention runs in blocks of query rows,
each recomputed too.

Leaves (the program's parameter names): ``embedding`` (V, D); per layer
``layer_<i>.operator_norm.scale``, ``layer_<i>.ffn_norm.scale`` (D,);
conv layers ``layer_<i>.conv.in_proj`` (D, 3D), ``.conv.weight`` (D, L),
``.conv.out_proj`` (D, D); attention layers ``layer_<i>.attn.wq`` (D,
H*Dh), ``.attn.wk``/``.attn.wv`` (D, KV*Dh), ``.attn.wo`` (H*Dh, D),
``.attn.q_norm.scale``/``.attn.k_norm.scale`` (Dh,); dense layers
``layer_<i>.mlp.w1``/``w3`` (D, F), ``.mlp.w2`` (F, D); sparse layers
``layer_<i>.moe.router`` (D, E), ``.moe.expert_bias`` (E,),
``.moe.w1``/``w3`` (G, D, Fm), ``.moe.w2`` (G, Fm, D) for the G experts
held; ``norm_f.scale``.
"""

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import Precision

#: query rows of one attention block
ATTN_BLOCK = 1024


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def short_conv(b, c, x, w):
    """``c * conv(b * x)`` on (B, S, D), the depthwise taps ``w`` (D, L)
    as ``nn.Conv1d(D, D, L, groups=D, padding=L - 1)`` cut to S."""
    S, (D, L) = x.shape[1], w.shape
    z = (b * x).transpose(1, 2)
    conv = F.conv1d(z, w[:, None, :], padding=L - 1, groups=D)[..., :S]
    return c * conv.transpose(1, 2)


def rotate(x):
    """The rotate-half partner of each feature: (-x2, x1)."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rotary(x, positions, theta):
    """Rotary positions on (B, S, H, Dh), angles in float64."""
    Dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float64,
                                       device=x.device) / Dh)
    ang = positions.double()[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float(), ang.sin().float()
    return x * cos[:, None] + rotate(x) * sin[:, None]


def qk_norm(x, scale, eps):
    return rms_norm(x, scale, eps)


def kv_head(h: int, heads: int, kv_heads: int) -> int:
    """The K/V head that query head ``h`` reads."""
    return h // (heads // kv_heads)


def route(logits, bias, cfg: dict):
    """(picked experts (T, k), their weights (T, k)) of the sigmoid
    router."""
    scores = torch.sigmoid(logits)
    _, picked = torch.topk(scores + bias, cfg["num_experts_per_tok"], dim=-1)
    weights = scores.gather(-1, picked)
    if cfg["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    return picked, weights * cfg["routed_scaling_factor"]


def _attn_block(q, k, v, start, prec):
    Q, K = q.shape[1], k.shape[1]
    s = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    rows = torch.arange(start, start + Q, device=q.device)
    seen = rows[:, None] >= torch.arange(K, device=q.device)[None]
    a = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
    return prec.einsum("bhqk,bkhd->bqhd", a, v)


def attention(h, w, p, cfg, prec, positions):
    B, S, _ = h.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh, eps = cfg["hidden_size"] // H, cfg["norm_eps"]
    q = prec.einsum("bse,ef->bsf", h, w[p + "wq"]).view(B, S, H, Dh)
    k = prec.einsum("bse,ef->bsf", h, w[p + "wk"]).view(B, S, KV, Dh)
    v = prec.einsum("bse,ef->bsf", h, w[p + "wv"]).view(B, S, KV, Dh)
    q = prec.act(rotary(qk_norm(q, w[p + "q_norm.scale"], eps), positions,
                        cfg["rope_theta"]))
    k = prec.act(rotary(qk_norm(k, w[p + "k_norm.scale"], eps), positions,
                        cfg["rope_theta"]))
    heads = torch.tensor([kv_head(j, H, KV) for j in range(H)],
                         device=h.device)
    k, v = k[:, :, heads], v[:, :, heads]
    out = torch.cat([
        checkpoint(_attn_block, q[:, r:r + ATTN_BLOCK],
                   k[:, :r + ATTN_BLOCK], v[:, :r + ATTN_BLOCK], r, prec,
                   use_reentrant=False)
        for r in range(0, S, ATTN_BLOCK)], dim=1)
    return prec.einsum("bsf,fe->bse", prec.act(out).reshape(B, S, H * Dh),
                       w[p + "wo"])


def conv_op(h, w, p, prec):
    b, c, x = prec.einsum("bse,ef->bsf", h, w[p + "in_proj"]).chunk(3, -1)
    y = prec.act(short_conv(b, c, x, w[p + "weight"]))
    return prec.einsum("bse,ef->bsf", y, w[p + "out_proj"])


def swiglu(x, w1, w3, w2, prec):
    h = prec.act(F.silu(prec.einsum("td,df->tf", x, w1))
                 * prec.einsum("td,df->tf", x, w3))
    return prec.einsum("tf,fd->td", h, w2)


def moe(h, w, p, cfg, prec):
    """The held experts' part of the sparse feed-forward of (B, S, D)."""
    B, S, D = h.shape
    x = h.reshape(B * S, D)
    picked, weights = route(x @ w[p + "router"], w[p + "expert_bias"], cfg)
    first = cfg["experts_held"][0]
    y = torch.zeros_like(x)
    for g in range(cfg["num_experts"]):
        hit = picked == first + g
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        share = (weights * hit).sum(-1)[rows]
        out = swiglu(x[rows], w[p + "w1"][g], w[p + "w3"][g], w[p + "w2"][g],
                     prec)
        y = y.index_add(0, rows, out * share[:, None])
    return prec.act(y).view(B, S, D)


def layer(x, w, i, cfg, prec, positions):
    p, eps = f"layer_{i}.", cfg["norm_eps"]
    h = prec.act(rms_norm(x, w[p + "operator_norm.scale"], eps))
    if cfg["layer_types"][i] == "conv":
        x = prec.act(x + conv_op(h, w, p + "conv.", prec))
    else:
        x = prec.act(x + attention(h, w, p + "attn.", cfg, prec, positions))
    h = prec.act(rms_norm(x, w[p + "ffn_norm.scale"], eps))
    if i < cfg["num_dense_layers"]:
        B, S, D = h.shape
        f = swiglu(h.reshape(B * S, D), w[p + "mlp.w1"], w[p + "mlp.w3"],
                   w[p + "mlp.w2"], prec).view(B, S, D)
    else:
        f = moe(h, w, p + "moe.", cfg, prec)
    return prec.act(x + f)


def logits(w: Dict[str, torch.Tensor], tokens, cfg: dict,
           prec: Precision) -> torch.Tensor:
    """The logits (B, S, V) of ``tokens`` (B, S), each layer recomputed
    in the backward."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = prec.act(w["embedding"][tokens])
    for i in range(cfg["num_hidden_layers"]):
        x = checkpoint(layer, x, w, i, cfg, prec, positions,
                       use_reentrant=False)
    x = prec.act(rms_norm(x, w["norm_f.scale"], cfg["norm_eps"]))
    return prec.einsum("bse,ve->bsv", x, w["embedding"])


def loss_sum(w: Dict[str, torch.Tensor], tokens, targets, cfg: dict,
             prec: Precision) -> torch.Tensor:
    """The summed next-token cross-entropy of ``tokens`` (B, S) against
    ``targets`` (B, S)."""
    out = logits(w, tokens, cfg, prec)
    picked = out.gather(-1, targets[..., None])[..., 0]
    return (torch.logsumexp(out, dim=-1) - picked).sum()


def loss_and_grads(w: Dict[str, torch.Tensor], batch, cfg: dict,
                   prec: Precision, rows_per_block: int = 1):
    """The mean loss over all tokens of ``batch`` = (tokens, targets) and
    its gradient, ``rows_per_block`` rows at a time. The expert bias
    takes no gradient, and a held expert that no token picked gets a zero
    one."""
    tokens, targets = batch
    count = tokens.numel()
    leaves = {n: t.detach().requires_grad_(not n.endswith("expert_bias"))
              for n, t in w.items()}
    total = 0.0
    for r in range(0, tokens.shape[0], rows_per_block):
        part = loss_sum(leaves, tokens[r:r + rows_per_block],
                        targets[r:r + rows_per_block], cfg, prec) / count
        part.backward()
        total += part.item()
    grads = {n: t.grad if t.grad is not None else torch.zeros_like(t)
             for n, t in leaves.items()}
    return total, grads, {}


def update_running(buffers, stats, cfg: dict) -> None:
    """Running statistics: the decoder keeps none."""
