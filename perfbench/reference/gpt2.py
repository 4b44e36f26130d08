"""A GPT-2-shaped decoder in plain PyTorch (Radford et al. 2019), as the
configuration file states it: learned positions, pre-LayerNorm blocks,
multi-head causal attention, an MLP of four times the width with the tanh
GELU ("gelu_new"), a final LayerNorm and logits against the tied token
embedding. The departures the configuration lists under ``assumed`` hold
here too: no biases on the projections, and LayerNorm's epsilon as the
file gives it.

Leaves (by the program's parameter names): ``embedding`` (V, E),
``pos_embedding`` (P, E), per layer ``layer_<i>.ln1.scale``/``.bias``,
``layer_<i>.attn.wq``/``wk``/``wv`` (E, H, D), ``layer_<i>.attn.wo``
(H, D, E), ``layer_<i>.ln2.*``, ``layer_<i>.mlp.wi`` (E, 4E) and
``layer_<i>.mlp.wo`` (4E, E), and ``ln_f.scale``/``.bias``.
"""

import math
from typing import Dict

import torch

from .precision import Precision


def layer_norm(x, scale, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x * x * x)))


def loss_sum(w: Dict[str, torch.Tensor], tokens, targets, cfg: dict,
             prec: Precision) -> torch.Tensor:
    """The summed next-token cross-entropy of ``tokens`` (B, S) against
    ``targets`` (B, S)."""
    E, H, L = cfg["n_embd"], cfg["n_head"], cfg["n_layer"]
    D = E // H
    eps = cfg["layer_norm_epsilon"]
    S = tokens.shape[1]
    act = prec.act
    x = act(w["embedding"][tokens] + w["pos_embedding"][:S][None])
    hidden = torch.ones(S, S, dtype=torch.bool, device=tokens.device).tril()
    for i in range(L):
        p = f"layer_{i}."
        h = act(layer_norm(x, w[p + "ln1.scale"], w[p + "ln1.bias"], eps))
        q = prec.einsum("bse,ehd->bshd", h, w[p + "attn.wq"])
        k = prec.einsum("bse,ehd->bshd", h, w[p + "attn.wk"])
        v = prec.einsum("bse,ehd->bshd", h, w[p + "attn.wv"])
        s = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
        a = torch.softmax(s.masked_fill(~hidden, float("-inf")), dim=-1)
        o = prec.einsum("bhqk,bkhd->bqhd", a, v)
        x = act(x + prec.einsum("bshd,hde->bse", o, w[p + "attn.wo"]))
        h = act(layer_norm(x, w[p + "ln2.scale"], w[p + "ln2.bias"], eps))
        u = act(gelu_tanh(prec.einsum("bse,ef->bsf", h, w[p + "mlp.wi"])))
        x = act(x + prec.einsum("bsf,fe->bse", u, w[p + "mlp.wo"]))
    x = act(layer_norm(x, w["ln_f.scale"], w["ln_f.bias"], eps))
    logits = prec.einsum("bse,ve->bsv", x, w["embedding"])
    picked = logits.gather(-1, targets[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - picked).sum()


def loss_and_grads(w: Dict[str, torch.Tensor], batch, cfg: dict,
                   prec: Precision, rows_per_block: int = 2):
    """The mean loss over all tokens of ``batch`` = (tokens, targets) and
    its gradient, computed ``rows_per_block`` rows at a time (the
    gradients of the blocks' shares add up to the whole batch's)."""
    tokens, targets = batch
    count = tokens.numel()
    leaves = {n: t.detach().requires_grad_(True) for n, t in w.items()}
    total = 0.0
    for r in range(0, tokens.shape[0], rows_per_block):
        part = loss_sum(leaves, tokens[r:r + rows_per_block],
                        targets[r:r + rows_per_block], cfg, prec) / count
        part.backward()
        total += part.item()
    grads = {n: t.grad for n, t in leaves.items()}
    return total, grads, {}


def update_running(buffers, stats, cfg: dict) -> None:
    """Running statistics: the decoder keeps none."""
