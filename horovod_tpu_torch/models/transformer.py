"""Decoder-only transformer in PyTorch (counterpart of the full-sequence
path of ``horovod_tpu/models/transformer.py``).

Same parameters, same names, same shapes as the flax module, so a
checkpoint crosses packages by name and conversion is a copy
(:mod:`.convert`): ``embedding`` (vocab, d_model), ``pos_embedding``
(max_seq_len, d_model), per layer ``layer_<i>.ln1``/``ln2`` scale and bias,
``layer_<i>.attn.wq``/``wk``/``wv`` (d_model, H, D) and ``wo`` (H, D,
d_model), ``layer_<i>.mlp.wi``/``wo``, and ``ln_f``. Parameters are fp32;
activations run in ``cfg.dtype`` (bf16 by default) with the JAX module's
casts: LayerNorm statistics in fp32 (epsilon 1e-6, E[x^2] - E[x]^2),
tanh-approximate GELU, embeddings added in ``cfg.dtype``, fp32 logits
against the tied embedding.

Causal attention runs through ``cfg.attention_fn`` (``(q, k, v, mask,
dtype) -> out`` on (B, S, H, D)); the default is :func:`_default_attention`,
plain softmax attention. The training step injects the flash kernel there
(parallel/train.py). The paged KV-cache path is not ported yet.

Sharded (``Transformer.shard_``, the training mesh's tp and fsdp): every
parameter keeps only this process's block, by the logical axes of
:func:`logical_axes` and ``parallel.mesh_utils.TRANSFORMER_RULES`` (vocab,
heads and mlp over tp, embed over fsdp). Each fsdp-sharded weight is
all-gathered over fsdp just before its use (its gradient reduce-scattered
back in backward); attention runs on this process's H/tp heads and the MLP
on its hidden/tp columns, and their output projections are summed over tp
in the activation dtype. The embedding lookup is vocab-parallel, and the
forward returns the logits of this process's vocab block, (B, S,
vocab/tp): the loss is the vocab-parallel cross-entropy
(``MeshSharding.cross_entropy``), which reduces the softmax's max and sum
over tp instead of gathering the fp32 logits (2.1 GB at full width and
batch 8 x 2048).
"""

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..basics import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    head_dim: int = 64
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # injected attention implementation; default = plain softmax attention
    attention_fn: Optional[Callable] = None
    remat: bool = False


def _default_attention(q, k, v, mask, dtype):
    """Plain softmax attention: (B, S, H, D) inputs, causal mask applied.
    Scores are cast to fp32 after the product, as in the JAX module, and
    masked with the fp32 minimum."""
    depth = torch.tensor(q.shape[-1], dtype=torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / torch.sqrt(depth)
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def logical_axes(name: str) -> Optional[Tuple[Optional[str], ...]]:
    """The logical axes of parameter ``name`` (its state_dict key), as the
    flax module annotates them with ``nn.with_logical_partitioning``
    (``horovod_tpu/models/transformer.py``); None for the unannotated
    LayerNorm parameters."""
    leaf = name.rsplit(".", 2)[-2:]
    if name == "embedding":
        return ("vocab", "embed")
    if name == "pos_embedding":
        return (None, "embed")
    if leaf[0] == "attn":
        return ("heads", "kv", "embed") if leaf[1] == "wo" \
            else ("embed", "heads", "kv")
    if leaf[0] == "mlp":
        return ("embed", "mlp") if leaf[1] == "wi" else ("mlp", "embed")
    return None


def _use(shard, p, dtype):
    """A weight as a product takes it: gathered over fsdp when sharded,
    then cast to the activation dtype."""
    return (p if shard is None else shard.gather(p)).to(dtype)


def _normal(shape, device, generator):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if device.type != "meta":
        t.normal_(0.0, 0.02, generator=generator)
    return nn.Parameter(t)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=cfg.dtype, param_dtype=float32)``."""

    def __init__(self, features: int, dtype, device, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(self.dtype)


class Attention(nn.Module):
    shard = None

    def __init__(self, cfg: TransformerConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        E, H, D = cfg.d_model, cfg.num_heads, cfg.head_dim
        self.wq = _normal((E, H, D), device, generator)
        self.wk = _normal((E, H, D), device, generator)
        self.wv = _normal((E, H, D), device, generator)
        self.wo = _normal((H, D, E), device, generator)

    def forward(self, x, mask):
        dt, sh = self.cfg.dtype, self.shard
        if sh is not None:
            x = sh.tp_in(x)
        q = torch.einsum("bse,ehd->bshd", x, _use(sh, self.wq, dt))
        k = torch.einsum("bse,ehd->bshd", x, _use(sh, self.wk, dt))
        v = torch.einsum("bse,ehd->bshd", x, _use(sh, self.wv, dt))
        attn = self.cfg.attention_fn or _default_attention
        out = attn(q, k, v, mask, dt)
        out = torch.einsum("bshd,hde->bse", out, _use(sh, self.wo, dt))
        return out if sh is None else sh.tp_out(out)


class MlpBlock(nn.Module):
    shard = None

    def __init__(self, cfg: TransformerConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.d_model * cfg.mlp_ratio
        self.wi = _normal((cfg.d_model, hidden), device, generator)
        self.wo = _normal((hidden, cfg.d_model), device, generator)

    def forward(self, x):
        dt, sh = self.cfg.dtype, self.shard
        if sh is not None:
            x = sh.tp_in(x)
        h = torch.matmul(x, _use(sh, self.wi, dt))
        h = F.gelu(h, approximate="tanh")  # flax nn.gelu is the tanh form
        out = torch.matmul(h, _use(sh, self.wo, dt))
        return out if sh is None else sh.tp_out(out)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, generator):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.attn = Attention(cfg, device, generator)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.mlp = MlpBlock(cfg, device, generator)

    def forward(self, x, mask):
        x = x + self.attn(self.ln1(x), mask)
        return x + self.mlp(self.ln2(x))


class Transformer(nn.Module):
    """Full-sequence forward: tokens (B, S) -> fp32 logits (B, S, vocab).

    Parameters are created on ``device`` (cuda unless asked otherwise) and
    drawn from N(0, 0.02) with ``generator`` (one on that device), in the
    flax module's order; LayerNorm scales start at 1 and biases at 0."""

    shard = None

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.embedding = _normal((cfg.vocab_size, cfg.d_model), dev,
                                 generator)
        self.pos_embedding = _normal((cfg.max_seq_len, cfg.d_model), dev,
                                     generator)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", DecoderLayer(cfg, dev, generator))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, dev)

    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.cfg.num_layers)]

    def shard_(self, sharding) -> "Transformer":
        """Keep only this process's block of every parameter
        (``sharding.specs[name].index``, a ``parallel.mesh_utils
        .MeshSharding``) and run the sharded forward from now on. The
        parameter objects stay the same (their data shrinks), so an
        optimizer made afterwards holds state for the blocks only."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.data = p.data[sharding.specs[name].index].clone(
                    memory_format=torch.contiguous_format)
        sharding.bind(self.named_parameters())
        for m in self.modules():
            if isinstance(m, (Transformer, Attention, MlpBlock)):
                m.shard = sharding
        return self

    def forward(self, tokens, pos_offset: int = 0):
        """``pos_offset``: the global position of ``tokens``' first column.
        A sequence shard (sp index i of shards of length S) passes i * S,
        so its rows get the positions they have in the full sequence."""
        cfg = self.cfg
        B, S = tokens.shape
        dt = cfg.dtype
        if not 0 <= pos_offset <= cfg.max_seq_len - S:
            raise ValueError(f"positions [{pos_offset}, {pos_offset + S}) "
                             f"exceed max_seq_len {cfg.max_seq_len}")
        sh = self.shard
        pos = _use(sh, self.pos_embedding, dt)[pos_offset:pos_offset + S]
        if sh is None:
            x = self.embedding.to(dt)[tokens] + pos[None]
        else:
            x = sh.embed(tokens, _use(sh, self.embedding, dt)) + pos[None]
        mask = torch.ones(S, S, dtype=torch.bool,
                          device=tokens.device).tril()[None, None]
        for layer in self.layers():
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, mask, use_reentrant=False)
            else:
                x = layer(x, mask)
        x = self.ln_f(x)
        # logits in fp32, weight-tied to the embedding (sharded: this
        # process's vocab block)
        if sh is None:
            return torch.matmul(x.float(), self.embedding.t())
        return torch.matmul(sh.tp_in(x).float(),
                            sh.gather(self.embedding).t())
