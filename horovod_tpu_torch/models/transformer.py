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
(parallel/train.py).

Paged incremental path (the generation plane,
:mod:`horovod_tpu_torch.serving.generation`): given a :class:`PagedCache`,
``forward`` runs one chunk of ``C`` tokens per row against a paged KV
cache, as the JAX module does. Each layer scatters the chunk's K/V into
fixed-size blocks of its pool through the rows' block tables (pad tokens
and dead lanes write to the null block 0), then gathers each row's whole
table back as one (B, T, H, D) view and reads it through
:func:`_default_attention`, whatever ``cfg.attention_fn`` says, as the JAX
module's paged path does. Positions come from ``cache.lengths``; the
optional ``logits_at`` (B,) projects only that position of each row into
the vocab. The pools are updated in place (``index_put_``), the
counterpart of the JAX program's donated buffers.

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


@dataclasses.dataclass(frozen=True)
class PagedCache:
    """The paged-KV view threaded through one incremental forward.

    ``k``/``v``: ``(num_layers, num_blocks, block_size, heads, head_dim)``
    pools (block 0 reserved as the null block), written in place.
    ``block_tables``: ``(B, max_blocks)`` int, each row mapping a
    sequence's logical block index to a pool block (0-padded past its
    allocation). ``lengths``: ``(B,)`` tokens already in each sequence's
    cache (the chunk starts there). ``live``: ``(B,)`` how many of this
    chunk's ``C`` tokens are real; pad tokens (and dead lanes, ``live ==
    0``) write to the null block."""

    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor
    live: torch.Tensor


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

    def forward(self, x, mask, layer_cache=None, groups=None):
        dt, sh = self.cfg.dtype, self.shard
        if layer_cache is None:
            if sh is not None:
                x = sh.tp_in(x)
            q = torch.einsum("bse,ehd->bshd", x, _use(sh, self.wq, dt))
            k = torch.einsum("bse,ehd->bshd", x, _use(sh, self.wk, dt))
            v = torch.einsum("bse,ehd->bshd", x, _use(sh, self.wv, dt))
            attn = self.cfg.attention_fn or _default_attention
            out = attn(q, k, v, mask, dt)
            out = torch.einsum("bshd,hde->bse", out, _use(sh, self.wo, dt))
            return out if sh is None else sh.tp_out(out)
        # -- paged incremental path: this layer's (num_blocks, block_size,
        # H, D) pools plus the batch's tables and positions. Every
        # per-token product runs on each column group alone (see
        # Transformer.forward's step_width).
        k_slab, v_slab, block_tables, positions, live = layer_cache
        wq, wk, wv = self.wq.to(dt), self.wk.to(dt), self.wv.to(dt)
        xs = _split(x, groups)
        qs = [torch.einsum("bse,ehd->bshd", xg, wq) for xg in xs]
        k = _join([torch.einsum("bse,ehd->bshd", xg, wk) for xg in xs])
        v = _join([torch.einsum("bse,ehd->bshd", xg, wv) for xg in xs])
        B, C, H, D = k.shape
        block_size = k_slab.shape[1]
        # scatter the chunk's K/V through the block tables; pad tokens
        # (and dead lanes) route to the null block 0. A pad position past
        # the table clamps for the lookup: its block is replaced by 0.
        blk_idx = (positions // block_size).clamp(
            max=block_tables.shape[1] - 1)
        offsets = positions % block_size
        blocks = torch.gather(block_tables, 1, blk_idx)
        valid = torch.arange(C, device=x.device)[None, :] < live[:, None]
        blocks = torch.where(valid, blocks, torch.zeros_like(blocks))
        k_slab.index_put_((blocks, offsets), k)
        v_slab.index_put_((blocks, offsets), v)
        # gather every table slot back as one (B, T, H, D) view:
        # T = max_blocks * block_size, position t lives at index t
        kc = k_slab[block_tables].reshape(B, -1, H, D)
        vc = v_slab[block_tables].reshape(B, -1, H, D)
        wo = self.wo.to(dt)
        masks = [mask] if groups is None else [mask[:, :, g] for g in groups]
        return _join([torch.einsum("bshd,hde->bse",
                                   _default_attention(q, kc, vc, m, dt), wo)
                      for q, m in zip(qs, masks)])


def _split(x, groups):
    """``x``'s column groups (dim 1), each contiguous; ``[x]`` for None."""
    return [x] if groups is None else [x[:, g].contiguous() for g in groups]


def _join(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


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

    def forward(self, x, mask, layer_cache=None, groups=None):
        if layer_cache is None:
            x = x + self.attn(self.ln1(x), mask)
            return x + self.mlp(self.ln2(x))
        h = _join([self.ln1(xg) for xg in _split(x, groups)])
        x = x + self.attn(h, mask, layer_cache, groups)
        return x + _join([self.mlp(self.ln2(xg)) for xg in _split(x, groups)])


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

    def forward(self, tokens, pos_offset: int = 0,
                cache: Optional[PagedCache] = None, logits_at=None,
                step_width: Optional[int] = None):
        """``pos_offset``: the global position of ``tokens``' first column.
        A sequence shard (sp index i of shards of length S) passes i * S,
        so its rows get the positions they have in the full sequence.

        With ``cache`` (a :class:`PagedCache`), the paged incremental
        forward: returns ``(logits, cache)``, the logits (B, C, vocab)
        or, with ``logits_at`` (B,), (B, vocab) at that position of each
        row; the cache's pools hold the chunk's K/V on return.

        ``step_width`` (paged path only): run every per-token product,
        the attention read and each position's vocab projection on
        groups of that many columns (the chunk's width a multiple of
        it), each group at exactly the shapes of a decode step of that
        width. A GEMM's row can round differently at another number of
        rows (cuBLAS picks its kernel by shape), so a chunk that must
        reproduce decode steps' logits bit for bit (the speculative
        verify) runs this way."""
        if cache is not None:
            return self._paged_forward(tokens, cache, logits_at, step_width)
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

    def _paged_forward(self, tokens, cache: PagedCache, logits_at,
                       step_width=None):
        if self.shard is not None:
            raise ValueError("the paged forward runs on whole parameters "
                             "(a sharded model has none)")
        cfg = self.cfg
        dt = cfg.dtype
        B, S = tokens.shape
        dev = tokens.device
        groups = None
        if step_width is not None and step_width < S:
            if S % step_width:
                raise ValueError(f"chunk width {S} is not a multiple of "
                                 f"step_width {step_width}")
            groups = [slice(j, j + step_width)
                      for j in range(0, S, step_width)]
        # absolute positions from each sequence's cache length, clipped
        # only to keep the pad tokens' embedding lookup in bounds (live
        # tokens are validated against max_seq_len before submission)
        positions = cache.lengths.long()[:, None] \
            + torch.arange(S, device=dev)[None, :]
        safe_pos = positions.clamp(0, cfg.max_seq_len - 1)
        x = self.embedding.to(dt)[tokens.long()] \
            + self.pos_embedding.to(dt)[safe_pos]
        # gathered cache slot t holds absolute position t; a chunk query
        # at absolute position p attends to every t <= p
        t_max = cache.block_tables.shape[1] * cache.k.shape[2]
        mask = (torch.arange(t_max, device=dev)[None, None, None, :]
                <= positions[:, None, :, None])
        tables = cache.block_tables.long()
        live = cache.live.long()
        for i, layer in enumerate(self.layers()):
            x = layer(x, mask, (cache.k[i], cache.v[i], tables, positions,
                                live), groups)
        x = _join([self.ln_f(xg) for xg in _split(x, groups)])
        # logits in fp32, weight-tied to the embedding
        emb_t = self.embedding.t()
        if logits_at is not None:
            # project only the position each row samples from: the
            # (B, C, vocab) logits never materialize
            x = x[torch.arange(B, device=dev), logits_at.long()][:, None]
            return torch.matmul(x.float(), emb_t)[:, 0], cache
        if groups is not None:
            # one position at a time, as a decode step projects its row
            return torch.cat([torch.matmul(
                x[:, i:i + 1].contiguous().float(), emb_t)
                for i in range(S)], dim=1), cache
        return torch.matmul(x.float(), emb_t), cache
