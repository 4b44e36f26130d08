"""Ulysses-style sequence parallelism: all-to-all over the head axis
(counterpart of ``horovod_tpu/parallel/ulysses.py``).

Instead of rotating K/V blocks (ring attention), one all-to-all re-shards
the activations from sequence-sharded to head-sharded, each member
computes full-sequence attention for its subset of heads, and a second
all-to-all restores sequence sharding. Two collectives in all (against
n-1 ring shifts), at the cost of needing num_heads % n == 0 and
full-sequence attention per head.

The all-to-alls are ``comm.all_to_all`` (``all_to_all_single``,
differentiable, in the process's order of wire calls), which splits dim 0
of its input into n equal chunks, sends chunk j to member j and stacks
what it receives by source on dim 0.
JAX's ``all_to_all(tiled=True)`` splits and concatenates inner axes, so
each direction permutes the peer's chunk to the front first.
"""

import torch
import torch.distributed as dist

from ..ops.flash_attention import flash_attention
from .comm import all_to_all


def _seq_to_heads(x, group):
    # (B, S_local, H, D) -> (B, S_full, H_local, D): head chunk j goes to
    # member j; what arrives from member i is sequence block i
    n = dist.get_world_size(group)
    B, S, H, D = x.shape
    chunks = x.reshape(B, S, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = all_to_all(chunks, group)                    # (n, B, S, Hl, D)
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * S, H // n, D)


def _heads_to_seq(x, group):
    # (B, S_full, H_local, D) -> (B, S_local, H, D): sequence block j goes
    # to member j; what arrives from member i is head chunk i
    n = dist.get_world_size(group)
    B, S_full, Hl, D = x.shape
    chunks = x.reshape(B, n, S_full // n, Hl, D).permute(1, 0, 2, 3, 4)
    got = all_to_all(chunks, group)                    # (n, B, S, Hl, D)
    return got.permute(1, 2, 0, 3, 4).reshape(B, S_full // n, n * Hl, D)


def ulysses_attention(q, k, v, group, causal: bool = True,
                      attention_fn=None, out_dtype=None):
    """Exact attention with the sequence sharded over ``group``.

    Args:
      q, k, v: (B, S_local, H, D); H must be divisible by the group size.
      attention_fn: inner full-sequence attention, given (q, k, v, mask,
        dtype) with shapes (B, S_full, H_local, D); default the flash
        kernel, causal inside it (its plain version on a CPU tensor).
    Returns (B, S_local, H, D).
    """
    out_dtype = out_dtype or q.dtype
    n = dist.get_world_size(group)
    H = q.shape[2]
    if H % n != 0:
        raise ValueError(f"num_heads {H} not divisible by 'sp' "
                         f"axis size {n}; use ring_attention instead")
    if attention_fn is None:
        def attention_fn(qh, kh, vh, mask, dtype):
            del mask  # causal handled inside the kernel
            return flash_attention(qh, kh, vh, causal=causal,
                                   out_dtype=dtype)
    qh = _seq_to_heads(q, group)
    kh = _seq_to_heads(k, group)
    vh = _seq_to_heads(v, group)
    S = qh.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()[
        None, None] if causal else None
    oh = attention_fn(qh, kh, vh, mask, torch.float32)
    return _heads_to_seq(oh.to(out_dtype), group)


def make_ulysses_attention(group, causal: bool = True, attention_fn=None):
    """Adapter for TransformerConfig.attention_fn."""
    def fn(q, k, v, mask, dtype):
        del mask
        return ulysses_attention(q, k, v, group, causal=causal,
                                 attention_fn=attention_fn, out_dtype=dtype)
    return fn
