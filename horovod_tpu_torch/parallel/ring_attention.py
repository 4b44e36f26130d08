"""Ring attention: context parallelism over a sequence-parallel process
group (counterpart of ``horovod_tpu/parallel/ring_attention.py``).

The sequence is sharded over the group's n members: member ``my`` holds
the query, key and value rows [my*S, (my+1)*S) of every sequence, shapes
(B, S, H, D). Each member keeps its Q block and the K/V blocks rotate
around the ring (``comm.ring_shift``, member j to member j+1), n steps in
all; at step i member ``my`` holds the block of source ``src = (my - i) %
n``. Causal masking uses global positions, so a block from a source
before ``my`` is seen whole, the diagonal block causally, and a block from
a later source not at all.

``impl="flash"`` (and "auto") runs each step through the hand-written
flash kernel (``ops/flash_attention.py``; its plain version on a CPU
tensor) with the global offsets ``my*S`` and ``src*S`` as int32 tensors on
the device and fp32 output, then merges the step's partial result through
its log-sum-exp. While ``torch.compile`` traces, the offsets are Python
ints instead, constants of this process's graph (as its rank is), so each
step is the custom op ``hvd_tpu::flash_fwd``, and each step stays
checkpointed (recomputed in backward) inside the graph. ``impl="xla"`` is
the JAX package's blockwise fp32 recurrence, in plain PyTorch. Both are
exact attention.
"""

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention_with_lse, offset_tensor
from .comm import ring_shift

NEG_INF = -1e30
IMPLS = ("flash", "xla", "auto")


def ring_attention(q, k, v, group, causal: bool = True, out_dtype=None,
                   impl: str = "auto"):
    """Exact attention over sequence blocks distributed on ``group``.

    Args:
      q, k, v: (B, S_local, H, D) blocks of this member (its rows of the
        sequence).
      group: the process group carrying the sequence shards (the ring),
        such as ``mesh.get_group("sp")``.
      causal: apply a causal mask using global positions.
      impl: "flash" = the flash kernel per ring step, "xla" = the blockwise
        fp32 recurrence, "auto" = flash.
    Returns (B, S_local, H, D) attention output for the local Q block.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl in ("flash", "auto"):
        return ring_attention_flash(q, k, v, group, causal=causal,
                                    out_dtype=out_dtype)
    out_dtype = out_dtype or q.dtype
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    B, S, H, D = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    qf = q.float()
    o = torch.zeros(B, S, H, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, H, S, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        src = (my - i) % n
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        if causal:
            qpos = my * S + torch.arange(S, device=q.device)
            kpos = src * S + torch.arange(S, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
        o = o * corr.transpose(1, 2)[..., None] + pv
        m = m_new
        if i + 1 < n:  # the final rotation is unnecessary
            k_blk, v_blk = ring_shift((k_blk, v_blk), group)
    # fully-masked rows have l == 0 (not with causal self-attention, where
    # every query sees at least itself; guarded anyway)
    l = torch.clamp(l, min=1e-30)
    return (o / l.transpose(1, 2)[..., None]).to(out_dtype)


def _flash_step(q, k_blk, v_blk, o, lse, q_off, k_off, causal: bool):
    """One ring step: the flash kernel on the held block, fp32 out, then
    the log-sum-exp merge into the running (o, lse)."""
    o_i, lse_i = flash_attention_with_lse(
        q, k_blk, v_blk, causal=causal, q_offset=q_off, k_offset=k_off,
        out_dtype=torch.float32)
    lse_new = torch.logaddexp(lse, lse_i)
    w_old = torch.exp(lse - lse_new)[..., None]          # (B, S, H, 1)
    w_new = torch.exp(lse_i - lse_new)[..., None]
    return o * w_old + o_i * w_new, lse_new


Block = Tuple[torch.Tensor, torch.Tensor]


def _ring_flash(q, block: Callable[[int, Optional[Block]], Block],
                my: int, n: int, causal: bool, out_dtype):
    """The n merge steps of member ``my``; ``block(i, held)`` gives the
    K/V block held at step i (source (my - i) % n) from the one held at
    step i - 1 (None at step 0)."""
    out_dtype = out_dtype or q.dtype
    B, S, H, D = q.shape
    o = torch.zeros(B, S, H, D, dtype=torch.float32, device=q.device)
    lse = torch.full((B, S, H), NEG_INF, dtype=torch.float32,
                     device=q.device)
    compiling = torch.compiler.is_compiling()
    held = None
    for i in range(n):
        held = block(i, held)
        k_blk, v_blk = held
        src = (my - i) % n
        if compiling:
            offsets = (my * S, src * S)
        else:
            offsets = (offset_tensor(my * S, q.device),
                       offset_tensor(src * S, q.device))
        args = (q, k_blk, v_blk, o, lse, *offsets, causal)
        if torch.is_grad_enabled():
            # backward re-runs the kernel instead of keeping each step's
            # partial output, as the JAX package's compiled path does
            o, lse = checkpoint(_flash_step, *args, use_reentrant=False)
        else:
            o, lse = _flash_step(*args)
    return o.to(out_dtype)


def ring_attention_flash(q, k, v, group, causal: bool = True,
                         out_dtype=None):
    """Ring attention with the flash kernel as the per-step block engine.

    Each step computes this member's Q block against the held K/V block
    with the kernel, which returns (out_i, lse_i), both differentiable,
    and merges the partials with the log-sum-exp combine::

        lse' = logaddexp(lse, lse_i)
        o'   = o * exp(lse - lse') + o_i * exp(lse_i - lse')

    A step whose K block lies wholly in the causal future gives out_i = 0
    and lse_i ~ -1e30, so its merge weight is 0 and every step is the same
    program. With grad enabled every step is recomputed in backward
    (``torch.utils.checkpoint``), on every device. The JAX version's
    ``interpret``, ``block_q`` and ``block_k`` have no counterpart: the
    kernel's tiles are fixed.
    """
    n = dist.get_world_size(group)
    my = dist.get_rank(group)

    def rotate(i, held):
        # the block of step i - 1 shifted one member on (the final
        # rotation is unnecessary, so there are n - 1 shifts)
        return (k, v) if held is None else ring_shift(held, group)
    return _ring_flash(q, rotate, my, n, causal, out_dtype)


def ring_attention_local(q, kv_blocks, my: int, causal: bool = True,
                         out_dtype=None):
    """The same steps as :func:`ring_attention_flash` for ring position
    ``my``, with every position's K/V block held by this process:
    ``kv_blocks[j]`` is position j's (k, v). No communication; the result
    and the kernel calls are those of member ``my`` of a ring of
    ``len(kv_blocks)``, so one card can drive every position in turn."""
    n = len(kv_blocks)
    if not 0 <= my < n:
        raise ValueError(f"ring position {my} out of range for {n} blocks")
    return _ring_flash(q, lambda i, held: kv_blocks[(my - i) % n], my, n,
                       causal, out_dtype)


def make_ring_attention(group, causal: bool = True):
    """Adapter matching TransformerConfig.attention_fn's signature (q, k,
    v, mask, dtype). The local mask argument is ignored — global causal
    masking is computed from ring positions."""
    @functools.wraps(ring_attention)
    def fn(q, k, v, mask, dtype):
        del mask
        return ring_attention(q, k, v, group, causal=causal,
                              out_dtype=dtype)
    return fn
