"""Flash (blockwise online-softmax) attention with a hand-written Hopper
kernel.

Counterpart of ``horovod_tpu/ops/flash_attention.py``. The forward on a
CUDA tensor is the CUDA C++ in ``csrc/flash_fwd.cu`` (it replaces the
Pallas TPU kernel ``_fwd_kernel``): TMA and wgmma tiles with
warp-specialised warpgroups for bf16 and fp16, scalar fp32 FMAs for fp32;
its note says what it computes and what bounds it. On a CPU tensor the
forward is :func:`flash_fwd_plain`, the same recurrence in plain PyTorch.
The backward is :func:`flash_bwd_plain` on either device: the JAX
package's backward (``_flash_vjp_bwd``) is plain XLA, not a kernel, and
this is its counterpart — a blockwise recompute over K in fp32 that also
carries the lse cotangent, ``ds = p * (dp - delta + g_lse) * scale``.

Positions are global: ``q_offset``/``k_offset`` give the global index of
local row 0 for causal masking across sequence shards. They may be Python
ints or int32 one-element tensors on the inputs' device; the kernel reads
them from device memory, so offsets computed on the device need no host
sync.

A query row that sees no key gives out = 0 and lse ~ -1e30 here whatever
the tiling, where the TPU kernel's answer for such a row depends on its
block_q (see the kernel's note); its gradient is 0.
"""

import ctypes
import math
import threading
from typing import Optional

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
#: keys per K/V tile of the bf16/fp16 kernel (``kKeyTile`` in
#: csrc/flash_fwd.cu): P is rounded relative to the running max after each
#: tile, so the plain version matches the kernel's rounding at this tile
KEY_TILE = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: kernel launches, one added per launch of the CUDA kernel by its wrapper
#: (under a lock: the serving batcher launches from its own thread while a
#: training step launches from another)
LAUNCHES = {"flash_fwd": 0}
_LAUNCHES_LOCK = threading.Lock()

_kernel = None
_offsets = {}


# ---------------------------------------------------------------------------
# Reference implementation (test oracle)
# ---------------------------------------------------------------------------

def mha_reference(q, k, v, causal: bool = True,
                  sm_scale: Optional[float] = None,
                  q_offset=0, k_offset=0, out_dtype=None):
    """Exact attention in plain PyTorch. Shapes (B, S, H, D); fp32
    softmax."""
    out_dtype = out_dtype or q.dtype
    D = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Forward: plain version and the CUDA kernel's wrapper, on (BH, S, D)
# ---------------------------------------------------------------------------

def _visible(qpos, kpos, causal: bool):
    if not causal:
        return None
    return qpos[:, None] >= kpos[None, :]


def flash_fwd_plain(q, k, v, q_offset=0, k_offset=0, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_k: int = KEY_TILE):
    """The kernel's recurrence in PyTorch: (BH, S_q, D) x (BH, S_k, D) ->
    out (BH, S_q, D) in q's dtype, lse (BH, S_q) fp32. ``block_k`` is the
    kernel's key tile: P is rounded to V's dtype relative to the running
    max, which moves with the tiling, so at the same tile only the order
    of summation differs from the kernel."""
    BH, SQ, D = q.shape
    SK = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf = q.float()
    o = torch.zeros(BH, SQ, D, dtype=torch.float32, device=dev)
    m = torch.full((BH, SQ, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(BH, SQ, 1, dtype=torch.float32, device=dev)
    qpos = q_offset + torch.arange(SQ, device=dev)
    for k0 in range(0, SK, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k]
        s = torch.matmul(qf, kb.transpose(1, 2)) * sm_scale
        valid = _visible(qpos, k_offset + k0
                         + torch.arange(kb.shape[1], device=dev), causal)
        if valid is not None:
            s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.matmul(p.to(vb.dtype).float(), vb.float())
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (o / l).to(q.dtype), (m + torch.log(l))[..., 0]


def bind(lib):
    """The C entry point ``hvd_flash_fwd`` of a built library, typed."""
    fn = lib.hvd_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _load_kernel():
    global _kernel
    if _kernel is None:
        from . import _build
        _kernel = bind(_build.load("flash_fwd"))
    return _kernel


def offset_tensor(off, device):
    """An offset as the kernel reads it: one int32 on ``device``. An int
    gives a tensor cached per (device, value); a tensor is checked."""
    if isinstance(off, torch.Tensor):
        if off.dtype != torch.int32 or off.numel() != 1 \
                or off.device != device:
            raise ValueError(
                "an offset tensor must hold one int32 on the inputs' device, "
                f"got {off.dtype} {tuple(off.shape)} on {off.device}")
        return off.contiguous()
    key = (device, int(off))
    t = _offsets.get(key)
    if t is None:
        t = _offsets[key] = torch.tensor([int(off)], dtype=torch.int32,
                                         device=device)
    return t


def flash_fwd_cuda(q, k, v, q_offset=0, k_offset=0, causal: bool = True,
                   sm_scale: Optional[float] = None):
    """Launch the Hopper kernel on (BH, S, D) CUDA tensors; returns out
    (BH, S_q, D) in q's dtype and lse (BH, S_q) fp32. Raises on anything
    the kernel does not take; there is no fallback."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"flash_fwd_cuda: {name} must be a CUDA tensor")
        if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_fwd_cuda: {name} must be a contiguous, "
                             f"16-byte aligned (BH, S, D) tensor, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_fwd_cuda: q, k, v must share dtype and "
                             "device")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_fwd_cuda: dtype {q.dtype} not supported")
    BH, SQ, D = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != D:
        raise ValueError(f"flash_fwd_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    SK = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_fwd_cuda: head dim {D} not in {HEAD_DIMS}")
    if BH < 1 or SQ < 1 or SK < 1:
        raise ValueError("flash_fwd_cuda: empty input")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if not (0 < sm_scale < math.inf):
        # the bf16/fp16 kernel takes each row's max on the raw scores
        raise ValueError(f"flash_fwd_cuda: sm_scale must be positive and "
                         f"finite, got {sm_scale}")
    qo = offset_tensor(q_offset, q.device)
    ko = offset_tensor(k_offset, q.device)
    kernel = _load_kernel()
    out = torch.empty_like(q)
    lse = torch.empty(BH, SQ, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), qo.data_ptr(), ko.data_ptr(), BH, SQ, SK, D,
        _DTYPE_CODES[q.dtype], int(bool(causal)), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    with _LAUNCHES_LOCK:
        LAUNCHES["flash_fwd"] += 1
    return out, lse


def _flash_fwd(q, k, v, q_offset, k_offset, causal, sm_scale):
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, q_offset, k_offset, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, q_offset, k_offset, causal, sm_scale)
    raise ValueError(f"flash attention has no path for device {q.device}")


# ---------------------------------------------------------------------------
# Backward (counterpart of the XLA _flash_vjp_bwd) and the autograd Function
# ---------------------------------------------------------------------------

def flash_bwd_plain(q, k, v, out, lse, g, g_lse, q_offset=0, k_offset=0,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block_k: int = 256):
    """Blockwise recompute backward over K in fp32; returns (dq, dk, dv) in
    the inputs' dtypes. With int offsets and ``causal``, each key block
    only visits the query rows that can see it. The per-row terms ride in
    the GEMMs' epilogues (``baddbmm``), so a block costs three elementwise
    passes: p = exp(scale * q k^T - lse), its mask, and
    ds = p * (scale * (dp - delta + g_lse)). ``block_k`` only sets the
    order of sums and the size of each block's GEMMs."""
    BH, SQ, D = q.shape
    SK = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    delta = (out.float() * gf).sum(dim=-1)                 # (BH, SQ)
    neg_lse = -lse.float()
    row_term = (g_lse.float() - delta) * sm_scale
    qpos = q_offset + torch.arange(SQ, device=dev)
    static = not isinstance(q_offset, torch.Tensor) \
        and not isinstance(k_offset, torch.Tensor)
    dq = torch.zeros(BH, SQ, D, dtype=torch.float32, device=dev)
    dk = torch.zeros(BH, SK, D, dtype=torch.float32, device=dev)
    dv = torch.zeros(BH, SK, D, dtype=torch.float32, device=dev)
    for k0 in range(0, SK, block_k):
        ks = kf[:, k0:k0 + block_k]
        vs = vf[:, k0:k0 + block_k]
        q0 = 0
        if causal and static:
            q0 = min(max(k_offset + k0 - q_offset, 0), SQ)
        if q0 == SQ:
            continue
        valid = _visible(qpos[q0:], k_offset + k0
                         + torch.arange(ks.shape[1], device=dev), causal)
        p = torch.baddbmm(neg_lse[:, q0:, None], qf[:, q0:],
                          ks.transpose(1, 2), alpha=sm_scale).exp_()
        if valid is not None:
            p.masked_fill_(~valid, 0.0)
        ds = torch.baddbmm(row_term[:, q0:, None], gf[:, q0:],
                           vs.transpose(1, 2), alpha=sm_scale).mul_(p)
        dq[:, q0:] += torch.matmul(ds, ks)
        dk[:, k0:k0 + block_k] = torch.matmul(ds.transpose(1, 2), qf[:, q0:])
        dv[:, k0:k0 + block_k] = torch.matmul(p.transpose(1, 2), gf[:, q0:])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """(BH, S, D) q, k, v -> (out, lse), both differentiable: ring
    attention merges partial results through lse, so its cotangent feeds
    the score gradients."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, causal, sm_scale):
        out, lse = _flash_fwd(q, k, v, q_offset, k_offset, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.offsets = (q_offset, k_offset)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_plain(q, k, v, out, lse, g, g_lse,
                                     *ctx.offsets, causal=ctx.causal,
                                     sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             sm_scale: Optional[float] = None,
                             q_offset=0, k_offset=0, out_dtype=None):
    """Flash attention over (B, S, H, D) tensors; also returns the per-row
    log-sum-exp ``lse`` with shape (B, S, H), differentiable."""
    out_dtype = out_dtype or q.dtype
    B, SQ, H, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)

    def to_bh(x):
        # at B = 1 the reshape is a strided view, and the kernel takes
        # contiguous (BH, S, D) tensors only
        return x.transpose(1, 2).reshape(B * H, x.shape[1], D).contiguous()
    out, lse = FlashAttentionFunction.apply(
        to_bh(q), to_bh(k), to_bh(v), q_offset, k_offset, bool(causal),
        float(sm_scale))
    out = out.reshape(B, H, SQ, D).transpose(1, 2)
    lse = lse.reshape(B, H, SQ).transpose(1, 2)
    return out.to(out_dtype), lse


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    q_offset=0, k_offset=0, out_dtype=None):
    """Flash attention over (B, S, H, D); see flash_attention_with_lse."""
    out, _ = flash_attention_with_lse(
        q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
        k_offset=k_offset, out_dtype=out_dtype)
    return out
