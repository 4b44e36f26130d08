"""Flash (blockwise online-softmax) attention with hand-written Hopper
kernels.

Counterpart of ``horovod_tpu/ops/flash_attention.py``. The forward on a
CUDA tensor is the CUDA C++ in ``csrc/flash_fwd.cu`` (it replaces the
Pallas TPU kernel ``_fwd_kernel``): TMA and wgmma tiles with
warp-specialised warpgroups for bf16 and fp16, scalar fp32 FMAs for fp32;
its note says what it computes and what bounds it. On a CPU tensor the
forward is :func:`flash_fwd_plain`, the same recurrence in plain PyTorch.

The backward (:func:`_flash_bwd`) is, on a bf16 or fp16 CUDA tensor, the
CUDA C++ in ``csrc/flash_bwd.cu`` (:func:`flash_bwd_cuda`): the same TMA
and wgmma design in two passes, dK/dV over key tiles and a deterministic
dQ over query tiles, with P and dS rounded to the input type before the
products that accumulate. It replaces no TPU kernel (the JAX package's
backward, ``_flash_vjp_bwd``, is plain XLA); its note says why it was
added and what bounds it. On a CPU tensor, and on an fp32 CUDA tensor
(no training path runs one; the exact fp32 arithmetic is that path's),
the backward is :func:`flash_bwd_plain`: a blockwise recompute over K in
fp32, the kernel's test oracle. Both carry the lse cotangent,
``ds = p * (dp - delta + g_lse) * scale``.

Positions are global: ``q_offset``/``k_offset`` give the global index of
local row 0 for causal masking across sequence shards. They may be Python
ints or int32 one-element tensors on the inputs' device; the kernels read
them from device memory, so offsets computed on the device need no host
sync.

A query row that sees no key gives out = 0 and lse ~ -1e30 here whatever
the tiling, where the TPU kernel's answer for such a row depends on its
block_q (see the kernel's note); its gradient is 0.

Under ``torch.compile`` the forward is the custom op ``hvd_tpu::flash_fwd``
(:func:`flash_fwd_op`), which a compiled graph calls without a break (the
ctypes launch cannot be traced): its body is :func:`_flash_fwd`, the kernel
on a CUDA tensor (counting its launches at run time) and the plain version
on a CPU one; its fake gives out like q and lse (BH, S_q) fp32; its
gradient is the operator ``hvd_tpu::flash_bwd`` (:func:`flash_bwd_op`),
whose body is :func:`_flash_bwd`, as the autograd Function's. Integer
offsets only: a compiled ring step (``parallel.ring_attention``) passes
its global offsets as Python ints, constants of its process's graph, so
every step of a compiled ring is this op at nonzero offsets. Eager calls
go through :class:`FlashAttentionFunction` as before, which also takes
device-tensor offsets (the eager ring's). Merging the two wrappers is
ROADMAP P16, once the op's eager dispatch cost at the host-bound BH 12
shapes has been measured.
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

#: kernel calls, one added per call of a CUDA kernel path by its wrapper
#: (under a lock: the serving batcher launches from its own thread while a
#: training step launches from another)
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}
_LAUNCHES_LOCK = threading.Lock()

_kernels = {}
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


def bind_bwd(lib):
    """The C entry points of a built backward library, typed: the launch
    ``hvd_flash_bwd`` and ``hvd_flash_bwd_scratch_floats``, the fp32
    scratch its kernels need at (BH, S_q)."""
    fn = lib.hvd_flash_bwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    floats = lib.hvd_flash_bwd_scratch_floats
    floats.argtypes = [ctypes.c_int, ctypes.c_int]
    floats.restype = ctypes.c_longlong
    return fn, floats


#: kernel name (as in ``_build.SOURCES``) -> the binder of its library
BINDERS = {"flash_fwd": bind, "flash_bwd": bind_bwd}


def _load_kernel(name="flash_fwd"):
    fn = _kernels.get(name)
    if fn is None:
        from . import _build
        fn = _kernels[name] = BINDERS[name](_build.load(name))
    return fn


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


def _check_inputs(fn, named, dtypes, sm_scale):
    """The checks of both kernel wrappers (``fn`` names the wrapper in the
    messages): the (name, tensor) pairs of ``named``, q, k, v first, are
    contiguous, 16-byte aligned (BH, S, D) CUDA tensors of one dtype in
    ``dtypes`` and one device; k and v agree, and every later tensor has
    q's shape; D is in ``HEAD_DIMS``; nothing is empty; ``sm_scale``
    (default 1/sqrt(D)) is positive and finite, since the bf16/fp16
    kernels take each row's max on the raw scores. Returns (BH, S_q, S_k,
    D, sm_scale)."""
    q, k, v = (t for _, t in named[:3])
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor")
        if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be a contiguous, 16-byte "
                             f"aligned (BH, S, D) tensor, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{fn}: {', '.join(n for n, _ in named)} must "
                             f"share dtype and device")
    if q.dtype not in dtypes:
        raise ValueError(f"{fn}: dtype {q.dtype} not supported")
    BH, SQ, D = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != D \
            or any(t.shape != q.shape for _, t in named[3:]):
        raise ValueError(f"{fn}: shapes " + ", ".join(
            f"{n} {tuple(t.shape)}" for n, t in named) + " disagree")
    SK = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {D} not in {HEAD_DIMS}")
    if BH < 1 or SQ < 1 or SK < 1:
        raise ValueError(f"{fn}: empty input")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if not (0 < sm_scale < math.inf):
        raise ValueError(f"{fn}: sm_scale must be positive and finite, got "
                         f"{sm_scale}")
    return BH, SQ, SK, D, sm_scale


def flash_fwd_cuda(q, k, v, q_offset=0, k_offset=0, causal: bool = True,
                   sm_scale: Optional[float] = None):
    """Launch the Hopper kernel on (BH, S, D) CUDA tensors; returns out
    (BH, S_q, D) in q's dtype and lse (BH, S_q) fp32. Raises on anything
    the kernel does not take; there is no fallback."""
    BH, SQ, SK, D, sm_scale = _check_inputs(
        "flash_fwd_cuda", (("q", q), ("k", k), ("v", v)), _DTYPE_CODES,
        sm_scale)
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


def flash_bwd_cuda(q, k, v, out, lse, g, g_lse, q_offset=0, k_offset=0,
                   causal: bool = True, sm_scale: Optional[float] = None):
    """Launch the Hopper backward on (BH, S, D) bf16 or fp16 CUDA tensors:
    q, k, v and the forward's out and lse (BH, S_q) fp32, with their
    cotangents g and g_lse; returns (dq, dk, dv) in the inputs' dtype.
    Raises on anything the kernels do not take; there is no fallback."""
    # autograd may hand over a strided cotangent
    g = g.contiguous() if isinstance(g, torch.Tensor) else g
    BH, SQ, SK, D, sm_scale = _check_inputs(
        "flash_bwd_cuda", (("q", q), ("k", k), ("v", v), ("out", out),
                           ("g", g)), (torch.bfloat16, torch.float16),
        sm_scale)
    for name, t in (("lse", lse), ("g_lse", g_lse)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or tuple(t.shape) != (BH, SQ) or t.device != q.device:
            raise ValueError(f"flash_bwd_cuda: {name} must be a (BH, S_q) "
                             f"fp32 tensor on the inputs' device")
    qo = offset_tensor(q_offset, q.device)
    ko = offset_tensor(k_offset, q.device)
    lse, g_lse = lse.contiguous(), g_lse.contiguous()
    kernel, scratch_floats = _load_kernel("flash_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(scratch_floats(BH, SQ), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        g.data_ptr(), lse.data_ptr(), g_lse.data_ptr(), scratch.data_ptr(),
        scratch.numel(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        qo.data_ptr(), ko.data_ptr(), BH, SQ, SK, D, _DTYPE_CODES[q.dtype],
        int(bool(causal)), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {err}")
    with _LAUNCHES_LOCK:
        LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv


def _flash_bwd(q, k, v, out, lse, g, g_lse, q_offset, k_offset, causal,
               sm_scale):
    """The backward of both autograd wrappers: the kernel on a bf16 or
    fp16 CUDA tensor (it raises on what it does not take), the plain
    version on a CPU or an fp32 CUDA tensor."""
    if q.device.type == "cuda" and q.dtype != torch.float32:
        return flash_bwd_cuda(q, k, v, out, lse, g, g_lse, q_offset,
                              k_offset, causal, sm_scale)
    if q.device.type in ("cpu", "cuda"):
        return flash_bwd_plain(q, k, v, out, lse, g, g_lse, q_offset,
                               k_offset, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"flash attention has no path for device {q.device}")


@torch.library.custom_op("hvd_tpu::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_offset: int, k_offset: int, causal: bool,
                 sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as one operator of a compiled graph: (BH, S, D) q, k,
    v -> out (BH, S_q, D) in q's dtype, lse (BH, S_q) fp32."""
    # a compiled graph may hand over an input with other strides; the
    # kernel takes contiguous (BH, S, D) tensors only
    return _flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                      q_offset, k_offset, causal, sm_scale)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, q_offset, k_offset, causal, sm_scale):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _flash_op_setup(ctx, inputs, output):
    q, k, v, q_offset, k_offset, causal, sm_scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.offsets = (q_offset, k_offset)
    ctx.causal = causal
    ctx.sm_scale = sm_scale


@torch.library.custom_op("hvd_tpu::flash_bwd", mutates_args=())
def flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                 g_lse: torch.Tensor, q_offset: int, k_offset: int,
                 causal: bool, sm_scale: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_flash_bwd` as one operator of a compiled backward: the
    compiler calls it and does not trace into it (the kernel's ctypes
    launch cannot be traced, and the plain version's 8 key blocks a layer
    at S 2048 took most of inductor's 146 s compile of the full model's
    backward on the card's host)."""
    # a compiled graph may hand over inputs with other strides
    return _flash_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                      out.contiguous(), lse, g, g_lse, q_offset, k_offset,
                      causal, sm_scale)


@flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, lse, g, g_lse, q_offset, k_offset, causal,
                    sm_scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_op_backward(ctx, g, g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    if g is None:
        g = torch.zeros_like(out)
    if g_lse is None:
        g_lse = torch.zeros_like(lse)
    dq, dk, dv = flash_bwd_op(q, k, v, out, lse, g, g_lse, *ctx.offsets,
                              ctx.causal, ctx.sm_scale)
    return dq, dk, dv, None, None, None, None


flash_fwd_op.register_autograd(_flash_op_backward,
                               setup_context=_flash_op_setup)


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
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, g, g_lse, *ctx.offsets,
                                ctx.causal, ctx.sm_scale)
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
    if torch.compiler.is_compiling() and not isinstance(
            q_offset, torch.Tensor) and not isinstance(k_offset, torch.Tensor):
        out, lse = flash_fwd_op(to_bh(q), to_bh(k), to_bh(v), int(q_offset),
                                int(k_offset), bool(causal), float(sm_scale))
    else:
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
