"""The port on the card: its CUDA kernels against their plain PyTorch
versions, and every collective verb on CUDA tensors through NCCL in a
world of one.

Marked ``cuda``: every test skips on a machine without an NVIDIA GPU (the
CPU suite). On the card, from the root of a checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which these tests do
not use.) The serving path's kernel calls (BH 12, 24, 48, 96 under
``torch.inference_mode()`` on a worker thread) are among the cases.
Tolerances are chip_smoke.py's, and so is the check of a bf16 or
fp16 output: fp32 outputs within 1e-5 (order of fp32 sums only); bf16 and
fp16 outputs within a per-element bound of one output rounding plus one
rounding step of P, with at most 5% of the elements differing at all;
lse within 1e-4. The backward kernel's dq, dk and dv are held to
flash_bwd_plain element by element within two output roundings plus one
rounding step of the type on every term of each sum (the kernel rounds P
and dS to the input type; see ``_bwd_bounds``), and are bit-identical
from call to call. The verbs are exact at size 1 (integer-valued data and
power-of-two scales); SyncBatchNorm is held to nn.BatchNorm within 1e-5.
ResNet-18 in fp32 on the card is held to the port's CPU path, and its
SGD update to the fp64 update, within chip_smoke.py's cnn limits (TF32
off). The Spark TorchEstimator trains a small transformer on the card by
default and is held to a hand loop exactly.
"""

import pytest
import torch

import horovod_tpu_torch as hvd
from chip_smoke import (MISMATCH_LIMIT, TOL_FP32, TOL_LSE, cnn_limits,
                        half_agreement, resnet_parity)
from horovod_tpu_torch import collectives as tcoll
from horovod_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, dtype, bh, sq, sk, d, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(bh, s, d, generator=gen, device=device).to(dtype)
            for s in (sq, sk, sk)]


def _check(q, k, v, q_off, k_off, causal):
    before = fa.LAUNCHES["flash_fwd"]
    out, lse = fa.flash_fwd_cuda(q, k, v, q_off, k_off, causal)
    assert fa.LAUNCHES["flash_fwd"] == before + 1
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, q_off, k_off, causal)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    if q.dtype == torch.float32:
        assert (out - ref).abs().max().item() <= TOL_FP32
    else:
        ratio, share = half_agreement(torch, fa, out, ref, q, k, v, q_off,
                                      k_off, causal)
        assert ratio <= 1 and share <= MISMATCH_LIMIT, (ratio, share)
    return out, lse, ref_lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_ragged(cuda, dtype, d, causal):
    # ragged S_q and S_k; q_offset 70 leaves every row at least one key
    q, k, v = _qkv(cuda, dtype, 3, 131, 200, d, seed=d)
    _, lse, ref_lse = _check(q, k, v, 70, 0, causal)
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s", [64, 127, 128, 129, 255, 257])
def test_kernel_matches_plain_at_tile_edges(cuda, dtype, s):
    # S_q = S_k on both sides of the 128-key tile and of the 64-row
    # warpgroup slices of a q-tile, causal
    q, k, v = _qkv(cuda, dtype, 3, s, s, 64, seed=s)
    _, lse, ref_lse = _check(q, k, v, 0, 0, True)
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_that_see_no_key_give_zero(cuda, dtype):
    q, k, v = _qkv(cuda, dtype, 2, 96, 96, 64)
    out, lse, _ = _check(q, k, v, 0, 96, True)        # every row masked
    assert torch.count_nonzero(out) == 0 and lse.max().item() <= -1e29
    out, lse, ref_lse = _check(q, k, v, 0, 10, True)  # rows 0-9 masked
    assert torch.count_nonzero(out[:, :10]) == 0
    assert (lse[:, 10:] - ref_lse[:, 10:]).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("bucket", [1, 2, 4, 8])
def test_kernel_in_inference_mode_on_a_worker_thread(cuda, bucket):
    """The serving path's calls: the default transformer's attention at
    buckets 1, 2, 4 and 8 (BH = bucket x 12 heads: 12, 24, 48, 96; S
    2048, D 64, bf16, causal) through ``flash_attention_with_lse`` on
    (B, S, H, D) tensors under torch.inference_mode(), from a thread that
    is not the main one, as the serving batcher runs it; held to the
    plain version with the bf16 limits."""
    import threading
    heads = 12
    q, k, v = (t.view(bucket, heads, 2048, 64).transpose(1, 2)
               for t in _qkv(cuda, torch.bfloat16, bucket * heads, 2048,
                             2048, 64, seed=bucket))
    box = {}

    def run():
        try:
            with torch.inference_mode():
                before = fa.LAUNCHES["flash_fwd"]
                out, _ = fa.flash_attention_with_lse(q, k, v, causal=True)
                box["launches"] = fa.LAUNCHES["flash_fwd"] - before
                box["out"] = out.transpose(1, 2).reshape(
                    bucket * heads, 2048, 64).clone()
                torch.cuda.synchronize()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "error" in box:
        raise box["error"]
    assert box["launches"] == 1
    bh = [x.transpose(1, 2).reshape(bucket * heads, 2048, 64).contiguous()
          for x in (q, k, v)]
    ref, _ = fa.flash_fwd_plain(*bh, 0, 0, True)
    ratio, share = half_agreement(torch, fa, box["out"], ref, *bh, 0, 0,
                                  True)
    assert ratio <= 1 and share <= MISMATCH_LIMIT, (ratio, share)


def test_device_offsets_equal_int_offsets(cuda):
    q, k, v = _qkv(cuda, torch.bfloat16, 2, 128, 128, 64)
    qo = torch.tensor([40], dtype=torch.int32, device=cuda)
    ko = torch.tensor([8], dtype=torch.int32, device=cuda)
    a = fa.flash_fwd_cuda(q, k, v, 40, 8, True)
    b = fa.flash_fwd_cuda(q, k, v, qo, ko, True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, torch.bfloat16, 2, 32, 32, 64)
    before = fa.LAUNCHES["flash_fwd"]
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd_cuda(*_qkv(cuda, torch.bfloat16, 2, 32, 32, 48))
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd_cuda(q.transpose(1, 2), k, v)
    flat = torch.zeros(2 * 32 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_fwd_cuda(flat[1:].view(2, 32, 64), k, v)
    with pytest.raises(ValueError, match="share dtype"):
        fa.flash_fwd_cuda(q, k.half(), v)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_fwd_cuda(q, k, v, torch.tensor([0], device=cuda), 0)
    with pytest.raises(ValueError, match="sm_scale"):
        fa.flash_fwd_cuda(q, k, v, sm_scale=-0.125)
    assert fa.LAUNCHES["flash_fwd"] == before


def test_autograd_function_on_the_card(cuda):
    B, S, H, D = 2, 80, 2, 32
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, w = (torch.randn(B, S, H, D, generator=gen, device=cuda)
                  for _ in range(4))

    def grads(flash):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        if flash:
            out = fa.flash_attention(qq, kk, vv, causal=True)
        else:
            out = fa.mha_reference(qq, kk, vv, causal=True)
        (out * w).sum().backward()
        return qq.grad, kk.grad, vv.grad
    for a, b in zip(grads(True), grads(False)):
        assert (a - b).abs().max().item() <= 1e-4


# -- the backward kernel (csrc/flash_bwd.cu) against flash_bwd_plain ---------

def _bwd_case(device, dtype, bh, sq, sk, d, q_off, k_off, causal, seed,
              with_g_lse=True):
    """Inputs of one backward call: q, k, v, the forward kernel's out and
    lse, a cotangent g and (or not) an lse cotangent."""
    q, k, v = _qkv(device, dtype, bh, sq, sk, d, seed=seed)
    out, lse = fa.flash_fwd_cuda(q, k, v, q_off, k_off, causal)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    g = torch.randn(bh, sq, d, generator=gen, device=device).to(dtype)
    g_lse = (torch.randn(bh, sq, generator=gen, device=device) if with_g_lse
             else torch.zeros(bh, sq, device=device))
    return q, k, v, out, lse, g, g_lse


def _bwd_bounds(q, k, v, out, lse, g, g_lse, q_off, k_off, causal):
    """Per-element bounds of |kernel - plain| for dq, dk, dv. The plain
    version computes every product in fp32 and rounds each gradient to the
    input type once; the kernel rounds P and dS to the input type before
    the products that accumulate (dV = P^T dO, dK = dS^T Q, dQ = dS K), in
    fp32. So an element differs by at most one output rounding on each side
    (2 ulp of the plain value, with room for the order of the fp32 sums)
    plus the rounding of every term of its sum, at most half a step of the
    type (2^-m, m mantissa bits) each: within 2^-m (|dS| |K|), 2^-m (|dS|^T
    |Q|) and 2^-m (P^T |dO|), from P and dS computed densely here in fp32.
    Besides, each side sums dP - delta + g_lse in fp32 in its own order, so
    every dS also carries p * scale * 2^-16 (|dO| |V|^T + rowsum |O dO| +
    |g_lse|): D <= 128 fp32 roundings (2^-24 each) with room for the
    tensor cores' accumulation. It matters only where dP - delta cancels (a
    row that sees one key has dS = 0 exactly, and both sides keep noise).
    A missing or misplaced tile, mask or row term moves some element by
    the size of its terms, far past the bound."""
    bits = 7 if q.dtype == torch.bfloat16 else 10
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.exp(torch.bmm(qf, kf.transpose(1, 2)) * scale - lse[..., None])
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        p = p.masked_fill(qpos[:, None] < kpos[None], 0.0)
    delta = (out.float() * gf).sum(-1)
    ds = p * (torch.bmm(gf, vf.transpose(1, 2)) - delta[..., None]
              + g_lse[..., None]) * scale
    noise = p * scale * 2.0 ** -16 * (
        torch.bmm(gf.abs(), vf.abs().transpose(1, 2))
        + ((out.float() * gf).abs().sum(-1) + g_lse.abs())[..., None])
    step = 2.0 ** -bits
    ds_bound = step * ds.abs() + noise
    return (torch.bmm(ds_bound, kf.abs()),
            torch.bmm(ds_bound.transpose(1, 2), qf.abs()),
            step * torch.bmm(p.transpose(1, 2), gf.abs()))


def _check_bwd(q, k, v, out, lse, g, g_lse, q_off, k_off, causal):
    """The kernel's gradients, each within its bound of the plain
    version's (the largest |diff| / bound must be <= 1); returns them."""
    before = fa.LAUNCHES["flash_bwd"]
    got = fa.flash_bwd_cuda(q, k, v, out, lse, g, g_lse, q_off, k_off,
                            causal)
    assert fa.LAUNCHES["flash_bwd"] == before + 1
    qi = int(q_off) if isinstance(q_off, int) else int(q_off.item())
    ki = int(k_off) if isinstance(k_off, int) else int(k_off.item())
    want = fa.flash_bwd_plain(q, k, v, out, lse, g, g_lse, qi, ki, causal)
    bounds = _bwd_bounds(q, k, v, out, lse, g, g_lse, qi, ki, causal)
    bits = 7 if q.dtype == torch.bfloat16 else 10
    for name, a, b, bound in zip(("dq", "dk", "dv"), got, want, bounds):
        assert a.dtype == q.dtype and a.shape == b.shape, name
        r = b.float()
        _, e = torch.frexp(r.abs().clamp_min(torch.finfo(q.dtype).tiny))
        ulp = torch.ldexp(torch.ones_like(r), e - 1 - bits)
        ratio = ((a.float() - r).abs() / (2 * ulp + bound)).max().item()
        assert ratio <= 1, (name, ratio)
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_kernel_matches_plain_ragged(cuda, dtype, d, causal):
    # S_q != S_k, both ragged; q_offset 70 leaves every row a key; a
    # nonzero lse cotangent
    _check_bwd(*_bwd_case(cuda, dtype, 3, 131, 200, d, 70, 0, causal,
                          seed=d), 70, 0, causal)


@pytest.mark.parametrize("s", [64, 127, 128, 129, 255, 257])
def test_bwd_kernel_matches_plain_at_tile_edges(cuda, s):
    # both sides of the 64-row streamed tiles and 128-row work tiles, no lse
    # cotangent (the training path's)
    _check_bwd(*_bwd_case(cuda, torch.bfloat16, 3, s, s, 64, 0, 0, True,
                          seed=s, with_g_lse=False), 0, 0, True)


@pytest.mark.parametrize("q_off,k_off", [(70, 0), (37, 300), (2048 + 37, 0)])
def test_bwd_device_offsets_equal_int_offsets(cuda, q_off, k_off):
    """Nonzero offsets, as ints and as int32 device tensors (the eager
    ring's): the same gradients, bit for bit, each within its bound."""
    case = _bwd_case(cuda, torch.bfloat16, 2, 300, 260, 64, q_off, k_off,
                     True, seed=q_off + k_off)
    a = _check_bwd(*case, q_off, k_off, True)
    qo = torch.tensor([q_off], dtype=torch.int32, device=cuda)
    ko = torch.tensor([k_off], dtype=torch.int32, device=cuda)
    b = _check_bwd(*case, qo, ko, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_bwd_rows_that_see_no_key_get_zero(cuda):
    """Keys start at global position 100: query rows 0-99 see none, and
    keys 156-255 are seen by no query. Their gradients are exactly 0 (the
    mask comes before the exponential, and lse is ~ -1e30 there); with
    every row masked all three gradients are 0."""
    case = _bwd_case(cuda, torch.bfloat16, 2, 256, 256, 64, 0, 100, True,
                     seed=3)
    dq, dk, dv = _check_bwd(*case, 0, 100, True)
    assert torch.count_nonzero(dq[:, :100]) == 0
    assert torch.count_nonzero(dq[:, 100:]) > 0
    assert torch.count_nonzero(dk[:, 156:]) == 0
    assert torch.count_nonzero(dv[:, 156:]) == 0
    case = _bwd_case(cuda, torch.bfloat16, 2, 96, 96, 64, 0, 96, True,
                     seed=4)
    assert all(torch.count_nonzero(t) == 0
               for t in _check_bwd(*case, 0, 96, True))


@pytest.mark.parametrize("k_off", [2048, 1024])
def test_bwd_many_work_tiles_a_block_with_nothing_to_see(cuda, k_off):
    """The ring's later key shards at the training shape (BH 96, S 2048,
    device offsets): each block walks about a dozen work tiles, all (k_off
    2048) or some (1024) with no streamed tile a warpgroup can see; the
    gradients are 0 where nothing is seen and within the bounds elsewhere,
    and the call returns (the warps of a warpgroup that only waits and
    passes stay in step)."""
    qo = torch.tensor([0], dtype=torch.int32, device=cuda)
    ko = torch.tensor([k_off], dtype=torch.int32, device=cuda)
    case = _bwd_case(cuda, torch.bfloat16, 96, 2048, 2048, 64, 0, k_off,
                     True, seed=k_off)
    if k_off == 2048:
        grads = fa.flash_bwd_cuda(*case, qo, ko, True)
        assert all(torch.count_nonzero(t) == 0 for t in grads)
    else:
        dq, dk, dv = _check_bwd(*case, qo, ko, True)
        assert torch.count_nonzero(dq[:, :k_off]) == 0
        assert torch.count_nonzero(dk[:, 2048 - k_off:]) == 0


def test_bwd_kernel_at_the_gpt2_shape_is_deterministic(cuda):
    """GPT-2 medium's layer (BH 8 x 16 heads, S 1024, D 64, bf16, causal):
    within the bounds, and two calls give bit-identical dq, dk and dv (each
    element is summed by one thread in a fixed order; no atomics)."""
    case = _bwd_case(cuda, torch.bfloat16, 128, 1024, 1024, 64, 0, 0, True,
                     seed=11, with_g_lse=False)
    a = _check_bwd(*case, 0, 0, True)
    b = fa.flash_bwd_cuda(*case, 0, 0, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_bwd_op_and_function_launch_the_kernel(cuda):
    """The compiled graph's operator and the eager Function's backward
    both reach the kernel (one call each) and agree bit for bit."""
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, torch.bfloat16, 4,
                                                256, 256, 64, seed=9))
    g = torch.randn_like(q)
    grads = []
    for fn in (fa.FlashAttentionFunction.apply, fa.flash_fwd_op):
        before = fa.LAUNCHES["flash_bwd"]
        out, _ = fn(q, k, v, 0, 0, True, 0.125)
        grads.append(torch.autograd.grad(out, (q, k, v), g))
        assert fa.LAUNCHES["flash_bwd"] == before + 1
    assert all(torch.equal(x, y) for x, y in zip(*grads))


def test_bwd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, out, lse, g, g_lse = _bwd_case(cuda, torch.bfloat16, 2, 32, 32,
                                            64, 0, 0, True, seed=5)
    before = fa.LAUNCHES["flash_bwd"]

    def call(**kw):
        args = dict(q=q, k=k, v=v, out=out, lse=lse, g=g, g_lse=g_lse)
        args.update(kw)
        return fa.flash_bwd_cuda(**args)
    with pytest.raises(ValueError, match="dtype"):
        call(q=q.float(), k=k.float(), v=v.float(), out=out.float(),
             g=g.float())
    with pytest.raises(ValueError, match="share dtype"):
        call(k=k.half())
    with pytest.raises(ValueError, match="contiguous"):
        call(q=q.transpose(1, 2).contiguous().transpose(1, 2))
    flat = torch.zeros(2 * 32 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        call(q=flat[1:].view(2, 32, 64))
    with pytest.raises(ValueError, match="head dim"):
        case = _bwd_case(cuda, torch.bfloat16, 2, 32, 32, 64, 0, 0, True,
                         seed=6)
        fa.flash_bwd_cuda(*(t[..., :48].contiguous() if t.dim() == 3 else t
                            for t in case))
    with pytest.raises(ValueError, match="lse"):
        call(lse=lse.bfloat16())
    with pytest.raises(ValueError, match="g_lse"):
        call(g_lse=g_lse[:, :16])
    with pytest.raises(ValueError, match="int32"):
        fa.flash_bwd_cuda(q, k, v, out, lse, g, g_lse,
                          torch.tensor([0], device=cuda), 0)
    with pytest.raises(ValueError, match="sm_scale"):
        call(sm_scale=-0.125)
    assert fa.LAUNCHES["flash_bwd"] == before
    # a strided cotangent, as autograd may hand over, is taken
    gt = g.transpose(0, 1).contiguous().transpose(0, 1)
    assert not gt.is_contiguous()
    a = call(g=gt)
    assert all(torch.equal(x, y) for x, y in zip(a, call()))


def test_gpt2_shaped_training_step_launches_the_backward_kernel(
        cuda, monkeypatch):
    """The transformer step at GPT-2 medium's attention shape (8 x 1024
    tokens, 16 heads of 64, bf16; 4 layers) launches the backward kernel
    once a layer and never reaches the plain version."""
    from horovod_tpu_torch.models.transformer import TransformerConfig
    from horovod_tpu_torch.parallel.train import make_transformer_train_step

    def plain(*args, **kw):
        raise AssertionError("the plain backward ran on the card in bf16")
    monkeypatch.setattr(fa, "flash_bwd_plain", plain)
    cfg = TransformerConfig(vocab_size=1024, num_layers=4, d_model=1024,
                            num_heads=16, head_dim=64, mlp_ratio=4,
                            max_seq_len=1024, dtype=torch.bfloat16)
    hvd.init(process_sets=[[0]])
    try:
        bundle = make_transformer_train_step(
            cfg, generator=torch.Generator(device=cuda).manual_seed(0))
        data = torch.randint(0, cfg.vocab_size, (8, 1025), device=cuda,
                             generator=torch.Generator(device=cuda)
                             .manual_seed(1))
        before = dict(fa.LAUNCHES)
        loss = bundle.step(data[:, :-1], data[:, 1:])
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_bwd"] - before["flash_bwd"] == 4
        assert fa.LAUNCHES["flash_fwd"] - before["flash_fwd"] == 4
        assert torch.isfinite(loss).all()
        bundle.optimizer.remove_hooks()
    finally:
        hvd.shutdown()


# -- the collective verbs on NCCL, world of one --------------------------------

@pytest.fixture
def nccl(cuda):
    hvd.init(process_sets=[[0]])
    try:
        assert hvd.basics.world().backend == "nccl"
        yield cuda
    finally:
        hvd.shutdown()


def _ints(shape, seed, dtype=torch.float32, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-4, 5, shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_reductions_on_nccl(nccl, dtype):
    x, y = _ints((257, 3), 1, dtype), _ints((5,), 2, dtype)
    before = tcoll.COUNTS["allreduce"]
    for op in (hvd.Min, hvd.Max, hvd.Product):
        got = hvd.grouped_allreduce([x, y], op=op)
        assert all(torch.equal(g, w) for g, w in zip(got, (x, y)))
    for op in (hvd.Sum, hvd.Average, hvd.Adasum):
        got = hvd.grouped_allreduce([x, y], op=op, prescale_factor=0.5,
                                    postscale_factor=4.0)
        assert all(g.dtype == dtype and g.is_cuda and torch.equal(g, 2 * w)
                   for g, w in zip(got, (x, y)))
    # Adasum at size 1 only scales: five wire calls for six verbs
    assert tcoll.COUNTS["allreduce"] == before + 5
    i = _ints((9,), 3, torch.int32)
    assert torch.equal(hvd.allreduce(i, op=hvd.Sum), i)
    ps = hvd.process_set_mesh(0)
    assert torch.equal(hvd.allreduce(x, op=hvd.Max, process_set=ps), x)


def test_data_movement_on_nccl(nccl):
    x = _ints((300, 7), 4)
    for t in (x, x.bfloat16(), x[:0], torch.tensor(3.0, device=nccl)):
        got = hvd.allgather(t)
        assert got.is_cuda and torch.equal(got, t.reshape(-1, *t.shape[1:])
                                           if t.dim() else t.reshape(1))
    assert torch.equal(hvd.alltoall(x, splits=[300]), x)
    assert torch.equal(hvd.alltoall(x), x)
    assert torch.equal(hvd.broadcast(x, root_rank=0), x)
    gb = hvd.grouped_broadcast([x, x.int(), x.half()], root_rank=0)
    assert torch.equal(gb[1], x.int()) and torch.equal(gb[2], x.half())
    y = x.t()                       # not contiguous: broadcast through a copy
    assert hvd.broadcast_(y, root_rank=0) is y and torch.equal(y, x.t())
    # a CPU tensor in an NCCL world comes back on the CPU
    assert torch.equal(hvd.allreduce(x.cpu(), op=hvd.Sum), x.cpu())


def test_object_verbs_on_nccl(nccl):
    state = {"t": _ints((1000,), 5), "step": 7}
    got = hvd.broadcast_object(state, root_rank=0)
    assert got["step"] == 7 and got["t"].is_cuda
    assert torch.equal(got["t"], state["t"])
    (only,) = hvd.allgather_object(state)
    assert torch.equal(only["t"], state["t"])


def test_join_on_nccl(nccl):
    x = _ints((4,), 6)
    assert hvd.join_round() == 1
    assert hvd.join() == 0 and hvd.join_round() == 0
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum), torch.zeros_like(x))


def test_sync_batch_norm_backward_on_nccl(nccl):
    g = torch.Generator(device=nccl).manual_seed(7)
    x = torch.randn(64, 32, 9, generator=g, device=nccl)
    dy = torch.randn(64, 32, 9, generator=g, device=nccl)
    bn = hvd.SyncBatchNorm(32).to(nccl)
    ref = torch.nn.BatchNorm1d(32).to(nccl)
    xs, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    (bn(xs) * dy).sum().backward()
    out = ref(xr)
    (out * dy).sum().backward()
    assert (bn(x) - out).abs().max().item() <= 1e-5
    assert (xs.grad - xr.grad).abs().max().item() <= 1e-5
    assert (bn.weight.grad - ref.weight.grad).abs().max().item() <= 1e-3


def test_dispatcher_waits_for_the_callers_stream(nccl):
    """The input is written on a side stream held back by a spin kernel;
    the result, read on that stream right after synchronize, must see the
    write (the dispatcher's stream waits for the caller's)."""
    x = torch.zeros(1 << 22, device=nccl)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        x.fill_(3.0)
        h = hvd.allreduce_async(x, op=hvd.Sum, name="side.stream")
        out = hvd.synchronize(h)
        # .item() copies on the current stream: the side one
        assert out.sum().item() == 3.0 * (1 << 22)
        torch.cuda._sleep(100_000_000)
        x.fill_(5.0)
        (g,) = hvd.grouped_broadcast([x], root_rank=0)
        gathered = hvd.allgather(x[:1000])
        assert g.min().item() == 5.0 and gathered.min().item() == 5.0


def test_resnet18_on_the_card_matches_the_cpu_path(cuda):
    from horovod_tpu_torch.models import ResNet18
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        errs, info = resnet_parity(torch, ResNet18, 2, 64)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    limits = cnn_limits()
    assert all(errs[k] <= limits[k] for k in limits), (errs, limits, info)


def test_greedy_generation_on_the_card_equals_the_raw_program(cuda):
    """One short greedy generation at the default TransformerConfig
    (bf16 activations) through GenerationEngine on the card equals the
    raw paged program's host argmax, step for step, and the pools stay
    on the card."""
    from horovod_tpu_torch.models.transformer import (PagedCache,
                                                      Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.serving.generation import (GenerationEngine,
                                                      build_program,
                                                      make_pools)
    cfg = TransformerConfig()
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = dict(Transformer(cfg, device=cuda, generator=gen)
                  .named_parameters())
    params = {n: p.detach() for n, p in params.items()}
    model = Transformer(cfg, device="meta")
    prompt = torch.randint(0, cfg.vocab_size, (40,),
                           generator=torch.Generator().manual_seed(1))
    prompt = prompt.tolist()
    with GenerationEngine(model, params=params, num_blocks=64,
                          block_size=16, max_seqs=4, prefill_chunk=64,
                          reload_poll_seconds=0) as eng:
        got = eng.generate(prompt, max_tokens=8, timeout=120)
        assert eng.batcher._k.is_cuda and eng.batcher._v.is_cuda
    # the raw program at the engine's shapes: a (1, 64) prefill chunk,
    # (4, 2) decode steps with lane 0 live, tables 128 blocks wide
    raw = build_program(model)
    k, v = make_pools(cfg, 64, 16, device=cuda)
    i32 = dict(dtype=torch.int32, device=cuda)
    tables = torch.zeros((4, 128), **i32)
    tables[0, :8] = torch.arange(1, 9, **i32)
    toks = torch.tensor([prompt + [0] * 24], **i32)
    cache = PagedCache(k, v, tables[:1], torch.zeros(1, **i32),
                       torch.tensor([40], **i32))
    logits, _ = raw(params, cache, toks)
    want = [int(logits[0, 39].argmax())]
    for i in range(7):
        buf = torch.zeros((4, 2), **i32)
        buf[0, 0] = want[-1]
        cache = PagedCache(k, v, tables,
                           torch.tensor([40 + i, 0, 0, 0], **i32),
                           torch.tensor([1, 0, 0, 0], **i32))
        logits, _ = raw(params, cache, buf)
        want.append(int(logits[0, 0].argmax()))
    assert got == want


def test_router_over_a_card_replica_answers_as_a_direct_forward(cuda):
    """The fleet router in front of one InferenceServer replica on the
    card (a 2-layer transformer through the flash kernel, one-row
    requests): each routed answer equals the replica's direct forward of
    the same row, bit for bit, and carries the request id it was sent."""
    import dataclasses
    import json
    from urllib.request import Request, urlopen
    import numpy as np
    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.parallel import flash_attention_fn
    from horovod_tpu_torch.serving import fleet
    cfg = TransformerConfig(vocab_size=128, num_layers=2, max_seq_len=256,
                            attention_fn=flash_attention_fn)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {n: p.detach() for n, p in Transformer(
        dataclasses.replace(cfg, attention_fn=None), device=cuda,
        generator=gen).named_parameters()}
    model = Transformer(cfg, device="meta")

    def apply(p, x):
        logits = torch.func.functional_call(model, p, (x.long(),))
        return torch.log_softmax(logits[:, -1], dim=-1).max(dim=-1).values
    eng = serving.InferenceEngine(apply, params=params, max_batch=1,
                                  buckets=(1,), deadline_ms=0,
                                  reload_poll_seconds=0, warmup=False)
    srv = serving.InferenceServer(eng, port=0, addr="127.0.0.1")
    srv.start()
    router = fleet.FleetRouter({"r0": f"http://127.0.0.1:{srv.port}"},
                               port=0, addr="127.0.0.1")
    router.start()
    rows = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 256))
    try:
        for i, row in enumerate(rows):
            req = Request(router.url + "/v1/infer",
                          data=json.dumps({"inputs": [row.tolist()]})
                          .encode(), method="POST",
                          headers={"Content-Type": "application/json",
                                   fleet.REQUEST_ID_HEADER: f"card-{i}"})
            with urlopen(req, timeout=120) as resp:
                doc = json.loads(resp.read())
                assert resp.headers[fleet.REQUEST_ID_HEADER] == f"card-{i}"
            with torch.inference_mode():
                want = apply(params, torch.tensor(
                    row[None], dtype=torch.float32, device=cuda))
            assert doc["outputs"][0] == float(want[0])
    finally:
        router.stop()
        srv.close()


def test_spark_torch_estimator_on_the_card_equals_a_hand_loop(cuda):
    """The Spark TorchEstimator (pandas frame, no pyspark) trains a small
    transformer through the flash kernel on the card, by default, to the
    same loss history and parameters as a hand loop of the same batches
    through DistributedOptimizer(AdamW) (tolerance 0: one process, the
    same kernels on the same inputs); TorchModel.transform equals a
    direct forward of the fitted model."""
    import tempfile

    import numpy as np
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    from chip_smoke import TokenLoss, TokenModel
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.parallel import flash_attention_fn
    from horovod_tpu_torch.parallel.train import default_optimizer
    from horovod_tpu_torch.spark.store import LocalStore
    from horovod_tpu_torch.spark.torch import TorchEstimator
    cfg = TransformerConfig(vocab_size=256, num_layers=2, d_model=128,
                            num_heads=2, head_dim=64, max_seq_len=256,
                            attention_fn=flash_attention_fn)

    def model():
        gen = torch.Generator(device=cuda).manual_seed(0)
        return TokenModel(Transformer(cfg, device=cuda, generator=gen))
    seqs = np.random.RandomState(0).randint(0, 256, (16, 257))
    frame = pd.DataFrame({"tokens": list(seqs[:, :-1]),
                          "targets": list(seqs[:, 1:])})
    hvd.init(process_sets=[[0]])
    try:
        with tempfile.TemporaryDirectory() as root:
            before = fa.LAUNCHES["flash_fwd"]
            fitted = TorchEstimator(
                model=model(), optimizer=default_optimizer,
                loss=TokenLoss(), feature_cols=["tokens"],
                label_cols=["targets"], batch_size=8, epochs=1,
                shuffle=False, store=LocalStore(root)).fit(frame)
            assert fa.LAUNCHES["flash_fwd"] == before + 2 * cfg.num_layers
        assert fitted.device.type == "cuda"
        hand = model()
        opt = hvd.DistributedOptimizer(
            default_optimizer(hand.parameters()),
            named_parameters=hand.named_parameters())
        x = torch.tensor(seqs[:, :-1].astype(np.float32), device=cuda)
        y = torch.tensor(seqs[:, 1:].astype(np.float32), device=cuda)
        epoch = 0.0
        for s in (0, 8):
            opt.zero_grad()
            loss = TokenLoss()(hand(x[s:s + 8]), y[s:s + 8])
            loss.backward()
            opt.step()
            epoch += float(loss.detach()) * 8
        opt.remove_hooks()
        assert fitted.loss_history == [epoch / 16]
        state = fitted.getModel().state_dict()
        assert all(torch.equal(v, state[k])
                   for k, v in hand.state_dict().items())
        out = fitted.transform(frame.head(4))
        preds = np.stack(out[fitted.output_cols[0]].to_numpy())
        with torch.no_grad():
            ref = fitted.getModel()(x[:4]).cpu().numpy()
        assert np.array_equal(preds, ref)
    finally:
        hvd.shutdown()
