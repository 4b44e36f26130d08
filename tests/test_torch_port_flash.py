"""The port's flash attention (horovod_tpu_torch, CPU path) against the JAX
package's Pallas kernel in interpret mode and its plain reference, on every
case of tests/test_flash_attention.py.

Inputs are seeded numpy arrays handed to both packages as float32. The
tolerance is atol 1e-5 in fp32 throughout: both sides compute the same
online-softmax recurrence in fp32, and only the order of summation
differs (different tile sizes, XLA against PyTorch reductions).
"""

import importlib
import inspect
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("horovod_tpu.ops.flash_attention")
from horovod_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _qkv(shape, kv_shape=None):
    kv_shape = kv_shape or shape
    return _rand(shape, 0), _rand(kv_shape, 1), _rand(kv_shape, 2)


def _j(*xs):
    return [jnp.asarray(x, jnp.float32) for x in xs]


def _t(*xs):
    return [torch.from_numpy(x.copy()) for x in xs]


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 48, 3, 16), (1, 64, 2, 32)])
def test_forward_matches_jax_kernel_and_reference(causal, shape):
    q, k, v = _qkv(shape)
    jout = jfa.flash_attention(*_j(q, k, v), causal=causal, block_q=16,
                               block_k=16, interpret=True)
    jref = jfa.mha_reference(*_j(q, k, v), causal=causal)
    tout = tfa.flash_attention(*_t(q, k, v), causal=causal)
    tref = tfa.mha_reference(*_t(q, k, v), causal=causal)
    _close(tout, jout)
    _close(tout, jref)
    _close(tref, jref)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_offsets_cross_shard_causality(as_tensor):
    """Offsets reproduce causal masking between global blocks; a q block
    strictly before its k block is all masked and gives zeros."""
    q, k, v = _qkv((1, 32, 2, 16))

    def off(x):
        return torch.tensor([x], dtype=torch.int32) if as_tensor else x
    jout = jfa.flash_attention(*_j(q, k, v), causal=True, q_offset=64,
                               k_offset=32, block_q=8, block_k=8,
                               interpret=True)
    jref = jfa.mha_reference(*_j(q, k, v), causal=True, q_offset=64,
                             k_offset=32)
    tout = tfa.flash_attention(*_t(q, k, v), causal=True,
                               q_offset=off(64), k_offset=off(32))
    _close(tout, jout)
    _close(tout, jref)

    jmask = jfa.flash_attention(*_j(q, k, v), causal=True, q_offset=0,
                                k_offset=32, block_q=8, block_k=8,
                                interpret=True)
    tmask, tlse = tfa.flash_attention_with_lse(
        *_t(q, k, v), causal=True, q_offset=off(0), k_offset=off(32))
    _close(jmask, 0.0)
    assert torch.count_nonzero(tmask) == 0
    assert float(tlse.max()) <= -1e29
    _close(tmask, jmask)


def test_ragged_kv():
    q, k, v = _qkv((2, 24, 2, 16), (2, 19, 2, 16))
    jout = jfa.flash_attention(*_j(q, k, v), causal=False, block_q=8,
                               block_k=8, interpret=True)
    tout = tfa.flash_attention(*_t(q, k, v), causal=False)
    _close(tout, jout)
    _close(tout, jfa.mha_reference(*_j(q, k, v), causal=False))


def test_plain_forward_block_size_is_only_summation_order():
    """The plain version's K block (the kernel uses other tiles) changes
    the order of sums and nothing else, ragged last block included."""
    q, k, v = _t(*_qkv((6, 40, 16), (6, 37, 16)))
    a = tfa.flash_fwd_plain(q, k, v, 3, 0, True, block_k=8)
    b = tfa.flash_fwd_plain(q, k, v, 3, 0, True, block_k=128)
    _close(a[0], b[0])
    _close(a[1], b[1])


def test_plain_key_block_is_the_kernel_key_tile():
    """The plain version's default key block is the bf16/fp16 kernel's key
    tile, read from the kernel's source: P is rounded relative to the
    running max after each tile, so only at the same tile do the two round
    alike (the card's agreement checks rely on it)."""
    src = pathlib.Path(tfa.__file__).parent / "csrc" / "flash_fwd.cu"
    found = re.findall(r"constexpr int kKeyTile = (\d+);", src.read_text())
    assert [int(x) for x in found] == [tfa.KEY_TILE]
    default = inspect.signature(tfa.flash_fwd_plain).parameters["block_k"]
    assert default.default == tfa.KEY_TILE


def test_lse_values():
    q, k, v = _qkv((1, 16, 1, 8))
    _, jlse = jfa.flash_attention_with_lse(*_j(q, k, v), causal=False,
                                           block_q=8, block_k=8,
                                           interpret=True)
    _, tlse = tfa.flash_attention_with_lse(*_t(q, k, v), causal=False)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8.0)
    ref = np.moveaxis(np.log(np.exp(s).sum(-1)), 1, 2)
    _close(tlse, jlse)
    _close(tlse, ref)


def _torch_grads(q, k, v, w, causal, q_offset=0, k_offset=0):
    qq, kk, vv = (t.requires_grad_() for t in _t(q, k, v))
    out, lse = tfa.flash_attention_with_lse(
        qq, kk, vv, causal=causal, q_offset=q_offset, k_offset=k_offset)
    loss = (out ** 2).sum() if w is None \
        else (out * torch.from_numpy(w)).sum() + torch.sin(lse).sum()
    loss.backward()
    return qq.grad, kk.grad, vv.grad


def _jax_grads(q, k, v, w, causal, q_offset=0, k_offset=0):
    def loss(q, k, v):
        out, lse = jfa.flash_attention_with_lse(
            q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset,
            block_q=8, block_k=8, interpret=True)
        if w is None:
            return jnp.sum(out ** 2)
        return jnp.sum(out * jnp.asarray(w)) + jnp.sum(jnp.sin(lse))
    return jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v))


@pytest.mark.parametrize("with_lse", [False, True])
def test_gradients_match_jax(with_lse):
    """dq, dk, dv against jax.grad through the JAX custom VJP; with_lse
    adds an lse cotangent (the ds = p * (dp - delta + g_lse) term)."""
    shape = (2, 32, 2, 16)
    q, k, v = _qkv(shape)
    w = _rand(shape, 3) if with_lse else None
    for a, b in zip(_torch_grads(q, k, v, w, True),
                    _jax_grads(q, k, v, w, True)):
        _close(a, b)


def test_gradients_with_offsets_match_jax():
    """Shifted shards where every query row sees at least one key."""
    q, k, v = _qkv((1, 32, 2, 16))
    w = _rand((1, 32, 2, 16), 4)
    for a, b in zip(_torch_grads(q, k, v, w, True, 16, 8),
                    _jax_grads(q, k, v, w, True, 16, 8)):
        _close(a, b)


def test_rows_that_see_no_key_have_no_gradient():
    """Query rows 0-7 at global positions 8-15 see no key (keys start at
    16): their output is 0, so they get no gradient and add none to dk and
    dv. (The JAX backward differs here: its p = exp(-1e30 - lse) is 1 for
    such rows, so it is not the reference for them.)"""
    q, k, v = _qkv((1, 32, 2, 16))
    w = _rand((1, 32, 2, 16), 4)
    dq, dk, dv = _torch_grads(q, k, v, w, True, 8, 16)
    assert torch.count_nonzero(dq[:, :8]) == 0
    vq, vk, vv = _torch_grads(q[:, 8:].copy(), k, v, w[:, 8:].copy(), True,
                              16, 16)
    _close(dq[:, 8:], vq)
    _close(dk, vk)
    _close(dv, vv)


def test_backward_row_skip_matches_full_blocks():
    """With int offsets the backward visits, per key block, only the query
    rows that can see it; with tensor offsets it visits every row. Both
    must give the same gradients."""
    q, k, v = _t(*_qkv((4, 40, 16), (4, 40, 16)))
    out, lse = tfa.flash_fwd_plain(q, k, v, 5, 9, True)
    g = torch.from_numpy(_rand((4, 40, 16), 5))
    g_lse = torch.from_numpy(_rand((4, 40), 6))
    skip = tfa.flash_bwd_plain(q, k, v, out, lse, g, g_lse, 5, 9, True,
                               block_k=8)
    full = tfa.flash_bwd_plain(q, k, v, out, lse, g, g_lse,
                               torch.tensor([5], dtype=torch.int32),
                               torch.tensor([9], dtype=torch.int32), True,
                               block_k=8)
    for a, b in zip(skip, full):
        _close(a, b)


def _bwd_inputs(dtype=torch.float32):
    q, k, v = (t.to(dtype) for t in _t(*_qkv((3, 40, 16), (3, 37, 16))))
    out, lse = tfa.flash_fwd_plain(q, k, v, 5, 0, True)
    g = torch.from_numpy(_rand((3, 40, 16), 7)).to(dtype)
    g_lse = torch.from_numpy(_rand((3, 40), 8))
    return q, k, v, out, lse, g, g_lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_dispatcher_sends_cpu_tensors_to_the_plain_path(dtype):
    """On a CPU tensor the backward is the plain version, bit for bit, and
    no kernel call is counted."""
    args = _bwd_inputs(dtype)
    before = dict(tfa.LAUNCHES)
    got = tfa._flash_bwd(*args, 5, 0, True, 0.25)
    want = tfa.flash_bwd_plain(*args, 5, 0, causal=True, sm_scale=0.25)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tfa.LAUNCHES == before


def test_both_autograd_wrappers_reach_the_backward_dispatcher(monkeypatch):
    """The eager Function's backward and the compiled graph's operator
    ``hvd_tpu::flash_bwd`` both call ``_flash_bwd`` with the same
    arguments, and give the same gradients."""
    calls = []
    dispatch = tfa._flash_bwd

    def spy(*args):
        calls.append(args[7:])
        return dispatch(*args)
    monkeypatch.setattr(tfa, "_flash_bwd", spy)
    q, k, v = (t.requires_grad_() for t in _t(*_qkv((2, 24, 16))))
    g = torch.from_numpy(_rand((2, 24, 16), 9))
    grads = []
    for fn in (tfa.FlashAttentionFunction.apply, tfa.flash_fwd_op):
        out, lse = fn(q, k, v, 3, 0, True, 0.25)
        grads.append(torch.autograd.grad((out * g).sum() + lse.sum(),
                                         (q, k, v)))
    assert calls == [(3, 0, True, 0.25)] * 2
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_every_built_kernel_has_a_binder():
    """Each library ``_build.SOURCES`` builds has the binder that types its
    C entry points."""
    from horovod_tpu_torch.ops import _build
    assert set(tfa.BINDERS) == set(_build.SOURCES)


@pytest.mark.parametrize("wrapper", ["flash_fwd_cuda", "flash_bwd_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors_before_loading(wrapper,
                                                           monkeypatch):
    """Both kernel wrappers run the shared input checks, which name the
    wrapper, before anything is built or loaded."""
    monkeypatch.setattr(tfa, "_load_kernel", lambda *a: pytest.fail(
        "the kernel was loaded for a CPU tensor"))
    args = _bwd_inputs(torch.bfloat16)
    if wrapper == "flash_fwd_cuda":
        args = args[:3]
    before = dict(tfa.LAUNCHES)
    with pytest.raises(ValueError, match=f"^{wrapper}: q must be a CUDA "
                                         f"tensor"):
        getattr(tfa, wrapper)(*args)
    assert tfa.LAUNCHES == before


def test_bwd_kernel_names_are_not_the_forwards():
    """No kernel of the backward's source has ``flash_fwd`` in its name:
    the forward's roofline averages every kernel whose name holds it."""
    src = (pathlib.Path(tfa.__file__).parent / "csrc" / "flash_bwd.cu") \
        .read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                       r"(\w+)\(", src)
    assert sorted(names) == ["flash_bwd_dkdv", "flash_bwd_dq",
                             "flash_bwd_prep"]
