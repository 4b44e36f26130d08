"""The port's transformer and training step (horovod_tpu_torch, CPU path)
against the JAX package, on a tiny config: vocab 64, 2 layers, d_model 32,
4 heads x 8, seq 16. Weights are made by the flax module and carried over
with params_from_flax; tokens are seeded numpy arrays.

Tolerances: fp32 logits, gradients and losses at atol 1e-5 — the same
arithmetic in the same precision, only reductions ordered differently
(XLA against PyTorch; the JAX flash kernel interpreted at 8 x 8 tiles).
bf16 logits at atol 1e-2 — both sides round activations to bf16 at the
same places, but XLA and PyTorch accumulate bf16 products differently, and
one ulp of bf16 (2^-8 relative) in an activation moves the fp32 logits
(|logit| < 1 here) by a few 1e-3.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.linen import meta

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import (
    Transformer, TransformerConfig, params_from_flax)
from horovod_tpu_torch.parallel import (
    flash_attention_fn, make_transformer_train_step)

jfa = importlib.import_module("horovod_tpu.ops.flash_attention")

ATOL = 1e-5
ATOL_BF16 = 1e-2
TINY = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
            head_dim=8, max_seq_len=16)


def _jax_flash(q, k, v, mask, dtype):
    # the Ulysses adapter's inner flash call, interpreted on the CPU
    del mask
    return jfa.flash_attention(q, k, v, causal=True, out_dtype=dtype,
                               block_q=8, block_k=8, interpret=True)


def _jax_model(dtype, flash):
    cfg = jtr.TransformerConfig(**TINY, dtype=dtype,
                                attention_fn=_jax_flash if flash else None)
    model = jtr.Transformer(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, TINY["max_seq_len"]), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray,
                                    meta.unbox(variables["params"]))
    return model, params


def _torch_model(params, dtype, flash):
    cfg = TransformerConfig(**TINY, dtype=dtype,
                            attention_fn=flash_attention_fn if flash
                            else None)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return model


def _tokens(seed=0, batch=2):
    rng = np.random.RandomState(seed)
    return rng.randint(0, TINY["vocab_size"],
                       (batch, TINY["max_seq_len"] + 1)).astype(np.int32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


@pytest.fixture
def world():
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


# -- params_from_flax --------------------------------------------------------

def test_params_from_flax_round_trip():
    _, params = _jax_model(jnp.float32, flash=False)
    model = _torch_model(params, torch.float32, flash=False)
    state = model.state_dict()
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(state) == len(flat) == 2 + 2 * 10 + 2
    for path, leaf in flat.items():
        name = ".".join(p.key for p in path)
        np.testing.assert_array_equal(state[name].numpy(), leaf)
    assert sum(t.numel() for t in state.values()) == \
        sum(np.size(x) for x in flat.values())
    # a top-level {"params": ...} wrapper is accepted too
    assert params_from_flax({"params": params}).keys() == state.keys()


def test_params_from_flax_errors():
    _, params = _jax_model(jnp.float32, flash=False)

    def edited(fn):
        tree = jax.tree_util.tree_map(lambda x: x, params)
        fn(tree)
        return tree
    with pytest.raises(ValueError, match="leftover"):
        params_from_flax(edited(
            lambda t: t["layer_0"]["attn"].update(extra=np.zeros(3))))
    with pytest.raises(ValueError, match="missing"):
        params_from_flax(edited(lambda t: t["layer_1"]["mlp"].pop("wo")))
    with pytest.raises(ValueError, match="missing"):
        params_from_flax(edited(lambda t: t.pop("embedding")))
    with pytest.raises(ValueError, match="shapes"):
        params_from_flax(edited(lambda t: t["layer_1"]["attn"].update(
            wq=np.zeros((32, 4, 9), np.float32))))


def test_full_width_default_config_parameter_count():
    model = Transformer(TransformerConfig(), device="meta")
    assert sum(p.numel() for p in model.parameters()) == 111_121_920


# -- forward -----------------------------------------------------------------

@pytest.mark.parametrize("flash", [True, False])
def test_fp32_logits_match_jax(flash):
    jmodel, params = _jax_model(jnp.float32, flash)
    tmodel = _torch_model(params, torch.float32, flash)
    toks = _tokens()[:, :-1]
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("flash", [True, False])
def test_bf16_logits_match_jax(flash):
    jmodel, params = _jax_model(jnp.bfloat16, flash)
    tmodel = _torch_model(params, torch.bfloat16, flash)
    toks = _tokens(1)[:, :-1]
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, ATOL_BF16)


# -- training ----------------------------------------------------------------

def _jax_loss_fn(jmodel):
    def loss_fn(p, toks, tgts):
        logits = jmodel.apply({"params": p}, toks)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tgts).mean()
    return loss_fn


def test_first_step_gradients_match_jax():
    jmodel, params = _jax_model(jnp.float32, flash=True)
    data = _tokens(2)
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jmodel)))(
        params, jnp.asarray(data[:, :-1]), jnp.asarray(data[:, 1:]))
    tmodel = _torch_model(params, torch.float32, flash=True)
    logits = tmodel(torch.from_numpy(data[:, :-1]).long())
    tloss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, TINY["vocab_size"]),
        torch.from_numpy(data[:, 1:]).long().reshape(-1))
    tloss.backward()
    _close(tloss.item(), float(loss))
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in tmodel.named_parameters():
        _close(p.grad, want[name])


def test_three_step_loss_trajectory_matches_optax_adamw(world):
    jmodel, params = _jax_model(jnp.float32, flash=True)
    data = [_tokens(10 + i) for i in range(3)]
    opt = optax.adamw(1e-3)
    loss_fn = _jax_loss_fn(jmodel)

    @jax.jit
    def jstep(p, s, toks, tgts):
        loss, grads = jax.value_and_grad(loss_fn)(p, toks, tgts)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss
    p, s = params, opt.init(params)
    jlosses = []
    for d in data:
        p, s, loss = jstep(p, s, jnp.asarray(d[:, :-1]),
                           jnp.asarray(d[:, 1:]))
        jlosses.append(float(loss))

    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    bundle = make_transformer_train_step(cfg, device="cpu")
    bundle.model.load_state_dict(params_from_flax(params))
    tlosses = [bundle.step(torch.from_numpy(d[:, :-1]),
                           torch.from_numpy(d[:, 1:])).item() for d in data]
    bundle.optimizer.remove_hooks()
    _close(tlosses, jlosses)
    final = params_from_flax(jax.tree_util.tree_map(np.asarray, p))
    for name, t in bundle.model.state_dict().items():
        _close(t, final[name])


def test_train_step_flash_and_default_attention_agree(world):
    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    data = torch.from_numpy(_tokens(20).astype(np.int64))
    losses = {}
    for attention in ("flash", "default"):
        bundle = make_transformer_train_step(cfg, device="cpu",
                                             attention=attention)
        losses[attention] = [bundle.step(data[:, :-1], data[:, 1:]).item()
                             for _ in range(2)]
        bundle.optimizer.remove_hooks()
    _close(losses["flash"], losses["default"])
    with pytest.raises(ValueError):
        make_transformer_train_step(cfg, device="cpu", attention="ring")


def test_remat_recomputes_the_same_gradients():
    _, params = _jax_model(jnp.float32, flash=False)
    data = torch.from_numpy(_tokens(3).astype(np.int64))
    grads = []
    for remat in (False, True):
        cfg = TransformerConfig(**TINY, dtype=torch.float32,
                                attention_fn=flash_attention_fn, remat=remat)
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(params_from_flax(params))
        torch.nn.functional.cross_entropy(
            model(data[:, :-1]).reshape(-1, TINY["vocab_size"]),
            data[:, 1:].reshape(-1)).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def test_sequence_shard_positions_match_full_forward():
    """A sequence shard run with its offset (sp index x shard length) sees
    the same activations before attention as the matching rows of the
    full forward; without the offset it would not."""
    _, params = _jax_model(jnp.float32, flash=False)
    model = _torch_model(params, torch.float32, flash=False)
    seen = []
    model.layer_0.ln1.register_forward_hook(
        lambda mod, args, out: seen.append(args[0]))
    toks = torch.from_numpy(_tokens(4)[:, :-1].astype(np.int64))
    S, shards = TINY["max_seq_len"], 4
    s = S // shards
    with torch.no_grad():
        model(toks)
        full = seen.pop()
        for i in range(shards):
            model(toks[:, i * s:(i + 1) * s], pos_offset=i * s)
            torch.testing.assert_close(seen.pop(),
                                       full[:, i * s:(i + 1) * s],
                                       rtol=0, atol=0)
        model(toks[:, s:2 * s])
        assert not torch.equal(seen.pop(), full[:, s:2 * s])
        with pytest.raises(ValueError, match="max_seq_len"):
            model(toks[:, :2 * s], pos_offset=S - s)


def test_config_replace_keeps_defaults():
    cfg = dataclasses.replace(TransformerConfig(), num_layers=1)
    assert (cfg.vocab_size, cfg.d_model, cfg.num_heads, cfg.head_dim,
            cfg.mlp_ratio, cfg.max_seq_len, cfg.dtype) == \
        (32000, 768, 12, 64, 4, 2048, torch.bfloat16)
