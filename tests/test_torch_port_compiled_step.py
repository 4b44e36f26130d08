"""The compiled training step (``make_transformer_train_step(compiled=
True)``, the counterpart of the JAX step's ``jax.jit(_step)``) and the
flash kernel's custom op ``hvd_tpu::flash_fwd``, on the CPU.

Every region compiles with ``fullgraph=True`` and ``backend="aot_eager"``
(the test passes it; inductor's C++ build would eat the test budget), so
a graph break fails. The CPU body of the custom op is the plain forward,
the same arithmetic as the eager autograd Function, and the inner
optimizer steps eagerly, so the op and the compiled step equal their
eager counterparts bit for bit (asserted at 1e-6 for the losses, 0 for
the rest). Against the
JAX package's jitted step (``horovod_tpu.parallel.train.
make_transformer_train_step``, weights carried over by
``params_from_flax``) the losses and final parameters agree at
tests/test_torch_port_transformer.py's atol 1e-5: the same arithmetic in
fp32, reductions ordered differently (XLA against PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

import horovod_tpu_torch as hvd
from horovod_tpu_torch import collectives as C
from horovod_tpu_torch import metrics
from horovod_tpu_torch.models import TransformerConfig, params_from_flax
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import make_transformer_train_step

TINY = dict(vocab_size=64, num_layers=2, d_model=64, num_heads=4,
            head_dim=16, max_seq_len=64)
STEPS = 3
BACKEND = "aot_eager"
GROUPED = 'hvd_tpu_injit_lowerings_total{op="grouped_allreduce"}'


@pytest.fixture
def world():
    hvd.init(device="cpu")
    try:
        yield hvd
    finally:
        hvd.shutdown()


def _data(step, batch=2):
    rng = np.random.RandomState(40 + step)
    return rng.randint(0, TINY["vocab_size"],
                       (batch, TINY["max_seq_len"] + 1)).astype(np.int64)


def _run(bundle):
    losses = []
    for step in range(STEPS):
        d = torch.from_numpy(_data(step))
        losses.append(bundle.step(d[:, :-1], d[:, 1:]).item())
    return losses


# -- the flash kernel as a custom op -----------------------------------------

def _qkv(seed, bh=6, s=48, d=16):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal((bh, s, d))
                             .astype(np.float32)).requires_grad_()
            for _ in range(3)]


@pytest.mark.parametrize("causal,q_offset,k_offset", [
    (True, 0, 0), (False, 0, 0), (True, 16, 0), (True, 0, 8)])
def test_flash_custom_op_equals_the_autograd_function(causal, q_offset,
                                                      k_offset):
    """Forward (out, lse) and the gradients of q, k, v through the custom
    op equal FlashAttentionFunction's on the same inputs, bit for bit."""
    rng = np.random.RandomState(5)
    w_out = torch.from_numpy(rng.standard_normal((6, 48, 16))
                             .astype(np.float32))
    w_lse = torch.from_numpy(rng.standard_normal((6, 48)).astype(np.float32))
    results = []
    for fn in (fa.flash_fwd_op, fa.FlashAttentionFunction.apply):
        q, k, v = _qkv(1)
        out, lse = fn(q, k, v, q_offset, k_offset, causal, 0.25)
        ((out * w_out).sum() + (lse * w_lse).sum()).backward()
        results.append([out.detach(), lse.detach(), q.grad, k.grad, v.grad])
    for got, want in zip(*results):
        assert torch.equal(got, want)


def test_flash_attention_compiles_to_the_custom_op():
    """flash_attention under torch.compile(fullgraph=True) calls the custom
    op (no graph break) and equals the eager call, gradients included."""
    rng = np.random.RandomState(2)

    def make():
        return [torch.from_numpy(rng.standard_normal((2, 32, 3, 16))
                                 .astype(np.float32)).requires_grad_()
                for _ in range(3)]
    q, k, v = make()
    eager = fa.flash_attention(q, k, v)
    eager.square().sum().backward()
    want = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    seen = []

    def backend(gm, example_inputs):
        seen.extend(str(n.target) for n in gm.graph.nodes
                    if n.op == "call_function")
        from torch._dynamo import lookup_backend
        return lookup_backend(BACKEND)(gm, example_inputs)
    got = torch.compile(fa.flash_attention, fullgraph=True,
                        backend=backend)(q, k, v)
    got.square().sum().backward()
    assert torch.equal(got, eager)
    assert all(torch.equal(t.grad, g) for t, g in zip((q, k, v), want))
    assert sum("hvd_tpu.flash_fwd" in t for t in seen) == 1


def test_flash_custom_op_registration_checks():
    """torch.library.opcheck: the schema, the fake (shapes and dtypes of
    out and lse) and the autograd registration agree with the op."""
    q, k, v = (t.detach() for t in _qkv(3, bh=2, s=32))
    torch.library.opcheck(fa.flash_fwd_op, (q, k, v, 0, 0, True, 0.25),
                          test_utils=("test_schema", "test_faketensor",
                                      "test_autograd_registration"))
    fake = fa._flash_fwd_fake(q, k, v, 0, 0, True, 0.25)
    out, lse = fa.flash_fwd_op(q, k, v, 0, 0, True, 0.25)
    assert (fake[0].shape, fake[0].dtype) == (out.shape, out.dtype)
    assert (fake[1].shape, fake[1].dtype) == (lse.shape, torch.float32)
    # the backward operator: its schema and fake, and it is the plain
    # backward
    g, g_lse = torch.ones_like(out), torch.zeros_like(lse)
    args = (q, k, v, out, lse, g, g_lse, 0, 0, True, 0.25)
    torch.library.opcheck(fa.flash_bwd_op, args,
                          test_utils=("test_schema", "test_faketensor"))
    for got, want in zip(fa.flash_bwd_op(*args),
                         fa.flash_bwd_plain(*args[:9], causal=True,
                                            sm_scale=0.25)):
        assert torch.equal(got, want)


# -- the compiled step --------------------------------------------------------

def _bundle(compiled, **kw):
    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    extra = dict(compiled=True, compile_backend=BACKEND) if compiled else {}
    return make_transformer_train_step(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0),
        **extra, **kw)


def test_compiled_step_equals_the_eager_step(world):
    """3 steps of the compiled step against the eager step from the same
    weights (the bundle's AdamW): losses within 1e-6 (equal in fact),
    parameters and optimizer state bit for bit; one graph a region, the
    flash op once a layer, one in-graph all-reduce for the gradients (one
    packed bucket), no eager dispatch and one lowering."""
    _check_compiled_equals_eager({})


OPTIMIZERS = {
    "sgd_momentum": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
    "adam": lambda ps: torch.optim.Adam(ps, lr=1e-3, weight_decay=1e-2),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_compiled_step_takes_any_optimizer(world, name):
    """The inner optimizer steps eagerly after the compiled reduction, so
    any torch optimizer is taken, with the checks above."""
    _check_compiled_equals_eager({"optimizer": OPTIMIZERS[name]})


def _check_compiled_equals_eager(kw):
    eager = _bundle(False, **kw)
    want = _run(eager)
    eager.optimizer.remove_hooks()
    comp = _bundle(True, **kw)
    counts = dict(C.COUNTS)
    before = metrics.snapshot()
    got = _run(comp)
    after = metrics.snapshot()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for (name, a), b in zip(eager.model.named_parameters(),
                            comp.model.parameters()):
        assert torch.equal(a, b), name
        sa, sb = eager.optimizer.state[a], comp.optimizer.state[b]
        assert sorted(sa) == sorted(sb) and sa, name
        for key in sa:
            assert torch.equal(sa[key], sb[key]), (name, key)
    assert [(g["region"], g["flash_ops"], g["all_reduces"])
            for g in comp.compile_log] \
        == [("forward", TINY["num_layers"], 0), ("reduce", 0, 1)]
    assert C.COUNTS == counts
    assert all(after[k] == before[k] for k in after
               if k.startswith("hvd_tpu_collective_ops_total"))
    assert after[GROUPED] - before[GROUPED] == 1
    assert comp.optimizer._hooks_on is False


def test_compiled_step_matches_the_jax_jitted_step(world):
    """The JAX package's ``jax.jit(_step)`` bundle (a dp 1 mesh) from
    PRNGKey(0)'s weights, carried into the compiled step: losses and
    final parameters at atol 1e-5."""
    from horovod_tpu import parallel as jpar
    from horovod_tpu.models import TransformerConfig as JCfg
    from horovod_tpu.parallel.train import make_transformer_train_step as mk
    mesh = jpar.make_training_mesh(jpar.MeshConfig(dp=1),
                                   devices=jax.devices()[:1])
    jb = mk(JCfg(**TINY, dtype=jnp.float32), mesh)
    start = params_from_flax(jax.tree_util.tree_map(
        np.asarray, meta.unbox(jb.params)))
    p, s = jb.params, jb.opt_state
    jlosses = []
    for step in range(STEPS):
        d = _data(step).astype(np.int32)
        p, s, loss = jb.step(p, s, jnp.asarray(d[:, :-1]),
                             jnp.asarray(d[:, 1:]))
        jlosses.append(float(loss))
    final = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                    meta.unbox(p)))
    comp = _bundle(True)
    comp.model.load_state_dict(start)
    np.testing.assert_allclose(_run(comp), jlosses, rtol=0, atol=1e-5)
    for name, t in comp.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), final[name], rtol=0,
                                   atol=1e-5, err_msg=name)


def test_compiled_reduction_fills_a_missing_gradient_with_zeros(world):
    """A parameter the loss does not reach gets zeros, reduced in the
    graph with the others (one bucket), and the inner optimizer steps it
    as a parameter with a zero gradient; the others as eagerly."""
    torch.manual_seed(0)
    used, unused = (torch.nn.Parameter(torch.randn(4, 3)) for _ in range(2))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([used, unused], lr=0.25),
        named_parameters=[("used", used), ("unused", unused)])
    opt.remove_hooks()
    log = []
    from horovod_tpu_torch.parallel.train import _recording_backend
    reduce = torch.compile(opt.synchronize, fullgraph=True,
                           backend=_recording_backend(BACKEND, "reduce", log))
    start = (used.detach().clone(), unused.detach().clone())
    used.square().sum().backward()
    assert unused.grad is None
    reduce()
    opt._opt.step()
    assert torch.equal(unused.grad, torch.zeros(4, 3))
    assert torch.equal(unused.detach(), start[1])
    assert torch.equal(used.detach(), start[0] - 0.25 * (2 * start[0]))
    assert [g["all_reduces"] for g in log] == [1]
