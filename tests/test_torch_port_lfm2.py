"""The LFM2-MoE decoder of horovod_tpu_torch (``models/lfm2.py``) and its
dropless expert layer (``parallel/moe.py``) held to the benchmark's plain
reference (``perfbench/reference/lfm2_moe.py``) on the CPU, at a tiny
size of the configuration's shape: 4 layers (conv, conv, attention,
conv), width 64, 4 query and 2 K/V heads of 16, one dense layer, then 8
router outputs with 4 experts held and top 2. In float32 the port's
logits, loss and every leaf's gradient, taken through
``make_transformer_train_step`` as the benchmark steps it, agree with the
reference to float32 rounding. Then the pieces one at a time, and the
layer's spans and counters (``tracing.py``)."""

import dataclasses
import json
import os
import types

import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import config as tconfig
from horovod_tpu_torch import tracing as ttr
from horovod_tpu_torch.models import lfm2
from horovod_tpu_torch.parallel import moe
from horovod_tpu_torch.parallel.train import make_transformer_train_step
from perfbench import feed
from perfbench.families import lfm2_moe as family
from perfbench.reference import lfm2_moe as ref
from perfbench.reference.precision import Precision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [7, 2**31 + 23]
FP32 = Precision("fp32")
TRAFFIC = {"batch_per_chip": 2, "seq_len": 24, "pool_batches": 1,
           "optimizer": {"name": "adamw", "lr": 1e-3, "betas": [0.9, 0.999],
                         "eps": 1e-8, "weight_decay": 1e-4}}
NEW_RANGES = ("hvd.moe.route", "hvd.moe.experts", "hvd.moe.combine",
              "hvd.conv.short")
NEW_NODES = ("ExpertMatmulFunctionBackward", "ShortConvFunctionBackward")


def _cfg(**kw) -> dict:
    """The configuration file's keys at the tiny size, in float32."""
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "lfm2-8b-a1b.json")) as f:
        cfg = json.load(f)
    cfg.update(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
               num_hidden_layers=4,
               layer_types=["conv", "conv", "full_attention", "conv"],
               num_attention_heads=4, num_key_value_heads=2,
               num_dense_layers=1, router_experts=8, num_experts=4,
               experts_held=[0, 4], num_experts_per_tok=2, vocab_size=128,
               dtype="float32")
    cfg.update(kw)
    cfg["parameters"] = sum(
        int(torch.tensor(shape).prod()) for name, shape, _ in
        family.leaves(cfg) if not name.endswith("expert_bias"))
    return cfg


@pytest.fixture(scope="module", autouse=True)
def world():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    hvd.init(device="cpu")
    try:
        yield
    finally:
        _tracer(False)
        hvd.shutdown()
        ttr.reset()
        moe.PROFILED_HELD_SLOTS.clear()
        torch.set_num_threads(threads)


def _program(cfg, seed):
    w = feed.make_weights(family.leaves(cfg), seed, "cpu")
    x, y = feed.token_batches(TRAFFIC, cfg["vocab_size"], seed, 0, "cpu")
    return family.Program(cfg, TRAFFIC, w, "cpu"), w, x[0], y[0]


def _close(got, want, rtol):
    """Relative to the leaf's largest value: float32 rounding of sums in
    another order, not a tolerance for a different formula."""
    scale = want.abs().max().clamp(min=1e-12)
    return float((got - want).abs().max() / scale) <= rtol


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_agrees_with_the_reference(seed):
    cfg = _cfg()
    prog, w, tokens, targets = _program(cfg, seed)
    with torch.no_grad():
        got = prog.model(tokens)
    want = ref.logits(w, tokens, cfg, FP32)
    assert _close(got, want, 1e-5)
    loss = float(prog.step(tokens, targets))
    want_loss, grads, _ = ref.loss_and_grads(w, (tokens, targets), cfg, FP32)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    mine = prog.first_grads(None)
    assert set(mine) == set(grads)
    for name, g in grads.items():
        if name.endswith("expert_bias"):
            assert not mine[name].any() and not g.any(), name
        else:
            assert _close(mine[name], g, 2e-4), name


def _layer_inputs(seed, T=48, D=16, E=8, Fm=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, D, generator=g)
    router = 0.5 * torch.randn(D, E, generator=g)
    bias = 0.05 * torch.randn(E, generator=g)
    w1, w3 = (0.3 * torch.randn(E, D, Fm, generator=g) for _ in range(2))
    w2 = 0.3 * torch.randn(E, Fm, D, generator=g)
    return x, router, bias, w1, w3, w2


def _ref_layer(x, router, bias, w1, w3, w2, first, stop, k):
    cfg = {"num_experts_per_tok": k, "norm_topk_prob": True,
           "routed_scaling_factor": 1.0, "num_experts": stop - first,
           "experts_held": [first, stop]}
    w = {"router": router, "expert_bias": bias, "w1": w1[first:stop],
         "w3": w3[first:stop], "w2": w2[first:stop]}
    return ref.moe(x[None], w, "", cfg, FP32)[0]


def _port_layer(x, router, bias, w1, w3, w2, first, stop, k):
    return moe.dropless_moe(
        x, router, bias, torch.cat([w1[first:stop], w3[first:stop]], 2),
        w2[first:stop], (first, stop), k)


def test_the_chip_shares_add_up_to_the_uncut_layer():
    """Four ep shares of 2 experts each, summed, give the reference's
    layer with all 8 experts held."""
    x, router, bias, w1, w3, w2 = _layer_inputs(3)
    whole = _ref_layer(x, router, bias, w1, w3, w2, 0, 8, 2)
    parts = sum(_port_layer(x, router, bias, w1, w3, w2, r, r + 2, 2)
                for r in range(0, 8, 2))
    assert _close(parts, whole, 1e-6)


def test_a_skewed_bias_drops_nothing_and_an_idle_expert_gets_zeros():
    """A bias that sends every token to expert 1 and none to expert 2:
    expert 1 computes every token's slot (no capacity), the output is
    the reference's, and expert 2's gradient is zeros, not None."""
    x, router, bias, w1, w3, w2 = _layer_inputs(4)
    bias = bias.clone()
    bias[1], bias[2] = 10.0, -10.0
    w13 = torch.cat([w1[:4], w3[:4]], 2).requires_grad_(True)
    down = w2[:4].clone().requires_grad_(True)
    tr = _tracer(True)
    with ttr.step_forward(0):
        y = moe.dropless_moe(x, router, bias, w13, down, (0, 4), 2)
    _tracer(False)
    assert _close(y.detach(), _ref_layer(x, router, bias, w1, w3, w2, 0, 4, 2),
                  1e-6)
    route = [s for s in tr.spans("step-0") if s["name"] == "moe.route"][0]
    assert route["args"]["held_load_max"] == x.shape[0]
    assert route["args"]["dropped"] == 0
    y.square().sum().backward()
    for grad in (w13.grad, down.grad):
        assert grad is not None and not grad[2].any() and grad[1].any()


def test_selection_is_on_biased_scores_and_weights_on_unbiased_ones():
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.9])
    experts, weights = moe.route_topk(logits, bias, 2)
    assert experts.tolist() == [[3, 0]]   # expert 1 loses on the bias
    s = torch.sigmoid(logits[0, [3, 0]])
    assert torch.allclose(weights[0], s / (s.sum() + 1e-6))
    want = ref.route(logits, bias, {"num_experts_per_tok": 2,
                                    "norm_topk_prob": True,
                                    "routed_scaling_factor": 1.0})
    assert torch.equal(want[0], experts) and torch.allclose(want[1], weights)


def test_the_short_convolution_is_causal_and_its_backward_is_the_reference():
    g = torch.Generator().manual_seed(5)
    b, c, x = (torch.randn(2, 10, 6, dtype=torch.float64, generator=g,
                           requires_grad=True) for _ in range(3))
    w = torch.randn(6, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    y = lfm2.ShortConvFunction.apply(b, c, x, w)
    want = ref.short_conv(b, c, x, w)
    assert torch.allclose(y, want, rtol=1e-12, atol=1e-12)
    later = x.detach().clone()
    later[:, 6:] += 1.0
    y2 = lfm2.ShortConvFunction.apply(b, c, later, w)
    assert torch.equal(y2[:, :6], y[:, :6]) and not torch.equal(y2, y)
    gy = torch.randn(y.shape, dtype=torch.float64, generator=g)
    mine = torch.autograd.grad(y, (b, c, x, w), gy)
    theirs = torch.autograd.grad(want, (b, c, x, w), gy)
    for a, t in zip(mine, theirs):
        assert torch.allclose(a, t, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("which", ["rms_norm", "swiglu", "combine"])
def test_the_fused_functions_match_autograd(which):
    """The memory-lean autograd Functions against torch's autograd of the
    reference's formulas, in float64."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(3, 5, 12, dtype=torch.float64, generator=g,
                    requires_grad=True)
    if which == "rms_norm":
        scale = (1 + 0.1 * torch.randn(12, dtype=torch.float64,
                                       generator=g)).requires_grad_(True)
        ins = (x, scale)
        got = lfm2.RMSNormFunction.apply(x, scale, 1e-5, torch.float64)
        want = ref.rms_norm(x, scale, 1e-5)
    elif which == "swiglu":
        ins = (x,)
        got = moe.SwiGLUFunction.apply(x)
        want = F.silu(x[..., :6]) * x[..., 6:]
    else:
        w = torch.rand(3, 5, dtype=torch.float64, generator=g,
                       requires_grad=True)
        ins = (x, w)
        got = moe.CombineFunction.apply(x, w)
        want = (x * w[..., None]).sum(1)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    gy = torch.randn(got.shape, dtype=torch.float64, generator=g)
    for a, b in zip(torch.autograd.grad(got, ins, gy),
                    torch.autograd.grad(want, ins, gy)):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-12)


def test_query_head_h_reads_kv_head_h_over_the_group():
    """With v constant per K/V head, each query head's output is its K/V
    head's constant: h // (H / KV), as the reference maps it."""
    cfg = lfm2.Lfm2MoeConfig(hidden_size=64, num_attention_heads=8,
                             num_key_value_heads=2, num_hidden_layers=1,
                             layer_types=("full_attention",),
                             dtype=torch.float32)
    seen = {}

    def attn(q, k, v, mask, dtype):
        seen["v"] = v
        return v
    att = lfm2.GQAttention(dataclasses.replace(cfg, attention_fn=attn),
                           torch.device("cpu"), None)
    with torch.no_grad():
        att.wv.zero_()
        att.wv[0, :8] = 1.0      # K/V head 0 reads feature 0
        att.wv[1, 8:] = 1.0      # K/V head 1 reads feature 1
    x = torch.zeros(1, 3, 64)
    x[..., 0], x[..., 1] = 10.0, 20.0
    cos, sin = lfm2.rotary_tables(torch.arange(3), 8, 1e6)
    att(x, None, cos, sin)
    heads = seen["v"][0, 0, :, 0].tolist()
    assert heads == [10.0 if ref.kv_head(h, 8, 2) == 0 else 20.0
                     for h in range(8)] == [10.0] * 4 + [20.0] * 4


def test_a_sharded_mesh_and_the_compiled_step_are_refused():
    cfg = family.port_config(_cfg(), 24)
    mesh = types.SimpleNamespace(
        device_type="cpu", shape=(1, 1, 1, 1, 1, 2),
        mesh_dim_names=("dp", "fsdp", "pp", "ep", "sp", "tp"))
    with pytest.raises(ValueError, match="no mesh step"):
        make_transformer_train_step(cfg, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="compiled"):
        make_transformer_train_step(cfg, device="cpu", compiled=True)


# -- spans and counters -------------------------------------------------------

def _tracer(on: bool):
    hvd.basics.world().config.set(tconfig.TRACE_SAMPLE, 1.0 if on else 0.0)
    ttr.reset()
    return ttr.tracer()


def test_a_profiled_step_records_the_ranges_nodes_and_slots_the_metrics_read():
    from perfbench.metrics import expert_mm_roofline
    from torch.profiler import ProfilerActivity, profile
    _tracer(False)
    cfg = _cfg()
    prog, _, tokens, targets = _program(cfg, 11)
    moe.PROFILED_HELD_SLOTS.clear()
    prog.step(tokens, targets)
    assert not moe.PROFILED_HELD_SLOTS
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append((args[0].reshape(-1, 64),
                                     m.router.detach().clone(),
                                     m.expert_bias)))
        for m in prog.model.modules()
        if isinstance(m, lfm2.SparseMoeBlock)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prog.step(tokens, targets)
    for h in hooks:
        h.remove()
    names = {e.name for e in prof.events()}
    for want in NEW_RANGES + ("hvd.step.forward",):
        assert want in names, want
    for node in NEW_NODES:
        assert any(node in n for n in names), node
    assert "aten::_grouped_mm" in names
    # one record a sparse layer: its slots that picked experts 0-3 of 8
    held = [int((moe.route_topk(x.float() @ r, bias, 2)[0] < 4).sum())
            for x, r, bias in seen]
    assert [int(s) for s in moe.PROFILED_HELD_SLOTS] == held
    run = types.SimpleNamespace(steps=1, config=cfg)
    assert expert_mm_roofline.traced_slots(run) == sum(held) > 0
    assert expert_mm_roofline.traced_slots(
        types.SimpleNamespace(steps=2, config=cfg)) is None


def test_a_sampled_step_carries_the_counters():
    tr = _tracer(True)
    cfg = _cfg()
    prog, _, tokens, targets = _program(cfg, 12)
    prog.step(tokens, targets)
    step = prog.optimizer._steps - 1
    spans = tr.spans(f"step-{step}")
    forward = [s for s in spans if s["name"] == "step.forward"]
    routes = [s for s in spans if s["name"] == "moe.route"]
    assert len(forward) == 1
    assert len(routes) == cfg["num_hidden_layers"] - cfg["num_dense_layers"]
    slots = tokens.numel() * cfg["num_experts_per_tok"]
    for s in routes:
        a = s["args"]
        assert set(a) == set(moe.COUNTERS)
        assert 0 <= a["held_load_min"] <= a["held_load_max"]
        assert a["held_assignments"] <= slots and a["dropped"] == 0
        assert s["parent"] == forward[0]["span"]
    names = {s["name"] for s in spans}
    assert {"moe.experts", "moe.combine", "conv.short"} <= names
    _tracer(False)


def test_with_the_tracer_off_no_span_and_no_device_read(monkeypatch):
    assert _tracer(False) is None

    def read(counts):
        raise AssertionError("counters read on an unsampled step")
    monkeypatch.setattr(moe, "load_counters", read)
    prog, _, tokens, targets = _program(_cfg(), 13)
    assert ttr.step_forward(0) is ttr.span("moe.route")
    prog.step(tokens, targets)


def test_the_span_table_lists_the_new_spans():
    table = ttr.__doc__
    for name in ("step.forward", "moe.route", "moe.experts", "moe.combine",
                 "conv.short"):
        assert f"``{name}``" in table, name


# -- the benchmark's counts and readers ---------------------------------------

def test_the_configuration_counts_its_parameters_and_flops():
    """The configuration file's parameter count is the port's model's, on
    the meta device; all 32 experts held give the published 8.34 B; the
    FLOP count is about 45.8 TFLOP a step (ISSUE's arithmetic)."""
    from perfbench import counts_moe
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "lfm2-8b-a1b.json")) as f:
        cfg = json.load(f)

    def count(c):
        m = lfm2.Lfm2Moe(family.port_config(c, 8192), device="meta")
        return sum(p.numel() for p in m.parameters())
    assert count(cfg) == cfg["parameters"] == 2_526_624_512
    whole = {**cfg, "num_experts": 32, "experts_held": [0, 32]}
    assert count(whole) == cfg["published"]["parameters"]
    flops = counts_moe.lfm2_flops_per_step(cfg, 1, 8192)
    assert 45.7e12 < flops < 45.9e12
    slots = 22 * counts_moe.held_slots(cfg, 8192)
    nbytes, ops, least = counts_moe.expert_mm_bound(cfg, slots)
    assert ops == 22 * 9 * 2 * 8192 * 2048 * 1792
    assert least == ops / 989e12 > nbytes / 3.35e12


def test_the_readers_count_a_kernel_once_under_nested_ranges():
    from perfbench import model_ranges
    from perfbench.trace import Trace
    host = [("hvd.moe.experts", 0.0, 100.0, 1),
            ("aten::_grouped_mm", 10.0, 20.0, 1),
            ("autograd::engine::evaluate_function: "
             "ExpertMatmulFunctionBackward", 200.0, 50.0, 2),
            ("aten::_grouped_mm", 210.0, 20.0, 2),
            ("aten::mm", 300.0, 10.0, 1)]
    launches = {1: (15.0, 1), 2: (50.0, 1), 3: (220.0, 2), 4: (305.0, 1)}
    device = [("k1", 400.0, 3.0, 1), ("k2", 410.0, 5.0, 2),
              ("k3", 420.0, 7.0, 3), ("k4", 430.0, 11.0, 4)]
    run = types.SimpleNamespace(
        host_trace=Trace(device, host, launches, (0.0, 1000.0, 1)), steps=2)
    assert model_ranges.device_ms_per_step(
        run, ("hvd.moe.",), ("ExpertMatmulFunctionBackward",)) == \
        pytest.approx(1e-3 * (3 + 5 + 7) / 2)
    assert model_ranges.device_ms_per_step(run, ("aten::_grouped_mm",)) == \
        pytest.approx(1e-3 * (3 + 7) / 2)
    assert model_ranges.device_ms_per_step(run, ("hvd.conv.",)) is None
