"""The port's CNN zoo (horovod_tpu_torch.models: ResNet, VGG, InceptionV3,
MLP, and the converters of models/convert.py) against the JAX package's
flax models on the CPU.

Weights are the JAX module's variable tree (names and shapes from its
init through ``jax.eval_shape``) with values drawn from a numpy seed,
carried across by ``cnn_params_from_flax``: BatchNorm scales and
statistics are random, so every residual branch computes (the JAX init
starts each block's last scale at 0) and a statistics fault shows, and
drawing them costs no JAX init (seconds a model on the CPU); the real JAX
init converts in ``test_converters_round_trip_and_reject_mismatch``.
Images are made from a numpy seed, NHWC for JAX and NCHW for the port.
Tolerances, relative L2 over all elements:

* fp32 eval forward: ``TOL_FP32`` 1e-4 (fp32 sums in other orders);
* train-mode forward, the updated batch statistics and the gradients of a
  summed loss run in fp64 on both sides, within ``TOL_FP64`` 1e-6 (both
  packages cast to fp32 at the classifier, as the JAX module states; the
  rest is fp64). In fp32 these comparisons measure conditioning, not the
  port: flax takes the batch variance as E[x^2] - E[x]^2, the port's
  batch norm by two passes, and a ReLU input within 1e-6 of zero can take
  the other sign, which moves every earlier layer's gradient far beyond
  fp32 rounding against fp64, in either package;
* bf16 (the models' default) eval forward: ``TOL_BF16`` 2e-2, about five
  bf16 roundings (2^-8) through the network. That bound would also pass
  an fp32 model, so where the products run in bf16 is checked apart, by
  recording the dtypes each conv and dense product receives.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from horovod_tpu import models as jm
from horovod_tpu_torch import models as tm
from horovod_tpu_torch.models import layers as tl

TOL_FP32 = 1e-4
TOL_FP64 = 1e-6
TOL_BF16 = 2e-2
TOL_STEM = 1e-5

# (JAX constructor, port constructor, keyword arguments, image size)
RESNETS = {
    "resnet18": (jm.ResNet18, tm.ResNet18, dict(num_classes=10), 64),
    "resnet50_narrow": (jm.ResNet50, tm.ResNet50,
                        dict(num_classes=10, num_filters=8), 64),
}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _images(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype)


def _is_bn(path) -> bool:
    return any(str(getattr(p, "key", "")).startswith("BatchNorm")
               or getattr(p, "key", "") in ("bn_init", "norm_proj")
               for p in path)


def _jax_variables(jmodel, x, seed=1, **kw):
    """The JAX module's variables: names and shapes from its init (by
    ``jax.eval_shape``), values from a numpy seed. Kernels lecun-normal
    by their fan-in, other biases N(0, 0.1); BatchNorm scale and var in
    [0.5, 1.5), bias and mean N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), **kw))

    def draw(path, a):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0.0, fan_in ** -0.5, a.shape).astype(
                np.float32)
        if _is_bn(path) and key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _jax_init(jmodel, x, **kw):
    v = jax.jit(lambda xx: jmodel.init(jax.random.PRNGKey(0), xx, **kw))(
        jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, dict(v))


def _jax_eval(jmodel, v, x, dtype=jnp.float32):
    return jax.jit(lambda vv, xx: jmodel.apply(vv, xx, train=False))(
        v, jnp.asarray(x, dtype))


def _port(tcls, variables, dtype=torch.float32, **kw):
    model = tcls(**kw, dtype=dtype, device="cpu")
    model.load_state_dict(tm.cnn_params_from_flax(model, variables))
    return model.to(dtype) if dtype == torch.float64 else model


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _jax_count(jmodel, size, **kw):
    v = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.bfloat16),
        train=False, **kw))
    return sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(v["params"]))


def _count(model):
    return sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("name, jax_model, port_model, size, canonical", [
    ("resnet50", jm.ResNet50(), tm.ResNet50(device="meta"), 224,
     25_557_032),
    ("resnet18", jm.ResNet18(), tm.ResNet18(device="meta"), 224,
     11_689_512),
    ("vgg16", jm.VGG16(), tm.VGG16(device="meta"), 224, 138_357_544),
    ("inception_v3", jm.InceptionV3(), tm.InceptionV3(device="meta"), 299,
     23_834_568),
])
def test_parameter_counts_equal_jax(name, jax_model, port_model, size,
                                    canonical):
    assert _count(port_model) == _jax_count(jax_model, size) == canonical


def test_mlp_parameter_count_equals_jax():
    v = jax.eval_shape(lambda: jm.MLP().init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 28, 28, 1))))
    n = sum(int(np.prod(a.shape))
            for a in jax.tree_util.tree_leaves(v["params"]))
    assert _count(tm.MLP(device="meta")) == n


@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_eval_forward_matches_jax(name):
    jcls, tcls, kw, size = RESNETS[name]
    x = _images((2, size, size, 3))
    jmodel = jcls(**kw, dtype=jnp.float32)
    v = _jax_variables(jmodel, x, train=False)
    want = _jax_eval(jmodel, v, x)
    got = _port(tcls, v, **kw).eval()(_nchw(x))
    assert got.dtype == torch.float32
    assert _rel(got.detach(), want) <= TOL_FP32


@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_train_step_matches_jax(name):
    """Train-mode logits, the updated batch_stats and the gradients of a
    summed loss, in fp64 (see the module docstring)."""
    jcls, tcls, kw, size = RESNETS[name]
    x = _images((2, size, size, 3), seed=2)
    v = _jax_variables(jcls(**kw, dtype=jnp.float32), x,
                       train=False)
    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
    jmodel = jcls(**kw, dtype=jnp.float64)

    @jax.jit
    def jax_step(params, stats, xx):
        def loss(p):
            logits, upd = jmodel.apply({"params": p, "batch_stats": stats},
                                       xx, train=True,
                                       mutable=["batch_stats"])
            return logits.sum(), (logits, upd["batch_stats"])
        return jax.grad(loss, has_aux=True)(params)
    grads, (logits, stats) = jax_step(v64["params"], v64["batch_stats"],
                                      jnp.asarray(x, jnp.float64))

    model = _port(tcls, v, torch.float64, **kw).train()
    out = model(_nchw(x, torch.float64))
    out.sum().backward()
    port = tm.cnn_params_to_flax(
        {**{n: p.grad for n, p in model.named_parameters()},
         **dict(model.named_buffers())})
    assert _rel(out.detach(), logits) <= TOL_FP64
    got_stats, want_stats = _leaves(port["batch_stats"]), _leaves(stats)
    assert len(got_stats) == len(want_stats)
    for a, b in zip(got_stats, want_stats):
        assert _rel(a, b) <= TOL_FP64
    got_grads, want_grads = _leaves(port["params"]), _leaves(grads)
    assert len(got_grads) == len(want_grads) == len(list(
        model.parameters()))
    for a, b in zip(got_grads, want_grads):
        assert _rel(a, b) <= TOL_FP64


@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_bf16_forward_close_to_jax(name):
    jcls, tcls, kw, size = RESNETS[name]
    x = _images((2, size, size, 3), seed=3)
    v = _jax_variables(jcls(**kw, dtype=jnp.float32), x,
                       train=False)
    want = _jax_eval(jcls(**kw), v, x, jnp.bfloat16)
    got = _port(tcls, v, torch.bfloat16, **kw).eval()(
        _nchw(x, torch.bfloat16))
    assert got.dtype == torch.float32     # the fp32 classifier
    assert _rel(got.detach(), want) <= TOL_BF16


# (port constructor, keyword arguments, image size, the dtypes of its dense
# layers' products in call order): every conv and hidden dense layer
# computes in bf16, the classifier heads in fp32 (resnet.py:159-161,
# vgg.py:49-54, inception.py:172-174, mlp.py:20-22 of the JAX package)
BF16_CASES = {
    "resnet18": (tm.ResNet18, dict(num_classes=10), 32, ["fp32"]),
    "resnet18_s2d": (tm.ResNet18, dict(num_classes=10,
                                       stem="space_to_depth"), 32, ["fp32"]),
    "vgg16": (tm.VGG16, dict(num_classes=10, classifier_width=64,
                             dropout_rate=0.0, image_size=32), 32,
              ["bf16", "bf16", "fp32"]),
    "inception3_aux": (tm.InceptionV3, dict(num_classes=10,
                                            aux_logits=True,
                                            dropout_rate=0.0,
                                            image_size=107), 107,
                       ["fp32", "fp32"]),
    "mlp": (tm.MLP, dict(in_features=6 * 6 * 3), 6,
            ["bf16", "bf16", "fp32"]),
}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
@pytest.mark.parametrize("train", [False, True])
def test_bf16_models_cast_where_jax_does(name, train, monkeypatch):
    """With dtype=bf16 every conv gets a bf16 input and kernel, every
    hidden dense layer a bf16 input and kernel, and each classifier head
    fp32: the forward's tolerance (TOL_BF16) cannot tell bf16 from fp32
    convs, so the casts are checked where the products are taken."""
    names = {torch.bfloat16: "bf16", torch.float32: "fp32"}
    convs, denses = [], []

    def recording(fn, into):
        def call(x, w, *args, **kw):
            into.append((names.get(x.dtype, str(x.dtype)),
                         names.get(w.dtype, str(w.dtype))))
            return fn(x, w, *args, **kw)
        return call

    monkeypatch.setattr(F, "conv2d", recording(F.conv2d, convs))
    monkeypatch.setattr(F, "linear", recording(F.linear, denses))
    build, kw, size, want = BF16_CASES[name]
    model = build(**kw, dtype=torch.bfloat16, device="cpu",
                  generator=torch.Generator().manual_seed(0)).train(train)
    x = _nchw(_images((2, size, size, 3), seed=5))
    with torch.no_grad():
        out = model(x)
    for o in out if isinstance(out, tuple) else (out,):
        assert o.dtype == torch.float32
    assert convs or name == "mlp"
    assert set(convs) <= {("bf16", "bf16")}
    assert denses == [(d, d) for d in want]


@pytest.mark.parametrize("size", [8, 7])
def test_stride2_same_padding_is_xlas(size):
    """flax's SAME on a 3x3 stride-2 conv pads (0, 1) on an even input and
    (1, 1) on an odd one; torch's padding=1 is (1, 1) always, and on the
    even input that is another function (the check below proves the case
    can tell them apart)."""
    import flax.linen as nn
    x = _images((2, size, size, 4), seed=4)
    conv = nn.Conv(6, (3, 3), (2, 2), use_bias=False, dtype=jnp.float32)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(v, jnp.asarray(x))).transpose(0, 3, 1, 2)
    port = tl.Conv(4, 6, (3, 3), (2, 2), use_bias=False, dtype=torch.float32,
                   device="cpu")
    port.load_state_dict({"kernel": torch.from_numpy(np.asarray(
        v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())})
    got = port(_nchw(x)).detach()
    pad = (0, 1) if size % 2 == 0 else (1, 1)
    assert port.pads(size, size) == (pad, pad)
    assert _rel(got, want) <= TOL_FP32
    symmetric = F.conv2d(_nchw(x), port.kernel.detach(), stride=2,
                         padding=1)
    assert (_rel(symmetric, want) > 0.1) == (size % 2 == 0)


def test_space_to_depth_stem_equals_conv_stem_and_jax():
    x = _images((2, 32, 32, 3), seed=5)
    conv_j = jm.ResNet18(num_classes=10, dtype=jnp.float32, stem="conv")
    s2d_j = jm.ResNet18(num_classes=10, dtype=jnp.float32,
                        stem="space_to_depth")
    v = _jax_variables(conv_j, x, train=False)
    conv = _port(tm.ResNet18, v, num_classes=10, stem="conv").eval()
    s2d = _port(tm.ResNet18, v, num_classes=10,
                stem="space_to_depth").eval()
    assert s2d.state_dict().keys() == conv.state_dict().keys()
    got_conv, got_s2d = conv(_nchw(x)).detach(), s2d(_nchw(x)).detach()
    assert _rel(got_s2d, got_conv) <= TOL_STEM
    assert _rel(got_s2d, _jax_eval(s2d_j, v, x)) <= TOL_FP32
    with pytest.raises(ValueError, match="even spatial"):
        s2d(torch.zeros(1, 3, 31, 32))
    with pytest.raises(ValueError, match="unknown stem"):
        tm.ResNet18(stem="s2d", device="meta")


def test_vgg16_matches_jax_with_nhwc_flatten_order():
    """64 px leaves 2 x 2 x 512 at the flatten, so Dense_0's rows are in
    (H, W, C) order only if the port flattens as flax does."""
    kw = dict(num_classes=10, classifier_width=64, dropout_rate=0.0)
    x = _images((2, 64, 64, 3), seed=6)
    jmodel = jm.VGG16(**kw, dtype=jnp.float32)
    v = _jax_variables(jmodel, x, train=False)
    assert v["params"]["Dense_0"]["kernel"].shape == (2 * 2 * 512, 64)
    model = _port(tm.VGG16, v, image_size=64, **kw).eval()
    want = _jax_eval(jmodel, v, x)
    assert _rel(model(_nchw(x)).detach(), want) <= TOL_FP32
    # the same weights flattened in NCHW order are another function
    feats = _nchw(x)
    for i in range(13):
        feats = F.relu(getattr(model, f"Conv_{i}")(feats))
        if i in (1, 3, 6, 9, 12):
            feats = F.max_pool2d(feats, 2, 2)
    nchw = F.linear(feats.reshape(2, -1), model.Dense_0.kernel)
    nhwc = F.linear(tl.nhwc_flatten(feats), model.Dense_0.kernel)
    assert _rel(nchw.detach(), nhwc.detach()) > 0.1


def test_vgg_dropout_active_in_train_only():
    model = tm.VGG11(num_classes=10, classifier_width=64, dropout_rate=0.5,
                     image_size=32, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    x = _nchw(_images((2, 32, 32, 3), seed=7))
    torch.manual_seed(0)
    a, b = model(x), model(x)
    assert not torch.allclose(a, b)
    model.eval()
    assert torch.equal(model(x), model(x))


@pytest.mark.parametrize("aux, size", [(False, 75), (True, 107)])
def test_inception_v3_matches_jax(aux, size):
    """At 75 px the 17x17 grid is 3x3, too small for the aux head's 5x5
    pool: the JAX module fails there too (below), so the aux case runs at
    107 px, the least size that has it."""
    kw = dict(num_classes=10, dropout_rate=0.0, aux_logits=aux)
    x = _images((2, size, size, 3), seed=8)
    jmodel = jm.InceptionV3(**kw, dtype=jnp.float32)
    v = _jax_variables(jmodel, x, train=False)
    want = _jax_eval(jmodel, v, x)
    got = _port(tm.InceptionV3, v, image_size=size, **kw).eval()(_nchw(x))
    if aux:
        assert _rel(got[0].detach(), want[0]) <= TOL_FP32
        assert _rel(got[1].detach(), want[1]) <= TOL_FP32
    else:
        assert _rel(got.detach(), want) <= TOL_FP32


def test_inception_aux_head_needs_107_px_in_both():
    with pytest.raises(ValueError, match="107"):
        tm.InceptionV3(aux_logits=True, image_size=75, device="meta")
    with pytest.raises(ZeroDivisionError):
        _jax_variables(jm.InceptionV3(num_classes=10, aux_logits=True),
                       np.zeros((1, 75, 75, 3), np.float32), train=False)


@pytest.mark.parametrize("shape", [(4, 28, 28, 1), (4, 6, 6, 3)])
def test_mlp_matches_jax(shape):
    x = _images(shape, seed=9)
    jmodel = jm.MLP(features=(32, 16), num_classes=10)
    v = _jax_variables(jmodel, x)
    model = tm.MLP(features=(32, 16), num_classes=10,
                   in_features=int(np.prod(shape[1:])), device="cpu")
    model.load_state_dict(tm.cnn_params_from_flax(model, v))
    want = jax.jit(jmodel.apply)(v, jnp.asarray(x))
    assert _rel(model(_nchw(x)).detach(), want) <= TOL_FP32


def test_converters_round_trip_and_reject_mismatch():
    x = _images((1, 32, 32, 3))
    kw = dict(num_classes=10, num_filters=8)
    v = _jax_init(jm.ResNet18(**kw), x, train=False)
    model = tm.ResNet18(**kw, device="cpu")
    state = tm.cnn_params_from_flax(model, v)
    assert state["conv_init.kernel"].shape == (8, 3, 7, 7)       # OIHW
    assert state["Dense_0.kernel"].shape == (10, 64)             # (out, in)
    back = tm.cnn_params_to_flax(state)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, v)
    short = {"params": dict(v["params"]), "batch_stats": v["batch_stats"]}
    del short["params"]["Dense_0"]
    with pytest.raises(ValueError, match="missing"):
        tm.cnn_params_from_flax(model, short)
    extra = {"params": {**v["params"], "Dense_9": {"bias": np.zeros(3)}},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError, match="leftover"):
        tm.cnn_params_from_flax(model, extra)
