"""The port's compiled-plane reductions (``DistributedOptimizer(axis_name=,
inner_axis=, mesh=, reduce_strategy=, packing=, compression=)``,
``fusion.packed_plan``, ``compression.int8_pack_reduce``,
``adasum.adasum_grads``) against the JAX package's
``DistributedGradientTransform`` inside ``shard_map``.

In one process (gloo at size 1; the JAX side on a 1-device mesh): the
packed plan, the argument checks, the int8 state and its resume, the
residual carried across packages, bf16 on the wire.

Across processes: gloo worlds of ``tests/torch_port_reduce_worker.py``
(see there for what each rank reduces), one of 2 (2 x 1: cross 2, local
1; also a 1 x 2 mesh through ``mesh=``) and one of 4 (2 x 2), held
against the JAX package on sub-meshes of tests/conftest.py's 8 CPU
devices.

Tolerances:
* every sum of two values is order-free, so at n = 2, and under
  ``hierarchical`` at 2 x 2 (a mean over 2, then over 2), the results
  equal the JAX package's bit for bit, and packed equals per-leaf;
* ``flat`` at 2 x 2 sums 4 values in one collective, in gloo's ring
  order on one side and XLA's on the other: the oracle's integer
  gradients within its rtol 1e-6 (tests/test_autotune.py:136-176), the
  seeded ones within the reordering bound (:func:`reorder_bound`);
* int8 is exact everywhere: a MAX, elementwise fp32 steps, an exact
  integer sum, and the residual x - q * scale rounded once, as XLA's
  FMA rounds it (``test_int8_residual_is_rounded_once``);
* Adasum within rtol 1e-4, atol 1e-5 (tests/test_adasum.py:75-87).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu import adasum as jadasum
from horovod_tpu import fusion as jfusion
from horovod_tpu.compression import Compression as JCompression
from horovod_tpu.optimizer import Int8ErrorFeedbackState

import horovod_tpu_torch as hvd
from horovod_tpu_torch import fusion as tfusion
from horovod_tpu_torch.compression import int8_pack_reduce
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.models.convert import (
    flax_order, int8_residual_from_flax, int8_residual_to_flax)
from torch_port_reduce_worker import (
    INT8_STEPS, SHAPES, VARIANTS, _optimizer, _params, _set_grads,
    make_grads, oracle_grads, run_world)

try:
    from jax import shard_map as _shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as _shard_map

AX = ("outer", "inner")


def _smap(f, mesh, in_specs, out_specs):
    try:
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_rep=False)
    except TypeError:  # renamed in newer jax
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False)


def _mesh(outer, inner):
    return Mesh(np.array(jax.devices()[:outer * inner]).reshape(outer, inner),
                AX)


def _jax_opt(base=None, **kw):
    return jhvd.DistributedOptimizer(base or optax.sgd(1.0),
                                     axis_name="outer", inner_axis="inner",
                                     **kw)


def jax_reduce(layout, grads, **kw):
    """Each device's reduced gradients ({leaf: (n, *shape)}, row = device)
    under ``DistributedOptimizer(axis_name='outer', inner_axis='inner',
    **kw).reduce_gradients``."""
    opt = _jax_opt(**kw)
    f = jax.jit(_smap(opt.reduce_gradients, _mesh(*layout), P(AX), P(AX)))
    return {k: np.asarray(v) for k, v in f(
        {k: jnp.asarray(v) for k, v in grads.items()}).items()}


def jax_int8_steps(layout, seeds, strategy, n):
    """``len(seeds)`` updates through int8 with each device's residual
    carried: [(reduced, residual) per step], rows by device."""
    opt = _jax_opt(reduce_strategy=strategy, packing="packed",
                   compression=JCompression.int8)
    inner_state = optax.sgd(1.0).init({k: jnp.zeros(s)
                                      for k, s in SHAPES.items()})

    def step(g, res):
        u, st = opt.update(g, Int8ErrorFeedbackState(res, inner_state))
        return u, st.residual
    f = jax.jit(_smap(step, _mesh(*layout), (P(AX), P(AX)), (P(AX), P(AX))))
    res = {k: jnp.zeros((n,) + s, jnp.float32) for k, s in SHAPES.items()}
    steps = []
    for seed in seeds:
        g = {k: jnp.asarray(v) for k, v in make_grads(n, seed=seed).items()}
        u, res = f(g, res)
        # sgd(1.0): the update is minus the reduced gradient, exactly
        steps.append(({k: -np.asarray(v) for k, v in u.items()},
                      {k: np.asarray(v) for k, v in res.items()}))
    return steps


# -- worlds -------------------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("reduce2"), 2, 1)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("reduce4"), 2, 2)


def _worlds(request, which):
    return request.getfixturevalue(which)


WORLDS = [("world2", (2, 1), "base"), ("world2", (1, 2), "1x2"),
          ("world4", (2, 2), "base")]


def _rows(arrays, key):
    return np.stack([a[key] for a in arrays])


# -- in one process -----------------------------------------------------------

@pytest.fixture
def world1():
    hvd.init(device="cpu")
    try:
        yield hvd
    finally:
        hvd.shutdown()


def test_packed_plan_cached_and_shaped():
    """tests/test_injit.py::test_packed_plan_cached_and_shaped, on the
    port's planner, and equal to the JAX planner's tuples."""
    shapes = ((4,), (2, 3), (8,), (5,))
    dtypes = ("float32", "float32", "int32", "float32")
    p1 = tfusion.packed_plan(shapes, dtypes, 1 << 20)
    p2 = tfusion.packed_plan(list(shapes), list(dtypes), 1 << 20)
    assert p1 is p2
    assert p1 == (("float32", (0, 1, 3)), ("int32", (2,)))
    assert tfusion.packed_plan(shapes, dtypes, 0) == p1
    tiny = tfusion.packed_plan(shapes, dtypes, 16)
    assert tiny == (("float32", (0,)), ("float32", (1,)),
                    ("float32", (3,)), ("int32", (2,)))
    torch_dtypes = (torch.float32, torch.float32, torch.int32, torch.float32)
    for thr in (1 << 20, 0, 16):
        assert tfusion.packed_plan(shapes, torch_dtypes, thr) \
            == jfusion.packed_plan(shapes, dtypes, thr)


@pytest.mark.parametrize("threshold", [64 << 20, 0, 1 << 20, 4096])
def test_packed_plan_on_the_transformer_matches_jax(threshold):
    """The default transformer's leaves in flax order, with a bf16 and an
    int32 leaf mixed in (dtype groups sort by numpy's name)."""
    model = Transformer(TransformerConfig(), device="meta")
    state = model.state_dict()
    names = flax_order(state)
    shapes = [tuple(state[n].shape) for n in names] + [(3, 5), (7,)]
    tdt = [state[n].dtype for n in names] + [torch.bfloat16, torch.int32]
    jdt = [np.dtype(d) for d in [jnp.float32] * len(names)
                                 + [jnp.bfloat16, jnp.int32]]
    info0 = tfusion._packed_plan_cached.cache_info()
    plan = tfusion.packed_plan(shapes, tdt, threshold)
    assert plan == jfusion.packed_plan(shapes, jdt, threshold)
    assert [dt for dt, _ in plan][:1] == ["bfloat16"]
    tfusion.packed_plan(shapes, tdt, threshold)
    assert tfusion._packed_plan_cached.cache_info().hits > info0.hits


def test_flatten_bucket_round_trip():
    vals = [torch.arange(6.0).view(2, 3), torch.arange(4.0)]
    flat, unflatten = tfusion.flatten_bucket(vals)
    assert flat.tolist() == [0, 1, 2, 3, 4, 5, 0, 1, 2, 3]
    back = unflatten(flat * 2)
    assert [tuple(b.shape) for b in back] == [(2, 3), (4,)]
    assert torch.equal(back[0], vals[0] * 2)


def test_int8_requires_packed_compiled_path(world1):
    """tests/test_injit.py::test_int8_requires_packed_compiled_path."""
    lin = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="packed"):
        hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0),
                                 compression=hvd.Compression.int8)
    with pytest.raises(ValueError, match="packed"):
        hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0),
                                 axis_name="cross", packing="per_leaf",
                                 compression=hvd.Compression.int8)
    with pytest.raises(NotImplementedError, match="packed"):
        hvd.Compression.int8.compress(torch.ones(4))
    with pytest.raises(ValueError, match="Average/Sum"):
        hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0),
                                 op=hvd.Adasum, axis_name="cross",
                                 packing="packed",
                                 compression=hvd.Compression.int8)


@pytest.mark.parametrize("kwargs", [
    {"op": "Min"}, {"reduce_strategy": "ring"}, {"packing": "bucketed"}])
def test_argument_checks_match_jax(world1, kwargs):
    """The same ValueError, with the JAX package's message's lead."""
    lin = torch.nn.Linear(2, 2)
    tkw = {k: getattr(hvd, v) if k == "op" else v for k, v in kwargs.items()}
    jkw = {k: getattr(jhvd, v) if k == "op" else v
           for k, v in kwargs.items()}
    with pytest.raises(ValueError) as jerr:
        jhvd.DistributedOptimizer(optax.sgd(1.0), axis_name="dp", **jkw)
    with pytest.raises(ValueError) as terr:
        hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0),
                                 axis_name="cross", **tkw)
    assert str(terr.value).split(" (")[0] == str(jerr.value).split(" (")[0]


def test_unknown_axis_and_eager_plane_untouched(world1):
    lin = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="not a dim"):
        hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0),
                                 axis_name="dp")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0),
                                   reduce_strategy="flat", packing="packed")
    assert type(opt) is hvd.DistributedOptimizer
    assert len(opt._hooks) == 2
    opt.remove_hooks()
    assert hvd.cross_local_mesh().mesh_dim_names == ("cross", "local")
    assert hvd.cross_local_mesh() is hvd.cross_local_mesh()


def test_int8_state_shape_and_update(world1):
    """tests/test_injit.py::test_int8_state_shape_and_update: one fp32
    residual per parameter, zero at first, nonzero after a step, and a
    state without it refused."""
    ps = _params(torch, "cpu")
    opt = _optimizer(hvd, torch, ps, axis_name="cross", packing="packed",
                     compression=hvd.Compression.int8)
    res = opt.state_dict()["error_feedback_residual"]
    for k, p in ps.items():
        assert res[k].shape == p.shape and res[k].dtype == torch.float32
        assert not res[k].any()
    _set_grads(torch, ps, make_grads(1), 0)
    opt.step()
    res = opt.state_dict()["error_feedback_residual"]
    assert max(float(res[k].abs().max()) for k in ps) > 0
    plain = torch.optim.SGD(list(ps.values()), lr=1.0).state_dict()
    with pytest.raises(TypeError, match="init"):
        opt.load_state_dict(plain)


def _np_int8_reference(x, r):
    """int8_pack_reduce at n = 1 in numpy: fp32 steps, the residual
    x - q * scale computed exactly and rounded once (an FMA)."""
    x = (x + r).astype(np.float32)
    scale = np.maximum(np.float32(np.abs(x).max()) / np.float32(127.0),
                       np.finfo(np.float32).tiny).astype(np.float32)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return (q.astype(np.float32) * scale,
            (x.astype(np.float64) - q.astype(np.float64)
             * np.float64(scale)).astype(np.float32))


def test_int8_residual_is_rounded_once():
    """XLA on the CPU contracts x - q * scale into one FMA; rounding the
    product first (two roundings) differs from it here, and the port's
    residual is the FMA's."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal(1000).astype(np.float32)

    def f(v):
        scale = jnp.maximum(jnp.max(jnp.abs(v)) / 127.0,
                            jnp.finfo(jnp.float32).tiny)
        q = jnp.clip(jnp.round(v / scale), -127.0, 127.0).astype(jnp.int8)
        return v - q.astype(jnp.float32) * scale, q, scale
    jres, q, scale = (np.asarray(a) for a in jax.jit(f)(x))
    twice = x - (q.astype(np.float32) * scale).astype(np.float32)
    assert not np.array_equal(jres, twice)
    _, res = int8_pack_reduce(torch.from_numpy(x), None)
    np.testing.assert_array_equal(res.numpy(), jres)


def test_int8_pack_reduce_at_one_against_numpy():
    """Local quantize/dequantize (no group): round half to even, the
    clamp, and the residual, against numpy's fp32."""
    rng = np.random.RandomState(5)
    x = rng.standard_normal(257).astype(np.float32)
    x[:4] = [2.5, -2.5, 0.5, 127.0]         # ties at half-integers
    r = rng.standard_normal(257).astype(np.float32) * 0.01
    out, nr = int8_pack_reduce(torch.from_numpy(x), torch.from_numpy(r))
    want_out, want_res = _np_int8_reference(x, r)
    np.testing.assert_array_equal(out.numpy(), want_out)
    np.testing.assert_array_equal(nr.numpy(), want_res)


def test_int8_at_one_matches_jax_and_converts_the_residual(world1):
    """n = 1: three int8 steps equal the JAX package's on a 1-device mesh
    (reduced gradients and residuals); then both restart from the JAX
    state after two steps (residual through int8_residual_from_flax) and
    agree on the third."""
    jsteps = jax_int8_steps((1, 1), [10 + t for t in range(INT8_STEPS)],
                            "hierarchical", 1)
    ps = _params(torch, "cpu")
    opt = _optimizer(hvd, torch, ps, axis_name="cross", inner_axis="local",
                     packing="packed", compression=hvd.Compression.int8)
    for t, (jred, jres) in enumerate(jsteps):
        opt.zero_grad()
        _set_grads(torch, ps, make_grads(1, seed=10 + t), 0)
        opt.step()
        res = opt.state_dict()["error_feedback_residual"]
        for k, p in ps.items():
            np.testing.assert_array_equal(p.grad.numpy(), jred[k][0])
            np.testing.assert_array_equal(res[k].numpy(), jres[k][0])
    # carry the JAX residual after step 2 into a fresh optimizer
    carried = int8_residual_from_flax(
        {"params": {k: v[0] for k, v in jsteps[1][1].items()}})
    back = int8_residual_to_flax(carried)
    assert all(np.array_equal(back[k], jsteps[1][1][k][0]) for k in SHAPES)
    ps2 = _params(torch, "cpu")
    opt2 = _optimizer(hvd, torch, ps2, axis_name="cross", packing="packed",
                      compression=hvd.Compression.int8)
    opt2.load_state_dict(dict(opt2.state_dict(),
                              error_feedback_residual=carried))
    _set_grads(torch, ps2, make_grads(1, seed=12), 0)
    opt2.step()
    res = opt2.state_dict()["error_feedback_residual"]
    for k, p in ps2.items():
        np.testing.assert_array_equal(p.grad.numpy(), jsteps[2][0][k][0])
        np.testing.assert_array_equal(res[k].numpy(), jsteps[2][1][k][0])


def test_cnn_kernel_residual_moves_to_torch_layout():
    k = np.arange(24, dtype=np.float32).reshape(4, 6)      # flax (in, out)
    conv = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    tree = {"Dense_0": {"kernel": k, "bias": np.ones(6, np.float32)},
            "Conv_0": {"kernel": conv}}
    res = int8_residual_from_flax(tree)
    assert tuple(res["Dense_0.kernel"].shape) == (6, 4)
    assert tuple(res["Conv_0.kernel"].shape) == (5, 4, 2, 3)
    back = int8_residual_to_flax(res)
    np.testing.assert_array_equal(back["Dense_0"]["kernel"], k)
    np.testing.assert_array_equal(back["Conv_0"]["kernel"], conv)


@pytest.mark.parametrize("comp", ["bf16", "fp16_strict"])
def test_packed_half_wire_at_one_matches_jax(world1, comp):
    """bf16 on the wire: within rtol = atol = 0.05 of fp32 and different
    somewhere (tests/test_injit.py::test_packed_bf16_error_bound), and
    equal to the JAX package's at n = 1."""
    grads = make_grads(1)
    ps = _params(torch, "cpu")
    opt = _optimizer(hvd, torch, ps, axis_name="cross", packing="packed",
                     compression=getattr(hvd.Compression, comp))
    _set_grads(torch, ps, grads, 0)
    opt.synchronize()
    want = jax_reduce((1, 1), grads, packing="packed",
                      compression=getattr(JCompression, comp))
    for k, p in ps.items():
        np.testing.assert_allclose(p.grad.numpy(), grads[k][0],
                                   rtol=0.05, atol=0.05)
        np.testing.assert_array_equal(p.grad.numpy(), want[k][0])
    assert any(not np.array_equal(ps[k].grad.numpy(), grads[k][0])
               for k in ps)


# -- across processes ---------------------------------------------------------

@pytest.mark.parametrize("which,layout,mesh", WORLDS)
@pytest.mark.parametrize("strategy,packing,op", VARIANTS)
def test_variants_match_jax(request, which, layout, mesh, strategy, packing,
                            op):
    """Every (strategy, packing, op) against the JAX package on the same
    (outer, inner) layout: bit for bit where every sum is of two values;
    else (flat at 2 x 2, four values in one sum, in another order) the
    oracle's integer gradients within its rtol 1e-6 and the seeded ones
    within the reordering bound of :func:`reorder_bound`."""
    arrays, _ = _worlds(request, which)
    n = layout[0] * layout[1]
    kw = dict(reduce_strategy=strategy, packing=packing, op=getattr(jhvd, op))
    grads = make_grads(n)
    want = jax_reduce(layout, grads, **kw)
    want_oracle = jax_reduce(layout, oracle_grads(n), **kw)
    exact = n == 2 or strategy == "hierarchical"
    for k in want_oracle:
        np.testing.assert_allclose(
            _rows(arrays, f"oracle.{mesh}.{strategy}.{packing}.{op}.{k}"),
            want_oracle[k], rtol=1e-6, err_msg=k)
    divisor = n if op == "Average" else layout[1]
    for k in SHAPES:
        got = _rows(arrays, f"{mesh}.{strategy}.{packing}.{op}.default.{k}")
        if exact:
            np.testing.assert_array_equal(got, want[k], err_msg=k)
        else:
            assert_reordered(got, want[k], grads[k], divisor)


def reorder_bound(rows, divisor):
    """Two fp32 sums of the same n values in different orders differ by at
    most 2 (n - 1) u sum |x| (u = 2^-24: each of the n - 1 partial sums
    of either order rounds once), divided here as the sum then is."""
    n = rows.shape[0]
    return 2 * (n - 1) * 2.0 ** -24 * np.abs(rows).sum(axis=0) / divisor


def assert_reordered(got, want, rows, divisor):
    bound = reorder_bound(rows, divisor) + 1e-6 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), \
        np.max(np.abs(got - want) / bound)


@pytest.mark.parametrize("which,layout,mesh", WORLDS)
@pytest.mark.parametrize("threshold", ["default", "64"])
def test_packed_equals_per_leaf(request, monkeypatch, which, layout, mesh,
                                threshold):
    """tests/test_injit.py::test_packed_vs_per_leaf_bit_exact and
    ::test_packed_threshold_splits_buckets over the world: fp32 packed
    equals per-leaf bit for bit (hierarchical at 2 x 2, every variant at
    n = 2), in the port and in the JAX package at the same threshold;
    at 2 x 2 flat packed within the reordering bound of flat per-leaf
    (gloo's ring orders an element's sum by its place in the buffer)."""
    arrays, _ = _worlds(request, which)
    n = layout[0] * layout[1]
    if threshold != "default":
        monkeypatch.setenv("HVD_TPU_INJIT_PACKED_THRESHOLD", threshold)
    for s in ("hierarchical", "flat"):
        want = jax_reduce(layout, make_grads(n), reduce_strategy=s,
                          packing="packed")
        for k in SHAPES:
            leaf = _rows(arrays, f"{mesh}.{s}.per_leaf.Average.{threshold}"
                                 f".{k}")
            packed = _rows(arrays, f"{mesh}.{s}.packed.Average.{threshold}"
                                   f".{k}")
            if n == 2 or s == "hierarchical":
                np.testing.assert_array_equal(packed, leaf)
                np.testing.assert_array_equal(packed, want[k])
            else:
                rows = make_grads(n)[k]
                assert_reordered(packed, leaf, rows, n)
                assert_reordered(packed, want[k], rows, n)


def test_flat_equals_hierarchical_at_two(world2):
    """At n = 2, over a 2 x 1 and a 1 x 2 layout, flat and hierarchical
    give the same bits (a sum of two values is order-free), as the JAX
    package's do."""
    arrays, _ = world2
    for mesh in ("base", "1x2"):
        for p in ("per_leaf", "packed"):
            for op in ("Average", "Sum"):
                for k in SHAPES:
                    h = _rows(arrays, f"{mesh}.hierarchical.{p}.{op}."
                                      f"default.{k}")
                    f = _rows(arrays, f"{mesh}.flat.{p}.{op}.default.{k}")
                    np.testing.assert_array_equal(h, f)
                    assert np.array_equal(h[0], h[1])


def test_training_mesh_dim_as_axis(world2):
    arrays, _ = world2
    for k in SHAPES:
        np.testing.assert_array_equal(
            _rows(arrays, f"dp.{k}"),
            _rows(arrays, f"base.hierarchical.packed.Average.default.{k}"))


@pytest.mark.parametrize("which,layout", [("world2", (2, 1)),
                                          ("world4", (2, 2))])
@pytest.mark.parametrize("strategy", ["hierarchical", "flat"])
def test_int8_matches_jax(request, which, layout, strategy):
    """Three SGD steps through int8 with each rank's residual carried:
    the reduced gradients, the parameters and the residuals equal the
    JAX package's bit for bit."""
    arrays, _ = _worlds(request, which)
    n = layout[0] * layout[1]
    jsteps = jax_int8_steps(layout, [10 + t for t in range(INT8_STEPS)],
                            strategy, n)
    param = {k: np.zeros((n,) + s, np.float32) for k, s in SHAPES.items()}
    for t, (jred, jres) in enumerate(jsteps):
        for k in SHAPES:
            param[k] = param[k] - jred[k]
            got = _rows(arrays, f"int8.{strategy}.{t}.grad.{k}")
            np.testing.assert_array_equal(got, jred[k])
            np.testing.assert_array_equal(
                _rows(arrays, f"int8.{strategy}.{t}.res.{k}"), jres[k])
            np.testing.assert_array_equal(
                _rows(arrays, f"int8.{strategy}.{t}.param.{k}"), param[k])
            assert np.array_equal(got[0], got[-1])   # one answer everywhere


@pytest.mark.parametrize("which,layout", [("world2", (2, 1)),
                                          ("world4", (2, 2))])
def test_packed_half_wire_matches_jax(request, which, layout):
    arrays, _ = _worlds(request, which)
    n = layout[0] * layout[1]
    grads = make_grads(n)
    for comp in ("bf16", "fp16_strict"):
        want = jax_reduce(layout, grads, packing="packed",
                          compression=getattr(JCompression, comp))
        fp32 = jax_reduce(layout, grads, packing="packed")
        for k in SHAPES:
            got = _rows(arrays, f"{comp}.{k}")
            np.testing.assert_allclose(got, fp32[k], rtol=0.05, atol=0.05)
            if n == 2:
                np.testing.assert_array_equal(got, want[k])
            else:
                # 4 half values summed in another order: within one
                # rounding of the wire type
                np.testing.assert_allclose(got, want[k], rtol=2 ** -7)


@pytest.mark.parametrize("which,layout", [("world2", (2, 1)),
                                          ("world4", (2, 2))])
def test_adasum_grads_matches_jax(request, which, layout):
    """adasum_grads at n = 2 (over cross) and at 2 x 2 (the mean over
    local, then Adasum over cross) against the JAX package's, and the
    optimizer's route: with axis_name it is adasum_grads, without it the
    delta optimizer."""
    arrays, infos = _worlds(request, which)
    n = layout[0] * layout[1]
    rows = make_grads(n, seed=3)["w"]
    inner = "inner" if layout[1] > 1 else None
    f = jax.jit(_smap(lambda g: jadasum.adasum_grads(
        g[0], outer_axis="outer", inner_axis=inner)[None],
        _mesh(*layout), P(AX), P(AX)))
    want = np.asarray(f(jnp.asarray(rows)))
    got = _rows(arrays, "adasum")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert all(np.array_equal(got[0], g) for g in got)
    for info in infos:
        assert info["adasum_route_equal"]
        assert info["adasum_compiled_type"] == "_CompiledPlaneOptimizer"
        assert info["adasum_eager_type"] == \
            "_DistributedAdasumDeltaOptimizer"


def test_int8_error_feedback_convergence(world2):
    """tests/test_injit.py::test_int8_error_feedback_convergence over a
    gloo world of 2: the loss falls 1000x and the weights land within
    0.02 of the uncompressed run's."""
    _, infos = world2
    for info in infos:
        l8 = info["conv_l8"]
        assert l8[-1] < l8[0] * 1e-3
        assert abs(l8[-1] - info["conv_l32"][-1]) < 1e-3
        np.testing.assert_allclose(info["conv_w8"], info["conv_w32"],
                                   atol=0.02)


def test_int8_state_dict_resume_is_bit_exact(world2):
    _, infos = world2
    for info in infos:
        assert info["resume_moved"]
        assert info["resume_params_equal"]
        assert info["resume_residual_equal"]
