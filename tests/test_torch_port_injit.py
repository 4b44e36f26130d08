"""The port's in-jit route (the collective verbs, the named in-graph
collectives and both optimizer planes under ``torch.compile``) against the
JAX package's in-jit route inside ``shard_map``, case for case as
tests/test_injit.py holds the JAX package.

The port side is one gloo world of 2 (``tests/torch_port_injit_worker.py``:
every function compiled with ``fullgraph=True`` and ``backend=
"aot_eager"``, so a graph break fails the run), the JAX side
``shard_map`` over a 2-device mesh of tests/conftest.py's forced CPU
devices. Inputs are seeded numpy arrays, one row per rank. Every
comparison is exact (a sum of two values has one order), apart from bf16
on the wire, which is held within tests/test_injit.py's bound of the fp32
reduction.

Deliberate divergence: with no mesh in scope the JAX package's verbs are
the identity (its arrays are global), the port's reduce over the world
and equal the eager verbs (a torch process holds its own tensor).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JCompression

from torch_port_injit_worker import (N, PLANE_SHAPES, PLANE_VARIANTS,
                                      gather_weights, inputs, plane_grads,
                                      run_world)

try:
    from jax import shard_map as _shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as _shard_map

OPS = 'hvd_tpu_collective_ops_total{op="%s"}'
INJIT = 'hvd_tpu_injit_lowerings_total{op="%s"}'


def _smap(f, mesh, in_specs, out_specs):
    try:
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_rep=False)
    except TypeError:  # renamed in newer jax
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False)


def _per_device(fn, *arrays, axes=("dp",), shape=(N,)):
    """``fn`` on each device's row of ``arrays`` inside shard_map over a
    mesh of ``shape`` (named ``axes``); returns the rows stacked, for
    every output leaf."""
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                axes)
    spec = P(axes if len(axes) > 1 else axes[0])

    tmap = jax.tree_util.tree_map

    def body(*blocks):
        out = fn(*[tmap(lambda leaf: leaf[0], b) for b in blocks])
        return tmap(lambda o: o[None], out)
    f = jax.jit(_smap(body, mesh, tuple(spec for _ in arrays), spec))
    return tmap(np.asarray, f(*[tmap(jnp.asarray, a) for a in arrays]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("injit"))


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX reference, in one JAX world."""
    if jhvd.is_initialized():
        jhvd.shutdown()
    jhvd.init()
    try:
        return _jax_references()
    finally:
        jhvd.shutdown()


def _jax_references():
    d = inputs()
    x, a, b, i, pr, s, t = (d[k] for k in "xabipst")
    h = np.asarray(jnp.asarray(d["h"], jnp.bfloat16))
    ref = {}
    ref.update({f"verbs.{k}": v for k, v in _per_device(lambda x, p, i: {
        "sum": jhvd.allreduce(x, op=jhvd.Sum),
        "average": jhvd.allreduce(x, op=jhvd.Average),
        "min": jhvd.allreduce(x, op=jhvd.Min),
        "max": jhvd.allreduce(x, op=jhvd.Max),
        "product": jhvd.allreduce(p, op=jhvd.Product),
        "scaled": jhvd.allreduce(x, op=jhvd.Sum, prescale_factor=0.5,
                                 postscale_factor=3.0),
        "int_sum": jhvd.allreduce(i, op=jhvd.Sum),
        "broadcast": jhvd.broadcast(x, root_rank=1),
        "alltoall": jhvd.alltoall(x),
        "alltoall_splits": jhvd.alltoall(x, splits=[4, 4]),
    }, x, pr, i).items()})
    ref["verbs.bf16_avg"] = _per_device(
        lambda v: jhvd.allreduce(v, op=jhvd.Average), h).astype(np.float32)
    grouped = _per_device(lambda u, v, w: tuple(
        jhvd.grouped_allreduce([u, v, w], op=jhvd.Sum)), a, b, h)
    ref.update({f"verbs.grouped.{k}": g.astype(np.float32)
                for k, g in enumerate(grouped)})
    ref["adasum"] = _per_device(lambda v: jhvd.allreduce(v, op=jhvd.Adasum),
                                x)
    w = gather_weights()
    gmesh = Mesh(np.array(jax.devices()[:N]), ("dp",))
    for verb, fn, wv in (("allgather", jhvd.allgather, w),
                         ("broadcast", lambda v: jhvd.broadcast(v, 1),
                          w[:, :x.shape[1]])):
        f = _smap(lambda v, u, fn=fn: jnp.sum(fn(v[0]) * u[0])[None], gmesh,
                  (P("dp"), P("dp")), P("dp"))
        ref[f"{verb}_grad"] = np.asarray(jax.jit(jax.grad(
            lambda v, f=f, wv=wv: f(v, wv).sum()))(jnp.asarray(x)))
    ref["verbs.allgather"] = _per_device(jhvd.allgather, a)
    ref["verbs.allgather0"] = _per_device(jhvd.allgather, s)
    ref.update({f"verbs.grouped_broadcast.{k}": g for k, g in enumerate(
        _per_device(lambda u, v: tuple(jhvd.grouped_broadcast(
            [u, v], root_rank=1)), a, b))})
    lax = jax.lax
    ref.update({f"named.{k}": v for k, v in _per_device(lambda x, t: {
        "psum": lax.psum(x, "dp"),
        "pmean": lax.pmean(x, "dp"),
        "all_gather": lax.all_gather(x, "dp", axis=0, tiled=True),
        "all_gather_stack1": lax.all_gather(x, "dp", axis=1, tiled=False),
        "all_gather_axis1": lax.all_gather(t, "dp", axis=1, tiled=True),
        "reduce_scatter": lax.psum_scatter(x, "dp", scatter_dimension=0,
                                           tiled=True),
        "reduce_scatter1": lax.psum_scatter(t, "dp", scatter_dimension=1,
                                            tiled=True),
        "all_to_all": lax.all_to_all(t, "dp", 1, 0, tiled=True),
        "all_to_all00": lax.all_to_all(x, "dp", 0, 0, tiled=True),
        "ppermute_swap": lax.ppermute(x, "dp", [(0, 1), (1, 0)]),
        "ppermute_one": lax.ppermute(t, "dp", [(0, 1)]),
    }, x, t).items()})
    # the eager plane's optimizer: tests/test_injit.py's jit update
    gr = np.random.RandomState(11)
    shapes = {"w": (4, 3), "v": (5,)}
    og = {k: gr.standard_normal((N,) + s).astype(np.float32)
          for k, s in shapes.items()}
    opt = jhvd.DistributedOptimizer(optax.sgd(1.0), axis_name="dp")
    params = {k: jnp.zeros(s) for k, s in shapes.items()}
    state = opt.init(params)
    upd = _per_device(lambda g: opt.update(g, state, params)[0], og)
    ref.update({f"optimizer.{k}": -v for k, v in upd.items()})
    # a gradient on rank 0 only: the JAX tree has every leaf, so rank 1's
    # is zeros
    og["v"][1:] = 0.0
    upd = _per_device(lambda g: opt.update(g, state, params)[0], og)
    ref.update({f"missing.{k}": -v for k, v in upd.items()})
    # the compiled plane
    pg = plane_grads()
    for layout, shape in (("2x1", (2, 1)), ("1x2", (1, 2))):
        for strategy, packing, op in PLANE_VARIANTS + [
                ("hierarchical", "packed", "bf16"),
                ("flat", "packed", "bf16"), ("fp32", "packed", "Average")]:
            kw = dict(reduce_strategy="hierarchical" if strategy == "fp32"
                      else strategy, packing=packing,
                      op=jhvd.Sum if op == "Sum" else jhvd.Average)
            if op == "bf16":
                kw["compression"] = JCompression.bf16
            popt = jhvd.DistributedOptimizer(
                optax.sgd(1.0), axis_name="outer", inner_axis="inner", **kw)
            red = _per_device(popt.reduce_gradients, pg,
                              axes=("outer", "inner"), shape=shape)
            ref.update({f"plane.{layout}.{strategy}.{packing}.{op}.{k}": v
                        for k, v in red.items()})
    return ref


def _rows(arrays, key):
    return np.stack([a[key] for a in arrays])


def _delta(pair, key):
    before, after = pair
    return after.get(key, 0.0) - before.get(key, 0.0)


# -- trace-aware lowering: routing + semantics -------------------------------

VERB_CASES = ["sum", "average", "min", "max", "product", "scaled",
              "bf16_avg", "int_sum", "broadcast", "alltoall",
              "alltoall_splits", "allgather", "allgather0"]


@pytest.mark.parametrize("case", VERB_CASES)
def test_verb_matches_jax_shard_map(world, jax_ref, case):
    """tests/test_injit.py's sum, average, min/max, allgather and
    broadcast (and Product, the scales, bf16, int32 and alltoall), each
    equal to the JAX package's in-jit lowering bit for bit."""
    arrays, _ = world
    got = _rows(arrays, f"verbs.{case}")
    want = jax_ref[f"verbs.{case}"]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_sum_zero_dispatcher_and_one_lowering_per_compilation(world):
    """tests/test_injit.py::test_injit_allreduce_sum_zero_dispatcher: the
    dispatcher's counters stay flat over three runs of a compiled
    function, the wire counts of the eager path too, and the lowering
    counter moves once per compilation: 6 allreduces, one grouped."""
    _, infos = world
    for info in infos:
        for verb in ("allreduce", "grouped_allreduce", "allgather",
                     "broadcast", "alltoall"):
            assert _delta(info["verbs_ops"], OPS % verb) == 0
        before, after = info["verbs_counts"]
        assert before == after
        lowered = {v: _delta(info["verbs_injit"], INJIT % v) for v in (
            "allreduce", "grouped_allreduce", "allgather", "broadcast",
            "grouped_broadcast", "alltoall")}
        assert lowered == {"allreduce": 12, "grouped_allreduce": 1,
                           "allgather": 2, "broadcast": 2,
                           "grouped_broadcast": 1, "alltoall": 2}
        assert len(info["graphs"]["verbs"]) == 1


def test_grouped_matches_per_leaf_bit_exact(world, jax_ref):
    arrays, infos = world
    for k in range(3):
        grouped = _rows(arrays, f"verbs.grouped.{k}")
        np.testing.assert_array_equal(
            grouped, _rows(arrays, f"verbs.per_leaf.{k}"))
        np.testing.assert_array_equal(grouped, jax_ref[f"verbs.grouped.{k}"])


def test_grouped_broadcast_and_in_place_verbs(world, jax_ref):
    arrays, _ = world
    d = inputs()
    for k in range(2):
        np.testing.assert_array_equal(
            _rows(arrays, f"verbs.grouped_broadcast.{k}"),
            jax_ref[f"verbs.grouped_broadcast.{k}"])
    np.testing.assert_array_equal(_rows(arrays, "verbs.inplace_sum"),
                                  jax_ref["verbs.sum"])
    np.testing.assert_array_equal(_rows(arrays, "verbs.inplace_broadcast"),
                                  np.stack([d["b"][0]] * N))


def test_async_handle_completes(world, jax_ref):
    """tests/test_injit.py::test_injit_async_handle_completes: poll is
    true in the graph, synchronize lands the result in the graph and out
    of it (a handle returned by the compiled function)."""
    arrays, _ = world
    assert all(bool(a["verbs.ready"]) for a in arrays)
    np.testing.assert_array_equal(_rows(arrays, "handle_out"),
                                  jax_ref["verbs.sum"])


def test_mapped_axis_sizes_in_the_graph_and_eagerly(world):
    arrays, infos = world
    assert all(list(a["verbs.sizes"]) == [N] for a in arrays)
    assert all(info["eager_sizes"] == {} for info in infos)


def test_unmapped_reduces_over_the_world_as_the_eager_verb(world):
    """The port's divergence from tests/test_injit.py::
    test_injit_unmapped_jit_is_size1 (ROADMAP C): with no mesh in scope
    the compiled verbs equal the eager ones, over the world."""
    arrays, _ = world
    d = inputs()
    for k in range(4):
        np.testing.assert_array_equal(_rows(arrays, f"unmapped.{k}"),
                                      _rows(arrays, f"unmapped_eager.{k}"))
    np.testing.assert_array_equal(_rows(arrays, "unmapped.0"),
                                  np.stack([d["x"].sum(axis=0)] * N))
    assert not np.array_equal(_rows(arrays, "unmapped.0"), d["x"])


@pytest.mark.parametrize("case,kind,match", [
    ("fastpath_disabled", "TypeError", "INJIT_FASTPATH"),
    ("process_set", "ValueError", "process_set"),
    ("ragged_alltoall", "ValueError", "uniform splits only"),
    ("root_range", "ValueError", "root_rank 2 out of range"),
    ("adasum_several_dims", "ValueError", "needs an explicit hierarchy"),
    ("unbound_axis", "NameError", "unbound axis name"),
    ("hooks_on", "ValueError", "remove_hooks"),
])
def test_trace_time_errors(world, case, kind, match):
    """tests/test_injit.py's fast-path-disabled and process_set cases,
    and the contracts of the route: each raises while the graph is
    traced, as the compiler's error whose cause it is (Adasum with a
    mesh of two dims in scope: the JAX package's own error for several
    mapped axes)."""
    _, infos = world
    for info in infos:
        got = info["errors"][case]
        assert got is not None, case
        assert got[0] == kind and match in got[1], got


def test_allreduce_gradient_in_the_graph(world):
    """allreduce's gradient in a compiled graph is the same allreduce of
    the upstream gradient (the reference's, as eagerly): Average of
    2 * x, upstream arange, gives 2 * mean of the upstream, here the
    upstream itself on every rank."""
    arrays, _ = world
    upstream = np.arange(32, dtype=np.float32).reshape(8, 4)
    np.testing.assert_array_equal(_rows(arrays, "allreduce_grad"),
                                  np.stack([2.0 * upstream] * N))


def test_adasum_verb_over_the_mesh_in_the_graph(world, jax_ref):
    """allreduce(op=Adasum) traced under the 1-D mesh: the JAX in-jit
    verb over "dp" within rtol 1e-4, atol 1e-5 (tests/test_adasum.py's
    bound: the tree's dot products sum in another order), and the eager
    verb over the same two processes bit for bit."""
    arrays, _ = world
    got = _rows(arrays, "adasum_mesh")
    np.testing.assert_allclose(got, jax_ref["adasum"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got, _rows(arrays, "adasum_eager"))


@pytest.mark.parametrize("verb", ["allgather", "broadcast"])
def test_gather_gradient_in_the_graph(world, jax_ref, verb):
    """The gradient of allgather (the reduce-scatter of the cotangents
    onto this rank's rows) and of broadcast from rank 1 (the cotangents'
    sum at the root, zeros at rank 0) in the graph against jax.grad
    through the JAX in-jit verbs: sums of two values, bit for bit."""
    arrays, _ = world
    got = _rows(arrays, f"{verb}_grad")
    np.testing.assert_array_equal(got, jax_ref[f"{verb}_grad"])
    if verb == "broadcast":
        assert got[1].any() and not got[0].any()


def test_eager_path_untouched(world):
    """tests/test_injit.py::test_eager_path_untouched_by_fastpath."""
    arrays, infos = world
    d = inputs()
    np.testing.assert_array_equal(_rows(arrays, "eager_sum"),
                                  np.stack([d["x"].sum(axis=0)] * N))
    for info in infos:
        assert _delta(info["eager_ops"], OPS % "allreduce") == 1
        assert all(_delta(info["eager_injit"], k) == 0
                   for k in info["eager_injit"][1])


# -- packed buckets ----------------------------------------------------------

def test_packed_threshold_splits_buckets(world):
    """tests/test_injit.py::test_packed_threshold_splits_buckets: at 64
    bytes every fp32 member rides its own collective (60 + 28 bytes), at
    the default one collective per dtype; the results do not move."""
    arrays, infos = world
    for info in infos:
        assert [g["all_reduces"] for g in info["graphs"]["grouped_64"]] \
            == [3]
        assert [g["all_reduces"] for g in info["graphs"]["grouped_default"]] \
            == [2]
    for k in range(3):
        np.testing.assert_array_equal(_rows(arrays, f"grouped_64.{k}"),
                                      _rows(arrays, f"grouped_default.{k}"))
        np.testing.assert_array_equal(_rows(arrays, f"grouped_64.{k}"),
                                      _rows(arrays, f"verbs.per_leaf.{k}"))


# -- the named in-graph collectives -------------------------------------------

NAMED = ["psum", "pmean", "all_gather", "all_gather_stack1",
         "all_gather_axis1", "reduce_scatter", "reduce_scatter1",
         "all_to_all", "all_to_all00", "ppermute_swap", "ppermute_one"]


@pytest.mark.parametrize("case", NAMED)
def test_named_collective_matches_jax_lax(world, jax_ref, case):
    """psum/pmean/all_gather_in_jit/reduce_scatter_in_jit/
    all_to_all_in_jit/ppermute against jax.lax's on the same rows, in the
    graph and eagerly: sums of two values and moves, bit for bit."""
    arrays, _ = world
    want = jax_ref[f"named.{case}"]
    for where in ("named", "named_eager"):
        got = _rows(arrays, f"{where}.{case}")
        assert got.shape == want.shape, (where, got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


# -- the optimizers ----------------------------------------------------------

def test_optimizer_update_in_graph_zero_dispatcher(world, jax_ref):
    """tests/test_injit.py::test_optimizer_jit_update_zero_dispatcher:
    DistributedOptimizer.synchronize compiled (hooks removed) averages
    every gradient in one in-graph collective, as the JAX transform's
    update does, with no dispatcher submission."""
    arrays, infos = world
    for k in ("w", "v"):
        np.testing.assert_array_equal(_rows(arrays, f"optimizer.{k}"),
                                      jax_ref[f"optimizer.{k}"])
    for info in infos:
        assert all(_delta(info["optimizer_ops"], k) == 0
                   for k in info["optimizer_ops"][1])
        assert [g["all_reduces"] for g in info["graphs"]["optimizer_sync"]] \
            == [1]


@pytest.mark.parametrize("plane", ["eager", "compiled"])
def test_missing_gradient_on_one_rank_reduces_as_zeros(world, jax_ref,
                                                       plane):
    """A parameter with a gradient on rank 0 only: rank 1 reduces zeros
    for it, so both ranks trace the same collectives, and every rank gets
    the average with zeros, as the JAX transform (whose gradient tree has
    every leaf) gives it."""
    arrays, infos = world
    for k in ("w", "v"):
        np.testing.assert_array_equal(_rows(arrays, f"missing.{plane}.{k}"),
                                      jax_ref[f"missing.{k}"], err_msg=k)
    counts = [[g["all_reduces"] for g in info["graphs"][f"missing.{plane}"]]
              for info in infos]
    # one packed bucket; the compiled plane's default: per leaf, 2 stages
    assert counts == [[1 if plane == "eager" else 4]] * N


def test_world_made_anew_traces_again(world):
    """A compiled Average traced in the world of 2, called again after
    rank 0 shuts down and inits a world of 1: basics.shutdown() drops the
    compiled graphs, so the call traces again and equals the eager verb
    of the new world (the old graph's constants would divide by 2)."""
    arrays, infos = world
    d = inputs()
    np.testing.assert_array_equal(_rows(arrays, "reset.before"),
                                  np.stack([d["x"].mean(axis=0)] * N))
    np.testing.assert_array_equal(arrays[0]["reset.after"],
                                  arrays[0]["reset.after_eager"])
    np.testing.assert_array_equal(arrays[0]["reset.after"], d["x"][0])
    assert len(infos[0]["graphs"]["reset"]) == 2
    assert len(infos[1]["graphs"]["reset"]) == 1


@pytest.mark.parametrize("layout", ["2x1", "1x2"])
@pytest.mark.parametrize("strategy,packing,op", PLANE_VARIANTS)
def test_compiled_plane_in_graph_matches_reduce_in_jit(world, jax_ref,
                                                       layout, strategy,
                                                       packing, op):
    """The compiled plane (``axis_name='cross', inner_axis='local'``)
    reducing in the graph against the JAX package's ``_reduce_in_jit``
    on the same (outer, inner) layout: bit for bit, packed equal to
    per-leaf, one collective per bucket and stage."""
    arrays, infos = world
    name = f"plane.{layout}.{strategy}.{packing}.{op}"
    for k in PLANE_SHAPES:
        np.testing.assert_array_equal(_rows(arrays, f"{name}.{k}"),
                                      jax_ref[f"{name}.{k}"], err_msg=k)
        np.testing.assert_array_equal(
            _rows(arrays, f"{name}.{k}"),
            _rows(arrays, f"plane.{layout}.{strategy}.per_leaf.{op}.{k}"))
    stages = 2 if strategy == "hierarchical" else 1
    leaves = 1 if packing == "packed" else len(PLANE_SHAPES)
    for info in infos:
        assert [g["all_reduces"] for g in info["graphs"][name]] \
            == [stages * leaves]


@pytest.mark.parametrize("layout", ["2x1", "1x2"])
@pytest.mark.parametrize("strategy", ["hierarchical", "flat"])
def test_compiled_plane_bf16_wire_in_graph(world, jax_ref, layout, strategy):
    """tests/test_injit.py::test_packed_bf16_error_bound: bf16 on the wire
    within rtol = atol = 0.05 of the fp32 reduction and different
    somewhere, and equal to the JAX package's bf16 reduction."""
    arrays, _ = world
    name = f"plane.{layout}.{strategy}.packed.bf16"
    fp32 = f"plane.{layout}.fp32.packed.Average"
    differs = False
    for k in PLANE_SHAPES:
        got = _rows(arrays, f"{name}.{k}")
        np.testing.assert_allclose(got, jax_ref[f"{fp32}.{k}"], rtol=0.05,
                                   atol=0.05)
        np.testing.assert_array_equal(got, jax_ref[f"{name}.{k}"])
        differs |= not np.array_equal(got, jax_ref[f"{fp32}.{k}"])
    assert differs
