"""The reductions of both optimizer planes and of the verbs in a compiled
graph (``torch.compile(fullgraph=True, backend="aot_eager")``): int8 with
error feedback, Adasum (the verb, the compiled plane, the delta
optimizer), the gathers' gradients and ``grad_process_sets``, against
the JAX package inside ``shard_map`` and against the port's own eager
route on the same inputs.

Run as a script, this file is the worker: ``python tests/
test_torch_port_compiled_reduce.py world <dir> cpu`` with the
``HVD_TPU_*`` identity env, the ranks laid out host by host
(``torch_port_reduce_worker.run_world`` starts such a world). The tests
spawn one world of 2 (cross 2 x local 1) and one of 4 (cross 2 x local
2) and hold them to the JAX package on sub-meshes of tests/conftest.py's
8 CPU devices, computed while the world runs.

Tolerances:
* int8: bit for bit against the JAX package (as tests/
  test_torch_port_reduce.py::test_int8_matches_jax holds the eager
  plane) and against the eager plane: the same elementwise fp32 steps, a
  MAX, an exact integer sum, the residual rounded once;
* Adasum: rtol 1e-4, atol 1e-5 against the JAX ``adasum_grads`` (its
  dot products and norms are sums in another order), bit for bit
  against the port's eager route (the same all-gather and tree);
* the gathers' gradients: atol 1e-6 against ``jax.grad`` through the
  JAX in-jit verbs (fp32; sums of n cotangent blocks in another order);
* ``grad_process_sets``: bit for bit against the eager plane (the
  in-graph bucket is the eager verb's buffer, so gloo sums each element
  in the same order).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    sys.path.insert(0, os.path.dirname(HERE))

from torch_port_reduce_worker import (  # noqa: E402
    INT8_STEPS, SHAPES, _optimizer, _params, _set_grads, make_grads,
    run_world)

BACKEND = "aot_eager"
ADASUM_SEED = 3
DELTA_STEPS = 2
#: the gathers' inputs: rows per rank, columns
GATHER = (3, 5)
WORLDS = [("world2", (2, 1)), ("world4", (2, 2))]


def _gather_inputs(n):
    """Each rank's x (rows, cols) and loss weights (n * rows, cols)."""
    rng = np.random.RandomState(17)
    rows, cols = GATHER
    return (rng.standard_normal((n, rows, cols)).astype(np.float32),
            rng.standard_normal((n, n * rows, cols)).astype(np.float32))


def _verb_inputs(n):
    rng = np.random.RandomState(23)
    return (rng.standard_normal((n, 6, 4)).astype(np.float32),
            rng.standard_normal((n, 9)).astype(np.float32))


def _set_coefficients(n):
    rng = np.random.RandomState(29)
    return {k: rng.standard_normal((n,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _world_worker(out_dir) -> int:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.train import _recording_backend
    hvd.init(device="cpu")
    n, r = hvd.size(), hvd.rank()
    base = hvd.cross_local_mesh()
    local = int(base.mesh.shape[1])
    out, info = {}, {"graphs": {}, "errors": {}, "types": {}}

    def compiled(name, fn):
        # a bound method of a new optimizer each time: past Dynamo's
        # recompile limit of one code object, fullgraph fails
        torch._dynamo.reset()
        info["graphs"][name] = log = []
        return torch.compile(fn, fullgraph=True,
                             backend=_recording_backend(BACKEND, name, log))

    def keep(prefix, tensors):
        for k, t in tensors.items():
            out[f"{prefix}.{k}"] = t.detach().numpy().copy()

    def error(name, fn):
        try:
            fn()
            info["errors"][name] = None
        except (TypeError, ValueError, NotImplementedError) as e:
            # the JAX package's kinds, through torch.compile as themselves
            kinds = [k.__name__ for k in (TypeError, ValueError,
                                          NotImplementedError)
                     if isinstance(e, k)]
            info["errors"][name] = [kinds[0], str(e)]

    # -- int8 with error feedback: INT8_STEPS SGD steps, the residual
    #    carried, eagerly and with synchronize() compiled
    for s in ("hierarchical", "flat"):
        for mode in ("eager", "compiled"):
            ps = _params(torch, "cpu")
            opt = _optimizer(hvd, torch, ps, axis_name="cross",
                             inner_axis="local", reduce_strategy=s,
                             packing="packed",
                             compression=hvd.Compression.int8)
            sync = opt.synchronize if mode == "eager" \
                else compiled(f"int8.{s}", opt.synchronize)
            for t in range(INT8_STEPS):
                opt.zero_grad()
                _set_grads(torch, ps, make_grads(n, seed=10 + t), r)
                sync()
                opt._opt.step()
                name = f"int8.{mode}.{s}.{t}"
                keep(f"{name}.grad", {k: p.grad for k, p in ps.items()})
                keep(f"{name}.param", ps)
                keep(f"{name}.res",
                     opt.state_dict()["error_feedback_residual"])

    # -- Adasum, the compiled plane (the mean over local, then Adasum
    #    over cross): eagerly and in the graph
    inner = "local" if local > 1 else None
    for mode in ("eager", "compiled"):
        ps = _params(torch, "cpu")
        opt = _optimizer(hvd, torch, ps, op=hvd.Adasum, axis_name="cross",
                         inner_axis=inner)
        _set_grads(torch, ps, make_grads(n, seed=ADASUM_SEED), r)
        (opt.synchronize if mode == "eager"
         else compiled("adasum_plane", opt.synchronize))()
        keep(f"adasum_plane.{mode}", {k: p.grad for k, p in ps.items()})

    # -- Adasum, the verb over the world (no mesh in scope), alone and
    #    grouped with scales
    xv, yv = (torch.from_numpy(a[r].copy()) for a in _verb_inputs(n))

    def verbs(x, y):
        return {"single": hvd.allreduce(x, op=hvd.Adasum),
                **dict(zip(("grouped.x", "grouped.y"), hvd.grouped_allreduce(
                    [x, y], op=hvd.Adasum, prescale_factor=0.5,
                    postscale_factor=3.0)))}
    keep("adasum_verb.compiled", compiled("adasum_verb", verbs)(xv, yv))
    keep("adasum_verb.eager", verbs(xv, yv))

    # -- the Adasum delta optimizer: hooks and step() eagerly, against
    #    stage_deltas() eagerly and step() compiled
    for mode in ("eager", "compiled"):
        ps = _params(torch, "cpu")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(list(ps.values()), lr=1.0),
            named_parameters=list(ps.items()), op=hvd.Adasum)
        info["types"]["delta"] = type(opt).__name__
        step = opt.step
        if mode == "compiled":
            opt.remove_hooks()
            step = compiled("delta", opt.step)
        for t in range(DELTA_STEPS):
            opt.zero_grad()
            coef = make_grads(n, seed=20 + t)
            sum((p * torch.from_numpy(coef[k][r].copy())).sum()
                for k, p in ps.items()).backward()
            if mode == "compiled":
                opt.stage_deltas()
            step()
            keep(f"delta.{mode}.{t}", ps)

    # -- the gathers' gradients in the graph
    xs, ws = _gather_inputs(n)
    for verb, fn in (("allgather", lambda x: hvd.allgather(x)),
                     ("broadcast", lambda x: hvd.broadcast(x, root_rank=1))):
        x = torch.from_numpy(xs[r].copy()).requires_grad_()
        w = torch.from_numpy(ws[r].copy())
        w = w if verb == "allgather" else w[:GATHER[0]]
        loss = compiled(f"grad.{verb}", lambda x, w: (fn(x) * w).sum())(x, w)
        loss.backward()
        keep(f"grad.{verb}", {"x": x.grad, "loss": loss})

    # -- grad_process_sets: sums over pairs of ranks and over the world,
    #    each scaled, eagerly and in the graph
    world_mesh = hvd.basics.world().world_mesh
    halves = [world_mesh.subset(list(range(h * n // 2, (h + 1) * n // 2)))
              for h in range(2)]
    mine = halves[0] if r < n // 2 else halves[1]
    sets = {"w": (mine, 0.5), "b": (None, 0.25), "k": (mine, 0.5),
            "m": (None, 0.25)}
    coef = _set_coefficients(n)
    for mode in ("eager", "compiled"):
        ps = _params(torch, "cpu")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(list(ps.values()), lr=1.0),
            named_parameters=list(ps.items()), grad_process_sets=sets)
        if mode == "compiled":
            opt.remove_hooks()
        sum((p * torch.from_numpy(coef[k][r].copy())).sum()
            for k, p in ps.items()).backward()
        (opt.synchronize if mode == "eager"
         else compiled("sets", opt.synchronize))()
        keep(f"sets.{mode}", {k: p.grad for k, p in ps.items()})

    # -- trace-time errors: Adasum with a mesh of several dims in scope,
    #    and over a group whose size is not a power of two
    x = torch.from_numpy(xv.numpy().copy())
    with base:
        error("adasum_several_dims", lambda: compiled(
            "several", lambda x: hvd.allreduce(x, op=hvd.Adasum))(x))
    if n == 4:
        three = DeviceMesh("cpu", [0, 1, 2], mesh_dim_names=("dp",))
        if r < 3:
            with three:
                error("adasum_not_pow2", lambda: compiled(
                    "not_pow2", lambda x: hvd.allreduce(x, op=hvd.Adasum))(x))
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(info, f)
    dist.barrier()
    hvd.shutdown()
    return 0


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_adasum(layout, rows_by_leaf):
    """The JAX package's ``adasum_grads`` (mean over "inner" when the
    layout has one, then Adasum over "outer") of each leaf's rows, row =
    device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu import adasum as jadasum
    from test_torch_port_reduce import AX, _mesh, _smap
    inner = "inner" if layout[1] > 1 else None
    f = jax.jit(_smap(lambda g: jax.tree_util.tree_map(
        lambda leaf: jadasum.adasum_grads(leaf[0], outer_axis="outer",
                                          inner_axis=inner)[None], g),
        _mesh(*layout), P(AX), P(AX)))
    return {k: np.asarray(v) for k, v in f(
        {k: jnp.asarray(v) for k, v in rows_by_leaf.items()}).items()}


def _jax_references(n, layout):
    """Every JAX reference of a world of ``n`` laid out ``layout``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import horovod_tpu as jhvd
    from test_torch_port_injit import _per_device, _smap
    from test_torch_port_reduce import jax_int8_steps
    ref = {"int8": {s: jax_int8_steps(layout, [10 + t for t in range(
        INT8_STEPS)], s, n) for s in ("hierarchical", "flat")},
        "adasum_plane": _jax_adasum(layout, make_grads(n, seed=ADASUM_SEED))}
    # the verbs over the world: one axis of all n devices
    xv, yv = _verb_inputs(n)
    ref["adasum_verb"] = {k: np.asarray(v) for k, v in _per_device(
        lambda x, y: {"single": jhvd.allreduce(x, op=jhvd.Adasum),
                      **dict(zip(("grouped.x", "grouped.y"),
                                 jhvd.grouped_allreduce(
                                     [x, y], op=jhvd.Adasum,
                                     prescale_factor=0.5,
                                     postscale_factor=3.0)))},
        xv, yv, shape=(n,)).items()}
    # SGD at lr 1 from zeros: each step's delta is minus the gradient
    deltas = [_jax_adasum((n, 1), make_grads(n, seed=20 + t))
              for t in range(DELTA_STEPS)]
    ref["delta"] = [{k: -sum(d[k] for d in deltas[:t + 1]) for k in SHAPES}
                    for t in range(DELTA_STEPS)]
    xs, ws = _gather_inputs(n)
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))

    def grad(fn, w):
        # every rank's loss summed: its gradient is each rank's
        f = _smap(lambda x, w: jnp.sum(fn(x[0]) * w[0])[None], mesh,
                  (P("dp"), P("dp")), P("dp"))
        return np.asarray(jax.jit(jax.grad(lambda x: f(x, w).sum()))(
            jnp.asarray(xs)))
    ref["grad"] = {
        "allgather": grad(jhvd.allgather, ws),
        "broadcast": grad(lambda x: jhvd.broadcast(x, root_rank=1),
                          ws[:, :GATHER[0]])}
    return ref


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

_WORLDS = {}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world name: (per-rank arrays, per-rank infos, JAX references)},
    both worlds running at once, the JAX side computed meanwhile."""
    if _WORLDS:
        return _WORLDS
    import threading

    import horovod_tpu as jhvd
    runs, failures = {}, {}
    # made here: tmp_path_factory is not safe from two threads at once
    dirs = {name: tmp_path_factory.mktemp(name) for name, _ in WORLDS}

    def spawn(name, layout):
        try:
            runs[name] = run_world(dirs[name], *layout, script=HERE)
        except Exception as e:   # noqa: BLE001 (re-raised by the fixture)
            failures[name] = e
    threads = [threading.Thread(target=spawn, args=w) for w in WORLDS]
    for t in threads:
        t.start()
    if jhvd.is_initialized():
        jhvd.shutdown()
    jhvd.init()
    try:
        refs = {name: _jax_references(layout[0] * layout[1], layout)
                for name, layout in WORLDS}
    finally:
        jhvd.shutdown()
        for t in threads:
            t.join(300)
    for name, _ in WORLDS:
        assert name in runs, f"the {name} run failed: {failures.get(name)}"
        _WORLDS[name] = runs[name] + (refs[name],)
    return _WORLDS


def _rows(arrays, key):
    return np.stack([a[key] for a in arrays])


@pytest.mark.parametrize("which,layout", WORLDS)
@pytest.mark.parametrize("strategy", ["hierarchical", "flat"])
def test_int8_compiled_plane_matches_jax(worlds, which, layout, strategy):
    """Three SGD steps through int8 with synchronize() compiled, each
    rank's residual carried and written back from the graph: the reduced
    gradients, the parameters and the residuals equal the JAX package's
    bit for bit."""
    arrays, _, ref = worlds[which]
    n = layout[0] * layout[1]
    param = {k: np.zeros((n,) + s, np.float32) for k, s in SHAPES.items()}
    for t, (jred, jres) in enumerate(ref["int8"][strategy]):
        name = f"int8.compiled.{strategy}.{t}"
        for k in SHAPES:
            param[k] = param[k] - jred[k]
            np.testing.assert_array_equal(_rows(arrays, f"{name}.grad.{k}"),
                                          jred[k])
            np.testing.assert_array_equal(_rows(arrays, f"{name}.res.{k}"),
                                          jres[k])
            np.testing.assert_array_equal(
                _rows(arrays, f"{name}.param.{k}"), param[k])


@pytest.mark.parametrize("which,layout", WORLDS)
@pytest.mark.parametrize("strategy", ["hierarchical", "flat"])
def test_int8_compiled_plane_equals_eager(worlds, which, layout, strategy):
    arrays, _, _ = worlds[which]
    for key in arrays[0]:
        if key.startswith(f"int8.compiled.{strategy}."):
            np.testing.assert_array_equal(
                _rows(arrays, key),
                _rows(arrays, key.replace(".compiled.", ".eager.")), key)


@pytest.mark.parametrize("which,layout", WORLDS)
def test_int8_reduces_in_one_graph(worlds, which, layout):
    """One graph a compiled synchronize(), one packed bucket: the group's
    MAX, the int8 all-gather and, hierarchical, the inner mean before
    them."""
    _, infos, _ = worlds[which]
    for info in infos:
        for s in ("hierarchical", "flat"):
            graphs = info["graphs"][f"int8.{s}"]
            assert [(g["all_reduces"], g["all_gathers"]) for g in graphs] \
                == [(2 if s == "hierarchical" else 1, 1)], (s, graphs)


@pytest.mark.parametrize("which,layout", WORLDS)
def test_adasum_compiled_plane(worlds, which, layout):
    """adasum_grads in the graph (mean over local, Adasum over cross):
    within rtol 1e-4, atol 1e-5 of the JAX package's, and bit for bit the
    eager plane's."""
    arrays, _, ref = worlds[which]
    for k in SHAPES:
        got = _rows(arrays, f"adasum_plane.compiled.{k}")
        np.testing.assert_allclose(got, ref["adasum_plane"][k], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(got,
                                      _rows(arrays, f"adasum_plane.eager.{k}"))
        assert all(np.array_equal(got[0], g) for g in got)


@pytest.mark.parametrize("which,layout", WORLDS)
@pytest.mark.parametrize("case", ["single", "grouped.x", "grouped.y"])
def test_adasum_verb_in_the_graph(worlds, which, layout, case):
    """allreduce(op=Adasum) compiled with no mesh in scope reduces over
    the world: the JAX in-jit verb over one axis of every device within
    rtol 1e-4, atol 1e-5, the eager verb bit for bit (scales included)."""
    arrays, _, ref = worlds[which]
    got = _rows(arrays, f"adasum_verb.compiled.{case}")
    np.testing.assert_allclose(got, ref["adasum_verb"][case], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(got,
                                  _rows(arrays, f"adasum_verb.eager.{case}"))


@pytest.mark.parametrize("which,layout", WORLDS)
def test_adasum_delta_optimizer_compiled(worlds, which, layout):
    """The delta optimizer's call divided: stage_deltas() eagerly, then
    step() compiled, which combines the deltas in the graph. Two SGD
    steps equal the eager optimizer's (hooks and step()) bit for bit,
    and the JAX package's adasum_grads of the deltas within rtol 1e-4,
    atol 1e-5."""
    arrays, infos, ref = worlds[which]
    assert all(info["types"]["delta"] == "_DistributedAdasumDeltaOptimizer"
               for info in infos)
    for t in range(DELTA_STEPS):
        for k in SHAPES:
            got = _rows(arrays, f"delta.compiled.{t}.{k}")
            np.testing.assert_array_equal(
                got, _rows(arrays, f"delta.eager.{t}.{k}"))
            np.testing.assert_allclose(got, ref["delta"][t][k], rtol=1e-4,
                                       atol=1e-5)
    for info in infos:
        assert [g["all_gathers"] for g in info["graphs"]["delta"]] \
            == [len(SHAPES)]


@pytest.mark.parametrize("which,layout", WORLDS)
@pytest.mark.parametrize("verb", ["allgather", "broadcast"])
def test_gather_gradients_in_the_graph(worlds, which, layout, verb):
    """The gradient of a compiled allgather (the reduce-scatter of the
    cotangents onto each rank's rows) and broadcast (the cotangents'
    sum at the root, zeros elsewhere) against jax.grad through the JAX
    in-jit verbs, atol 1e-6."""
    arrays, infos, ref = worlds[which]
    got = _rows(arrays, f"grad.{verb}.x")
    np.testing.assert_allclose(got, ref["grad"][verb], rtol=0, atol=1e-6)
    if verb == "broadcast":     # the root gets the sum, the rest zeros
        n = layout[0] * layout[1]
        assert got[1].any() and not got[np.arange(n) != 1].any()
    for info in infos:
        assert [(g["all_gathers"], g["reduce_scatters"])
                for g in info["graphs"][f"grad.{verb}"]] == [(1, 0)]


@pytest.mark.parametrize("which,layout", WORLDS)
def test_grad_process_sets_in_the_graph(worlds, which, layout):
    """grad_process_sets reduced in the graph (one all-reduce a bucket of
    the eager plane's plan, over its set) equal the eager plane's
    reduction bit for bit; a pair's sum differs from the world's."""
    arrays, infos, _ = worlds[which]
    for k in SHAPES:
        np.testing.assert_array_equal(_rows(arrays, f"sets.compiled.{k}"),
                                      _rows(arrays, f"sets.eager.{k}"))
    n = layout[0] * layout[1]
    coef = _set_coefficients(n)
    half = n // 2
    np.testing.assert_allclose(
        _rows(arrays, "sets.compiled.w")[0],
        coef["w"][:half].sum(axis=0) * 0.5, rtol=1e-6)
    for info in infos:
        assert sum(g["all_reduces"] for g in info["graphs"]["sets"]) == 2


def test_adasum_eager_plane_in_the_graph_at_one():
    """The eager plane with op=Adasum (a world of one: more processes
    take the delta optimizer) reduced in the graph: Adasum of one
    contribution is the gradient itself, as the eager plane's hooks and
    the JAX package's adasum_grads over one device give it (bit for bit;
    no collective in the graph)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.train import _recording_backend
    hvd.init(device="cpu")
    try:
        coef = make_grads(1, seed=ADASUM_SEED)
        got = {}
        for mode in ("eager", "compiled"):
            ps = _params(torch, "cpu")
            opt = _optimizer(hvd, torch, ps, op=hvd.Adasum)
            assert type(opt).__name__ == "DistributedOptimizer"
            sync, log = opt.synchronize, []
            if mode == "compiled":
                opt.remove_hooks()
                torch._dynamo.reset()
                sync = torch.compile(opt.synchronize, fullgraph=True,
                                     backend=_recording_backend(
                                         BACKEND, "eager_plane", log))
            sum((p * torch.from_numpy(coef[k][0].copy())).sum()
                for k, p in ps.items()).backward()
            sync()
            got[mode] = {k: p.grad.numpy().copy() for k, p in ps.items()}
    finally:
        hvd.shutdown()
    want = _jax_adasum((1, 1), coef)
    for k in SHAPES:
        np.testing.assert_array_equal(got["compiled"][k], got["eager"][k])
        np.testing.assert_allclose(got["compiled"][k], want[k][0], rtol=1e-4,
                                   atol=1e-5)
    assert [(g["all_reduces"], g["all_gathers"]) for g in log] == [(0, 0)]


@pytest.mark.parametrize("which,case,match", [
    ("world2", "adasum_several_dims", "explicit hierarchy"),
    ("world4", "adasum_several_dims", "explicit hierarchy"),
    ("world4", "adasum_not_pow2", "power-of-two"),
])
def test_adasum_trace_time_errors(worlds, which, case, match):
    """Adasum raises ValueError while the graph is traced, as the JAX
    package raises while it traces: with a mesh of several dims in scope
    (no hierarchy given), and over a group of 3."""
    _, infos, _ = worlds[which]
    for info in infos[:3]:
        got = info["errors"][case]
        assert got is not None and got[0] == "ValueError", got
        assert match in got[1], got


if __name__ == "__main__":
    sys.exit(_world_worker(sys.argv[2]) if sys.argv[1] == "world" else 2)
