"""The compiled mesh step (``make_transformer_train_step(mesh=,
compiled=True)`` at tp, fsdp and sp > 1) and the parallel package's wire
calls in a compiled graph, on the CPU: every compile ``fullgraph=True``,
``backend="aot_eager"``, so a graph break fails.

Run as a script, this file is the worker: ``python tests/
test_torch_port_compiled_mesh.py world <dir>`` with the ``HVD_TPU_*``
identity env. The tests spawn one gloo world of 4 and one of 2
(``test_torch_port_parallel._start``). In the world of 4 the tiny
transformer of tests/test_torch_port_sharding.py (vocab 64, 2 layers,
d 32, 4 x 8 heads, S 16, fp32) trains 2 steps from the JAX package's
initial weights on each mesh of ``MESHES``: the sharding tests' five and
dp 2 x sp 2 with ring and with Ulysses attention, once eagerly and once
compiled. Both worlds run each of ``parallel.comm``'s wire calls in a
compiled graph and eagerly, forward and gradient. In the test process,
the JAX package's jitted step on the same mesh shapes, run while the
worlds run, and the one-process ring (``ring_attention_local``)
compiled.

Tolerances, fp32 on both sides:
* against the JAX jitted step: the first loss within rtol 1e-5, the
  parameters after 2 steps within atol 2e-5 (the sharding tests' own);
* against the port's eager mesh step: losses and parameters within atol
  1e-6 (the compiled backward of a ring step skips the query rows a key
  block cannot see, as the eager one cannot with device offsets: its
  sums run over fewer rows; the in-graph data-parallel reduction packs
  its buckets at another threshold, so a sum of 4 values over gloo may
  take another order);
* the wire calls: bit for bit (moves and sums of the same buffers).
"""

import functools
import importlib
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

import test_torch_port_sharding as sharding  # noqa: E402

BACKEND = "aot_eager"
TOL_EAGER = 1e-6
#: label -> (mesh sizes, attention kind): the sharding tests' meshes and
#: dp 2 x sp 2 with either sequence-parallel attention
MESHES = dict(sharding.MESHES,
              dp2_sp2_ring=(dict(dp=2, sp=2), "ring"),
              dp2_sp2_ulysses=(dict(dp=2, sp=2), "ulysses"))
#: the meshes of the world of 2, held to its eager steps
MESHES_2 = {"tp2": (dict(tp=2), "ring"), "sp2_ring": (dict(sp=2), "ring")}
COMM = ["ring_shift", "all_to_all", "all_gather", "copy_to_group",
        "sum_replicated", "all_reduce_max"]


def _comm_inputs(n):
    """Each rank's inputs and loss weights of the wire calls."""
    rng = np.random.RandomState(31)
    draw = lambda *s: rng.standard_normal((n,) + s).astype(np.float32)
    return {"a": draw(2 * n, 3), "b": draw(n, 5), "wa": draw(2 * n, 3),
            "wb": draw(n, 5), "wg": draw(2 * n, 3 * n)}


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _train(label, sizes, kind, tree, res, log):
    import horovod_tpu_torch as hvd  # noqa: F401
    from horovod_tpu_torch.models import (TransformerConfig, params_from_flax,
                                          params_to_flax)
    from horovod_tpu_torch.parallel import (MeshConfig, make_training_mesh,
                                            make_transformer_train_step)
    for mode in ("eager", "compiled"):
        torch._dynamo.reset()
        cfg = TransformerConfig(**sharding.TINY, dtype=torch.float32)
        mesh = make_training_mesh(MeshConfig(**sizes), device="cpu")
        kw = dict(compiled=True, compile_backend=BACKEND) \
            if mode == "compiled" else {}
        b = make_transformer_train_step(cfg, device="cpu", mesh=mesh,
                                        attention_kind=kind, **kw)
        sharded = b.sharding is not None
        b.model.load_state_dict(params_from_flax(
            tree, mesh=mesh if sharded else None))
        losses = []
        for s in range(sharding.STEPS):
            d = torch.from_numpy(sharding._data(s))
            losses.append(b.step(d[:, :-1], d[:, 1:]).item())
        b.optimizer.remove_hooks()
        res[f"{label}.{mode}.losses"] = np.array(losses)
        final = params_to_flax(b.model.state_dict(),
                               mesh if sharded else None)
        for name, val in sharding._flat(final).items():
            res[f"{label}.{mode}.param.{name}"] = val
        if mode == "compiled":
            log[label] = b.compile_log


def _comm(n, r, res, log):
    """Each wire call of parallel.comm over the world, compiled and
    eagerly: its outputs and its inputs' gradients."""
    import torch.distributed as dist

    from horovod_tpu_torch.parallel import comm
    from horovod_tpu_torch.parallel.train import _recording_backend
    group = dist.group.WORLD
    d = {k: torch.from_numpy(v[r].copy()) for k, v in _comm_inputs(n).items()}
    calls = {
        "ring_shift": lambda a, b: comm.ring_shift((a, b), group),
        "all_to_all": lambda a, b: (comm.all_to_all(a, group),),
        "all_gather": lambda a, b: (comm.all_gather(a, 1, group),),
        "copy_to_group": lambda a, b: (comm.copy_to_group(a, group),
                                       comm.copy_to_group(b, group)),
        "sum_replicated": lambda a, b: (comm.sum_replicated(a, group),),
        "all_reduce_max": lambda a, b: (comm.all_reduce_max(a, group),),
    }
    weights = {"ring_shift": ("wa", "wb"), "all_gather": ("wg",),
               "copy_to_group": ("wa", "wb")}

    def loss_of(name, outs):
        ws = [d[k] for k in weights.get(name, ("wa",))]
        return sum((o * w).sum() for o, w in zip(outs, ws))
    for name, call in calls.items():
        for mode in ("eager", "compiled"):
            a, b = (d[k].clone().requires_grad_() for k in "ab")

            def fn(a, b, name=name, call=call):
                outs = call(a, b)
                return outs, loss_of(name, outs)
            if mode == "compiled":
                torch._dynamo.reset()
                log[name] = graphs = []
                fn = torch.compile(fn, fullgraph=True, backend=(
                    _recording_backend(BACKEND, name, graphs)))
            outs, loss = fn(a, b)
            if loss.requires_grad:
                loss.backward()
            for i, o in enumerate(outs):
                res[f"comm.{name}.{mode}.out{i}"] = o.detach().numpy().copy()
            for k, t in (("a", a), ("b", b)):
                if t.grad is not None:
                    res[f"comm.{name}.{mode}.grad_{k}"] = t.grad.numpy().copy()


def _world_worker(out_dir) -> int:
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    n, r = hvd.size(), hvd.rank()
    ref = np.load(os.path.join(out_dir, "inputs.npz"))
    tree = {}
    for key in ref.files:
        node = tree
        *path, last = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = ref[key]
    res, logs = {}, {"train": {}, "comm": {}}
    for label, (sizes, kind) in (MESHES if n == 4 else MESHES_2).items():
        _train(label, sizes, kind, tree, res, logs["train"])
    _comm(n, r, res, logs["comm"])
    hvd.barrier()
    hvd.shutdown()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(logs, f)
    print("RESULT " + json.dumps({"rank": r}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_train(label):
    """Losses and final parameters (flat names) of the JAX package's
    jitted step on the mesh shape ``label`` (tests/
    test_torch_port_sharding.py's data and initial weights)."""
    if label in sharding.MESHES:
        return sharding._jax_train(label)
    import jax
    import jax.numpy as jnp
    from flax.linen import meta

    from horovod_tpu.parallel.train import make_transformer_train_step as mk
    sizes, kind = MESHES[label]
    bundle = mk(sharding._jax_cfg(), sharding._jax_mesh(sizes),
                attention_kind=kind)
    p, s = bundle.params, bundle.opt_state
    losses = []
    for step in range(sharding.STEPS):
        d = sharding._data(step).astype(np.int32)
        tok = jax.device_put(jnp.asarray(d[:, :-1]), bundle.batch_sharding)
        tgt = jax.device_put(jnp.asarray(d[:, 1:]), bundle.batch_sharding)
        p, s, loss = bundle.step(p, s, tok, tgt)
        losses.append(float(loss))
    return np.array(losses), sharding._flat(
        jax.tree_util.tree_map(np.asarray, meta.unbox(p)))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

_WORLDS = {}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: (per-rank results, per-rank logs)} and the JAX references by
    mesh label, both worlds spawned at once, the JAX side run meanwhile."""
    if _WORLDS:
        return _WORLDS["v"]
    from test_torch_port_parallel import _finish, _start
    dirs, procs = {}, {}
    for n in (4, 2):
        dirs[n] = str(tmp_path_factory.mktemp(f"compiled_mesh{n}"))
        np.savez(os.path.join(dirs[n], "inputs.npz"),
                 **sharding._flat(sharding._jax_init()))
        procs[n] = _start(n, ["world", dirs[n]], HERE)
    ref = {label: _jax_train(label) for label in MESHES}
    runs = {}
    for n in (4, 2):
        _finish(procs[n], timeout=300)
        runs[n] = ([dict(np.load(os.path.join(dirs[n], f"rank{r}.npz")))
                    for r in range(n)],
                   [json.load(open(os.path.join(dirs[n], f"rank{r}.json")))
                    for r in range(n)])
    _WORLDS["v"] = (runs, ref)
    return _WORLDS["v"]


def _params(res, label, mode):
    prefix = f"{label}.{mode}.param."
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("label", list(MESHES))
def test_compiled_mesh_step_matches_jax(worlds, label):
    """The compiled step on each mesh against the JAX package's jitted
    step: the first loss within rtol 1e-5, the losses within it too, and
    the gathered parameters after 2 steps within atol 2e-5."""
    runs, ref = worlds
    losses, final = ref[label]
    for res in runs[4][0]:
        got = res[f"{label}.compiled.losses"]
        np.testing.assert_allclose(got[0], losses[0], rtol=sharding.RTOL_LOSS)
        np.testing.assert_allclose(got, losses, rtol=sharding.RTOL_LOSS)
        params = _params(res, label, "compiled")
        assert set(params) == set(final)
        for name, want in final.items():
            np.testing.assert_allclose(params[name], want,
                                       atol=sharding.ATOL_PARAM, rtol=0,
                                       err_msg=f"{label}: {name}")


@pytest.mark.parametrize("n,label", [(4, label) for label in MESHES]
                         + [(2, label) for label in MESHES_2])
def test_compiled_mesh_step_equals_eager(worlds, n, label):
    """The compiled step's losses and parameters against the port's eager
    mesh step from the same weights: within atol 1e-6."""
    runs, _ = worlds
    for res in runs[n][0]:
        np.testing.assert_allclose(res[f"{label}.compiled.losses"],
                                   res[f"{label}.eager.losses"], rtol=0,
                                   atol=TOL_EAGER)
        eager = _params(res, label, "eager")
        for name, got in _params(res, label, "compiled").items():
            np.testing.assert_allclose(got, eager[name], rtol=0,
                                       atol=TOL_EAGER, err_msg=name)


@pytest.mark.parametrize("n,label", [(4, label) for label in MESHES]
                         + [(2, label) for label in MESHES_2])
def test_compiled_mesh_step_graphs(worlds, n, label):
    """One graph a region, fullgraph: the forward holds the flash op once
    a ring step (once a layer otherwise) and the sharded forward's
    collectives with their backward's (tp's sums, fsdp's gathers and
    reduce-scatters, the ring's shifts, Ulysses' all-to-alls); the
    reduction holds all-reduces only."""
    from horovod_tpu_torch.parallel.mesh_utils import AXIS_ORDER
    runs, _ = worlds
    sizes, kind = (MESHES if n == 4 else MESHES_2)[label]
    size = {a: sizes.get(a, 1) for a in AXIS_ORDER}
    layers = sharding.TINY["num_layers"]
    sp_ring = size["sp"] > 1 and kind == "ring"
    shifts = 2 * (size["sp"] - 1) if sp_ring else 0
    exchanges = 8 if size["sp"] > 1 and kind == "ulysses" else shifts
    for logs in runs[n][1]:
        forward, reduce = logs["train"][label]
        assert (forward["region"], reduce["region"]) == ("forward", "reduce")
        assert forward["flash_ops"] == layers * (size["sp"] if sp_ring
                                                 else 1)
        assert forward["all_to_alls"] == layers * exchanges
        assert (forward["all_reduces"] > 0) == (size["tp"] > 1)
        assert forward["all_gathers"] == forward["reduce_scatters"]
        assert (forward["all_gathers"] > 0) == (size["fsdp"] > 1)
        assert reduce["all_reduces"] > 0 and reduce["flash_ops"] == 0
        assert reduce["all_gathers"] == reduce["all_to_alls"] == 0


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("name", COMM)
def test_comm_wire_call_in_the_graph_equals_eager(worlds, n, name):
    """Each of parallel.comm's wire calls compiled (its in-graph branch)
    against its eager call: outputs and gradients bit for bit, and one
    in-graph collective of its kind forward (with its transpose in the
    backward subgraph where it has one)."""
    runs, _ = worlds
    arrays, logs = runs[n]
    for res in arrays:
        keys = [k for k in res if k.startswith(f"comm.{name}.compiled.")]
        assert keys
        for key in keys:
            np.testing.assert_array_equal(
                res[key], res[key.replace(".compiled.", ".eager.")], key)
    want = {"ring_shift": ("all_to_alls", 2), "all_to_all": ("all_to_alls", 2),
            "all_gather": ("all_gathers", 1),
            "copy_to_group": ("all_reduces", 2),
            "sum_replicated": ("all_reduces", 1),
            "all_reduce_max": ("all_reduces", 1)}[name]
    for log in logs:
        graphs = log["comm"][name]
        assert len(graphs) == 1 and graphs[0][want[0]] == want[1], graphs


def test_comm_wire_calls_move_what_they_should(worlds):
    """The eager side of the comparisons above, against numpy: the shift
    takes the previous member's rows, the sum and the max are over the
    world, copy_to_group's gradient is the world's sum of the weights."""
    runs, _ = worlds
    for n in (4, 2):
        d = _comm_inputs(n)
        for r, res in enumerate(runs[n][0]):
            np.testing.assert_array_equal(
                res["comm.ring_shift.eager.out0"], d["a"][(r - 1) % n])
            np.testing.assert_allclose(
                res["comm.sum_replicated.eager.out0"], d["a"].sum(axis=0),
                rtol=0, atol=1e-6)
            np.testing.assert_array_equal(
                res["comm.all_reduce_max.eager.out0"], d["a"].max(axis=0))
            np.testing.assert_allclose(
                res["comm.copy_to_group.eager.grad_a"], d["wa"].sum(axis=0),
                rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [4, 2])
def test_compiled_ring_local_recomputes_each_step(n, monkeypatch):
    """ring_attention_local compiled at each position: every step is the
    custom op at the position's int offsets, checkpointed, so backward
    runs it again (n calls forward, n more in backward, as eagerly); the
    output equals the eager ring's bit for bit, the gradients within
    atol 1e-6, and both the JAX ring's within atol 2e-5."""
    from test_torch_port_parallel import (ATOL, _attn_inputs, _jax_attention,
                                          _sp_block, _t)
    from horovod_tpu_torch.ops import flash_attention as fa
    ra = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")
    ref = _jax_attention()["ring_flash_causal"]
    q, k, v, w = _attn_inputs()
    calls = []
    kernel = fa._flash_fwd

    def counted(*args):
        calls.append(args[3:5])
        return kernel(*args)
    monkeypatch.setattr(fa, "_flash_fwd", counted)

    def local(my, qb, *kv):
        return ra.ring_attention_local(qb, list(zip(kv[::2], kv[1::2])), my)
    # the position is a constant of each graph: one graph a position
    compiled = torch.compile(local, fullgraph=True, backend=BACKEND,
                             dynamic=False)
    got = {"eager": [], "compiled": []}
    for my in range(n):
        for mode, fn in (("eager", local), ("compiled", compiled)):
            leaves = [_t(_sp_block(x, j, n), True) for x in (k, v)
                      for j in range(n)]
            ks, vs = leaves[:n], leaves[n:]
            qb = _t(_sp_block(q, my, n), True)
            calls.clear()
            out = fn(my, qb, *[t for pair in zip(ks, vs) for t in pair])
            assert len(calls) == n
            if mode == "compiled":
                s = q.shape[1] // n
                assert all(isinstance(c, int) for pair in calls
                           for c in pair)
                assert sorted(calls) == sorted(
                    (my * s, ((my - i) % n) * s) for i in range(n))
            (out * _t(_sp_block(w, my, n))).sum().backward()
            assert len(calls) == 2 * n
            got[mode].append([out.detach().numpy(), qb.grad.numpy(),
                              np.stack([x.grad.numpy() for x in ks]),
                              np.stack([x.grad.numpy() for x in vs])])
    for e, c in zip(got["eager"], got["compiled"]):
        np.testing.assert_array_equal(c[0], e[0])
        for a, b in zip(c[1:], e[1:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL_EAGER)
    out = np.concatenate([c[0] for c in got["compiled"]], axis=1)
    dq = np.concatenate([c[1] for c in got["compiled"]], axis=1)
    dk = np.concatenate(list(sum(c[2] for c in got["compiled"])), axis=1)
    dv = np.concatenate(list(sum(c[3] for c in got["compiled"])), axis=1)
    for a, b in zip((out, dq, dk, dv), ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0)


if __name__ == "__main__":
    sys.exit(_world_worker(sys.argv[2]) if sys.argv[1] == "world" else 2)
