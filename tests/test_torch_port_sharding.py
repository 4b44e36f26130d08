"""Tensor- and fully-sharded parameters (tp, fsdp) of the port's training
step against the JAX package's step on the same mesh shapes.

Run as a script, this file is the worker: it joins a gloo world of 4
through the ``HVD_TPU_*`` env contract and trains the tiny transformer of
``tests/test_parallel.py``'s fsdp oracle (vocab 64, 2 layers, d 32, 4 x 8
heads, S 16, fp32) 2 steps on each mesh of ``MESHES``, from the JAX
package's initial weights (PRNGKey(0)), each process loading its blocks
(``params_from_flax(tree, mesh=)``), then gathers the parameters back
(``params_to_flax(state, mesh=)``); once more on dp 4 (no sharding), the
port's own data-parallel reference. The test spawns the world once and
holds it against the JAX package's ``make_transformer_train_step`` on a
4-device sub-mesh of the 8-device CPU mesh, run here while the world runs.

Tolerances, fp32 on both sides:
* first loss: rtol 1e-5 against the JAX step on the same mesh shape and
  against the port's dp run (the JAX package's own fsdp oracle's
  tolerance; the vocab-parallel softmax sums in another order);
* parameters after 2 steps, gathered: atol 2e-5 (PR 4's two-step
  tolerance: AdamW's first steps move every parameter by about lr, so a
  rounding-level gradient difference stays at rounding level; a gradient
  averaged over the wrong processes moves parameters by ~1e-3);
* shardings: exact (each parameter's PartitionSpec and this process's
  block are the JAX package's).

JAX is imported inside the tests, so the module also imports where JAX is
absent.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.models import (  # noqa: E402
    Transformer, TransformerConfig, params_from_flax, params_to_flax)
from horovod_tpu_torch.parallel import (  # noqa: E402
    MeshConfig, fsdp_sharded_leaves, make_training_mesh,
    make_transformer_train_step, param_shardings)
from horovod_tpu_torch.parallel.mesh_utils import (  # noqa: E402
    tensor_parallel_blocks, tensor_parallel_local)

N = 4
TINY = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
            head_dim=8, max_seq_len=16)
BATCH = 8
STEPS = 2
RTOL_LOSS = 1e-5
ATOL_PARAM = 2e-5
#: label -> (mesh sizes, attention kind)
MESHES = {
    "fsdp2_tp2": (dict(dp=1, fsdp=2, tp=2), "ring"),
    "dp2_tp2": (dict(dp=2, tp=2), "ring"),
    "fsdp4": (dict(dp=1, fsdp=4), "ring"),
    "tp4": (dict(dp=1, tp=4), "ring"),
    "sp2_tp2_ring": (dict(dp=1, sp=2, tp=2), "ring"),
}


def _data(step):
    rng = np.random.RandomState(90 + step)
    return rng.randint(0, TINY["vocab_size"],
                       (BATCH, TINY["max_seq_len"] + 1)).astype(np.int64)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _train(label, sizes, kind, tree, res):
    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    mesh = make_training_mesh(MeshConfig(**sizes), device="cpu")
    b = make_transformer_train_step(cfg, device="cpu", mesh=mesh,
                                    attention_kind=kind)
    sharded = b.sharding is not None
    b.model.load_state_dict(params_from_flax(tree,
                                             mesh=mesh if sharded else None))
    losses = []
    for s in range(STEPS):
        d = torch.from_numpy(_data(s))
        losses.append(b.step(d[:, :-1], d[:, 1:]).item())
    b.optimizer.remove_hooks()
    res[f"{label}.losses"] = np.array(losses)
    final = params_to_flax(b.model.state_dict(), mesh if sharded else None)
    for name, val in _flat(final).items():
        res[f"{label}.param.{name}"] = val
    leaves = fsdp_sharded_leaves(b.model)
    specs = b.sharding.specs if sharded else {}
    names = {id(p): n for n, p in b.model.named_parameters()}
    res[f"{label}.fsdp_leaves"] = np.array(
        [[p.numel(), int(np.prod(specs[names[id(p)]].shape))]
         for p in leaves], dtype=np.int64).reshape(-1, 2)
    # AdamW state of the blocks only: every moment has its block's shape
    state = b.optimizer.state
    res[f"{label}.state_numel"] = np.array(
        [sum(state[p][k].numel() for p in b.model.parameters()
             for k in ("exp_avg", "exp_avg_sq")),
         2 * sum(p.numel() for p in b.model.parameters())])


def _world_worker(out_dir) -> int:
    hvd.init(device="cpu")
    r = hvd.rank()
    ref = np.load(os.path.join(out_dir, "inputs.npz"))
    tree = {}
    for key in ref.files:
        node = tree
        *path, last = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = ref[key]
    res = {}
    for label, (sizes, kind) in MESHES.items():
        _train(label, sizes, kind, tree, res)
    _train("dp", dict(dp=N), "ring", tree, res)
    hvd.barrier()
    hvd.shutdown()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)
    print("RESULT " + json.dumps({"rank": r}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_cfg():
    import jax.numpy as jnp

    from horovod_tpu.models import TransformerConfig as JCfg
    return JCfg(**TINY, dtype=jnp.float32)


def _jax_mesh(sizes):
    import jax

    from horovod_tpu import parallel as jpar
    return jpar.make_training_mesh(jpar.MeshConfig(**sizes),
                                   devices=jax.devices()[:N])


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX transformer's initial parameters (PRNGKey(0), as its train
    step draws them), unboxed numpy."""
    import jax
    import jax.numpy as jnp
    from flax.linen import meta

    from horovod_tpu.models import Transformer as JTransformer
    variables = JTransformer(_jax_cfg()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, TINY["max_seq_len"]),
                                         jnp.int32))
    return jax.tree_util.tree_map(np.asarray,
                                  meta.unbox(variables["params"]))


@functools.lru_cache(maxsize=None)
def _jax_train(label):
    """Losses and final parameters (flat names) of the JAX package's step
    on the mesh shape ``label``."""
    import jax
    import jax.numpy as jnp
    from flax.linen import meta

    from horovod_tpu.parallel.train import make_transformer_train_step as mk
    sizes, kind = MESHES[label]
    bundle = mk(_jax_cfg(), _jax_mesh(sizes), attention_kind=kind)
    p, s = bundle.params, bundle.opt_state
    losses = []
    for step in range(STEPS):
        d = _data(step).astype(np.int32)
        tok = jax.device_put(jnp.asarray(d[:, :-1]), bundle.batch_sharding)
        tgt = jax.device_put(jnp.asarray(d[:, 1:]), bundle.batch_sharding)
        p, s, loss = bundle.step(p, s, tok, tgt)
        losses.append(float(loss))
    final = _flat(jax.tree_util.tree_map(np.asarray, meta.unbox(p)))
    return np.array(losses), final


_WORLD = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(per-rank results, JAX references by mesh label), run once."""
    if _WORLD:
        return _WORLD["v"]
    from test_torch_port_parallel import _finish, _start
    out_dir = str(tmp_path_factory.mktemp("sharding"))
    np.savez(os.path.join(out_dir, "inputs.npz"), **_flat(_jax_init()))
    procs = _start(N, ["world", out_dir], os.path.abspath(__file__))
    ref = {label: _jax_train(label) for label in MESHES}
    _finish(procs, timeout=240)
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
             for r in range(N)]
    _WORLD["v"] = (ranks, ref)
    return _WORLD["v"]


@pytest.mark.parametrize("label", list(MESHES))
def test_first_loss_matches_jax_and_dp(world, label):
    ranks, ref = world
    losses, _ = ref[label]
    for res in ranks:
        got = res[f"{label}.losses"]
        np.testing.assert_allclose(got[0], losses[0], rtol=RTOL_LOSS)
        np.testing.assert_allclose(got[0], res["dp.losses"][0],
                                   rtol=RTOL_LOSS)
        np.testing.assert_allclose(got, losses, rtol=RTOL_LOSS)
    assert abs(losses[0] - np.log(TINY["vocab_size"])) < 1.0


@pytest.mark.parametrize("label", list(MESHES))
def test_params_after_two_steps_match_jax(world, label):
    ranks, ref = world
    _, final = ref[label]
    for res in ranks:
        for name, want in final.items():
            np.testing.assert_allclose(res[f"{label}.param.{name}"], want,
                                       atol=ATOL_PARAM, rtol=0,
                                       err_msg=f"{label}: {name}")


@pytest.mark.parametrize("label", list(MESHES))
def test_parameters_and_adamw_state_are_sharded(world, label):
    """fsdp_sharded_leaves proves the sharding as the JAX oracle does
    (each one's shard at most half its leaf), and the AdamW moments exist
    for the blocks only."""
    ranks, _ = world
    sizes, _ = MESHES[label]
    for res in ranks:
        leaves = res[f"{label}.fsdp_leaves"]
        assert len(leaves) > 0
        assert all(local * 2 <= whole for local, whole in leaves)
        state, blocks = res[f"{label}.state_numel"]
        assert state == blocks
        whole = 2 * sum(int(np.prod(v.shape)) for k, v in res.items()
                        if k.startswith(f"{label}.param."))
        shards = sizes.get("fsdp", 1) * sizes.get("tp", 1)
        assert blocks * shards >= whole > blocks
    assert len(ranks[0]["dp.fsdp_leaves"]) == 0


def test_dp_reference_matches_jax(world):
    """The unsharded mesh step (dp 4) against the JAX step on fsdp 2 x tp
    2: sharding changes the layout, not the math."""
    ranks, ref = world
    losses, final = ref["fsdp2_tp2"]
    for res in ranks:
        np.testing.assert_allclose(res["dp.losses"], losses, rtol=RTOL_LOSS)
        for name, want in final.items():
            np.testing.assert_allclose(res[f"dp.param.{name}"], want,
                                       atol=ATOL_PARAM, rtol=0)


# ---------------------------------------------------------------------------
# one process: the layout against the JAX package's param_shardings
# ---------------------------------------------------------------------------

class _FakeMesh:
    """The DeviceMesh surface param_shardings reads: dim names, shape and
    this rank's index on each dim."""

    def __init__(self, rank, **sizes):
        from horovod_tpu_torch.parallel.mesh_utils import AXIS_ORDER
        self.mesh_dim_names = AXIS_ORDER
        self.shape = tuple(sizes.get(a, 1) for a in AXIS_ORDER)
        coords = np.unravel_index(rank, self.shape)
        self.local = dict(zip(AXIS_ORDER, (int(c) for c in coords)))

    def get_local_rank(self, axis):
        return self.local[axis]


@pytest.mark.parametrize("label", list(MESHES))
def test_param_shardings_match_jax(label):
    """Each parameter's spec, and every process's block, exactly as the
    JAX package lays out the same mesh: the JAX NamedSharding's
    PartitionSpec and the index of the shard on device r (rank r of the
    port's mesh: both order the devices dp, fsdp, pp, ep, sp, tp)."""
    import jax

    from horovod_tpu.parallel import mesh_utils as jmesh
    from horovod_tpu.models import Transformer as JTransformer
    sizes, _ = MESHES[label]
    mesh = _jax_mesh(sizes)
    abstract = jax.eval_shape(lambda: JTransformer(_jax_cfg()).init(
        jax.random.PRNGKey(0),
        jax.numpy.zeros((1, TINY["max_seq_len"]), jax.numpy.int32)))
    shardings = _flat(jmesh.param_shardings(mesh, abstract)["params"])
    shapes = {n: tuple(t.shape) for n, t in Transformer(
        TransformerConfig(**TINY), device="meta").named_parameters()}
    assert set(shardings) == set(shapes)
    devices = list(mesh.devices.flat)
    for rank in range(N):
        specs = param_shardings(_FakeMesh(rank, **sizes), shapes)
        for name, sharding in shardings.items():
            spec = specs[name]
            want = tuple(sharding.spec) + (None,) * (
                len(shapes[name]) - len(sharding.spec))
            assert spec.spec == want, name
            index = sharding.devices_indices_map(shapes[name])[
                devices[rank]]
            assert spec.index == tuple(
                slice(s.start or 0, s.stop if s.stop is not None else d)
                for s, d in zip(index, shapes[name])), (name, rank)


def test_param_shardings_refuse_indivisible_dims():
    shapes = {n: tuple(t.shape) for n, t in Transformer(
        TransformerConfig(**TINY), device="meta").named_parameters()}
    with pytest.raises(ValueError, match="not divisible by mesh axis 'tp'"):
        param_shardings(_FakeMesh(0, tp=3), shapes)
    with pytest.raises(ValueError, match="mesh axis 'fsdp'"):
        param_shardings(_FakeMesh(0, fsdp=3), shapes)


def test_params_from_flax_blocks_cover_the_tree():
    """params_from_flax(tree, mesh=) gives each process its block; the
    blocks of all processes tile every global array exactly once per
    replica."""
    tree = _jax_init()
    flat = _flat(tree)
    sizes = MESHES["fsdp2_tp2"][0]
    seen = {n: np.zeros(v.shape, np.int64) for n, v in flat.items()}
    for rank in range(N):
        mesh = _FakeMesh(rank, **sizes)
        blocks = params_from_flax(tree, mesh=mesh)
        specs = param_shardings(mesh, {n: v.shape for n, v in flat.items()})
        for name, t in blocks.items():
            np.testing.assert_array_equal(t.numpy(),
                                          flat[name][specs[name].index])
            seen[name][specs[name].index] += 1
    for name, count in seen.items():
        assert (count == count.flat[0]).all(), name


@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_local_matches_the_layer(tp):
    """A decoder layer split into tp blocks, each block's attention and
    MLP run in turn in this process and the partial outputs summed, gives
    the unsplit layer's output (fp32: the products' sums in another
    order, atol 1e-5), with one attention call per block."""
    from horovod_tpu_torch.parallel import flash_attention_fn
    calls = []

    def attention(q, k, v, mask, dtype):
        calls.append(q.shape)
        return flash_attention_fn(q, k, v, mask, dtype)
    cfg = TransformerConfig(**TINY, dtype=torch.float32,
                            attention_fn=attention)
    layer = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(4)).layer_0
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = layer(x, None)
        calls.clear()
        got = tensor_parallel_local(layer, tensor_parallel_blocks(layer, tp),
                                    x, None)
    assert calls == [(2, 16, 4 // tp, 8)] * tp
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


if __name__ == "__main__":
    sys.exit(_world_worker(sys.argv[2]) if sys.argv[1] == "world" else 2)
