"""The port's parallel package (horovod_tpu_torch.parallel) against the JAX
package's (horovod_tpu.parallel).

In one process: the mesh host logic (plan_reshape under every policy and
error, replica groups, spec parsing, axis checks) and route_top1, exactly;
the MoE parameter converter; ring attention's one-process driver
(``ring_attention_local``) against the JAX ring on the CPU mesh.

Across processes: run as a script, this file is the worker. It joins a
gloo world through the ``HVD_TPU_*`` env contract, builds training meshes
and runs every module of the package on seeded inputs: hierarchical
allreduce (dp x sp), ring attention (flash and xla, causal and not,
output and dq/dk/dv) and Ulysses over sp = n, the pipeline over pp = n
(output and gradients), moe_mlp over ep = n (output and gradients), and
2 steps of the train step at dp = n/2 x sp = 2 with ring and Ulysses
attention. It saves its results to an .npz; the tests spawn n = 4 and
n = 2 and hold them against the JAX package run here, on the 8-device
CPU mesh of tests/conftest.py (the JAX flash kernel interpreted, as in
tests/test_flash_attention.py).

Tolerances, all fp32 on both sides:
* mesh logic and route_top1's dispatch: exact (the same integer logic);
  route_top1's combine within 1e-7 (softmax in another library);
* attention, pipeline, MoE and hierarchical results, and their
  gradients: atol 2e-5 (the same arithmetic, reductions in another order;
  the ring merges partial softmaxes where the reference takes one);
* train-step losses and final parameters: atol 2e-5, as in
  tests/test_torch_port_transformer.py (AdamW's first steps move every
  parameter by about lr, whatever the gradient's size, so a
  rounding-level gradient difference stays at rounding level).

JAX is imported inside the tests, so the module also imports where JAX is
absent (the card's machine, for the worker).
"""

import dataclasses
import functools
import importlib
import json
import os
import select
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.models import (  # noqa: E402
    TransformerConfig, moe_params_from_jax)
from horovod_tpu_torch.parallel import mesh_utils as tmesh  # noqa: E402
from horovod_tpu_torch.parallel import (  # noqa: E402
    MeshConfig, hierarchical_allreduce, hierarchical_pmean,
    make_training_mesh, make_transformer_train_step, moe_mlp,
    pipeline_apply, ring_attention, ring_attention_flash,
    ring_attention_local, route_top1, ulysses_attention)

ATOL = 2e-5
TOL_COMBINE = 1e-7
TINY = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
            head_dim=8, max_seq_len=16)
# attention inputs: global (B, S, H, D); H divides by 4 (Ulysses at sp 4)
ATTN = (2, 32, 4, 16)
# pipeline: microbatches, microbatch rows, width
PIPE = (6, 2, 4)
# MoE: tokens per rank, width, expert hidden, experts per rank
MOE = (8, 8, 16, 2)
TRAIN_BATCH = 4
TRAIN_STEPS = 2


# ---------------------------------------------------------------------------
# seeded inputs, shared by the workers and the tests
# ---------------------------------------------------------------------------

def _normal(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _attn_inputs(seed=0):
    """q, k, v and the loss weights w, global (B, S, H, D)."""
    return [_normal(seed + i, ATTN) for i in range(4)]


def _pipe_inputs(n):
    M, mb, d = PIPE
    return _normal(30 + n, (n, d, d), 0.5), _normal(40 + n, (M, mb, d))


def _moe_inputs(rank):
    T, D, _, _ = MOE
    return _normal(50 + rank, (T, D)), _normal(60 + rank, (T, D))


def _hier_input(rank):
    return _normal(70 + rank, (4, 6))


def _train_data(step):
    rng = np.random.RandomState(80 + step)
    return rng.randint(0, TINY["vocab_size"],
                       (TRAIN_BATCH, TINY["max_seq_len"] + 1)).astype(
                           np.int64)


def _train_mesh_config(n):
    return MeshConfig(dp=n // 2, sp=2)


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _ring_and_ulysses(mesh, res):
    g = mesh.get_group("sp")
    n, my = g.size(), mesh.get_local_rank("sp")
    sl = slice(my * ATTN[1] // n, (my + 1) * ATTN[1] // n)
    q, k, v, w = (x[:, sl] for x in _attn_inputs())
    runs = [(f"ring_{impl}_{'causal' if c else 'full'}",
             lambda a, b, d, impl=impl, c=c: ring_attention(
                 a, b, d, g, causal=c, impl=impl))
            for impl in ("flash", "xla") for c in (True, False)]
    runs += [(f"ulysses_{'causal' if c else 'full'}",
              lambda a, b, d, c=c: ulysses_attention(a, b, d, g, causal=c))
             for c in (True, False)]
    for name, fn in runs:
        qq, kk, vv = _t(q, True), _t(k, True), _t(v, True)
        out = fn(qq, kk, vv)
        (out * _t(w)).sum().backward()
        for key, val in (("out", out), ("dq", qq.grad), ("dk", kk.grad),
                         ("dv", vv.grad)):
            res[f"{name}.{key}"] = val.detach().numpy()
    with torch.no_grad():   # no grad: no checkpoint around the steps
        res["ring_flash_causal_nograd.out"] = ring_attention_flash(
            _t(q), _t(k), _t(v), g).numpy()
    try:
        ulysses_attention(_t(q[:, :, :3]), _t(k[:, :, :3]), _t(v[:, :, :3]),
                          g)
    except ValueError as e:
        res["ulysses_error"] = np.array(str(e))


def _pipeline(mesh, res):
    n = mesh.get_group("pp").size()
    idx = mesh.get_local_rank("pp")
    w, x = _pipe_inputs(n)
    wt = _t(w, True)
    out = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), {"w": wt},
                         _t(x), mesh, "pp")
    (out ** 2).sum().backward()
    res["pipe.out"] = out.detach().numpy()
    res["pipe.dw"] = wt.grad[idx].numpy()
    res["pipe.dw_other_rows"] = np.array(
        float(wt.grad.abs().sum() - wt.grad[idx].abs().sum()))


def _moe(mesh, r, params, res):
    g = mesh.get_group("ep")
    e0 = mesh.get_local_rank("ep") * MOE[3]
    x, wy = _moe_inputs(r)
    xt = _t(x, True)
    gate = _t(params["gate_w"].numpy(), True)
    w_in = _t(params["w_in"][e0:e0 + MOE[3]].numpy(), True)
    w_out = _t(params["w_out"][e0:e0 + MOE[3]].numpy(), True)
    y = moe_mlp(xt, gate, w_in, w_out, g)
    (y * _t(wy)).sum().backward()
    for key, val in (("y", y), ("dx", xt.grad), ("dgate", gate.grad),
                     ("dw_in", w_in.grad), ("dw_out", w_out.grad)):
        res[f"moe.{key}"] = val.detach().numpy()


def _hierarchical(mesh, r, res):
    inner, outer = mesh.get_group("sp"), mesh.get_group("dp")
    x = _t(_hier_input(r))
    res["hier.dim0"] = hierarchical_allreduce(x, inner, outer).numpy()
    res["hier.dim1"] = hierarchical_allreduce(x, inner, outer, 1).numpy()
    res["hier.pmean"] = hierarchical_pmean(x, inner, outer).numpy()


def _train(mesh, state, res):
    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    for kind in ("ring", "ulysses"):
        b = make_transformer_train_step(cfg, device="cpu", mesh=mesh,
                                        attention_kind=kind)
        b.model.load_state_dict(state)
        losses = []
        for s in range(TRAIN_STEPS):
            d = torch.from_numpy(_train_data(s))
            losses.append(b.step(d[:, :-1], d[:, 1:]).item())
        b.optimizer.remove_hooks()
        res[f"train_{kind}.losses"] = np.array(losses)
        for name, t in b.model.state_dict().items():
            res[f"train_{kind}.param.{name}"] = t.numpy()


def _world_worker(out_dir) -> int:
    n = int(os.environ["HVD_TPU_SIZE"])
    hvd.init(device="cpu")
    r = hvd.rank()
    ref = np.load(os.path.join(out_dir, "inputs.npz"))
    res = {}
    for name, cfg in (("tp3", MeshConfig(tp=3)),
                      ("oversized", MeshConfig(dp=n, tp=2))):
        try:
            make_training_mesh(cfg, device="cpu")
        except ValueError as e:
            res[f"mesh_error.{name}"] = np.array(str(e))
    mesh_sp = make_training_mesh(MeshConfig(sp=n), device="cpu")
    mesh_pp = make_training_mesh(MeshConfig(pp=n), device="cpu")
    mesh_ep = make_training_mesh(MeshConfig(ep=n), device="cpu")
    mesh_t = make_training_mesh(_train_mesh_config(n), device="cpu")
    res["mesh.shapes"] = np.array([m.shape for m in
                                   (mesh_sp, mesh_pp, mesh_ep, mesh_t)])
    res["mesh.names"] = np.array(mesh_t.mesh_dim_names)
    res["mesh.local"] = np.array([mesh_t.get_local_rank(a)
                                  for a in tmesh.AXIS_ORDER])
    _hierarchical(mesh_t, r, res)
    _ring_and_ulysses(mesh_sp, res)
    _pipeline(mesh_pp, res)
    _moe(mesh_ep, r, moe_params_from_jax(
        {k[4:]: ref[k] for k in ref.files if k.startswith("moe.")}), res)
    _train(mesh_t, {k[6:]: torch.from_numpy(ref[k]) for k in ref.files
                    if k.startswith("model.")}, res)
    hvd.barrier()
    hvd.shutdown()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)
    print("RESULT " + json.dumps({"rank": r}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _result_line(p, deadline):
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            p.kill()
            raise AssertionError("no RESULT line before the time limit:\n"
                                 + p.stderr.read()[-4000:])
        ready, _, _ = select.select([p.stdout], [], [], left)
        if not ready:
            continue
        line = p.stdout.readline()
        if not line:
            p.kill()
            raise AssertionError(p.stderr.read()[-4000:])
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])


def _start(n, args, script=None):
    """``n`` ranks of ``script`` (default: this file) with ``args``."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HVD_TPU_SIZE=str(n), HVD_TPU_RANK=str(rank),
                   HVD_TPU_LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, script or os.path.abspath(__file__)]
            + list(args),
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def _finish(procs, timeout):
    """Every rank's RESULT line, by rank; every rank must exit 0."""
    deadline = time.monotonic() + timeout
    try:
        results = [_result_line(p, deadline) for p in procs]
        for p in procs:
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    return sorted(results, key=lambda r: r["rank"])


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_mesh(n, *names_and_sizes):
    import jax
    from jax.sharding import Mesh
    names = tuple(a for a, _ in names_and_sizes)
    sizes = tuple(s for _, s in names_and_sizes)
    return Mesh(np.array(jax.devices()[:n]).reshape(sizes), names)


@functools.lru_cache(maxsize=None)
def _jax_attention():
    """{name: (out, dq, dk, dv)} of the JAX ring and Ulysses over sp = 4,
    global arrays. Every sp gives exact attention of the global sequence,
    so the n = 2 world is held to these too."""
    n = 4

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    jring = importlib.import_module("horovod_tpu.parallel.ring_attention")
    from horovod_tpu.parallel.ulysses import ulysses_attention as julysses
    mesh = _jax_mesh(n, ("sp", n))
    q, k, v, w = (jnp.asarray(x) for x in _attn_inputs())
    spec = P(None, "sp")
    fns = {}
    for c, tag in ((True, "causal"), (False, "full")):
        fns[f"ring_flash_{tag}"] = (functools.partial(
            jring.ring_attention_flash, axis_name="sp", causal=c,
            interpret=True, block_q=8, block_k=8), False)
        fns[f"ring_xla_{tag}"] = (functools.partial(
            jring.ring_attention, axis_name="sp", causal=c, impl="xla"),
            True)
        fns[f"ulysses_{tag}"] = (functools.partial(
            julysses, axis_name="sp", causal=c), True)
    out = {}
    for name, (fn, check) in fns.items():
        sharded = jax.shard_map(
            fn, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=check)

        def loss(a, b, d, sharded=sharded):
            o = sharded(a, b, d)
            return jnp.sum(o * w), o
        (_, o), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        out[name] = [np.asarray(x) for x in (o,) + grads]
    return out


def _jax_pipeline(n):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.parallel import pipeline_apply as jpipe
    mesh = _jax_mesh(n, ("pp", n))
    w, x = _pipe_inputs(n)

    def loss(wv):
        out = jpipe(lambda p, h: jnp.tanh(h @ p["w"]), {"w": wv},
                    jnp.asarray(x), mesh, "pp")
        return jnp.sum(out ** 2), out
    (_, out), dw = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(w))
    return np.asarray(out), np.asarray(dw)


def _jax_moe(n, params):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.parallel import moe_mlp as jmoe
    mesh = _jax_mesh(n, ("ep", n))
    x = np.concatenate([_moe_inputs(r)[0] for r in range(n)])
    wy = np.concatenate([_moe_inputs(r)[1] for r in range(n)])
    f = jax.shard_map(lambda a, g, wi, wo: jmoe(a, g, wi, wo, "ep"),
                      mesh=mesh, in_specs=(P("ep"), P(), P("ep"), P("ep")),
                      out_specs=P("ep"))

    def loss(a, g, wi, wo):
        y = f(a, g, wi, wo)
        return jnp.sum(y * wy), y
    args = [jnp.asarray(x)] + [params[k] for k in ("gate_w", "w_in",
                                                   "w_out")]
    (_, y), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    return [np.asarray(y)] + [np.asarray(g) for g in grads]


def _jax_hierarchical(n):
    import jax
    from jax.sharding import PartitionSpec as P

    from horovod_tpu import parallel as jpar
    dp = n // 2
    mesh = _jax_mesh(n, ("outer", dp), ("inner", 2))
    x = np.concatenate([_hier_input(r) for r in range(n)])
    spec = P(("outer", "inner"))
    out = {}
    for name, fn in (
            ("dim0", lambda a: jpar.hierarchical_allreduce(a, "inner",
                                                           "outer")),
            ("dim1", lambda a: jpar.hierarchical_allreduce(
                a, "inner", "outer", scatter_dimension=1)),
            ("pmean", lambda a: jpar.hierarchical_pmean(a, "inner",
                                                        "outer"))):
        out[name] = np.asarray(jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=spec, out_specs=spec))(x)).reshape(
                n, 4, 6)
    return out


def _jax_init_params():
    """The JAX transformer's initial parameters (as its train step makes
    them: PRNGKey(0)), flattened to the port's state_dict names."""
    import jax
    import jax.numpy as jnp
    from flax.linen import meta

    from horovod_tpu.models import transformer as jtr
    from horovod_tpu_torch.models import params_from_flax
    model = jtr.Transformer(jtr.TransformerConfig(**TINY, dtype=jnp.float32))
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, TINY["max_seq_len"]), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray,
                                    meta.unbox(variables["params"]))
    return params_from_flax(params)


@functools.lru_cache(maxsize=None)
def _jax_train(kind):
    """Losses and final parameters of the JAX package's train step on the
    dp 2 x sp 2 mesh, from PRNGKey(0)'s weights. The step computes the
    global batch's loss whatever the mesh, so the n = 2 world's dp 1 x
    sp 2 steps are held to it too."""
    n = 4
    import jax
    import jax.numpy as jnp

    from horovod_tpu import parallel as jpar
    from horovod_tpu.models import TransformerConfig as JCfg
    from horovod_tpu.parallel.train import make_transformer_train_step as mk
    from horovod_tpu_torch.models import params_from_flax
    cfg = JCfg(**TINY, dtype=jnp.float32)
    mc = _train_mesh_config(n)
    mesh = jpar.make_training_mesh(jpar.MeshConfig(dp=mc.dp, sp=mc.sp),
                                   devices=jax.devices()[:n])
    bundle = mk(cfg, mesh, attention_kind=kind)
    p, s = bundle.params, bundle.opt_state
    losses = []
    for step in range(TRAIN_STEPS):
        d = _train_data(step).astype(np.int32)
        tok = jax.device_put(jnp.asarray(d[:, :-1]), bundle.batch_sharding)
        tgt = jax.device_put(jnp.asarray(d[:, 1:]), bundle.batch_sharding)
        p, s, loss = bundle.step(p, s, tok, tgt)
        losses.append(float(loss))
    from flax.linen import meta
    final = params_from_flax(jax.tree_util.tree_map(
        np.asarray, meta.unbox(p)))
    return np.array(losses), final


# ---------------------------------------------------------------------------
# the worlds: spawned once per size, then held against JAX piece by piece
# ---------------------------------------------------------------------------

_WORLDS = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """world(n) -> (per-rank results, JAX references), run once per n."""
    import jax

    from horovod_tpu.parallel import MoEMlp as JMoE

    def get(n):
        if n in _WORLDS:
            return _WORLDS[n]
        out_dir = str(tmp_path_factory.mktemp(f"world{n}"))
        _, D, Hd, E_local = MOE
        moe = jax.tree_util.tree_map(
            np.asarray, JMoE(D, Hd, E_local * n).init(jax.random.PRNGKey(1)))
        state = _jax_init_params()
        np.savez(os.path.join(out_dir, "inputs.npz"),
                 **{f"moe.{k}": v for k, v in moe.items()},
                 **{f"model.{k}": v.numpy() for k, v in state.items()})
        procs = _start(n, ["world", out_dir])
        # the JAX references, computed while the world runs
        ref = types.SimpleNamespace(
            attention=_jax_attention(), pipeline=_jax_pipeline(n),
            moe=_jax_moe(n, moe), hierarchical=_jax_hierarchical(n),
            train={k: _jax_train(k) for k in ("ring", "ulysses")})
        _finish(procs, timeout=240)
        ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                 for r in range(n)]
        _WORLDS[n] = (ranks, ref)
        return _WORLDS[n]
    return get


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def _sp_block(x, my, n):
    s = x.shape[1] // n
    return x[:, my * s:(my + 1) * s]


@pytest.mark.parametrize("n", [4, 2])
def test_world_mesh(world, n):
    import jax

    from horovod_tpu import parallel as jpar
    ranks, _ = world(n)
    mc = _train_mesh_config(n)
    for r, res in enumerate(ranks):
        assert res["mesh.shapes"].tolist() == [
            [1, 1, 1, 1, n, 1], [1, 1, n, 1, 1, 1], [1, 1, 1, n, 1, 1],
            [mc.dp, 1, 1, 1, mc.sp, 1]]
        assert tuple(res["mesh.names"]) == jpar.mesh_utils.AXIS_ORDER
        # rank = dp_index * sp + sp_index (dp outermost)
        assert res["mesh.local"].tolist() == [r // 2, 0, 0, 0, r % 2, 0]
        for name, cfg in (("tp3", jpar.MeshConfig(tp=3)),
                          ("oversized", jpar.MeshConfig(dp=n, tp=2))):
            with pytest.raises(ValueError) as e:
                jpar.make_training_mesh(cfg, devices=jax.devices()[:n])
            assert str(res[f"mesh_error.{name}"]) == str(e.value)


@pytest.mark.parametrize("n", [4, 2])
def test_world_hierarchical(world, n):
    ranks, ref = world(n)
    for r, res in enumerate(ranks):
        for name in ("dim0", "dim1", "pmean"):
            _close(res[f"hier.{name}"], ref.hierarchical[name][r])


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("name", [
    "ring_flash_causal", "ring_flash_full", "ring_xla_causal",
    "ring_xla_full", "ulysses_causal", "ulysses_full"])
def test_world_attention(world, n, name):
    ranks, ref = world(n)
    want = ref.attention[name]
    for my, res in enumerate(ranks):
        for key, w in zip(("out", "dq", "dk", "dv"), want):
            _close(res[f"{name}.{key}"], _sp_block(w, my, n))


@pytest.mark.parametrize("n", [4, 2])
def test_world_ring_remat_and_ulysses_error(world, n):
    """The ring with grad enabled (each step under checkpoint, recomputed
    in backward) gives the same output as without grad (no checkpoint);
    Ulysses refuses heads that do not divide by sp with the JAX
    message."""
    ranks, _ = world(n)
    for res in ranks:
        np.testing.assert_array_equal(res["ring_flash_causal_nograd.out"],
                                      res["ring_flash_causal.out"])
        assert str(res["ulysses_error"]) == (
            f"num_heads 3 not divisible by 'sp' axis size {n}; use "
            f"ring_attention instead")


@pytest.mark.parametrize("n", [4, 2])
def test_world_pipeline(world, n):
    ranks, ref = world(n)
    out, dw = ref.pipeline
    for idx, res in enumerate(ranks):
        _close(res["pipe.out"], out)
        _close(res["pipe.dw"], dw[idx])
        assert float(res["pipe.dw_other_rows"]) == 0.0


@pytest.mark.parametrize("n", [4, 2])
def test_world_moe(world, n):
    ranks, ref = world(n)
    y, dx, dgate, dw_in, dw_out = ref.moe
    T, E_local = MOE[0], MOE[3]
    for r, res in enumerate(ranks):
        rows = slice(r * T, (r + 1) * T)
        experts = slice(r * E_local, (r + 1) * E_local)
        _close(res["moe.y"], y[rows])
        _close(res["moe.dx"], dx[rows])
        _close(res["moe.dw_in"], dw_in[experts])
        _close(res["moe.dw_out"], dw_out[experts])
    # the router's weights are replicated: its gradient is the sum of the
    # ranks' shares
    _close(sum(res["moe.dgate"] for res in ranks), dgate)


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_world_train_step(world, n, kind):
    ranks, ref = world(n)
    losses, final = ref.train[kind]
    for res in ranks:
        _close(res[f"train_{kind}.losses"], losses)
        for name, want in final.items():
            _close(res[f"train_{kind}.param.{name}"], want.numpy())
    assert abs(losses[0] - np.log(TINY["vocab_size"])) < 1.0


# ---------------------------------------------------------------------------
# one process: host logic against the JAX package
# ---------------------------------------------------------------------------

def _outcome(fn, *args, **kwargs):
    """What a call gives: its result (dataclasses as dicts) or its error's
    type name and message."""
    try:
        got = fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return ("error", type(e).__name__, str(e))
    if dataclasses.is_dataclass(got):
        return ("ok", type(got).__name__, dataclasses.asdict(got))
    return ("ok", type(got).__name__, got)


def _cfg(**kw):
    return kw


RESHAPE_CASES = [
    # (mesh config, survivors, policy)
    (_cfg(dp=-1), 8, "shrink"),
    (_cfg(dp=-1, fsdp=2, tp=2), 8, "shrink"),
    (_cfg(dp=-1, fsdp=4), 6, "shrink"),
    (_cfg(dp=-1, fsdp=4), 6, "strict"),
    (_cfg(dp=2, fsdp=2, tp=2), 8, "shrink"),
    (_cfg(dp=2, fsdp=2, tp=2), 8, "strict"),
    (_cfg(dp=4, fsdp=1, sp=2), 6, "shrink"),
    (_cfg(dp=4, fsdp=1, sp=2), 7, "shrink"),
    (_cfg(dp=4, fsdp=1, sp=2), 7, "degrade"),
    (_cfg(dp=4, fsdp=1, sp=2), 6, "strict"),
    (_cfg(dp=2, fsdp=2, pp=2), 12, "shrink"),
    (_cfg(dp=2, fsdp=4, pp=2), 12, "shrink"),
    (_cfg(dp=2, fsdp=4, pp=2), 12, "degrade"),
    (_cfg(dp=2, fsdp=4, pp=2), 5, "degrade"),
    (_cfg(dp=1, fsdp=3, ep=2), 2, "degrade"),
    (_cfg(dp=2, tp=4), 3, "shrink"),
    (_cfg(dp=2, tp=4), 3, "degrade"),
    (_cfg(dp=2, tp=4), 12, "shrink"),
    (_cfg(dp=2, tp=4), 16, "strict"),
    (_cfg(dp=2), 4, "elastic"),
    (_cfg(dp=-1, fsdp=3), 0, "shrink"),
]


@pytest.mark.parametrize("case", RESHAPE_CASES, ids=lambda c: str(c))
def test_plan_reshape_matches_jax(case):
    from horovod_tpu.parallel import mesh_utils as jmesh
    cfg, survivors, policy = case
    want = _outcome(jmesh.plan_reshape, jmesh.MeshConfig(**cfg), survivors,
                    policy)
    got = _outcome(tmesh.plan_reshape, tmesh.MeshConfig(**cfg), survivors,
                   policy)
    assert got == want


@pytest.mark.parametrize("policy", ["degrade", "strict", "bogus"])
def test_plan_reshape_default_policy_knob(monkeypatch, policy):
    from horovod_tpu.parallel import mesh_utils as jmesh
    monkeypatch.setenv("HVD_TPU_MESH_RESHAPE_POLICY", policy)
    for cfg, survivors in ((_cfg(dp=4, sp=2), 7), (_cfg(dp=2), 4)):
        want = _outcome(jmesh.plan_reshape, jmesh.MeshConfig(**cfg),
                        survivors)
        got = _outcome(tmesh.plan_reshape, tmesh.MeshConfig(**cfg),
                       survivors)
        assert got == want


HOST_CASES = [
    ("mesh_config_from_spec", ("dp=2,fsdp=2",)),
    ("mesh_config_from_spec", (" dp=-1 , tp=4 ,",)),
    ("mesh_config_from_spec", ("pp=2,ep=2,sp=2",)),
    ("mesh_config_from_spec", ("",)),
    ("mesh_config_from_spec", ("  ",)),
    ("mesh_config_from_spec", ("dp=2,xx=3",)),
    ("mesh_config_from_spec", ("dp",)),
    ("mesh_config_from_spec", ("dp=two",)),
    ("replica_groups", (8, 2)),
    ("replica_groups", (8, 8)),
    ("replica_groups", (12, 3)),
    ("replica_groups", (8, 3)),
    ("replica_groups", (8, 0)),
    ("replica_groups", (0, 1)),
    ("replica_group_of", (5, 8, 2)),
    ("replica_group_of", (7, 12, 3)),
    ("replica_group_of", (3, 8, 3)),
    ("mesh_total", ("config", dict(dp=2, fsdp=2, sp=2))),
    ("mesh_total", ("config", dict(dp=-1, tp=2))),
]


@pytest.mark.parametrize("name,args", HOST_CASES,
                         ids=[f"{n}{a}" for n, a in HOST_CASES])
def test_mesh_host_logic_matches_jax(name, args):
    from horovod_tpu.parallel import mesh_utils as jmesh
    if args and args[0] == "config":
        jargs = (jmesh.MeshConfig(**args[1]),)
        targs = (tmesh.MeshConfig(**args[1]),)
    else:
        jargs = targs = args
    assert _outcome(getattr(tmesh, name), *targs) == \
        _outcome(getattr(jmesh, name), *jargs)


def test_mesh_constants_match_jax():
    from horovod_tpu.parallel import mesh_utils as jmesh
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.RESHAPE_POLICIES == jmesh.RESHAPE_POLICIES
    assert tmesh.TRANSFORMER_RULES == jmesh.TRANSFORMER_RULES
    assert [f.name for f in dataclasses.fields(tmesh.MeshConfig)] == \
        [f.name for f in dataclasses.fields(jmesh.MeshConfig)]
    assert dataclasses.asdict(tmesh.MeshConfig()) == \
        dataclasses.asdict(jmesh.MeshConfig())
    assert issubclass(tmesh.MeshShapeError, ValueError)


@pytest.mark.parametrize("axes", [("sp",), ("dp", "tp"), ("sq",),
                                  ("pp", "xp", "ep")])
def test_require_axes_matches_jax(axes):
    from horovod_tpu.parallel import mesh_utils as jmesh
    jm = types.SimpleNamespace(axis_names=jmesh.AXIS_ORDER)
    tm = types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_ORDER)
    assert _outcome(tmesh.require_axes, tm, *axes) == \
        _outcome(jmesh.require_axes, jm, *axes)


ROUTE_CASES = [
    # (tokens, experts, capacity, integer logits (ties))
    (16, 4, 3, False),
    (16, 4, 2, True),
    (9, 3, 9, True),
    (32, 8, 1, False),
    (5, 2, 4, True),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: str(c))
def test_route_top1_matches_jax(case):
    import jax.numpy as jnp

    from horovod_tpu.parallel import route_top1 as jroute
    T, E, C, ties = case
    rng = np.random.RandomState(T * 100 + E)
    logits = (rng.randint(0, 3, (T, E)) if ties
              else rng.randn(T, E)).astype(np.float32)
    jd, jc = (np.asarray(x) for x in jroute(jnp.asarray(logits), C))
    td, tc = (x.numpy() for x in route_top1(torch.from_numpy(logits), C))
    assert td.shape == tc.shape == (T, E, C)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, atol=TOL_COMBINE, rtol=0)
    if ties:
        # a tie goes to the lowest expert index
        row = np.flatnonzero(logits.max(-1) == logits[:, 0])
        kept = row[jd[row].sum((1, 2)) > 0]
        assert (jd[kept, 0].sum(-1) == 1).all()


def test_route_top1_capacity_example():
    # the JAX package's own example: tokens 0, 1 fill expert 0, token 2 is
    # dropped, token 3 takes expert 1's first slot
    logits = torch.tensor([[5.0, 0.0], [4.0, 0.0], [3.0, 0.0], [0.0, 2.0]])
    d, c = route_top1(logits, capacity=2)
    assert d[0, 0, 0] == 1 and d[1, 0, 1] == 1 and d[3, 1, 0] == 1
    assert d[2].sum() == 0 and 0 < c[0, 0, 0] <= 1


def test_moe_params_from_jax_round_trip_and_errors():
    import jax

    from horovod_tpu.parallel import MoEMlp as JMoE
    params = jax.tree_util.tree_map(
        np.asarray, JMoE(8, 16, 4).init(jax.random.PRNGKey(0)))
    got = moe_params_from_jax(params)
    for k, v in params.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
        assert got[k].dtype == torch.float32
    with pytest.raises(ValueError, match="leaves"):
        moe_params_from_jax({**params, "bias": np.zeros(3)})
    with pytest.raises(ValueError, match="do not agree"):
        moe_params_from_jax({**params, "w_out": np.zeros((4, 8, 8))})
    from horovod_tpu_torch.parallel import MoEMlp
    layer = MoEMlp(8, 16, 4)
    fresh = layer.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: v.shape for k, v in params.items()}
    assert abs(float(fresh["w_in"].std()) - 0.02) < 0.005


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_local_matches_jax_ring(n, causal, monkeypatch):
    """The one-process driver of the ring (every position's blocks held
    here, as chip_smoke.py drives it) against the JAX ring: output and
    gradients. Every step is checkpointed: backward runs the kernel's
    call again, once per step (n * n in all), on the CPU as on the card."""
    ref = _jax_attention()[f"ring_flash_{'causal' if causal else 'full'}"]
    qs, ks, vs, ws = ([_t(_sp_block(x, j, n), True) for j in range(n)]
                      for x in _attn_inputs())
    blocks = list(zip(ks, vs))
    ra = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")
    calls = []
    kernel = ra.flash_attention_with_lse

    def counted(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return kernel(*args, **kwargs)
    monkeypatch.setattr(ra, "flash_attention_with_lse", counted)
    outs = [ring_attention_local(qs[j], blocks, j, causal=causal)
            for j in range(n)]
    assert len(calls) == n * n
    sum((o * ws[j].detach()).sum() for j, o in enumerate(outs)).backward()
    assert len(calls) == 2 * n * n
    got = [torch.cat(xs, dim=1).detach().numpy() for xs in
           (outs, [x.grad for x in qs], [x.grad for x in ks],
            [x.grad for x in vs])]
    for a, b in zip(got, ref):
        _close(a, b)
    with pytest.raises(ValueError, match="out of range"):
        ring_attention_local(qs[0], blocks, n)


class _FakeMesh:
    """The DeviceMesh surface the port reads: dim names, shape, this
    rank's index on each dim and the device type."""

    def __init__(self, device_type="cpu", **sizes):
        self.mesh_dim_names = tmesh.AXIS_ORDER
        self.shape = tuple(sizes.pop(a, 1) for a in tmesh.AXIS_ORDER)
        self.local = {a: sizes.pop(f"{a}_index", 0) for a in tmesh.AXIS_ORDER}
        self.device_type = device_type
        assert not sizes, sizes

    def get_local_rank(self, axis):
        return self.local[axis]


@pytest.mark.parametrize("sizes,want", [
    (dict(dp=2, sp=2, dp_index=1, sp_index=0), (slice(4, 8), slice(0, 8))),
    (dict(dp=2, fsdp=2, sp=2, dp_index=1, fsdp_index=1, sp_index=1),
     (slice(6, 8), slice(8, 16))),
    (dict(pp=2, ep=2, sp=4, pp_index=1, sp_index=3),
     (slice(0, 8), slice(12, 16))),
])
def test_batch_spec_blocks(sizes, want):
    assert tmesh.batch_spec(_FakeMesh(**sizes), 8, 16) == want


def test_batch_spec_and_train_step_refusals():
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.batch_spec(_FakeMesh(dp=3), 8, 16)
    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    # tp and fsdp shard the parameters; a dim that does not divide by its
    # axis is refused before any process group is made
    for sizes, err in ((dict(tp=3), "mesh axis 'tp' of size 3"),
                       (dict(fsdp=3), "mesh axis 'fsdp' of size 3")):
        with pytest.raises(ValueError, match=err):
            make_transformer_train_step(cfg, device="cpu",
                                        mesh=_FakeMesh(**sizes))
    with pytest.raises(ValueError, match="not divisible by sp=3"):
        make_transformer_train_step(cfg, device="cpu", mesh=_FakeMesh(sp=3))
    with pytest.raises(ValueError, match="mesh is on cuda"):
        make_transformer_train_step(cfg, device="cpu",
                                    mesh=_FakeMesh("cuda"))
    with pytest.raises(ValueError, match="attention_kind"):
        make_transformer_train_step(cfg, device="cpu", mesh=_FakeMesh(),
                                    attention_kind="tree")
    with pytest.raises(ValueError, match="cannot run on a sequence shard"):
        make_transformer_train_step(cfg, device="cpu", mesh=_FakeMesh(sp=2),
                                    attention="default")
    with pytest.raises(ValueError, match="axis name"):
        tmesh.require_axes(_FakeMesh(), "sp", "zz")


def test_mesh_of_one_trains_as_the_plain_step():
    """sp = 1: no sharded attention, the flash step on the whole batch;
    the mesh step's losses are the plain step's."""
    from horovod_tpu_torch.parallel import sharded_attention
    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    data = [torch.from_numpy(_train_data(s)) for s in range(2)]
    hvd.init(device="cpu")
    try:
        mesh = make_training_mesh(MeshConfig(), device="cpu")
        assert mesh.shape == (1,) * 6
        assert sharded_attention(mesh) is None
        losses = []
        for m in (None, mesh):
            b = make_transformer_train_step(cfg, device="cpu", mesh=m)
            losses.append([b.step(d[:, :-1], d[:, 1:]).item() for d in data])
            b.optimizer.remove_hooks()
        assert losses[0] == losses[1]
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    sys.exit(_world_worker(sys.argv[2]) if sys.argv[1] == "world" else 2)
