"""The port's checkpointing (horovod_tpu_torch.checkpointing, the
checkpoint facade, faults and the metrics registry they use) against the
JAX package's.

In one process:
* ``layout`` and ``gc``: exactly the JAX package's results on the same
  inputs (names, discovery, retention, GC passes over identical trees);
* the manager: sync and async save, restore, retention GC, the
  preemption drain, fallback past a corrupt step, and IntegrityError on a
  coverage gap, a bad checksum and a missing shard; the
  ``checkpoint.write``/``manifest``/``gc`` fault sites and the
  ``worker.mesh`` site of the mesh step;
* across packages: trees with fp32 and bf16 leaves (and the transformer's
  parameter tree) saved by one package restore in the other bit for bit,
  both ways.

Across processes: run as a script, this file is the worker of a gloo
world of 4. It trains the tiny transformer 2 steps on dp 2 x fsdp 2,
saves the train state (parameters and AdamW state, block by block), and
restores it onto dp 4, fsdp 4 and fsdp 2 x tp 2 and onto a fresh dp 2 x
fsdp 2 bundle; the tests hold every restored state to the saved one bit
for bit (gathered to global arrays), and the resumed steps on the same
mesh to the uninterrupted ones (``torch.equal`` of the losses).

JAX is imported inside the tests, so the module also imports where JAX is
absent.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import checkpoint as tfacade  # noqa: E402
from horovod_tpu_torch import checkpointing as tcp  # noqa: E402
from horovod_tpu_torch import faults as tfaults  # noqa: E402
from horovod_tpu_torch import metrics as tmetrics  # noqa: E402
from horovod_tpu_torch.checkpointing import gc as tgc  # noqa: E402
from horovod_tpu_torch.checkpointing import layout as tlayout  # noqa: E402
from horovod_tpu_torch.checkpointing import snapshot as tsnap  # noqa: E402
from horovod_tpu_torch.models import (  # noqa: E402
    TransformerConfig, params_to_flax)
from horovod_tpu_torch.parallel import (  # noqa: E402
    MeshConfig, make_training_mesh, make_transformer_train_step,
    restore_mesh_train_state, run_mesh_step, save_mesh_train_state,
    train_state_tree)

N = 4
TINY = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
            head_dim=8, max_seq_len=16)
SAVE_MESH = dict(dp=2, fsdp=2)
#: label -> mesh sizes a world of 4 restores the saved state onto
RESTORE_MESHES = {"dp4": dict(dp=4), "fsdp4": dict(dp=1, fsdp=4),
                  "fsdp2_tp2": dict(dp=1, fsdp=2, tp=2),
                  "same": SAVE_MESH}


def _counter(name):
    return tmetrics.snapshot().get(name, 0.0)


@pytest.fixture
def no_faults():
    tfaults.configure("")
    yield tfaults
    tfaults.configure("")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"dense": torch.randn(4, 3, generator=g),
                       "emb": torch.randn(6, 2, generator=g).to(
                           torch.bfloat16)},
            "opt": [torch.arange(5), (torch.tensor(2.5), None)],
            "count": 7}


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# layout and gc: the JAX package's results on the same inputs
# ---------------------------------------------------------------------------

def test_layout_constants_and_names_match_jax():
    from horovod_tpu.checkpointing import layout as jlayout
    for name in ("FORMAT", "MANIFEST_NAME", "COMMIT_NAME", "SHARDS_DIR",
                 "COMMITTED", "PARTIAL", "LEGACY"):
        assert getattr(tlayout, name) == getattr(jlayout, name)
    for args in ((0, ()), (3, (0, 8)), (12, (16,)), (99999, (1, 2, 3))):
        assert tlayout.shard_filename(*args) == jlayout.shard_filename(*args)
    for name in ("step_0000000042", "step_7", "step_x", "tmp", "step_"):
        assert tlayout.parse_step(name) == jlayout.parse_step(name)
    assert tlayout.step_dir("/d", 42) == jlayout.step_dir("/d", 42)
    assert tlayout.crc32(b"hvd") == jlayout.crc32(b"hvd")


@pytest.mark.parametrize("steps,keep,period", [
    ([1, 2, 3, 4, 5], 0, 0), ([1, 2, 3, 4, 5], 2, 0),
    ([10, 20, 30, 40, 50], 1, 20), ([3, 1, 2], 0, 2), ([], 3, 3),
    ([5, 7, 9, 11], 3, 4), ([4], 1, 1)])
def test_retained_steps_match_jax(steps, keep, period):
    from horovod_tpu.checkpointing import gc as jgc
    assert tgc.retained_steps(steps, keep, period) == \
        jgc.retained_steps(steps, keep, period)


def _fake_steps(root):
    """Step directories of every kind: committed, partial (crashed save)
    and legacy (orbax)."""
    for step, kind in ((1, "c"), (2, "c"), (3, "p"), (4, "l"), (5, "c"),
                       (6, "c"), (7, "p"), (9, "c")):
        path = os.path.join(root, f"step_{step:010d}")
        os.makedirs(os.path.join(path, "shards") if kind != "l" else path)
        if kind == "c":
            crc = tlayout.write_manifest(path, {"format": tlayout.FORMAT})
            tlayout.write_commit(path, step, crc)
        elif kind == "l":
            open(os.path.join(path, "checkpoint"), "w").close()
    os.makedirs(os.path.join(root, "unrelated"))


@pytest.mark.parametrize("keep,period", [(0, 0), (2, 0), (1, 3), (0, 5)])
def test_discovery_and_gc_match_jax(tmp_path, keep, period):
    from horovod_tpu.checkpointing import gc as jgc
    from horovod_tpu.checkpointing import layout as jlayout
    roots = [str(tmp_path / "t"), str(tmp_path / "j")]
    for r in roots:
        _fake_steps(r)
    t, j = roots
    assert tlayout.all_step_dirs(t) == jlayout.all_step_dirs(j)
    assert tlayout.completed_steps(t) == jlayout.completed_steps(j)
    assert tlayout.latest_step(t) == jlayout.latest_step(j)
    assert [tlayout.classify(tlayout.step_dir(t, s))
            for s in tlayout.all_step_dirs(t)] == \
        [jlayout.classify(jlayout.step_dir(j, s))
         for s in jlayout.all_step_dirs(j)]
    assert tgc.collect(t, keep, period) == jgc.collect(j, keep, period)
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))


def test_manifest_checks_match_jax(tmp_path):
    from horovod_tpu.checkpointing import layout as jlayout
    path = str(tmp_path)
    crc = tlayout.write_manifest(path, {"format": "other"})
    tlayout.write_commit(path, 3, crc)
    for mod in (tlayout, jlayout):
        with pytest.raises(mod.IntegrityError, match="unknown checkpoint"):
            mod.read_manifest(path)
    tlayout.write_commit(path, 3, crc ^ 1)
    for mod in (tlayout, jlayout):
        with pytest.raises(mod.IntegrityError, match="checksum mismatch"):
            mod.read_manifest(path)
    assert tlayout.read_commit(path) == jlayout.read_commit(path)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def test_save_restore_sync_and_async(tmp_path, no_faults):
    mgr = tcp.CheckpointManager(str(tmp_path))
    trees = {s: _tree(s) for s in (1, 2, 3)}
    mgr.save(1, trees[1], async_=False)
    mgr.save(2, trees[2])
    mgr.save(3, trees[3])
    mgr.wait_until_finished()
    assert mgr.all_steps() == [3, 2, 1] and mgr.latest_step() == 3
    _same(mgr.restore(), trees[3])
    _same(mgr.restore(step=2), trees[2])
    _same(mgr.restore(step=1, target=trees[3]), trees[1])
    with pytest.raises(FileExistsError):
        mgr.save(3, trees[3])
    mgr.save(3, trees[1], force=True, async_=False)
    _same(mgr.restore(step=3), trees[1])
    with pytest.raises(FileNotFoundError):
        mgr.restore(step=8)
    with pytest.raises(tcp.IntegrityError, match="leaves"):
        mgr.restore(step=1, target={"only": torch.zeros(1)})
    path = tlayout.step_dir(str(tmp_path), 3)
    assert sorted(os.listdir(path)) == ["COMMIT", "manifest.json", "shards"]
    mgr.close()


def test_retention_gc_and_drain(tmp_path, no_faults):
    before = _counter("hvd_tpu_checkpoint_gc_removed_total")
    mgr = tcp.CheckpointManager(str(tmp_path), keep=2, keep_period=4)
    for s in range(1, 7):
        mgr.save(s, _tree(s))
    mgr.wait_until_finished()
    assert mgr.all_steps() == [6, 5, 4]
    assert _counter("hvd_tpu_checkpoint_gc_removed_total") == before + 3
    # the drain persists a newer step, and only once
    assert mgr.drain_for_preemption(7, _tree(7)) == 7
    assert mgr.drain_for_preemption(7, _tree(8)) == 7
    _same(mgr.restore(step=7), _tree(7))
    assert mgr.drain_for_preemption() == 7


def _shard_files(path):
    shards = os.path.join(path, "shards")
    return sorted(os.path.join(shards, f) for f in os.listdir(shards)
                  if f.endswith(".bin"))


def test_fallback_past_a_corrupt_step(tmp_path, no_faults):
    mgr = tcp.CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1), async_=False)
    mgr.save(2, _tree(2), async_=False)
    f = _shard_files(tlayout.step_dir(str(tmp_path), 2))[0]
    data = bytearray(open(f, "rb").read())
    data[0] ^= 0xFF
    open(f, "wb").write(bytes(data))
    with pytest.raises(tcp.IntegrityError, match="checksum mismatch"):
        mgr.restore()
    integrity = _counter("hvd_tpu_checkpoint_integrity_failures_total")
    fallbacks = _counter("hvd_tpu_checkpoint_fallbacks_total")
    _same(mgr.restore(fallback=True), _tree(1))
    assert _counter("hvd_tpu_checkpoint_fallbacks_total") == fallbacks + 1
    assert _counter("hvd_tpu_checkpoint_integrity_failures_total") == \
        integrity + 1
    # the corrupt step was demoted: discovery no longer offers it
    assert mgr.all_steps() == [1]


def test_missing_shard_and_coverage_gap_raise(tmp_path, no_faults):
    mgr = tcp.CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1), async_=False)
    os.unlink(_shard_files(tlayout.step_dir(str(tmp_path), 1))[1])
    with pytest.raises(tcp.IntegrityError, match="missing shard"):
        mgr.restore(step=1)
    manifest = {"dtype": "float32", "shape": [4, 2], "path": "['w']",
                "shards": [{"shape": [2, 2], "starts": [0, 0],
                            "file": "s0"}]}
    payload = np.arange(4, dtype=np.float32).tobytes()
    with pytest.raises(tcp.IntegrityError, match="cover 4 of 8"):
        tsnap.assemble_array(manifest, lambda s: payload)
    with pytest.raises(tcp.IntegrityError, match="payload holds 3"):
        tsnap.assemble_array(manifest, lambda s: payload[:12])
    bf = {"dtype": "bfloat16", "shape": [2], "path": "['b']",
          "shards": [{"shape": [2], "starts": [0], "file": "s"}]}
    got = tsnap.assemble_array(bf, lambda s: b"\x80\x3f\x00\xc0")
    assert got.dtype == torch.bfloat16 and got.tolist() == [1.0, -2.0]


def test_write_fault_abandons_the_step(tmp_path, no_faults):
    no_faults.configure("checkpoint.write:crash:once")
    mgr = tcp.CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1))
    with pytest.raises(tcp.CheckpointWriterCrashed):
        mgr.wait_until_finished()
    assert tlayout.classify(tlayout.step_dir(str(tmp_path), 1)) == \
        tlayout.PARTIAL
    assert mgr.latest_step() is None
    mgr.save(2, _tree(2))          # the writer restarted
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2]


def test_manifest_and_gc_faults(tmp_path, no_faults):
    no_faults.configure("checkpoint.manifest:error:once")
    mgr = tcp.CheckpointManager(str(tmp_path), keep=1)
    with pytest.raises(OSError, match="checkpoint.manifest"):
        mgr.save(1, _tree(1), async_=False)
    assert mgr.latest_step() is None
    no_faults.configure("checkpoint.gc:error")
    mgr.save(2, _tree(2), async_=False)
    mgr.save(3, _tree(3), async_=False)
    # the GC pass failed (logged), the saves did not
    assert mgr.all_steps() == [3, 2]


def test_facade_and_callback(tmp_path, no_faults):
    d = str(tmp_path)
    tfacade.save(d, 5, _tree(5))
    assert tfacade.latest_step(d) == 5 and tfacade._steps(d) == [5]
    _same(tfacade.restore(d), _tree(5))
    cb = tcp.CheckpointCallback(os.path.join(d, "cb"), epochs_per_save=2,
                                async_=True)
    cb.run = types.SimpleNamespace(params={"w": torch.ones(3)})
    logs = {}
    for epoch in range(5):
        cb.on_epoch_end(epoch, logs)
    cb.on_train_end(logs)
    assert logs["checkpoint_step"] == 3
    assert cb.manager.all_steps() == [3, 1]


def test_metric_families_match_jax():
    """The families checkpointing and faults register: the JAX package's
    names, kinds and labels, so both export the same series."""
    import horovod_tpu.checkpointing  # noqa: F401 - registers its families
    import horovod_tpu.faults  # noqa: F401
    from horovod_tpu import metrics as jmetrics
    names = [f.name for f in tmetrics.REGISTRY.families()]
    assert "hvd_tpu_checkpoint_save_seconds" in names
    assert "hvd_tpu_faults_injected_total" in names
    jfam = {f.name: f for f in jmetrics.REGISTRY.families()}
    for fam in tmetrics.REGISTRY.families():
        if fam.name.startswith(("hvd_tpu_checkpoint", "hvd_tpu_faults")):
            want = jfam[fam.name]
            assert (fam.kind, fam.labelnames, fam.help) == \
                (want.kind, want.labelnames, want.help)


def test_fault_spec_grammar_matches_jax():
    from horovod_tpu import faults as jfaults
    for spec in ("worker.mesh:crash:step=4:rank=1",
                 "checkpoint.write:error:rate=0.5:after=2;x:delay=0.1",
                 "a:hang:once", "b:bitflip:times=3"):
        got = [(r.site, r.kind, r.seconds, r.rate, r.after, r.step, r.times,
                r.rank) for r in tfaults.parse_spec(spec)]
        want = [(r.site, r.kind, r.seconds, r.rate, r.after, r.step,
                 r.times, r.rank) for r in jfaults.parse_spec(spec)]
        assert got == want
    for bad in ("nokind", "a:error:zz=1", "a:bogus", "a:rate=x:error"):
        with pytest.raises(jfaults.FaultSpecError) as je:
            jfaults.parse_spec(bad)
        with pytest.raises(tfaults.FaultSpecError) as te:
            tfaults.parse_spec(bad)
        assert str(te.value) == str(je.value)
    assert tfaults.CRASH_EXIT_CODE == jfaults.CRASH_EXIT_CODE


def test_worker_mesh_site_fires_on_configured_step(no_faults):
    """The counterpart of tests/test_mesh_elastic.py TestMeshFaultSite:
    run_mesh_step fires ``worker.mesh`` once per call, before the step."""
    no_faults.configure("worker.mesh:error:step=2", seed=7)
    key = 'hvd_tpu_faults_injected_total{site="worker.mesh",kind="error"}'
    before = _counter(key)
    steps = []
    bundle = types.SimpleNamespace(
        step=lambda tok, tgt: steps.append(tok) or 1.5)
    assert run_mesh_step(bundle, 1, 2) == 1.5      # hit 1: clean
    with pytest.raises(tfaults.InjectedFault):
        run_mesh_step(bundle, 3, 4)                # hit 2: the step
    assert steps == [1] and _counter(key) == before + 1
    assert run_mesh_step(bundle, 5, 6) == 1.5
    rule = tfaults.parse_spec("worker.mesh:crash:step=4:rank=1")[0]
    assert rule.kind == "crash" and rule.step == 4 and rule.rank == 1


# ---------------------------------------------------------------------------
# across packages, bit for bit
# ---------------------------------------------------------------------------

def _jax_tree():
    import ml_dtypes
    rng = np.random.RandomState(3)
    return {"params": {
        "dense": rng.randn(4, 3).astype(np.float32),
        "emb": rng.randn(6, 2).astype(ml_dtypes.bfloat16),
        "inner": {"k": rng.randn(3).astype(np.float32),
                  "h": rng.randn(2, 2).astype(ml_dtypes.bfloat16)}}}


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32)
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x.view(np.int32)


def _torch_like(tree):
    if isinstance(tree, dict):
        return {k: _torch_like(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.itemsize == 2:   # bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_jax_checkpoint_restores_in_the_port(tmp_path, no_faults):
    from horovod_tpu import checkpointing as jcp
    tree = _jax_tree()
    jcp.CheckpointManager(str(tmp_path)).save(3, tree, async_=False)
    mgr = tcp.CheckpointManager(str(tmp_path))
    with_target = mgr.restore(target=_torch_like(
        {"params": {"dense": 0, "emb": 0, "inner": {"k": 0, "h": 0}}}))
    from_paths = mgr.restore(step=3)
    for out in (with_target, from_paths):
        flat = {"dense": out["params"]["dense"], "emb": out["params"]["emb"],
                "k": out["params"]["inner"]["k"],
                "h": out["params"]["inner"]["h"]}
        assert flat["emb"].dtype == flat["h"].dtype == torch.bfloat16
        assert flat["dense"].dtype == torch.float32
        ref = tree["params"]
        for name, want in (("dense", ref["dense"]), ("emb", ref["emb"]),
                           ("k", ref["inner"]["k"]),
                           ("h", ref["inner"]["h"])):
            np.testing.assert_array_equal(_bits(flat[name]), _bits(want))


def test_jax_checkpoint_with_none_and_tuple_raises_or_restores(
        tmp_path, no_faults):
    """The JAX package restores {"a": [x, None, y], "b": (z,)} as it was
    saved; from its leaf paths alone the port cannot (the None leaves no
    path), so it raises and names target=, and with a target it restores
    the exact structure. Without the None, a tuple comes back as a list
    (the documented limit of a restore from paths)."""
    from horovod_tpu import checkpointing as jcp
    rng = np.random.RandomState(4)
    x, y, z = (rng.randn(3).astype(np.float32) for _ in range(3))
    jcp.CheckpointManager(str(tmp_path / "gap")).save(
        1, {"a": [x, None, y], "b": (z,)}, async_=False)
    back = jcp.CheckpointManager(str(tmp_path / "gap")).restore(step=1)
    assert back["a"][1] is None and isinstance(back["b"], tuple)
    mgr = tcp.CheckpointManager(str(tmp_path / "gap"))
    with pytest.raises(ValueError, match="target="):
        mgr.restore(step=1)
    like = {"a": [torch.zeros(3), None, torch.zeros(3)],
            "b": (torch.zeros(3),)}
    out = mgr.restore(step=1, target=like)
    _same(out, {"a": [torch.from_numpy(x), None, torch.from_numpy(y)],
                "b": (torch.from_numpy(z),)})
    jcp.CheckpointManager(str(tmp_path / "full")).save(
        1, {"a": [x, y], "b": (z,)}, async_=False)
    out = tcp.CheckpointManager(str(tmp_path / "full")).restore(step=1)
    _same(out, {"a": [torch.from_numpy(x), torch.from_numpy(y)],
                "b": [torch.from_numpy(z)]})


def test_restore_takes_sharding_in_the_jax_order(tmp_path, no_faults):
    """restore(step, target, sharding, fallback) and
    restore_last_good(target, sharding), as in the JAX package: sharding
    None, given positionally or by keyword, restores as before and leaves
    fallback in its own place; any other sharding, such as a boolean meant
    for fallback or a device, raises ValueError naming the
    target-of-Shards route instead of binding silently."""
    import inspect

    from horovod_tpu import checkpointing as jcp
    for name in ("restore", "restore_last_good"):
        assert list(inspect.signature(getattr(
            tcp.CheckpointManager, name)).parameters) == list(
            inspect.signature(getattr(jcp.CheckpointManager,
                                      name)).parameters)
    assert list(inspect.signature(tcp.restore).parameters) == list(
        inspect.signature(jcp.restore).parameters)
    d = str(tmp_path)
    mgr = tcp.CheckpointManager(d)
    tree = _tree(1)
    mgr.save(1, tree, async_=False)
    _same(mgr.restore(1, tree, None), tree)
    _same(mgr.restore(1, None, None, True), mgr.restore(step=1,
                                                        sharding=None))
    _same(tcp.restore(d, 1, tree, None, True), tree)
    mgr.promote_last_good(1)
    _same(mgr.restore_last_good(tree, None), tree)
    for bad in (True, "cpu", torch.device("cpu"), {"params": None}):
        with pytest.raises(ValueError, match="Shard"):
            mgr.restore(1, None, bad)
        with pytest.raises(ValueError, match="Shard"):
            mgr.restore(step=1, sharding=bad)
        with pytest.raises(ValueError, match="Shard"):
            tcp.restore(d, 1, None, bad)
        with pytest.raises(ValueError, match="Shard"):
            mgr.restore_last_good(None, bad)


def test_port_checkpoint_restores_in_jax(tmp_path, no_faults):
    from horovod_tpu import checkpointing as jcp
    tree = _torch_like(_jax_tree())
    tcp.CheckpointManager(str(tmp_path)).save(4, tree, async_=False)
    target = _jax_tree()
    out = jcp.CheckpointManager(str(tmp_path)).restore(target=target)
    for key in ("dense", "emb"):
        assert np.asarray(out["params"][key]).dtype == target["params"][
            key].dtype
        np.testing.assert_array_equal(_bits(out["params"][key]),
                                      _bits(tree["params"][key]))
    for key in ("k", "h"):
        np.testing.assert_array_equal(_bits(out["params"]["inner"][key]),
                                      _bits(tree["params"]["inner"][key]))


def test_transformer_params_cross_both_ways(tmp_path, no_faults):
    """The JAX transformer's parameter tree, saved by the JAX package,
    restores into the port's train-state params tree (and back)."""
    import jax
    import jax.numpy as jnp
    from flax.linen import meta

    from horovod_tpu import checkpointing as jcp
    from horovod_tpu.models import Transformer as JT
    from horovod_tpu.models import TransformerConfig as JC
    variables = JT(JC(**TINY, dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray,
                                    meta.unbox(variables["params"]))
    jcp.CheckpointManager(str(tmp_path / "j")).save(1, params,
                                                    async_=False)
    hvd.init(device="cpu")
    try:
        b = make_transformer_train_step(
            TransformerConfig(**TINY, dtype=torch.float32), device="cpu")
        b.optimizer.remove_hooks()
        target = train_state_tree(b)["params"]
        got = tcp.CheckpointManager(str(tmp_path / "j")).restore(
            target=target)
        with torch.no_grad():
            for name, p in b.model.named_parameters():
                node = got
                for key in name.split("."):
                    node = node[key]
                p.copy_(node)
        back = params_to_flax(b.model.state_dict())
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
        tcp.CheckpointManager(str(tmp_path / "t")).save(
            1, train_state_tree(b)["params"], async_=False)
    finally:
        hvd.shutdown()
    out = jcp.CheckpointManager(str(tmp_path / "t")).restore(target=params)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        out, params)


# ---------------------------------------------------------------------------
# a gloo world: save on one mesh, restore onto others
# ---------------------------------------------------------------------------

def _data(step):
    rng = np.random.RandomState(120 + step)
    d = torch.from_numpy(rng.randint(0, TINY["vocab_size"], (8, 17)))
    return d[:, :-1], d[:, 1:]


def _bundle(sizes, seed):
    mesh = make_training_mesh(MeshConfig(**sizes), device="cpu")
    b = make_transformer_train_step(
        TransformerConfig(**TINY, dtype=torch.float32), device="cpu",
        mesh=mesh, generator=torch.Generator().manual_seed(seed))
    return b


def _gathered(b, res, label):
    """The bundle's train state as global arrays: parameters, AdamW
    moments, steps."""
    mesh = b.mesh if b.sharding is not None else None
    named = list(b.model.named_parameters())
    state = b.optimizer.state
    for key, src in (("param", {n: p for n, p in named}),
                     ("exp_avg", {n: state[p]["exp_avg"] for n, p in named}),
                     ("exp_avg_sq", {n: state[p]["exp_avg_sq"]
                                     for n, p in named})):
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                else:
                    flat[f"{prefix}{k}"] = v
        walk(params_to_flax(src, mesh), "")
        for name, v in flat.items():
            res[f"{label}.{key}.{name}"] = v
    res[f"{label}.steps"] = np.array([float(state[p]["step"])
                                      for _, p in named])


def _ckpt_worker(out_dir) -> int:
    hvd.init(device="cpu")
    r = hvd.rank()
    res = {}
    mgr = tcp.CheckpointManager(os.path.join(out_dir, "ckpt"))
    b = _bundle(SAVE_MESH, seed=0)
    for s in range(2):
        run_mesh_step(b, *_data(s))
    save_mesh_train_state(mgr, 2, b)
    _gathered(b, res, "saved")
    res["saved.resumed_losses"] = np.array(
        [run_mesh_step(b, *_data(s)).item() for s in (2, 3)])
    save_mesh_train_state(mgr, 4, b, async_=True)
    mgr.wait_until_finished()
    _gathered(b, res, "step4")
    b.optimizer.remove_hooks()
    for label, sizes in RESTORE_MESHES.items():
        nb = _bundle(sizes, seed=1)
        res[f"{label}.restored_step"] = np.array(
            restore_mesh_train_state(mgr, nb, step=2))
        _gathered(nb, res, label)
        if label == "same":
            res["same.resumed_losses"] = np.array(
                [run_mesh_step(nb, *_data(s)).item() for s in (2, 3)])
        nb.optimizer.remove_hooks()
    nb = _bundle(dict(dp=1, fsdp=4), seed=1)
    res["latest.restored_step"] = np.array(restore_mesh_train_state(mgr, nb))
    _gathered(nb, res, "latest")
    nb.optimizer.remove_hooks()
    hvd.barrier()
    hvd.shutdown()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)
    print("RESULT " + json.dumps({"rank": r}), flush=True)
    return 0


_WORLD = {}


@pytest.fixture(scope="module")
def ckpt_world(tmp_path_factory):
    if not _WORLD:
        from test_torch_port_parallel import _finish, _start
        out_dir = str(tmp_path_factory.mktemp("ckpt_world"))
        _finish(_start(N, ["ckpt", out_dir], os.path.abspath(__file__)),
                timeout=240)
        _WORLD["v"] = (out_dir, [dict(np.load(os.path.join(
            out_dir, f"rank{r}.npz"))) for r in range(N)])
    return _WORLD["v"]


def _state(res, label):
    return {k[len(label) + 1:]: v for k, v in res.items()
            if k.startswith(label + ".") and ".resumed" not in k
            and not k.endswith("restored_step")}


@pytest.mark.parametrize("label", list(RESTORE_MESHES))
def test_world_restore_onto_another_mesh_is_bit_exact(ckpt_world, label):
    _, ranks = ckpt_world
    for res in ranks:
        saved, got = _state(res, "saved"), _state(res, label)
        assert sorted(saved) == sorted(got)
        for key, want in saved.items():
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        assert int(res[f"{label}.restored_step"]) == 2


def test_world_resumed_steps_are_bit_identical(ckpt_world):
    _, ranks = ckpt_world
    for res in ranks:
        assert res["same.resumed_losses"].tobytes() == \
            res["saved.resumed_losses"].tobytes()
    assert all(r["saved.resumed_losses"].tobytes()
               == ranks[0]["saved.resumed_losses"].tobytes() for r in ranks)


def test_world_latest_async_step_and_shards_written_once(ckpt_world):
    out_dir, ranks = ckpt_world
    for res in ranks:
        assert int(res["latest.restored_step"]) == 4
        for key, want in _state(res, "step4").items():
            np.testing.assert_array_equal(_state(res, "latest")[key], want)
    root = os.path.join(out_dir, "ckpt")
    assert tlayout.completed_steps(root) == [4, 2]
    manifest = tlayout.read_manifest(tlayout.step_dir(root, 2))
    assert manifest["world_size"] == N and manifest["process_count"] == N
    by_path = {m["path"]: m for m in manifest["leaves"]}
    wq = by_path["['params']['layer_0']['attn']['wq']"]
    # (embed, heads, kv) over fsdp 2: two blocks, one file each
    assert [s["starts"] for s in wq["shards"]] == [[0, 0, 0], [16, 0, 0]]
    ln = by_path["['params']['ln_f']['scale']"]
    assert len(ln["shards"]) == 1
    step = by_path["['opt_state']['step']['embedding']"]
    assert step["shape"] == [] and len(step["shards"]) == 1
    for leaf in manifest["leaves"]:
        files = [s["file"] for s in leaf["shards"]]
        assert len(files) == len(set(files))


if __name__ == "__main__":
    sys.exit(_ckpt_worker(sys.argv[2]) if sys.argv[1] == "ckpt" else 2)
