"""The worker side of the mesh-aware elastic drill in the port (counterpart
of ``tests/mesh_train_worker.py`` and the drill of
``tests/test_mesh_elastic.py``), on gloo.

The elastic driver plans the process-level mesh (``HVD_TPU_MESH_SHAPE``)
and publishes it to the journaled ``mesh`` scope; the port's worker
(this file's ``__main__``) adopts it with ``hvd.elastic.fetch_mesh_shape``,
forms its training mesh over the world
(``parallel.mesh_utils.make_training_mesh``), restores the newest sharded
checkpoint through ``parallel.restore_mesh_train_state`` (the resharding
reader) and trains through ``parallel.run_mesh_step``, which fires the
``worker.mesh`` fault site. Fingerprints are compared within replica
groups (``FingerprintMonitor.for_mesh``); any detection is an ``sdc``
event.

The drill: two localhost-alias hosts with 2 slots each, ``dp=2,fsdp=2``;
``worker.mesh:crash:step=4:rank=3`` kills one rank of host 1 entering its
4th step. The driver blacklists host 1 and replans ``dp=1,fsdp=2``; the
two survivors reset in-process, re-form the mesh, restore the last
committed step and finish. Their final parameters must equal, bit for
bit, an uninterrupted 1-host ``fsdp=2`` run's, with no ``sdc`` event.

The data scheme is the JAX worker's: a per-step seeded batch, and every dp
replica computes the same batch (the global batch is the step's batch
repeated dp times), so a dp sum adds equal values. That makes the
fsdp-sharded gradients exact across dp sizes: the dp sum of two equal
blocks times 1/4 is the block times 1/2. A parameter the mesh replicates
(the LayerNorms) reduces over the whole world instead, in the ring's
order, and a sum of four in ring order is not twice a sum of two; the
drill's optimizer therefore steps every parameter but the LayerNorms
(their learning rate is 0; ROADMAP C).

Worker env: ``ELASTIC_TEST_DIR`` (events.log and ckpt/),
``MESH_TEST_STEPS`` (default 6).
"""

import hashlib
import os
import re
import stat
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
SEED = 1234
SMALL = dict(vocab_size=32, num_layers=1, d_model=16, num_heads=2,
             head_dim=8, mlp_ratio=2, max_seq_len=8)


def batch_for_step(step: int, dp: int):
    """The step's batch (the JAX worker's), repeated for each dp replica:
    every generation and the reference see the same data at each step."""
    rng = np.random.RandomState(1000 + step)
    toks = rng.randint(0, SMALL["vocab_size"],
                       size=(4, SMALL["max_seq_len"])).astype(np.int64)
    tgts = rng.randint(0, SMALL["vocab_size"],
                       size=(4, SMALL["max_seq_len"])).astype(np.int64)
    return np.tile(toks, (dp, 1)), np.tile(tgts, (dp, 1))


def adopt_mesh(shape, size: int):
    """The MeshConfig of a published plan ({axis: size}); without one, the
    flat world as dp."""
    from horovod_tpu_torch.parallel.mesh_utils import MeshConfig
    if not shape:
        return MeshConfig(dp=size)
    return MeshConfig(**{a: int(v) for a, v in shape.items()})


def build_bundle(mesh_cfg):
    import torch
    from horovod_tpu_torch.models import TransformerConfig
    from horovod_tpu_torch.parallel import make_transformer_train_step
    from horovod_tpu_torch.parallel.mesh_utils import make_training_mesh
    mesh = make_training_mesh(mesh_cfg, device="cpu")

    def sgd(params):
        # momentum gives the optimizer real state, so a resume that
        # dropped it would not be bit-identical. The LayerNorms (the
        # model's only 1-D parameters) keep their weights: lr 0, see the
        # module docstring
        params = list(params)
        return torch.optim.SGD(
            [{"params": [p for p in params if p.dim() > 1]},
             {"params": [p for p in params if p.dim() == 1], "lr": 0.0}],
            lr=0.1, momentum=0.9)
    return make_transformer_train_step(
        TransformerConfig(**SMALL, dtype=torch.float32), device="cpu",
        mesh=mesh, optimizer=sgd,
        generator=torch.Generator().manual_seed(0))


def worker_main() -> None:
    sys.path.insert(0, REPO)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.checkpointing import CheckpointManager
    from horovod_tpu_torch.models.convert import flax_order, params_to_flax
    from horovod_tpu_torch.parallel import (restore_mesh_train_state,
                                            run_mesh_step,
                                            save_mesh_train_state)
    from horovod_tpu_torch.sdc import FingerprintMonitor

    test_dir = os.environ["ELASTIC_TEST_DIR"]
    steps = int(os.environ.get("MESH_TEST_STEPS", "6"))
    manager = CheckpointManager(os.path.join(test_dir, "ckpt"))

    def log_event(msg: str) -> None:
        with open(os.path.join(test_dir, "events.log"), "a") as f:
            f.write(f"{msg} t={time.time():.3f}\n")

    hvd.init(device="cpu")
    state = hvd.elastic.ObjectState(step=0)

    @hvd.elastic.run
    def train(state):
        # rebuilt every generation: after a reset the world has a new
        # size and the driver's new plan waits in the 'mesh' scope
        shape = hvd.elastic.fetch_mesh_shape()
        cfg = adopt_mesh(shape, hvd.size())
        bundle = build_bundle(cfg)
        restored = restore_mesh_train_state(manager, bundle)
        state.step = 0 if restored is None else restored + 1
        monitor = FingerprintMonitor.for_mesh(hvd.size(), hvd.rank(),
                                              dp=cfg.dp, every=1)
        log_event(f"mesh rank={hvd.rank()} size={hvd.size()} dp={cfg.dp} "
                  f"fsdp={cfg.fsdp} restored={restored} start={state.step}")
        while state.step < steps:
            toks, tgts = batch_for_step(state.step, cfg.dp)
            loss = run_mesh_step(bundle, torch.from_numpy(toks),
                                 torch.from_numpy(tgts))
            local = bundle.model.state_dict()
            det = monitor.maybe_check(
                state.step, [local[n] for n in flax_order(local)])
            if det is not None:
                log_event(f"sdc rank={hvd.rank()} step={state.step} "
                          f"local={det.local}")
            log_event(f"step={state.step} rank={hvd.rank()} "
                      f"size={hvd.size()} loss={float(loss):.6f}")
            state.step += 1
            # commit before the sharded save: its synchronizing call is
            # the failure detector, so the save runs in a whole world
            state.commit()
            save_mesh_train_state(manager, state.step - 1, bundle)
        return bundle

    bundle = train(state)
    tree = params_to_flax(bundle.model.state_dict(), bundle.mesh)
    digest = hashlib.sha256()
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = v
    walk(tree, "")
    for name in flax_order(flat):
        digest.update(np.ascontiguousarray(flat[name]).tobytes())
    log_event(f"done rank={hvd.rank()} size={hvd.size()} "
              f"steps={state.step} sha={digest.hexdigest()}")
    hvd.shutdown()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker_main()
    sys.exit(0)

# -- the tests ---------------------------------------------------------------

import pytest  # noqa: E402

from horovod_tpu_torch import faults as F  # noqa: E402
from horovod_tpu_torch import metrics as M  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    F.configure("", seed=0)


def test_worker_mesh_site_fires_on_configured_step():
    from horovod_tpu_torch.parallel import train as ptrain
    F.configure("worker.mesh:error:step=2", seed=SEED)
    key = ('hvd_tpu_faults_injected_total'
           '{site="worker.mesh",kind="error"}')
    before = float(M.snapshot().get(key, 0.0))
    ptrain._FP_MESH.fire()            # hit 1: clean
    with pytest.raises(F.InjectedFault):
        ptrain._FP_MESH.fire()        # hit 2: the configured step
    assert float(M.snapshot().get(key, 0.0)) == before + 1


def test_crash_rule_parses_with_rank_scope():
    rule = F.parse_spec("worker.mesh:crash:step=4:rank=3")[0]
    assert rule.kind == "crash" and rule.step == 4 and rule.rank == 3


def test_worker_adopts_the_published_plan(monkeypatch):
    """The driver's replan reaches the worker: published to the 'mesh'
    scope of a live KV store, fetched by fetch_mesh_shape, adopted as the
    MeshConfig the worker forms its mesh from."""
    from horovod_tpu_torch.elastic import fetch_mesh_shape
    from horovod_tpu_torch.elastic.discovery import FixedHosts
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    from horovod_tpu_torch.parallel.mesh_utils import (MeshConfig,
                                                       replica_groups)
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    monkeypatch.setenv("HVD_TPU_MESH_SHAPE", "dp=2,fsdp=2")
    server = RendezvousServer()
    port = server.start()
    driver = ElasticDriver(server, FixedHosts({"a": 2, "b": 2}), min_np=2,
                           timeout=5)
    try:
        monkeypatch.setenv("HVD_TPU_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HVD_TPU_RENDEZVOUS_PORT", str(port))
        monkeypatch.setenv("HVD_TPU_ELASTIC", "1")
        driver._replan_mesh(4)
        assert adopt_mesh(fetch_mesh_shape(), 4) == MeshConfig(dp=2, fsdp=2)
        driver._replan_mesh(2)         # host b lost: shrink dp first
        cfg = adopt_mesh(fetch_mesh_shape(), 2)
        assert cfg == MeshConfig(dp=1, fsdp=2)
        assert replica_groups(2, cfg.dp) == [[0], [1]]
        assert replica_groups(4, 2) == [[0, 2], [1, 3]]
    finally:
        driver.stop()
        server.stop()
    assert adopt_mesh(None, 3) == MeshConfig(dp=3)


def test_drill_data_repeats_the_batch_for_each_replica():
    one, _ = batch_for_step(3, 1)
    two, _ = batch_for_step(3, 2)
    np.testing.assert_array_equal(two, np.concatenate([one, one]))
    assert not np.array_equal(batch_for_step(4, 1)[0], one)


def _launch(test_dir, hosts, np_, min_np, extra_env):
    hosts_file = os.path.join(test_dir, "hosts.txt")
    with open(hosts_file, "w") as f:
        f.write(hosts + "\n")
    script = os.path.join(test_dir, "discover.sh")
    with open(script, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts_file}\n")
    os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)
    env = dict(os.environ)
    env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "ELASTIC_TEST_DIR": test_dir})
    env.update(extra_env)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "-np", str(np_), "--min-np", str(min_np),
           "--host-discovery-script", script, "--slots", "2",
           "--stall-check-warning-time-seconds", "5",
           "--stall-check-shutdown-time-seconds", "30",
           sys.executable, HERE, "worker"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, cwd=test_dir)
    try:
        out, _ = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError("mesh drill timed out:\n"
                             + out.decode(errors="replace")[-6000:])
    path = os.path.join(test_dir, "events.log")
    evs = [line.strip() for line in open(path)] if os.path.exists(path) \
        else []
    return proc.returncode, out.decode(errors="replace"), evs


def _final_sha(evs):
    done = [e for e in evs if e.startswith("done rank=0 ")]
    assert done, evs
    return re.search(r" sha=([0-9a-f]{64})", done[-1]).group(1)


def test_mesh_drill_shrinks_dp_and_ends_bit_identical():
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as ref_dir:
        code, out, ref = _launch(ref_dir, "localhost:2", 2, 2,
                                 {"HVD_TPU_MESH_SHAPE": "dp=1,fsdp=2"})
        assert code == 0, f"reference run exited {code}:\n{out[-6000:]}"
        sha_ref = _final_sha(ref)
        assert not any(e.startswith("sdc ") for e in ref), ref
    with tempfile.TemporaryDirectory() as td:
        code, out, evs = _launch(td, "localhost:2\n127.0.0.1:2", 4, 2, {
            "HVD_TPU_MESH_SHAPE": "dp=2,fsdp=2",
            "HVD_TPU_FAULT_SPEC": "worker.mesh:crash:step=4:rank=3",
            "HVD_TPU_FAULT_SEED": str(SEED)})
        assert code == 0, f"drill exited {code}:\n{out[-6000:]}\n{evs}"
    # generation 1 formed dp=2 x fsdp=2 on all four ranks
    gen1 = [e for e in evs if re.match(r"mesh rank=\d size=4 dp=2 fsdp=2 ",
                                       e)]
    assert len(gen1) == 4, evs
    # the survivors re-formed dp=1 x fsdp=2 from the driver's replan and
    # resumed from a restored step
    gen2 = [e for e in evs if re.match(r"mesh rank=\d size=2 dp=1 fsdp=2 ",
                                       e)]
    assert len(gen2) == 2, evs
    m = re.search(r"restored=(\d+) start=(\d+)", gen2[-1])
    assert m and int(m.group(2)) == int(m.group(1)) + 1, gen2
    assert any(re.match(r"step=5 rank=0 size=2 ", e) for e in evs), evs
    assert not any(e.startswith("sdc ") for e in evs), evs
    assert _final_sha(evs) == sha_ref, (evs, sha_ref)
    print(f"mesh drill and reference: {time.monotonic() - t0:.1f} s")
