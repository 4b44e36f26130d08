"""The port's SDC plane (``horovod_tpu_torch.sdc``, ``_schedule.py``)
against the JAX package's (``horovod_tpu.sdc``, ``horovod_tpu._schedule``).

Host logic is held bit for bit: the ``worker.grads`` drill picks the same
leaf, element and bit for the same rule seed; ``fold_fingerprint`` and
the per-leaf folds give the same uint32 values on the same parameters
(numpy trees, and the port's transformer carried over from the flax one);
the KV keys, payloads and divergence diagnostics are the same; the step
guard and ``guard_update`` give the same verdicts and EWMA on the same
sequences; the policy makes the same decisions. Then the guarded
Estimator in a gloo world of 2 (the ``tests/sdc_train_worker.py`` drill):
a bitflip in rank 1's local gradients only is flagged ``local=True`` on
rank 1 and ``local=False`` on rank 0, both skip and retry the step, no
reduced gradient carries the poison, rank 1 alone reports itself for
quarantine, and the final parameters equal an uncorrupted run's.

This file is also its own worker: ``python tests/test_torch_port_sdc.py
drill <out.json>`` with the ``HVD_TPU_COORDINATOR_ADDR/SIZE/RANK`` env.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
SEED = 1234


def _drill_main(out_path: str) -> int:
    """One rank of the gloo drill: the guarded Estimator on an MLP, the
    same data on every rank (shard=False) and SGD, so the replicas stay
    bit-identical unless the corruption leaks."""
    sys.path.insert(0, REPO)
    import hashlib
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.estimator import Estimator
    from horovod_tpu_torch.models import MLP
    from horovod_tpu_torch.optimizer import DistributedOptimizer
    from horovod_tpu_torch.sdc import guard

    hvd.init(device="cpu")
    rank = hvd.rank()
    elastic = bool(os.environ.get("HVD_TPU_RENDEZVOUS_ADDR"))
    if elastic:
        from horovod_tpu_torch.elastic.worker import notification_manager
        notification_manager.init()
    detections = []
    check = guard.StepGuard.check

    def recording_check(self, grads, loss):
        det = check(self, grads, loss)
        if det is not None:
            detections.append({"kind": det.kind, "local": det.local})
        return det
    guard.StepGuard.check = recording_check
    reduced_max = []
    apply_result = DistributedOptimizer._apply_result

    def recording_apply(self, p, out):
        reduced_max.append(float(out.abs().max()))
        apply_result(self, p, out)
    DistributedOptimizer._apply_result = recording_apply

    rng = np.random.RandomState(7)
    x = rng.randn(64, 8).astype(np.float32)
    y = (np.arange(64) % 4).astype(np.int32)
    model = MLP(features=(16,), num_classes=4, in_features=8, device="cpu",
                generator=torch.Generator().manual_seed(3))
    est = Estimator(model, optimizer=lambda p: torch.optim.SGD(p, lr=1e-2),
                    seed=3, scale_lr_by_world=False, device="cpu")
    est.fit(x, y, epochs=2, batch_size=16, shard=False)
    digest = hashlib.sha256()
    for t in est.params.values():
        digest.update(t.numpy().tobytes())
    out = {"rank": rank, "params": digest.hexdigest(),
           "detections": detections,
           "detections_metric": sum(
               v for k, v in M.snapshot().items()
               if k.startswith("hvd_tpu_sdc_detections_total")),
           "max_reduced_grad": max(reduced_max)}
    if elastic:
        notification_manager.shutdown()
    with open(out_path + f".{rank}", "w") as f:
        json.dump(out, f)
    hvd.shutdown()
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["drill"]:
    sys.exit(_drill_main(sys.argv[2]))

# -- the tests (both packages) ----------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu import _schedule as j_schedule  # noqa: E402
from horovod_tpu import faults as JF  # noqa: E402
from horovod_tpu import sdc as jsdc  # noqa: E402
from horovod_tpu_torch import _schedule as t_schedule  # noqa: E402
from horovod_tpu_torch import faults as TF  # noqa: E402
from horovod_tpu_torch import sdc as tsdc  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    JF.configure("", seed=0)
    TF.configure("", seed=0)


def _tree(seed=0):
    """A flax-like nested tree with float leaves of several shapes, an
    integer leaf and an all-zero leaf."""
    rng = np.random.RandomState(seed)
    return {
        "Dense_0": {"bias": rng.randn(16).astype(np.float32),
                    "kernel": rng.randn(8, 16).astype(np.float32)},
        "Dense_1": {"bias": np.zeros(4, np.float32),
                    "kernel": rng.randn(16, 4).astype(np.float32)},
        "layer_10": {"w": rng.randn(3, 5).astype(np.float32)},
        "layer_2": {"w": (rng.randn(7) * 1e-30).astype(np.float32)},
        "steps": np.arange(3, dtype=np.int32),
    }


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                  tree)


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    return [t.numpy() for t in tree]


# ---------------------------------------------------------------------------
# worker.grads drill: the same leaf, element and bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "worker.grads:bitflip:step=1", "worker.grads:nan:step=1",
    "worker.grads:bitflip:step=2", "worker.grads:bitflip:rate=1.0"])
@pytest.mark.parametrize("seed", [SEED, 7, 99])
def test_corrupt_grads_same_leaf_element_and_bit(spec, seed):
    tree = _tree(seed)
    JF.configure(spec, seed=seed)
    TF.configure(spec, seed=seed)
    for _ in range(2):
        got = tsdc.corrupt_grads(_torch_tree(tree))
        want = jsdc.corrupt_grads(tree)
        a = _leaves_np(want)
        b = _leaves_np(got)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x.view(np.uint8),
                                          y.view(np.uint8))


def test_corrupt_grads_all_zero_leaf_falls_back_to_nan():
    tree = {"a": np.zeros((4, 4), np.float32)}
    JF.configure("worker.grads:bitflip:step=1", seed=SEED)
    TF.configure("worker.grads:bitflip:step=1", seed=SEED)
    a = np.asarray(jsdc.corrupt_grads(tree)["a"])
    b = tsdc.corrupt_grads(_torch_tree(tree))[0].numpy()
    assert np.isnan(b).sum() == 1
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))


def test_no_rule_is_identity():
    tree = _torch_tree(_tree())
    assert tsdc.corrupt_grads(tree) is tree


def test_flax_view_drill_matches_jax_on_the_mlp():
    """The MLP's dense kernels are stored (out, in); viewed in the flax
    layout the drill corrupts the element the JAX package corrupts."""
    from horovod_tpu_torch.models import MLP, cnn_params_from_flax
    from horovod_tpu_torch.models.convert import flax_order, flax_view
    from horovod_tpu.models.mlp import MLP as JMLP
    variables = JMLP(features=(16,), num_classes=4).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8)))
    model = MLP(features=(16,), num_classes=4, in_features=8, device="cpu")
    model.load_state_dict(cnn_params_from_flax(model, variables))
    state = model.state_dict()
    names = flax_order(state)
    views = [flax_view(n, state[n]) for n in names]
    for kind in ("bitflip", "nan"):
        spec = f"worker.grads:{kind}:step=1"
        JF.configure(spec, seed=SEED)
        TF.configure(spec, seed=SEED)
        want = jax.tree_util.tree_leaves(jsdc.corrupt_grads(
            variables["params"]))
        got = tsdc.corrupt_grads(views)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(
                np.asarray(w).view(np.uint32), g.numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_fingerprint_bit_exact(seed):
    tree = _tree(seed)
    tree["Dense_0"]["half"] = np.random.RandomState(seed).randn(5).astype(
        np.float16)
    tt = _torch_tree(tree)
    assert tsdc.fold_fingerprint(tt) == jsdc.fold_fingerprint(tree)
    assert tsdc.fold_leaf_fingerprints(tt) == \
        jsdc.fold_leaf_fingerprints(tree)
    # a list in the JAX leaf order folds the same
    assert tsdc.fold_fingerprint(
        [torch.from_numpy(a) for a in jax.tree_util.tree_leaves(tree)]) \
        == jsdc.fold_fingerprint(tree)


def test_fold_fingerprint_of_the_converted_transformer():
    """The port's transformer, carried over from the flax one, folds to
    the JAX tree's fingerprint: leaves in the flax tree's order, not the
    module's registration order (which differs, and folds differently)."""
    from flax.linen import meta
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.models import params_from_flax
    small = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
                 head_dim=8, max_seq_len=16)
    variables = jtr.Transformer(jtr.TransformerConfig(**small)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray,
                                    meta.unbox(variables["params"]))
    model = Transformer(TransformerConfig(**small), device="cpu")
    model.load_state_dict(params_from_flax(params))
    state = model.state_dict()
    assert tsdc.fold_fingerprint(state) == jsdc.fold_fingerprint(params)
    assert tsdc.fold_leaf_fingerprints(state) == \
        jsdc.fold_leaf_fingerprints(params)
    in_module_order = list(state.values())
    assert tsdc.fold_fingerprint(in_module_order) != \
        jsdc.fold_fingerprint(params)


def test_fold_is_bit_sensitive():
    tree = _torch_tree(_tree())
    fp = tsdc.fold_fingerprint(tree)
    tree["Dense_0"]["kernel"].view(torch.int32)[0, 0] ^= 1
    assert tsdc.fold_fingerprint(tree) != fp


def test_kv_keys_payloads_and_diagnostics_match(monkeypatch):
    class Rec:
        def __init__(self):
            self.puts = []

        def put(self, scope, key, value):
            self.puts.append((scope, key, value))

    recs = {}
    for name, mod in (("jax", j_schedule), ("torch", t_schedule)):
        rec = Rec()
        recs[name] = rec
        monkeypatch.setattr(mod, "_sdc_kv_client", lambda rec=rec: rec)
        assert mod._fp_key(3) == "sdc.fp.rank3"
        assert mod._fp_key(3, 1) == "sdc.fp.g1.rank3"
        mod.publish_sdc_fingerprint(5, 0xDEADBEEF, rank=2)
        mod.publish_sdc_fingerprint(6, 17, rank=1, group=0,
                                    leaf_fps={0: 1, 3: 2})
    assert recs["jax"].puts == recs["torch"].puts
    peers = {0: {"step": 5, "fp": 1, "leaves": {"0": 1, "1": 2}},
             1: {"step": 5, "fp": 1, "leaves": {"0": 1, "1": 2}},
             2: {"step": 5, "fp": 2, "leaves": {"0": 1, "1": 3}},
             3: {"step": 4, "fp": 9}}
    for step in (5, 4, None):
        for group in (None, 1):
            assert t_schedule.diff_sdc_fingerprints(peers, step, group) == \
                j_schedule.diff_sdc_fingerprints(peers, step, group)


def test_monitor_publishes_and_detects_through_live_kv(monkeypatch):
    """FingerprintMonitor on the port's KV store: the port publishes what
    a JAX rank publishes, and a diverging peer is named."""
    from horovod_tpu_torch.runner.rendezvous import KVStoreServer
    server = KVStoreServer(port=0)
    port = server.start()
    try:
        monkeypatch.setenv("HVD_TPU_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HVD_TPU_RENDEZVOUS_PORT", str(port))
        monkeypatch.setenv("HVD_TPU_SIZE", "2")
        for mod in (t_schedule, j_schedule):
            monkeypatch.setattr(mod, "_sdc_client", None)
            monkeypatch.setattr(mod, "_sdc_client_resolved", False)
        tree = _tree()
        # rank 1 (the JAX package) publishes other parameters
        other = _tree(1)
        j_schedule.publish_sdc_fingerprint(
            2, jsdc.fold_fingerprint(other), rank=1)
        monkeypatch.setenv("HVD_TPU_RANK", "0")
        det = tsdc.FingerprintMonitor(every=1).maybe_check(
            2, _torch_tree(tree))
        assert det is not None and det.kind == "fingerprint"
        raw = json.loads(server.get("schedule", "sdc.fp.rank0"))
        assert raw == {"step": 2, "fp": jsdc.fold_fingerprint(tree),
                       "rank": 0}
        # agreement: no detection
        j_schedule.publish_sdc_fingerprint(
            3, jsdc.fold_fingerprint(tree), rank=1)
        assert tsdc.FingerprintMonitor(every=1).maybe_check(
            3, _torch_tree(tree)) is None
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the step guard
# ---------------------------------------------------------------------------

def _guard_cases():
    rng = np.random.RandomState(3)
    g = {"a": rng.randn(4, 3).astype(np.float32),
         "b": rng.randn(5).astype(np.float32),
         "n": np.arange(4, dtype=np.int32)}

    def with_(leaf, idx, value):
        out = {k: v.copy() for k, v in g.items()}
        out[leaf].reshape(-1)[idx] = value
        return out
    bitflipped = g["a"].copy()
    bitflipped.view(np.uint32).reshape(-1)[5] ^= np.uint32(1 << 30)
    return [
        (g, 1.0), (g, 1.1), (with_("a", 2, np.nan), 1.0),
        (with_("b", 0, np.inf), 1.0), (with_("b", 1, -np.inf), 1.0),
        ({**g, "a": bitflipped}, 1.0), (with_("a", 0, 2e12), 1.0),
        (g, float("nan")), (g, 50.0), (g, 1.2), (g, 0.9),
        ({"n": np.array([10 ** 9], np.int32)}, 1.0), (g, 30.0)]


@pytest.mark.parametrize("factor", [10.0, 0.0])
def test_step_guard_same_verdicts_and_ewma(factor):
    jg = jsdc.StepGuard(loss_spike_factor=factor, sync=lambda c: c)
    tg = tsdc.StepGuard(loss_spike_factor=factor, sync=lambda c: c)
    for grads, loss in _guard_cases():
        # an fp32 loss on both sides, as the Estimators give it
        want = jg.check(grads, np.float32(loss))
        got = tg.check(_torch_tree(grads), torch.tensor(loss))
        assert got == want, (grads, loss)
        assert tg._ewma == jg._ewma


def test_step_guard_peer_verdict_is_not_local():
    tg = tsdc.StepGuard(sync=lambda c: 2)
    det = tg.check({"a": torch.ones(3)}, 1.0)
    assert det == tsdc.Detection(kind="nonfinite", local=False)


def test_guard_update_matches_jax():
    ewma_j = ewma_t = None
    for grads, loss in _guard_cases():
        cj, ewma_j = jsdc.guard_update(grads, loss, ewma_j, factor=10.0)
        ct, ewma_t = tsdc.guard_update(_torch_tree(grads),
                                       torch.tensor(loss), ewma_t,
                                       factor=10.0)
        assert int(ct) == int(cj), (grads, loss)
        np.testing.assert_allclose(float(ewma_t), float(ewma_j),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the policy: the same decisions on the same script
# ---------------------------------------------------------------------------

def test_policy_decisions_match():
    script = (["save:0"] + ["clean"] * 3 + ["local"] + ["clean"] * 2
              + ["peer", "local", "fingerprint", "rollback"] + ["clean"] * 120
              + ["save:7", "local", "clean", "clean", "local", "local",
                 "fingerprint-peer", "rollback"])
    runs = []
    for mod in (jsdc, tsdc):
        reports = []
        p = mod.SdcPolicy(confirm_steps=2, strikes=2,
                          report=lambda k, s: reports.append((k, s)))
        out = []
        for op in script:
            if op.startswith("save:"):
                p.on_saved(int(op[5:]))
            elif op == "clean":
                out.append(p.on_clean_step())
            elif op == "rollback":
                p.on_rollback()
            else:
                kind = "fingerprint" if op.startswith("fingerprint") \
                    else "nonfinite"
                local = op in ("local", "fingerprint")
                out.append(p.on_detection(mod.Detection(kind, local)))
        runs.append((out, reports, p.last_good))
    assert runs[0] == runs[1]
    assert runs[0][1]                        # a report was made


# ---------------------------------------------------------------------------
# the guarded Estimator in a gloo world of 2
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _drill(tmp_path, name, env_for):
    out = str(tmp_path / name)
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ)
        env.update(HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HVD_TPU_SIZE="2", HVD_TPU_RANK=str(r),
                   HVD_TPU_SDC_GUARD="1",
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        env.update(env_for(r))
        procs.append(subprocess.Popen(
            [sys.executable, HERE, "drill", out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0].decode(
                errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert [p.returncode for p in procs] == [0, 0], "\n===\n".join(logs)
    return [json.load(open(f"{out}.{r}")) for r in range(2)]


def test_sdc_drill_in_a_gloo_world_of_two(tmp_path):
    from horovod_tpu_torch.runner.rendezvous import KVStoreServer
    from horovod_tpu_torch.sdc.report import SDC_SCOPE, decode_report
    clean = _drill(tmp_path, "clean", lambda r: {})
    assert all(c["detections"] == [] for c in clean)
    server = KVStoreServer(port=0)
    kv_port = server.start()
    try:
        corrupt = _drill(tmp_path, "corrupt", lambda r: {
            "HVD_TPU_FAULT_SPEC": "worker.grads:bitflip:step=3:rank=1",
            "HVD_TPU_FAULT_SEED": str(SEED),
            "HVD_TPU_HOSTNAME": f"sdc-host-{r}",
            "HVD_TPU_LOCAL_RANK": "0",
            "HVD_TPU_RENDEZVOUS_ADDR": "127.0.0.1",
            "HVD_TPU_RENDEZVOUS_PORT": str(kv_port),
            "HVD_TPU_SDC_STRIKES": "1"})
        reports = server.items(SDC_SCOPE)
    finally:
        server.stop()
    # both ranks skipped the step; only rank 1's data tripped the guard
    assert corrupt[0]["detections"] == [{"kind": "nonfinite",
                                         "local": False}]
    assert corrupt[1]["detections"] == [{"kind": "nonfinite",
                                         "local": True}]
    # the poison (a value ~2^128 larger) never reached a reduced gradient
    assert all(c["max_reduced_grad"] < 1e3 for c in corrupt + clean)
    # the retried step erased it: every rank of both runs ends equal
    assert len({c["params"] for c in clean + corrupt}) == 1
    assert set(reports) == {"sdc-host-1"}, reports
    kind, strikes, _ = decode_report(reports["sdc-host-1"])
    assert kind == "nonfinite" and strikes >= 1
