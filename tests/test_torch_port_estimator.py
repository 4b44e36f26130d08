"""The port's Estimator, data feed and callbacks (``horovod_tpu_torch.
estimator``, ``data``, ``callbacks``, ``serving.batcher``) against the
JAX package's, on the CPU.

Host logic bit for bit: ``batches`` order, ``shard_dataset`` and
``pad_to_size``; the prefetcher's lifecycle (the JAX package's
``TestData`` and ``TestPrefetchLifecycle`` cases); the callbacks'
``lr_scale`` trajectories and logs.

``Estimator.fit`` on the MLP and on a 2-layer, 64-wide transformer (plain
attention on the CPU), from the JAX Estimator's initial parameters
carried over with the port's converters, the default Adam and loss:
per-epoch losses, final parameters, ``evaluate`` and ``predict`` within
fp32 ``ATOL`` (1e-5, the tolerance ``tests/test_torch_port_transformer.py``
uses: the same arithmetic in the same precision, reductions ordered
differently). Under the SDC guard: the JAX package's Estimator
integration cases (``tests/test_sdc.py``), a one-shot bitflip skipped and
retried with the run bit-identical to an unguarded one, and the guarded
run within ``ATOL`` of the JAX package's guarded run. Then in a gloo world
of 2: ``MetricAverageCallback`` (float64, sorted names) and a sharded
``fit`` that keeps the replicas equal.

This file is also its own worker: ``python tests/test_torch_port_estimator.py
world <out_dir>`` with the ``HVD_TPU_COORDINATOR_ADDR/SIZE/RANK`` env.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
ATOL = 1e-5


def _world_main(out_dir: str) -> int:
    sys.path.insert(0, REPO)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks as cbs
    from horovod_tpu_torch.estimator import Estimator
    from horovod_tpu_torch.models import MLP

    hvd.init(device="cpu")
    rank = hvd.rank()
    logs = {"loss": 1.5 + rank, "acc": np.float32(0.25 * rank),
            "t": torch.tensor(2.0 * rank), "n": 3 * rank, "name": "x",
            "flag": True}
    run = cbs.TrainingRun()
    cl = cbs.CallbackList([cbs.MetricAverageCallback()], run)
    cl.on_epoch_end(0, logs)
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (np.arange(64) % 4).astype(np.int32)
    # each rank starts from other weights: the first batch's broadcast
    # makes them rank 0's
    model = MLP(features=(16,), num_classes=4, in_features=8, device="cpu",
                generator=torch.Generator().manual_seed(rank))
    est = Estimator(model, seed=1, device="cpu")
    hist = est.fit(x, y, epochs=2, batch_size=8)
    out = {"logs": {k: v for k, v in logs.items()},
           "history": hist.history,
           "evaluate": est.evaluate(x, y),
           "params": {k: v.tolist() for k, v in est.params.items()}}
    with open(os.path.join(out_dir, f"world.{rank}.json"), "w") as f:
        json.dump(out, f)
    hvd.shutdown()
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["world"]:
    sys.exit(_world_main(sys.argv[2]))

# -- the tests (both packages) ----------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from flax.linen import meta  # noqa: E402

import horovod_tpu as jhvd  # noqa: E402
import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu import callbacks as jcbs  # noqa: E402
from horovod_tpu import data as jdata  # noqa: E402
from horovod_tpu import faults as JF  # noqa: E402
from horovod_tpu.estimator import Estimator as JEstimator  # noqa: E402
from horovod_tpu.models import transformer as jtr  # noqa: E402
from horovod_tpu.models.mlp import MLP as JMLP  # noqa: E402
from horovod_tpu_torch import callbacks as cbs  # noqa: E402
from horovod_tpu_torch import data as hdata  # noqa: E402
from horovod_tpu_torch import faults as TF  # noqa: E402
from horovod_tpu_torch import metrics as TM  # noqa: E402
from horovod_tpu_torch import sdc  # noqa: E402
from horovod_tpu_torch.estimator import Estimator  # noqa: E402
from horovod_tpu_torch.models import (  # noqa: E402
    MLP, Transformer, TransformerConfig, cnn_params_from_flax,
    cnn_params_to_flax, params_from_flax, params_to_flax)

SEED = 1234


@pytest.fixture
def worlds():
    """A JAX world and a port world (gloo, CPU) of one process each."""
    if jhvd.is_initialized():
        jhvd.shutdown()
    jhvd.init()
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()
        jhvd.shutdown()
        JF.configure("", seed=0)
        TF.configure("", seed=0)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# data: bit for bit with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bs,seed,shuffle,pad", [
    (23, 5, 7, True, False), (64, 16, 3, True, False),
    (23, 5, 0, False, True), (40, 8, 11, True, True), (7, 8, 1, True, True)])
def test_batches_match_jax(n, bs, seed, shuffle, pad):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = np.arange(n, dtype=np.int32) * 2
    want = list(jdata.batches((x, y), bs, shuffle=shuffle, seed=seed,
                              pad_remainder=pad))
    got = list(hdata.batches((x, y), bs, shuffle=shuffle, seed=seed,
                             pad_remainder=pad))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
            assert u.dtype == v.dtype


def test_shard_dataset_and_pad_to_size_match_jax():
    x = np.arange(10)
    for size in (1, 2, 3, 4):
        for r in range(size):
            np.testing.assert_array_equal(
                hdata.shard_dataset(x, rank=r, size=size),
                jdata.shard_dataset(x, rank=r, size=size))
            a = hdata.shard_dataset((x, x * 2), rank=r, size=size)
            assert isinstance(a, tuple)
    shards = [hdata.shard_dataset(x, rank=r, size=3) for r in range(3)]
    assert sorted(np.concatenate(shards).tolist()) == list(range(10))
    m = np.arange(6, dtype=np.float32).reshape(3, 2)
    for target in (3, 5):
        (pa,), ma = jdata.pad_to_size((m,), target)
        (pb,), mb = hdata.pad_to_size((m,), target)
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ma, mb)
    with pytest.raises(ValueError):
        hdata.pad_to_size(m, 2)


# ---------------------------------------------------------------------------
# the prefetcher's lifecycle (TestData / TestPrefetchLifecycle)
# ---------------------------------------------------------------------------

def test_prefetch_yields_cpu_tensors_in_order():
    src = [{"x": np.full((2, 2), i, np.float32), "y": np.arange(i + 1)}
           for i in range(6)]
    out = list(hdata.prefetch_to_device(iter(src), buffer_size=3,
                                        device="cpu"))
    assert len(out) == 6
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor)
        np.testing.assert_array_equal(b["x"].numpy(), src[i]["x"])
        np.testing.assert_array_equal(b["y"].numpy(), src[i]["y"])


def test_prefetch_overlaps_producer():
    produced = []

    def slow_src():
        for i in range(4):
            produced.append(i)
            yield np.zeros(1, np.float32)

    it = hdata.PrefetchIterator(slow_src(), buffer_size=4, device_put=False)
    deadline = time.monotonic() + 5
    while len(produced) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(produced) == 4
    assert len(list(it)) == 4


def test_prefetch_propagates_errors_and_keeps_raising():
    def bad():
        yield np.zeros(1)
        raise RuntimeError("source exploded")

    it = hdata.prefetch_to_device(bad(), buffer_size=2, device="cpu")
    next(it)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="source exploded"):
            next(it)


def test_prefetch_next_after_exhaustion_raises():
    it = hdata.prefetch_to_device(iter([np.zeros(1)]), buffer_size=1,
                                  device="cpu")
    assert len(list(it)) == 1
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(it)


def test_prefetch_close_mid_iteration_unblocks_worker():
    started = threading.Event()

    def src():
        for _ in range(100):
            started.set()
            yield np.zeros(1)

    it = hdata.PrefetchIterator(src(), buffer_size=2, device="cpu")
    started.wait(5)
    next(it)
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_concurrent_close_races_blocked_producer():
    producing = threading.Event()

    def src():
        for _ in range(1000):
            producing.set()
            yield np.zeros(1)

    it = hdata.PrefetchIterator(src(), buffer_size=1, device_put=False)
    assert producing.wait(5)
    time.sleep(0.05)
    closers = [threading.Thread(target=it.close) for _ in range(4)]
    for t in closers:
        t.start()
    for t in closers:
        t.join(timeout=10)
    assert all(not t.is_alive() for t in closers)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
    it.close()


def test_prefetch_context_manager():
    with hdata.PrefetchIterator(iter([np.zeros(1)] * 5),
                                device="cpu") as it:
        next(it)
    assert not it._thread.is_alive()


# ---------------------------------------------------------------------------
# callbacks: the same lr_scale trajectories and logs
# ---------------------------------------------------------------------------

def _trajectory(mod, make_callbacks, epochs=4, spe=3):
    run = mod.TrainingRun(steps_per_epoch=spe)
    cl = mod.CallbackList(make_callbacks(mod), run)
    sched = mod.scaled_schedule(lambda c: 0.1 * (c + 1), run)
    scales, lrs, epoch_logs = [], [], []
    cl.on_train_begin()
    count = 0
    for epoch in range(epochs):
        cl.on_epoch_begin(epoch)
        logs = {}
        for batch in range(spe):
            cl.on_batch_begin(batch)
            scales.append(run.lr_scale)
            lrs.append(sched(count))
            count += 1
            cl.on_batch_end(batch, logs)
        cl.on_epoch_end(epoch, logs)
        epoch_logs.append(dict(logs))
    cl.on_train_end(logs)
    return scales, lrs, epoch_logs, run.epoch


@pytest.mark.parametrize("case", ["warmup", "staircase", "fractional",
                                  "constant", "windowed", "composed"])
def test_lr_callbacks_match_jax(case):
    def make(mod):
        if case == "warmup":
            return [mod.LearningRateWarmupCallback(warmup_epochs=3, size=4)]
        if case == "staircase":
            return [mod.LearningRateScheduleCallback(
                lambda e: 0.5 ** e, staircase=True)]
        if case == "fractional":
            return [mod.LearningRateScheduleCallback(
                lambda e: 1.0 / (1.0 + e), staircase=False)]
        if case == "constant":
            return [mod.LearningRateScheduleCallback(0.3, start_epoch=1)]
        if case == "windowed":
            return [mod.LearningRateScheduleCallback(
                lambda e: 2.0 + e, start_epoch=1, end_epoch=3,
                staircase=False)]
        return [mod.LearningRateWarmupCallback(warmup_epochs=2, size=8),
                mod.LearningRateScheduleCallback(
                    lambda e: 0.1, start_epoch=2)]
    assert _trajectory(cbs, make) == _trajectory(jcbs, make)


def test_scaled_schedule_constant_and_callable():
    run = cbs.TrainingRun(lr_scale=0.25)
    assert cbs.scaled_schedule(0.4, run)(7) == 0.1
    assert cbs.scaled_schedule(lambda c: c, run)(8) == 2.0
    run.lr_scale = 2.0
    assert cbs.scaled_schedule(0.4, run)(0) == 0.8


def test_non_staircase_needs_steps_per_epoch():
    run = cbs.TrainingRun()
    cl = cbs.CallbackList([cbs.LearningRateScheduleCallback(
        lambda e: e, staircase=False)], run)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        cl.on_batch_begin(0)


def test_broadcast_callback_broadcasts_once_in_place(worlds, monkeypatch):
    from horovod_tpu_torch import functions
    calls = []
    monkeypatch.setattr(functions, "broadcast_parameters",
                        lambda p, root_rank: calls.append((p, root_rank)))
    state = {"w": torch.ones(2)}
    run = cbs.TrainingRun(params=state)
    cl = cbs.CallbackList([cbs.BroadcastGlobalVariablesCallback(0)], run)
    for b in range(3):
        cl.on_batch_end(b)
    assert calls == [(state, 0)] and run.params is state


# ---------------------------------------------------------------------------
# Estimator.fit / evaluate / predict against the JAX Estimator
# ---------------------------------------------------------------------------

def _toy_data(n=64):
    rng = np.random.RandomState(7)
    x = rng.randn(n, 8).astype(np.float32)
    y = (np.arange(n) % 4).astype(np.int32)
    return x, y


def _mlp_pair(seed=3):
    jm = JMLP(features=(16,), num_classes=4)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8)))
    model = MLP(features=(16,), num_classes=4, in_features=8, device="cpu")
    model.load_state_dict(cnn_params_from_flax(model, variables))
    return jm, variables, model


def _mlp_leaves(est):
    return jax.tree_util.tree_leaves(cnn_params_to_flax(est.params))


def test_fit_evaluate_predict_mlp_match_jax(worlds, tmp_path):
    x, y = _toy_data()
    jm, variables, model = _mlp_pair()
    # the default Adam at 1e-3 on both sides: the JAX world here spans
    # the CPU devices that conftest forces, so its dp_size() is not 1
    je = JEstimator(jm, seed=3, scale_lr_by_world=False)
    je.params = variables
    want = je.fit(x, y, epochs=3, batch_size=16,
                  validation_data=(x[:8], y[:8]))
    te = Estimator(model, seed=3, device="cpu", scale_lr_by_world=False)
    got = te.fit(x, y, epochs=3, batch_size=16,
                 validation_data=(x[:8], y[:8]))
    assert sorted(got.history) == sorted(want.history)
    for k in want.history:
        _close(got.history[k], want.history[k])
    for a, b in zip(jax.tree_util.tree_leaves(je.params), _mlp_leaves(te)):
        _close(b, a)
    ev_j, ev_t = je.evaluate(x, y), te.evaluate(x, y)
    assert sorted(ev_t) == sorted(ev_j)
    _close(ev_t["loss"], ev_j["loss"])
    for n, bucket in ((3, 4), (5, 8), (16, 16)):
        _close(te.predict(x[:n]).numpy(), np.asarray(je.predict(x[:n])))
        assert bucket in te._predict_cache.compiled_buckets
    assert te._predict_cache.compiled_buckets == {4, 8, 16}
    # predict rows are the live rows of the forward at the padded shape
    padded = np.concatenate([x[:5], np.zeros((3, 8), np.float32)])
    with torch.no_grad():
        np.testing.assert_array_equal(
            te.predict(x[:5]).numpy(),
            te.model(torch.from_numpy(padded))[:5].numpy())
    # save / load
    te.save(str(tmp_path / "saved"), step=3)
    fresh = MLP(features=(16,), num_classes=4, in_features=8, device="cpu")
    loaded = Estimator(fresh, device="cpu").load(str(tmp_path / "saved"))
    for k, v in te.params.items():
        assert torch.equal(loaded.params[k], v)


def test_metrics_and_unfitted_errors(worlds):
    x, y = _toy_data()
    jm, variables, model = _mlp_pair()

    def jacc(out, t):
        return jnp.mean(jnp.argmax(out, -1) == t)

    def tacc(out, t):
        return (out.argmax(-1) == t).float().mean()
    te = Estimator(model, seed=3, device="cpu", metrics={"acc": tacc},
                   scale_lr_by_world=False)
    with pytest.raises(RuntimeError, match="fit"):
        te.predict(x)
    with pytest.raises(RuntimeError, match="fit"):
        te.evaluate(x, y)
    je = JEstimator(jm, seed=3, metrics={"acc": jacc},
                    scale_lr_by_world=False)
    je.params = variables
    hj = je.fit(x, y, epochs=2, batch_size=16)
    ht = te.fit(x, y, epochs=2, batch_size=16)
    _close(ht.history["acc"], hj.history["acc"])
    _close(te.evaluate(x, y)["acc"], je.evaluate(x, y)["acc"])
    with pytest.raises(ValueError, match="no full batch"):
        te.fit(x[:4], y[:4], batch_size=16)


TINY = dict(vocab_size=128, num_layers=2, d_model=64, num_heads=4,
            head_dim=16, max_seq_len=16)


def test_fit_evaluate_predict_transformer_match_jax(worlds):
    rng = np.random.RandomState(5)
    data = rng.randint(0, TINY["vocab_size"],
                       (16, TINY["max_seq_len"] + 1)).astype(np.int32)
    x, y = data[:, :-1], data[:, 1:]
    # fp32 activations on both sides (the default config's are bf16)
    jmodel = jtr.Transformer(jtr.TransformerConfig(**TINY,
                                                   dtype=jnp.float32))
    variables = jmodel.init(jax.random.PRNGKey(0), x[:1])
    je = JEstimator(jmodel, seed=2, scale_lr_by_world=False)
    je.params = variables
    want = je.fit(x, y, epochs=2, batch_size=4)
    model = Transformer(TransformerConfig(**TINY, dtype=torch.float32),
                        device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(variables))))
    te = Estimator(model, seed=2, device="cpu", scale_lr_by_world=False)
    got = te.fit(x, y, epochs=2, batch_size=4)
    _close(got.history["loss"], want.history["loss"])
    want_params = jax.tree_util.tree_leaves(
        meta.unbox(je.params["params"]))
    got_params = jax.tree_util.tree_leaves(params_to_flax(te.params))
    for a, b in zip(want_params, got_params):
        _close(b, a)
    _close(te.evaluate(x, y)["loss"], je.evaluate(x, y)["loss"])
    for n in (3, 5):
        _close(te.predict(x[:n]).numpy(), np.asarray(je.predict(x[:n])))


def test_default_optimizer_is_adam_scaled_by_world(worlds):
    _, _, model = _mlp_pair()
    te = Estimator(model, device="cpu")
    te._build()
    base = te._opt._opt
    assert isinstance(base, torch.optim.Adam)
    assert base.param_groups[0]["lr"] == 1e-3 * hvd.dp_size()
    te2 = Estimator(_mlp_pair()[2], device="cpu", scale_lr_by_world=False,
                    optimizer=lambda p: torch.optim.SGD(p, lr=0.5))
    te2._build()
    assert isinstance(te2._opt._opt, torch.optim.SGD)


def test_epoch_checkpoint_restores_equal(worlds, tmp_path):
    from horovod_tpu_torch import checkpoint as ckpt
    x, y = _toy_data()
    te = Estimator(_mlp_pair()[2], seed=3, device="cpu",
                   checkpoint_dir=str(tmp_path))
    hist = te.fit(x, y, epochs=2, batch_size=16)
    assert hist.history["checkpoint_step"] == [0, 1]
    restored = ckpt.restore(str(tmp_path))
    assert sorted(restored) == sorted(te.params)
    for k, v in te.params.items():
        assert torch.equal(restored[k], v)


# ---------------------------------------------------------------------------
# under the SDC guard (the Estimator cases of tests/test_sdc.py)
# ---------------------------------------------------------------------------

def _guarded_fit(epochs=2, checkpoint_dir=None, spec="", seed=SEED,
                 model=None):
    TF.configure(spec, seed=seed)
    x, y = _toy_data()
    est = Estimator(model or _mlp_pair()[2],
                    optimizer=lambda p: torch.optim.SGD(p, lr=1e-2),
                    seed=3, scale_lr_by_world=False, device="cpu",
                    checkpoint_dir=checkpoint_dir)
    est.fit(x, y, epochs=epochs, batch_size=16, shard=False)
    return est


def _counter(name):
    return float(TM.snapshot().get(name, 0.0))


class _Records:
    def __init__(self, name="horovod_tpu.estimator"):
        import logging
        self.records = []
        self._logger = logging.getLogger(name)
        outer = self

        class H(logging.Handler):
            def emit(self, record):
                outer.records.append(record.getMessage())
        self._h = H(logging.WARNING)

    def __enter__(self):
        self._logger.addHandler(self._h)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self._h)


def test_skip_retry_keeps_run_bit_identical(worlds, monkeypatch):
    unguarded = _guarded_fit()
    monkeypatch.setenv("HVD_TPU_SDC_GUARD", "1")
    clean = _guarded_fit()
    key = 'hvd_tpu_sdc_detections_total{kind="nonfinite"}'
    before = _counter(key)
    corrupt = _guarded_fit(spec="worker.grads:bitflip:step=3")
    assert _counter(key) == before + 1
    for k, v in clean.params.items():
        assert torch.equal(corrupt.params[k], v)
        assert torch.equal(unguarded.params[k], v)


def test_guarded_run_matches_jax_guarded_run(worlds, monkeypatch):
    monkeypatch.setenv("HVD_TPU_SDC_GUARD", "1")
    x, y = _toy_data()
    jm, variables, model = _mlp_pair()
    JF.configure("worker.grads:bitflip:step=3", seed=SEED)
    je = JEstimator(jm, optimizer=optax.sgd(1e-2), seed=3,
                    scale_lr_by_world=False)
    je.params = variables
    je.fit(x, y, epochs=2, batch_size=16, shard=False)
    te = _guarded_fit(spec="worker.grads:bitflip:step=3", model=model)
    for a, b in zip(jax.tree_util.tree_leaves(je.params), _mlp_leaves(te)):
        _close(b, a)


def test_persistent_corruption_drops_the_batch(worlds, monkeypatch):
    monkeypatch.setenv("HVD_TPU_SDC_GUARD", "1")
    monkeypatch.setattr(sdc.policy, "ROLLBACK_TRIPS", 3)
    with _Records() as rec:
        est = _guarded_fit(
            epochs=1, spec="worker.grads:nan:step=3;worker.grads:nan:step=4")
    assert any("batch dropped" in m for m in rec.records)
    assert all(torch.isfinite(v).all() for v in est.params.values())


def test_repeat_trips_roll_back_to_last_good(worlds, monkeypatch, tmp_path):
    monkeypatch.setenv("HVD_TPU_SDC_GUARD", "1")
    monkeypatch.setenv("HVD_TPU_SDC_CONFIRM_STEPS", "1")
    rb_before = _counter("hvd_tpu_sdc_rollbacks_total")
    with _Records() as rec:
        _guarded_fit(epochs=3, checkpoint_dir=str(tmp_path),
                     spec="worker.grads:nan:step=9;worker.grads:nan:step=10")
    assert _counter("hvd_tpu_sdc_rollbacks_total") == rb_before + 1
    assert _counter("hvd_tpu_sdc_last_good_step") == 0
    assert any("rolled back to last-good step 0" in m for m in rec.records)


def test_rollback_without_last_good_skips_instead(worlds, monkeypatch):
    monkeypatch.setenv("HVD_TPU_SDC_GUARD", "1")
    with _Records() as rec:
        est = _guarded_fit(
            epochs=1, spec="worker.grads:nan:step=1;worker.grads:nan:step=2")
    assert any("no last-good" in m for m in rec.records)
    assert all(torch.isfinite(v).all() for v in est.params.values())


def test_guard_off_means_site_never_fires(worlds, monkeypatch):
    monkeypatch.delenv("HVD_TPU_SDC_GUARD", raising=False)
    key = ('hvd_tpu_faults_injected_total'
           '{site="worker.grads",kind="bitflip"}')
    before = _counter(key)
    _guarded_fit(epochs=1, spec="worker.grads:bitflip:step=1")
    assert _counter(key) == before


def test_guarded_step_holds_local_gradients(worlds, monkeypatch):
    """No bucket fires before the guard has run, and a tripped step fires
    none at all."""
    from horovod_tpu_torch.optimizer import DistributedOptimizer
    monkeypatch.setenv("HVD_TPU_SDC_GUARD", "1")
    events = []
    fire = DistributedOptimizer._fire_bucket
    monkeypatch.setattr(DistributedOptimizer, "_fire_bucket",
                        lambda self, bid: (events.append("fire"),
                                           fire(self, bid))[1])
    check = sdc.StepGuard.check
    monkeypatch.setattr(sdc.StepGuard, "check",
                        lambda self, g, l: (events.append("check"),
                                            check(self, g, l))[1])
    _guarded_fit(epochs=1, spec="worker.grads:nan:step=2")
    # 4 steps, the second retried: every check precedes its fires, and the
    # tripped attempt fires nothing
    steps = "".join("c" if e == "check" else "f" for e in events)
    assert steps.startswith("cf") and "cc" in steps
    assert steps.count("c") == 5


# ---------------------------------------------------------------------------
# a gloo world of 2
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metric_average_and_sharded_fit_in_a_gloo_world(tmp_path):
    env = dict(os.environ)
    env.update(HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               HVD_TPU_SIZE="2",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, HERE, "world", str(tmp_path)],
        env=dict(env, HVD_TPU_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = [p.communicate(timeout=120)[0].decode(errors="replace")
            for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n===\n".join(logs)
    res = [json.load(open(tmp_path / f"world.{r}.json")) for r in range(2)]
    for r in res:
        # numeric scalars averaged as float64; strings and bools untouched
        assert r["logs"]["loss"] == 2.0
        assert r["logs"]["acc"] == 0.125
        assert r["logs"]["t"] == 1.0 and r["logs"]["n"] == 1.5
        assert r["logs"]["name"] == "x" and r["logs"]["flag"] is True
    # one broadcast at the first batch, averaged gradients after: the
    # replicas stay equal, and so do their averaged logs
    assert res[0]["params"] == res[1]["params"]
    assert res[0]["history"] == res[1]["history"]
    assert res[0]["evaluate"] == res[1]["evaluate"]
