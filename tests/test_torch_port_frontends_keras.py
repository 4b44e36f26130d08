"""The port's Keras frontend (``horovod_tpu_torch.keras``, its callbacks,
``load_model``, ``horovod_tpu_torch.tensorflow.keras``) and the Spark
``KerasEstimator`` against the JAX package's, the oracle, on the CPU
(Keras 3 on its TensorFlow backend).

Both packages run a world of one process in this process and train the
same Keras model (``keras.utils.set_random_seed`` before each build and
each fit, so weights, shuffles and data are the same): ``model.fit`` with
the wrapped optimizer under the four callbacks, a saved model through
``load_model``, and the estimator's fit, transform and validation. The
weights, the learning rates and the histories are compared exactly in
fp32 (tolerance 0); the estimators' per-epoch histories within 1e-6.
The warmup callback scales by ``dp_size()``: the JAX world in a test
process spans conftest's 8 forced CPU devices, and at one process the
warmup is the identity, so both packages' width is pinned to 2 there.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
keras = pytest.importorskip("keras")
pd = pytest.importorskip("pandas")

import horovod_tpu.basics as jbasics  # noqa: E402
import horovod_tpu.keras as jk  # noqa: E402
import horovod_tpu_torch.keras as pk  # noqa: E402
from tests import torch_port_frontends_common as common  # noqa: E402

common.cap_tf_threads(tf)
ROOT = common.ROOT
TOL_HISTORY = 1e-6


@pytest.fixture(scope="module", autouse=True)
def worlds():
    with common.both_worlds():
        yield


@pytest.fixture
def width_two(monkeypatch):
    import horovod_tpu_torch.basics as pbasics
    monkeypatch.setattr(jbasics, "dp_size", lambda: 2)
    monkeypatch.setattr(pbasics, "dp_size", lambda: 2)


def _model():
    keras.utils.set_random_seed(0)
    return keras.Sequential([keras.Input(shape=(4,)),
                             keras.layers.Dense(8, activation="relu"),
                             keras.layers.Dense(1)])


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x @ np.array([[1.0], [-2.0], [0.5], [2.0]], np.float32)
         + 0.1 * rng.randn(n, 1).astype(np.float32))
    return x, y


def _lr_callbacks(mod, kind):
    cb = mod.callbacks
    if kind == "warmup":
        return [cb.LearningRateWarmupCallback(initial_lr=0.05,
                                              warmup_epochs=2,
                                              steps_per_epoch=4)]
    return [cb.LearningRateScheduleCallback(
        initial_lr=0.05, multiplier=lambda e: 0.5 ** e, start_epoch=1)]


def _fit(mod, kind):
    model = _model()
    opt = mod.DistributedOptimizer(keras.optimizers.SGD(0.05, momentum=0.9))
    model.compile(optimizer=opt, loss="mse", metrics=["mae"])
    x, y = _data()
    lrs = []

    class RecordLR(keras.callbacks.Callback):
        def on_train_batch_begin(self, batch, logs=None):
            lrs.append(float(np.asarray(self.model.optimizer.learning_rate)))
    keras.utils.set_random_seed(1)
    hist = model.fit(x, y, epochs=3, batch_size=16, verbose=0, callbacks=[
        mod.callbacks.BroadcastGlobalVariablesCallback(0),
        mod.callbacks.MetricAverageCallback(),
        *_lr_callbacks(mod, kind), RecordLR()])
    return ([w.tolist() for w in model.get_weights()], lrs,
            {k: list(v) for k, v in hist.history.items()})


@pytest.mark.parametrize("kind", ["warmup", "schedule"])
def test_fit_with_callbacks_equal_jax(width_two, kind):
    got, want = _fit(pk, kind), _fit(jk, kind)
    assert got[0] == want[0]          # weights, exactly
    assert got[1] == want[1]          # the LR at every batch
    assert got[2] == want[2]          # loss, mae and lr per epoch
    assert len(set(got[1])) > 1       # the callback moved the LR


def test_callbacks_reduce_and_broadcast_through_the_port(monkeypatch):
    """The wrapped optimizer reduces once a step (one grouped allreduce
    of every gradient), BroadcastGlobalVariablesCallback broadcasts once
    (model, then optimizer variables), MetricAverageCallback averages
    each epoch's logs."""
    import horovod_tpu_torch.tensorflow as ptf
    calls = {"grouped_allreduce": 0, "grouped_broadcast": 0, "allreduce": 0}
    for name in calls:
        real = getattr(ptf._c, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ptf._c, name, spy)
    _fit(pk, "schedule")
    assert calls["grouped_allreduce"] == 12      # 3 epochs x 4 steps
    assert calls["grouped_broadcast"] == 2       # model, optimizer
    # loss and mae each epoch (the schedule adds lr after the average)
    assert calls["allreduce"] == 2 * 3


def test_load_model_wraps_optimizer_equal_jax(tmp_path, monkeypatch):
    model = _model()
    model.compile(optimizer=keras.optimizers.Adam(0.01), loss="mse")
    x, y = _data(32, seed=2)
    model.fit(x, y, epochs=1, verbose=0, shuffle=False)
    path = str(tmp_path / "model.keras")
    model.save(path)
    import horovod_tpu_torch.tensorflow as ptf
    calls = []
    real = ptf._c.grouped_allreduce
    monkeypatch.setattr(ptf._c, "grouped_allreduce",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = {}
    for key, mod in (("port", pk), ("jax", jk)):
        loaded = mod.load_model(path)
        assert loaded.optimizer.apply_gradients.__qualname__.startswith(
            "DistributedOptimizer")
        loaded.fit(x, y, epochs=2, batch_size=8, verbose=0, shuffle=False)
        out[key] = [w.tolist() for w in loaded.get_weights()] + [
            np.asarray(v).tolist() for v in loaded.optimizer.variables]
    assert out["port"] == out["jax"]
    assert len(calls) == 8


def test_tensorflow_keras_namespace():
    import horovod_tpu_torch.tensorflow.keras as htk
    assert htk.DistributedOptimizer is pk.DistributedOptimizer
    assert htk.callbacks is pk.callbacks
    assert htk.load_model is pk.load_model
    assert htk.elastic.KerasState.__name__ == "TensorFlowKerasState"
    import horovod_tpu.tensorflow.keras as jtk
    for mod, jmod in ((htk, jtk), (pk, jk), (pk.callbacks, jk.callbacks)):
        names = [n for n in dir(jmod) if not n.startswith("_")
                 and not isinstance(getattr(jmod, n), type(os))]
        assert [n for n in names if not hasattr(mod, n)] == []


def test_other_keras_backend_is_refused_before_keras_imports():
    """Under KERAS_BACKEND=jax the port's keras module raises a clear
    ImportError and loads neither keras nor jax (which is blocked here)."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'horovod_tpu'):\n"
            "    sys.modules[m] = None\n"
            "try:\n"
            "    import horovod_tpu_torch.keras\n"
            "except ImportError as e:\n"
            "    print('refused:', e)\n"
            "print('keras' in sys.modules, 'tensorflow' in sys.modules)\n")
    env = dict(os.environ, KERAS_BACKEND="jax", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "refused:" in r.stdout and "TensorFlow backend" in r.stdout
    assert r.stdout.strip().endswith("False False")


# ---------------------------------------------------------------------------
# the Spark KerasEstimator (pandas path, no pyspark)
# ---------------------------------------------------------------------------

def _frame(n=96, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x @ np.array([[1.0], [-2.0], [0.5], [2.0]], np.float32)).ravel() \
        + 0.05 * rng.randn(n).astype(np.float32)
    df = pd.DataFrame({f"f{i}": x[:, i] for i in range(4)})
    df["label"] = y
    df["is_val"] = (np.arange(n) % 4 == 0).astype(np.float64)
    df["w"] = rng.uniform(0.5, 1.5, n)
    return df


@pytest.mark.parametrize("validation", [None, 0.25, "is_val"])
def test_keras_estimator_equal_jax(tmp_path, validation):
    from horovod_tpu.spark.keras import KerasEstimator as JEst
    from horovod_tpu.spark.store import LocalStore as JStore
    from horovod_tpu_torch.spark.keras import KerasEstimator
    from horovod_tpu_torch.spark.store import LocalStore
    df = _frame()
    out = {}
    for key, est_cls, store_cls in (("port", KerasEstimator, LocalStore),
                                    ("jax", JEst, JStore)):
        est = est_cls(
            model=_model(), optimizer="adam", loss="mse", metrics=["mae"],
            feature_cols=[f"f{i}" for i in range(4)], label_cols=["label"],
            batch_size=16, epochs=3, validation=validation,
            sample_weight_col="w" if validation == "is_val" else None,
            store=store_cls(str(tmp_path / key)))
        keras.utils.set_random_seed(3)
        fitted = est.fit(df)
        preds = fitted.transform(df.head(8))[fitted.output_cols[0]]
        out[key] = (fitted.history, np.stack(preds.to_numpy()),
                    [w for w in fitted.getModel().get_weights()])
    (ph, pp, pw), (jh, jp, jw) = out["port"], out["jax"]
    assert sorted(ph) == sorted(jh)
    if validation is not None:
        assert len(ph["val_loss"]) == 3
    for k in jh:
        np.testing.assert_allclose(ph[k], jh[k], rtol=0, atol=TOL_HISTORY)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=TOL_HISTORY)
    for a, b in zip(pw, jw):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_HISTORY)
