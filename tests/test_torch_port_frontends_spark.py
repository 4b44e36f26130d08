"""The port's Spark package (``horovod_tpu_torch.spark``: the Store and its
Parquet IO, the estimator machinery, ``TorchEstimator``/``TorchModel``,
``run``/``run_elastic``) against the JAX package's ``horovod_tpu.spark``,
the oracle, on the CPU and without pyspark.

* Parquet written by either package reads in the other, exactly;
  ``ParquetBatchIterator`` delivers every row once across ranks, and its
  seeded shuffle equals the JAX iterator's batch for batch.
* ``TorchEstimator`` (``device="cpu"``) from the same module, data and
  seed as the JAX one, in memory and streaming, with validation by
  fraction and by column and sample weights: the per-epoch histories
  within TOL_HISTORY, the fitted weights and the transform too. Both run
  in a world of one process in this process, where neither wraps the
  optimizer; the float32 products are the same torch calls on the same
  inputs, so the results are in fact equal.
* ``run_elastic``'s driver loop over a fake barrier stage makes the same
  attempts with the same environments as the JAX loop.
"""

import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")
pytest.importorskip("pyarrow")

import horovod_tpu.spark as jspark  # noqa: E402
import horovod_tpu.spark.store as jstore  # noqa: E402
import horovod_tpu_torch.spark as pspark  # noqa: E402
import horovod_tpu_torch.spark.store as pstore  # noqa: E402
from horovod_tpu.spark.torch import TorchEstimator as JEst  # noqa: E402
from horovod_tpu_torch.spark.torch import TorchEstimator  # noqa: E402
from tests import torch_port_frontends_common as common  # noqa: E402

TOL_HISTORY = 1e-6


@pytest.fixture(scope="module", autouse=True)
def worlds():
    with common.both_worlds():
        yield


def _columns(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return {"vec": rng.randn(n, 3).astype(np.float32),
            "ids": rng.randint(0, 1000, (n, 5)).astype(np.int64),
            "y": rng.randn(n).astype(np.float64),
            "flag": (np.arange(n) % 3 == 0).astype(np.int32)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_parquet_crosses_packages(tmp_path, writer):
    cols = _columns()
    w, r = (pstore, jstore) if writer == "port" else (jstore, pstore)
    path = str(tmp_path / "data")
    w.write_parquet(path, cols, row_group_rows=7, partitions=3)
    names = list(cols)
    for rank in range(2):
        got = r.read_parquet_shard(path, names, rank, 2)
        for name, a in zip(names, got):
            assert a.dtype == cols[name].dtype
            assert np.array_equal(a, cols[name][rank::2])


def test_batch_iterator_every_row_once_and_shuffle_equal_jax(tmp_path):
    cols = _columns(53)
    cols["row"] = np.arange(53)
    path = str(tmp_path / "d")
    pstore.write_parquet(path, cols, row_group_rows=5, partitions=2)
    names = ["row", "vec"]
    seen = []
    for rank in range(3):
        for epoch in (0, 1):
            p = pstore.ParquetBatchIterator(path, names, 4, rank, 3,
                                            shuffle=True, seed=11)
            j = jstore.ParquetBatchIterator(path, names, 4, rank, 3,
                                            shuffle=True, seed=11)
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            pb, jb = list(p), list(j)
            assert len(pb) == len(jb)
            for a, b in zip(pb, jb):
                assert all(np.array_equal(a[c], b[c]) for c in names)
            if epoch == 0:
                seen += [int(v) for b in pb for v in b["row"]]
    assert sorted(seen) == list(range(53))
    dropped = pstore.ParquetBatchIterator(path, names, 4, 0, 1,
                                          drop_last=True)
    assert all(len(b["row"]) == 4 for b in dropped)


def test_store_paths_and_schemes_equal_jax(tmp_path):
    for kw in ({}, {"train_path": str(tmp_path / "t"),
                    "checkpoint_path": str(tmp_path / "c")}):
        p = pstore.Store.create(str(tmp_path), **kw)
        j = jstore.Store.create(str(tmp_path), **kw)
        assert type(p).__name__ == type(j).__name__ == "LocalStore"
        for fn in ("get_train_data_path", "get_val_data_path",
                   "get_checkpoint_path", "get_logs_path"):
            assert getattr(p, fn)("r1") == getattr(j, fn)("r1")
    pytest.importorskip("fsspec")
    m = pstore.Store.create("memory://port-store")
    assert isinstance(m, pstore.FsspecStore)
    assert m.get_train_data_path("r") == jstore.Store.create(
        "memory://port-store").get_train_data_path("r")
    for mod in (pstore, jstore):
        with pytest.raises(ValueError, match="no store backend"):
            mod.Store.create("nosuchscheme://x")
    # a local checkpoint dir syncs into the store
    local = tmp_path / "ckpt"
    local.mkdir()
    (local / "a.txt").write_text("x")
    p = pstore.LocalStore(str(tmp_path / "store"))
    p.sync_fn("r2")(str(local))
    assert (tmp_path / "store" / "runs" / "r2" / "checkpoints"
            / "a.txt").read_text() == "x"


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


def _net():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                               torch.nn.Dropout(0.25), torch.nn.Linear(8, 1))


def mae(outputs, targets):
    return (outputs - targets).abs().mean()


CASES = {
    "plain": {},
    "fraction": {"validation": 0.25},
    "column_weights": {"validation": "is_val", "sample_weight_col": "w"},
    "streaming": {"streaming": True, "validation": "is_val",
                  "row_group_rows": 16},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_estimator_equal_jax(tmp_path, case):
    df = _frame()
    out = {}
    for key, cls, store in (("port", TorchEstimator, pstore.LocalStore),
                            ("jax", JEst, jstore.LocalStore)):
        kw = dict(model=_net(),
                  optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
                  loss=torch.nn.MSELoss(), metrics=[mae],
                  feature_cols=[f"f{i}" for i in range(4)],
                  label_cols=["label"], batch_size=16, epochs=3,
                  random_seed=5, store=store(str(tmp_path / key)),
                  **CASES[case])
        if key == "port":
            kw["device"] = "cpu"
        torch.manual_seed(1)   # the dropout masks
        fitted = cls(**kw).fit(df)
        preds = fitted.transform(df.head(10))[fitted.output_cols[0]]
        state = {k: v.numpy() if isinstance(v, torch.Tensor) else v
                 for k, v in fitted.getModel().state_dict().items()}
        out[key] = (fitted.loss_history, fitted.val_loss_history,
                    fitted.metrics_history, np.stack(preds.to_numpy()),
                    state)
    (pl, pv, pm, pp, ps), (jl, jv, jm, jp, js) = out["port"], out["jax"]
    assert len(pl) == 3 and len(pv) == (0 if case == "plain" else 3)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=TOL_HISTORY)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=TOL_HISTORY)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=0, atol=TOL_HISTORY)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=TOL_HISTORY)
    for k in js:
        np.testing.assert_allclose(ps[k], js[k], rtol=0, atol=TOL_HISTORY)


def test_torch_estimator_and_model_default_to_cuda():
    """Without a card and without device="cpu", the estimator and the
    model it returns raise; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from horovod_tpu_torch.spark.torch import TorchModel
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEstimator(model=_net())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchModel(_net(), ["f0"], ["label"])
    est = TorchEstimator(model=_net(), device="cpu")
    assert est.device == torch.device("cpu") and est.getDevice() == est.device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        est.setDevice("cuda")
        est.fit(_frame(16))


def test_estimator_params_equal_jax():
    for cls in (TorchEstimator, JEst):
        kw = {"device": "cpu"} if cls is TorchEstimator else {}
        est = cls(model=_net(), epochs=6, batch_size=7, **kw)
        assert est.getEpochs() == 6 and est.getBatchSize() == 7
        est.setEpochs(2).setValidation("is_val")
        assert est.epochs == 2 and est._validation_spec() == (
            "column", "is_val")
        with pytest.raises(TypeError, match="unknown estimator param"):
            cls(bogus=1)
        with pytest.raises(ValueError, match="validation"):
            cls(model=_net(), validation=1.5, **kw)._validation_spec()
    assert "device" not in JEst._param_names


def test_load_split_shard_equal_jax(tmp_path):
    from horovod_tpu.spark.estimator import load_split_shard as jsplit
    from horovod_tpu_torch.spark.estimator import load_split_shard
    df = _frame(40)
    df.loc[3, "is_val"] = -1.0
    path = str(tmp_path / "d")
    pstore.write_parquet(path, {c: df[c].to_numpy() for c in df.columns})
    for spec in (None, ("fraction", 0.25), ("column", "is_val")):
        for rank in range(2):
            got = load_split_shard(path, ["f0", "f1"], ["label"], rank, 2,
                                   sample_weight_col="w",
                                   validation_spec=spec)
            want = jsplit(path, ["f0", "f1"], ["label"], rank, 2,
                          sample_weight_col="w", validation_spec=spec)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                elif isinstance(w, list):
                    assert all(np.array_equal(a, b) for a, b in zip(g, w))
                else:
                    assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# run / run_elastic
# ---------------------------------------------------------------------------

def _elastic(mod, scenario):
    attempts, live = [], {"n": 4}

    def submit(n, env):
        attempts.append((n, env["HVD_TPU_ELASTIC_JOB_ID"],
                         env["HVD_TPU_ELASTIC_STATE_DIR"],
                         sorted(k for k in env)))
        if scenario == "retry" and len(attempts) < 3:
            raise RuntimeError("barrier task died")
        if scenario == "shrink" and len(attempts) == 1:
            live["n"] = 2
            raise RuntimeError("executor lost")
        if scenario == "exhaust":
            raise RuntimeError("always fails")
        return [f"rank{i}" for i in range(n)]
    kw = {"retry": dict(num_proc=2, min_np=1, reset_limit=3,
                        env={"EXTRA": "1"}),
          "shrink": dict(num_proc=4, min_np=2, max_np=4, reset_limit=2),
          "exhaust": dict(num_proc=1, reset_limit=1),
          "min_np": dict(min_np=3, reset_limit=0)}[scenario]
    avail = (lambda: 1) if scenario == "min_np" else (lambda: live["n"])
    try:
        result = mod.run_elastic(None, _submit_attempt=submit,
                                 _available_parallelism=avail, **kw)
    except RuntimeError as e:
        result = ("raised", str(e))
    shape = [(n, k) for n, _, _, k in attempts]
    same_job = len({a[1] for a in attempts}) <= 1 \
        and len({a[2] for a in attempts}) <= 1
    return result, shape, same_job


@pytest.mark.parametrize("scenario", ["retry", "shrink", "exhaust", "min_np"])
def test_run_elastic_loop_equal_jax(scenario):
    got, want = _elastic(pspark, scenario), _elastic(jspark, scenario)
    assert got == want
    assert got[2]   # one job id and state dir across generations
    if scenario == "shrink":
        assert [n for n, _ in got[1]] == [4, 2] and got[0] == [
            "rank0", "rank1"]


def test_missing_pyspark_raises_naming_the_port():
    import importlib.util
    if importlib.util.find_spec("pyspark") is not None:
        pytest.skip("pyspark is installed")
    for fn in (lambda: pspark.run(lambda: None),
               lambda: pspark.run_elastic(lambda: None)):
        with pytest.raises(ImportError, match="horovod_tpu_torch.spark "
                                              "requires pyspark"):
            fn()
