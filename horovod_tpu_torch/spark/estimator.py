"""Spark ML estimator machinery shared by the port's KerasEstimator and
TorchEstimator (counterpart of ``horovod_tpu/spark/estimator.py``;
reference: horovod/spark/common/params.py, spark/common/estimator.py).

The flow is the JAX package's:

  fit(df) -> materialize the DataFrame as Parquet through the Store
          -> run the training function (one worker per Spark executor
             through horovod_tpu_torch.spark.run, or in this process when
             no Spark session is live)
          -> return a Model transformer carrying the trained weights.

PySpark is optional: with a live SparkSession the estimator is a Spark ML
stage (DataFrame in and out); without it the same estimator trains from a
pandas DataFrame through the same Store and Parquet path.
"""

import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .store import LocalStore, Store, read_parquet_shard, write_parquet


def _pyspark():
    try:
        import pyspark
        return pyspark
    except ImportError:
        return None


def _is_spark_df(df) -> bool:
    ps = _pyspark()
    if ps is None:
        return False
    from pyspark.sql import DataFrame
    return isinstance(df, DataFrame)


class EstimatorParams:
    """Getter/setter param plumbing (reference spark/common/params.py).

    Every param ``foo`` gets ``setFoo/getFoo`` through ``_param_names`` —
    the Spark ML calling convention without requiring pyspark at import.
    """

    _param_names: List[str] = [
        "model", "optimizer", "loss", "metrics", "feature_cols",
        "label_cols", "output_cols", "batch_size", "epochs",
        "validation", "sample_weight_col", "num_proc", "store", "run_id",
        "verbose", "shuffle", "random_seed", "streaming",
        "row_group_rows",
    ]

    def __init__(self, **kwargs):
        self.model = None
        self.optimizer = None
        self.loss = None
        self.metrics = []
        self.feature_cols = ["features"]
        self.label_cols = ["label"]
        self.output_cols: Optional[List[str]] = None
        self.batch_size = 32
        self.epochs = 1
        #: float fraction in [0, 1) OR a column name (any str, even a
        #: numeric-looking one) whose rows with value > 0 form the
        #: validation set; rows with value 0 train, negative rows drop
        #: out of both sets (both reference forms,
        #: spark/common/params.py `validation`)
        self.validation = None
        #: per-row training weight column (reference `sample_weight_col`)
        self.sample_weight_col: Optional[str] = None
        self.num_proc: Optional[int] = None
        self.store: Optional[Store] = None
        self.run_id: Optional[str] = None
        self.verbose = 0
        self.shuffle = True
        self.random_seed = 0
        #: stream row groups through ParquetBatchIterator instead of
        #: materializing the shard in memory (the Petastorm reader role;
        #: datasets larger than worker RAM). Torch estimator only.
        self.streaming = False
        #: Parquet row-group size for the materialized dataset — the
        #: streaming reader's memory/shuffle granularity (smaller groups
        #: = finer shuffling and lower worker memory, more IO calls)
        self.row_group_rows = 4096
        for k, v in kwargs.items():
            if k not in self._param_names:
                raise TypeError(f"unknown estimator param {k!r}")
            setattr(self, k, v)

    def __getattr__(self, name):
        # setFooBar / getFooBar -> foo_bar  (Spark ML convention)
        for prefix in ("set", "get"):
            if name.startswith(prefix) and len(name) > 3:
                snake = "".join(
                    "_" + c.lower() if c.isupper() else c
                    for c in name[3:]).lstrip("_")
                if snake in self._param_names:
                    if prefix == "set":
                        def setter(value, _n=snake):
                            setattr(self, _n, value)
                            return self
                        return setter
                    return lambda _n=snake: getattr(self, _n)
        raise AttributeError(name)


class HorovodEstimator(EstimatorParams):
    """Common fit() machinery; subclasses provide the framework specifics
    (serialize model, remote train fn, build the Model transformer)."""

    def _resolve_store(self) -> Store:
        if self.store is None:
            import tempfile
            self.store = LocalStore(
                tempfile.mkdtemp(prefix="hvd_tpu_store_"))
        elif isinstance(self.store, str):
            self.store = Store.create(self.store)
        return self.store

    def _resolve_run_id(self) -> str:
        if not self.run_id:
            self.run_id = f"run_{int(time.time())}_{uuid.uuid4().hex[:8]}"
        return self.run_id

    # -- validation spec -----------------------------------------------------
    def _validation_spec(self):
        """('fraction', f) | ('column', name) | None — the reference's two
        `validation` forms (spark/common/params.py): a float fraction, or
        the name of a column whose rows with value > 0 are validation."""
        if self.validation is None:
            return None
        v = self.validation
        if isinstance(v, str):
            # ANY string is a column name (reference spark/common/util.py
            # check_validation): a column literally named '0.2' must not
            # be coerced into a fraction
            return ("column", v)
        frac = float(v)
        if not 0.0 <= frac < 1.0:
            raise ValueError(
                f"validation must be a fraction in [0, 1) or a column "
                f"name, got {self.validation!r} (reference estimator "
                f"`validation` param)")
        return ("fraction", frac)

    def _extra_cols(self) -> List[str]:
        """Columns beyond features+labels that must ship in the Parquet."""
        extra = []
        spec = self._validation_spec()
        if spec and spec[0] == "column":
            extra.append(spec[1])
        if self.sample_weight_col:
            extra.append(self.sample_weight_col)
        return extra

    # -- data materialization ------------------------------------------------
    def _materialize(self, df) -> str:
        """DataFrame -> Parquet under the store; returns the dataset path."""
        store = self._resolve_store()
        path = store.get_train_data_path(self._resolve_run_id())
        cols = (list(self.feature_cols) + list(self.label_cols)
                + self._extra_cols())
        fs = getattr(store, "fs", None)
        if _is_spark_df(df):
            if int(self.row_group_rows) != 4096:
                # Spark's writer sizes row groups in BYTES
                # (parquet.block.size), not rows; this knob only shapes
                # the pandas/dict materialization path
                import logging
                logging.getLogger("horovod_tpu_torch").warning(
                    "row_group_rows is ignored for Spark DataFrames — "
                    "configure spark.hadoop.parquet.block.size on the "
                    "session instead")
            df.select(cols).write.mode("overwrite").parquet(path)
        else:
            # pandas or dict-of-arrays
            if hasattr(df, "to_dict"):
                data = {c: np.stack(df[c].to_numpy()) if df[c].dtype == object
                        else df[c].to_numpy() for c in cols}
            else:
                data = {c: np.asarray(df[c]) for c in cols}
            write_parquet(path, data, fs=fs,
                          row_group_rows=int(self.row_group_rows))
        return path

    # -- training dispatch ---------------------------------------------------
    def _run_distributed(self, train_fn: Callable, train_path: str):
        """Run ``train_fn(rank, size, train_path)`` on every worker; returns
        rank-0's result. Uses Spark executors when a session is live,
        otherwise the current process (single worker or an existing
        horovod_tpu_torch world)."""
        ps = _pyspark()
        if ps is not None:
            from pyspark.sql import SparkSession
            if SparkSession.getActiveSession() is not None:
                from . import run as spark_run
                results = spark_run(
                    _SparkTrainTask(train_fn, train_path),
                    num_proc=self.num_proc, verbose=bool(self.verbose))
                return results[0]
        from .. import basics
        if basics.is_initialized():
            rank, size = basics.rank(), basics.size()
        else:
            rank, size = 0, 1
        return train_fn(rank, size, train_path)

    def _pre_fit_validate(self) -> None:
        """Param validation that must run BEFORE the (possibly expensive)
        Parquet materialization. Subclasses extend (and call super)."""
        self._validation_spec()

    def fit(self, df):
        """Materialize ``df`` and train; returns the fitted Model
        transformer (reference: estimator.py fit / _fit_on_prepared_data)."""
        self._pre_fit_validate()
        train_path = self._materialize(df)
        train_fn = self._make_train_fn()
        result = self._run_distributed(train_fn, train_path)
        return self._make_model(result)

    # -- subclass hooks ------------------------------------------------------
    def _make_train_fn(self) -> Callable:
        raise NotImplementedError

    def _make_model(self, train_result):
        raise NotImplementedError


def load_split_shard(train_path: str, feature_cols: List[str],
                     label_cols: List[str], rank: int, size: int,
                     sample_weight_col: Optional[str] = None,
                     validation_spec=None, fs=None):
    """Read this worker's Parquet shard and split train/validation.

    Returns ``(train_arrays, val_arrays_or_None, w_train, w_val)`` where
    the array lists follow ``feature_cols + label_cols`` order. Implements
    both reference validation forms (spark/common/params.py): a fraction
    (tail rows of the shard) or a column whose rows with value > 0 are
    validation; plus the per-row ``sample_weight_col``.
    """
    names = list(feature_cols) + list(label_cols)
    val_col = (validation_spec[1]
               if validation_spec and validation_spec[0] == "column"
               else None)
    extra = ([sample_weight_col] if sample_weight_col else []) \
        + ([val_col] if val_col else [])
    arrays = read_parquet_shard(train_path, names + extra, rank, size,
                                fs=fs)
    data = [np.asarray(a) for a in arrays[:len(names)]]
    k = len(names)
    w = np.asarray(arrays[k], dtype=np.float32) if sample_weight_col \
        else None
    if val_col:
        col = np.asarray(arrays[-1])
        # reference semantics (spark/common/util.py _train_val_split):
        # train is col == 0 and val is col > 0, so NEGATIVE values drop
        # out of both sets
        tmask = col == 0
        vmask = col > 0
        train = [a[tmask] for a in data]
        val = [a[vmask] for a in data]
        return (train, val,
                w[tmask] if w is not None else None,
                w[vmask] if w is not None else None)
    if validation_spec and validation_spec[0] == "fraction" \
            and validation_spec[1] > 0:
        n_val = int(len(data[0]) * validation_spec[1])
        if n_val:
            train = [a[:-n_val] for a in data]
            val = [a[-n_val:] for a in data]
            return (train, val,
                    w[:-n_val] if w is not None else None,
                    w[-n_val:] if w is not None else None)
    return data, None, w, None


class _SparkTrainTask:
    """Picklable wrapper so the train fn ships to Spark executors."""

    def __init__(self, fn, train_path):
        self.fn = fn
        self.train_path = train_path

    def __call__(self):
        from .. import basics
        basics.init()
        try:
            return self.fn(basics.rank(), basics.size(), self.train_path)
        finally:
            basics.shutdown()


class HorovodModel:
    """Base transformer returned by fit() (reference: spark/common —
    KerasModel/TorchModel). ``transform`` appends prediction columns."""

    def __init__(self, feature_cols: List[str], label_cols: List[str],
                 output_cols: Optional[List[str]] = None):
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.output_cols = list(output_cols) if output_cols else [
            c + "__output" for c in self.label_cols]

    def _predict(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _stack_features(self, df, rows=None):
        cols = []
        for c in self.feature_cols:
            col = df[c]
            arr = (np.stack(col.to_numpy()) if hasattr(col, "to_numpy")
                   else np.asarray(col))
            if arr.dtype == object:
                arr = np.stack(arr)
            cols.append(arr.reshape(len(arr), -1))
        return np.concatenate(cols, axis=1) if len(cols) > 1 else cols[0]

    def transform(self, df):
        if _is_spark_df(df):
            import pandas as pd
            from pyspark.sql.functions import pandas_udf

            model = self

            @pandas_udf("array<double>")
            def predict_udf(*feature_series):
                feats = np.concatenate(
                    [np.stack(s.to_numpy()).reshape(len(s), -1)
                     for s in feature_series], axis=1)
                preds = model._predict(feats)
                return pd.Series(list(np.asarray(preds, dtype=np.float64)))

            return df.withColumn(self.output_cols[0],
                                 predict_udf(*self.feature_cols))
        out = df.copy()
        preds = np.asarray(self._predict(self._stack_features(df)))
        out[self.output_cols[0]] = list(preds)
        return out
