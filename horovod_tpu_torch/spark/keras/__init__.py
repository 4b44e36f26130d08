"""KerasEstimator: a Spark ML stage training a Keras model on the port's
core (counterpart of ``horovod_tpu/spark/keras``; reference:
horovod/spark/keras/estimator.py:105-379).

The driver serializes the model (its JSON config and weights); each
worker materializes its Parquet shard, broadcasts the initial weights and
trains with the TensorFlow frontend's ``DistributedOptimizer``, and the
fit returns a :class:`KerasModel` transformer. ``custom_objects`` ship
custom layers and losses to the workers; ``sample_weight_col`` and both
forms of ``validation`` (a fraction, or a column) are supported. Keras
runs on its TensorFlow backend (see :mod:`horovod_tpu_torch.keras`).
"""

from typing import List, Optional

import numpy as np

from ..estimator import HorovodEstimator, HorovodModel, load_split_shard


def _serialize_keras(model):
    return {"config": model.to_json(),
            "weights": [np.array(w) for w in model.get_weights()]}


def _deserialize_keras(blob, custom_objects=None):
    from ...keras import _require_tensorflow_backend
    _require_tensorflow_backend()
    import keras
    model = keras.models.model_from_json(
        blob["config"], custom_objects=custom_objects or {})
    model.set_weights(blob["weights"])
    return model


class KerasEstimator(HorovodEstimator):
    """Usage (reference recipe)::

        est = KerasEstimator(model=model, optimizer="sgd", loss="mse",
                             feature_cols=["features"], label_cols=["y"],
                             batch_size=32, epochs=4, store=store)
        keras_model = est.fit(df)            # Spark or pandas DataFrame
        pred_df = keras_model.transform(df)
    """

    _param_names: List[str] = HorovodEstimator._param_names + [
        "custom_objects",
    ]

    def _pre_fit_validate(self) -> None:
        super()._pre_fit_validate()
        if self.streaming:
            # silently materializing would hand the user the exact OOM
            # they set the flag to avoid
            raise ValueError(
                "streaming=True is implemented for TorchEstimator only; "
                "KerasEstimator materializes the worker shard in memory")

    def __init__(self, **kwargs):
        #: name -> class/function mapping shipped to workers so custom
        #: layers/losses deserialize (reference keras estimator
        #: `custom_objects`)
        self.custom_objects = None
        super().__init__(**kwargs)

    def _make_train_fn(self):
        blob = _serialize_keras(self.model)
        custom_objects = self.custom_objects
        optimizer = self.optimizer or "sgd"
        loss = self.loss or "mse"
        metrics = list(self.metrics or [])
        feature_cols = list(self.feature_cols)
        label_cols = list(self.label_cols)
        batch_size, epochs = int(self.batch_size), int(self.epochs)
        shuffle, seed = bool(self.shuffle), int(self.random_seed)
        verbose = int(self.verbose)
        validation_spec = self._validation_spec()
        sample_weight_col = self.sample_weight_col
        fs = getattr(self._resolve_store(), "fs", None)

        def train_fn(rank: int, size: int, train_path: str):
            import keras

            from ... import tensorflow as hvd_tf

            model = _deserialize_keras(blob, custom_objects)
            if size > 1:
                # initial weight broadcast (reference:
                # BroadcastGlobalVariablesCallback role)
                ws = model.get_weights()
                ws = [np.asarray(hvd_tf.broadcast(
                    _np_tensor(w), 0, name=f"keras_est.w.{i}"))
                    for i, w in enumerate(ws)]
                model.set_weights(ws)

            train, val, w_t, w_v = load_split_shard(
                train_path, feature_cols, label_cols, rank, size,
                sample_weight_col=sample_weight_col,
                validation_spec=validation_spec, fs=fs)
            x = _stack(train[:len(feature_cols)])
            y = _stack(train[len(feature_cols):])
            validation_data = None
            if val is not None:
                xv = _stack(val[:len(feature_cols)])
                yv = _stack(val[len(feature_cols):])
                validation_data = (xv, yv, w_v) if w_v is not None \
                    else (xv, yv)

            opt = (keras.optimizers.get(optimizer)
                   if isinstance(optimizer, str) else optimizer)
            if size > 1:
                opt = hvd_tf.DistributedOptimizer(opt)
            model.compile(optimizer=opt, loss=loss, metrics=metrics)
            history = model.fit(x, y, batch_size=batch_size, epochs=epochs,
                                shuffle=shuffle, verbose=verbose,
                                sample_weight=w_t,
                                validation_data=validation_data)
            return {"weights": [np.array(w) for w in model.get_weights()],
                    "history": {k: [float(v) for v in vs]
                                for k, vs in history.history.items()}}

        def _np_tensor(w):
            import tensorflow as tf
            return tf.convert_to_tensor(np.asarray(w))

        def _stack(arrays):
            out = [a.reshape(len(a), -1) if a.ndim > 1 else a
                   for a in (np.asarray(a) for a in arrays)]
            if len(out) == 1:
                a = out[0]
                return a
            return np.concatenate(
                [a.reshape(len(a), -1) for a in out], axis=1)

        return train_fn

    def _make_model(self, train_result):
        model = _deserialize_keras(_serialize_keras(self.model),
                                   self.custom_objects)
        model.set_weights(train_result["weights"])
        return KerasModel(model, self.feature_cols, self.label_cols,
                          self.output_cols,
                          history=train_result.get("history"),
                          custom_objects=self.custom_objects)


class KerasModel(HorovodModel):
    """Transformer carrying trained Keras weights (reference:
    spark/keras/estimator.py KerasModel)."""

    def __init__(self, model, feature_cols: List[str],
                 label_cols: List[str],
                 output_cols: Optional[List[str]] = None, history=None,
                 custom_objects=None):
        super().__init__(feature_cols, label_cols, output_cols)
        self.model = model
        self.history = history or {}
        self.custom_objects = custom_objects

    def getModel(self):
        return self.model

    def _predict(self, features: np.ndarray) -> np.ndarray:
        return np.asarray(self.model.predict(features, verbose=0))
