"""Elastic state for TensorFlow and Keras models (counterpart of
``horovod_tpu/tensorflow/elastic.py``; reference:
tensorflow/elastic.py:91-210).

``TensorFlowKerasState`` snapshots a Keras model's (and optimizer's)
weights, ``TensorFlowState`` a list of variables, in host numpy; ``sync``
re-seeds restarted workers with rank 0's live values, broadcast through
the port's core.
"""

from typing import List, Optional

import numpy as np
import torch

from .. import collectives as _c
from ..elastic.run import run, run_fn  # noqa: F401
from ..elastic.state import ObjectState


def _bcast_arrays(arrays: List[np.ndarray], prefix: str) -> List[np.ndarray]:
    return [_c.broadcast(torch.from_numpy(a), root_rank=0,
                         name=f"{prefix}.{i}").numpy()
            for i, a in enumerate(arrays)]


class TensorFlowKerasState(ObjectState):
    """Elastic state of a Keras model (and its optimizer) plus plain
    attributes (reference: tensorflow/elastic.py TensorFlowKerasState)::

        state = hvd.elastic.TensorFlowKerasState(model, optimizer, batch=0)
    """

    def __init__(self, model, optimizer=None, **kwargs):
        self.model = model
        self.optimizer = optimizer if optimizer is not None else getattr(
            model, "optimizer", None)
        self._saved_weights = [np.array(w) for w in model.get_weights()]
        self._saved_opt_weights = self._opt_values()
        bcast_object = kwargs.pop("bcast_object", None)
        get_rank = kwargs.pop("get_rank", None)
        super().__init__(bcast_object=bcast_object, get_rank=get_rank,
                         **kwargs)

    def _opt_vars(self):
        opt = self.optimizer
        if opt is None:
            return []
        # Keras 3 exposes .variables; legacy optimizers .weights
        return list(getattr(opt, "variables", None)
                    or getattr(opt, "weights", []) or [])

    def _opt_values(self):
        return [np.array(v.numpy()) for v in self._opt_vars()]

    def save(self) -> None:
        self._saved_weights = [np.array(w) for w in self.model.get_weights()]
        self._saved_opt_weights = self._opt_values()
        super().save()

    def restore(self) -> None:
        self.model.set_weights([w.copy() for w in self._saved_weights])
        for v, w in zip(self._opt_vars(), self._saved_opt_weights):
            v.assign(w)
        super().restore()

    def sync(self) -> None:
        weights = _bcast_arrays(
            [np.array(w) for w in self.model.get_weights()],
            "elastic.keras.w")
        self.model.set_weights(weights)
        opt_vals = _bcast_arrays(self._opt_values(), "elastic.keras.opt")
        for v, w in zip(self._opt_vars(), opt_vals):
            v.assign(w)
        self._saved_weights = [w.copy() for w in weights]
        self._saved_opt_weights = [w.copy() for w in opt_vals]
        super().sync()


# the Keras-facing name (reference: horovod/_keras/elastic.py KerasState)
KerasState = TensorFlowKerasState


class TensorFlowState(ObjectState):
    """Elastic state of a list of tf.Variables (reference:
    tensorflow/elastic.py TensorFlowState); all global variables when
    none are given."""

    def __init__(self, variables: Optional[List] = None, **kwargs):
        if variables is None:
            import tensorflow as tf
            variables = tf.compat.v1.global_variables()
        self.variables = list(variables)
        self._saved_values = [np.array(v.numpy()) for v in self.variables]
        bcast_object = kwargs.pop("bcast_object", None)
        get_rank = kwargs.pop("get_rank", None)
        super().__init__(bcast_object=bcast_object, get_rank=get_rank,
                         **kwargs)

    def save(self) -> None:
        self._saved_values = [np.array(v.numpy()) for v in self.variables]
        super().save()

    def restore(self) -> None:
        for v, val in zip(self.variables, self._saved_values):
            v.assign(val)
        super().restore()

    def sync(self) -> None:
        vals = _bcast_arrays(
            [np.array(v.numpy()) for v in self.variables], "elastic.tf.v")
        for v, val in zip(self.variables, vals):
            v.assign(val)
        self._saved_values = [v.copy() for v in vals]
        super().sync()
