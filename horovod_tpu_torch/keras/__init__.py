"""The Keras frontend: Keras 3 models trained on the port's torch core
(counterpart of ``horovod_tpu/keras``; reference: horovod/keras and
horovod/_keras).

Gradients are reduced at the optimizer's ``apply_gradients`` (the
TensorFlow frontend's :func:`DistributedOptimizer`), and the callbacks
are ``keras.callbacks.Callback`` subclasses for ``model.fit``. Keras must
run on its TensorFlow backend: under another backend importing keras
would load that backend (JAX's, for ``KERAS_BACKEND=jax``), so this
module refuses any other before it imports keras, and again after, for a
backend chosen in keras.json. It sets no environment of its own.

Usage::

    import horovod_tpu_torch.keras as hvd
    hvd.init()
    model.compile(optimizer=hvd.DistributedOptimizer(opt), ...)
    model.fit(x, y, callbacks=[
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
    ])
"""

import os


def _require_tensorflow_backend():
    def refuse(backend):
        raise ImportError(
            f"horovod_tpu_torch.keras needs Keras on its TensorFlow "
            f"backend (KERAS_BACKEND=tensorflow); it is set to "
            f"{backend!r}")
    backend = os.environ.get("KERAS_BACKEND")
    if backend and backend != "tensorflow":
        refuse(backend)
    import keras
    if keras.backend.backend() != "tensorflow":
        refuse(keras.backend.backend())


_require_tensorflow_backend()

from ..basics import (  # noqa: E402,F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
)
from ..collectives import Average, Sum, Adasum  # noqa: E402,F401
from ..tensorflow import (  # noqa: E402,F401
    DistributedOptimizer, allreduce, allgather, broadcast,
    broadcast_variables,
)
from . import callbacks  # noqa: E402,F401


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=None):
    """Load a saved Keras model with its optimizer wrapped in
    :func:`DistributedOptimizer`, so that retraining reduces gradients
    (reference: horovod/keras/__init__.py:117-145 load_model). The model
    loads as Keras saved it, optimizer state included, and the live
    optimizer is wrapped afterwards; ``custom_optimizers`` only makes
    those classes visible to deserialization."""
    import keras
    objects = dict(custom_objects or {})
    for cls in custom_optimizers or ():
        objects.setdefault(cls.__name__, cls)
    model = keras.models.load_model(filepath, custom_objects=objects)
    if getattr(model, "optimizer", None) is not None:
        DistributedOptimizer(model.optimizer, compression=compression)
    return model
