"""``horovod_tpu_torch.tensorflow.keras``: the reference's TF2 Keras entry
point (``import horovod.tensorflow.keras as hvd``), the same surface as
:mod:`horovod_tpu_torch.keras` (counterpart of
``horovod_tpu/tensorflow/keras.py``).
"""

from ..keras import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    Average, Sum, Adasum,
    DistributedOptimizer, allreduce, allgather, broadcast,
    broadcast_variables, callbacks, load_model,
)
from . import elastic  # noqa: F401  (KerasState)
