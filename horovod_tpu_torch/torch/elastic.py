"""Elastic state for torch models and optimizers under the torch
frontend's module path (counterpart of ``horovod_tpu/torch/elastic.py``):
the core's :class:`TorchState` and :func:`run`.
"""

from ..elastic.run import run, run_fn  # noqa: F401
from ..elastic.state import ObjectState, TorchState  # noqa: F401
from ..functions import (  # noqa: F401
    broadcast_optimizer_state, broadcast_parameters,
)
