"""Checkpoint / resume facade (counterpart of ``horovod_tpu/checkpoint.py``).

A thin facade over :mod:`horovod_tpu_torch.checkpointing` with the
original one-shot signatures:

* :func:`save` returns only after the step is fully committed (and, in
  multi-process runs, after a barrier, or the COMMIT wait of a sharded
  tree);
* :func:`restore` defaults to the latest completed step; ``fallback=True``
  walks back past corrupt/partial steps, counting
  ``hvd_tpu_checkpoint_fallbacks_total``;
* :func:`latest_step` never reports a crashed save;
* :class:`CheckpointCallback` saves every N epochs from the callback loop.
"""

from .checkpointing import (CheckpointCallback, CheckpointManager,  # noqa: F401
                            IntegrityError, latest_step, restore, save)
from .checkpointing.layout import completed_steps as _completed_steps
from .checkpointing.manager import _M_FALLBACKS  # noqa: F401  (compat)


def _steps(directory: str):
    """Completed step numbers, newest first."""
    return _completed_steps(directory)
