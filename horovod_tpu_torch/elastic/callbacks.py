"""Elastic training callbacks for the callback protocol of
:mod:`horovod_tpu_torch.callbacks` (a copy of
``horovod_tpu/elastic/callbacks.py``).

Reference: horovod/_keras/elastic.py — CommitStateCallback
(commit every N batches), UpdateBatchStateCallback (resume mid-epoch at the
committed batch), UpdateEpochStateCallback (track the epoch in elastic
state). Semantics preserved; the host object is a
:class:`horovod_tpu_torch.elastic.State` instead of a Keras model.
"""

from ..callbacks import Callback


class CommitStateCallback(Callback):
    """``state.commit()`` every ``batches_per_commit`` batches and at epoch
    end — bounds lost work to that window on a worker failure."""

    def __init__(self, state, batches_per_commit: int = 1):
        self.state = state
        self.batches_per_commit = batches_per_commit
        self._remaining = batches_per_commit

    def on_batch_end(self, batch, logs=None):
        self._remaining -= 1
        if self._remaining == 0:
            self.state.commit()
            self._remaining = self.batches_per_commit

    def on_epoch_end(self, epoch, logs=None):
        self.state.commit()
        self._remaining = self.batches_per_commit


class UpdateBatchStateCallback(Callback):
    """Tracks the current batch in ``state.batch`` so a restored worker
    resumes mid-epoch; zeroed at epoch end. The loop reads
    ``state.batch`` as its starting batch after a reset."""

    def __init__(self, state):
        self.state = state

    def on_batch_end(self, batch, logs=None):
        self.state.batch = batch

    def on_epoch_end(self, epoch, logs=None):
        self.state.batch = 0


class UpdateEpochStateCallback(Callback):
    """Tracks the current epoch in ``state.epoch``."""

    def __init__(self, state):
        self.state = state

    def on_epoch_end(self, epoch, logs=None):
        self.state.epoch = epoch
