"""Training-loop callbacks (counterpart of ``horovod_tpu/callbacks.py``).

Only the hook protocol is ported so far: :class:`Callback`, the base
class of ``checkpointing.CheckpointCallback``. Its ``run`` is the
training-run record the loop threads through the hooks (anything with a
``params`` attribute: the tree to checkpoint). The Keras-style callbacks
(broadcast, metric averaging, learning-rate schedules) and their
``CallbackList`` wait for the port's frontends.
"""


class Callback:
    run = None  # the training-run record, set by the loop

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch: int, logs=None):
        pass

    def on_batch_begin(self, batch: int, logs=None):
        pass

    def on_batch_end(self, batch: int, logs=None):
        pass

    def on_epoch_end(self, epoch: int, logs=None):
        pass
