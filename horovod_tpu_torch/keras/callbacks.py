"""Keras callbacks on the port's torch core (counterpart of
``horovod_tpu/keras/callbacks.py``; reference:
horovod/_keras/callbacks.py:22-190). The framework-neutral callbacks of
hand-written torch loops are :mod:`horovod_tpu_torch.callbacks`.
"""

import numpy as np

import keras

from .. import basics as _basics


class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
    """Broadcast the model's and the optimizer's weights from the root
    once, at the end of the first batch, so that a checkpoint restored
    after the callback was made still wins (reference:
    _keras/callbacks.py:22-46)."""

    def __init__(self, root_rank: int = 0):
        super().__init__()
        self.root_rank = root_rank
        self._done = False

    def on_train_batch_end(self, batch, logs=None):
        if self._done:
            return
        from ..tensorflow import broadcast_variables
        broadcast_variables(self.model.weights, root_rank=self.root_rank)
        opt_vars = getattr(self.model.optimizer, "variables", None)
        if opt_vars:
            vars_ = opt_vars() if callable(opt_vars) else opt_vars
            broadcast_variables(list(vars_), root_rank=self.root_rank)
        self._done = True


class MetricAverageCallback(keras.callbacks.Callback):
    """Average the epoch-end metrics across processes, in place, in
    sorted order (reference: _keras/callbacks.py:48-87)."""

    def on_epoch_end(self, epoch, logs=None):
        from ..callbacks import average_logs
        average_logs(logs, "keras.metric")


class LearningRateScheduleCallback(keras.callbacks.Callback):
    """Set the optimizer's LR to ``initial_lr * multiplier(epoch)`` within
    [start_epoch, end_epoch) (reference: _keras/callbacks.py:90-166);
    ``staircase`` sets it once an epoch, otherwise every batch at the
    fractional epoch."""

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch=None, staircase: bool = True,
                 steps_per_epoch=None):
        super().__init__()
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.steps_per_epoch = steps_per_epoch
        if not callable(multiplier):
            self.staircase = True
            self.multiplier = lambda e: multiplier
        else:
            self.staircase = staircase
            self.multiplier = multiplier
        self._epoch = 0

    def _set_lr(self, epoch_like: float):
        self.model.optimizer.learning_rate.assign(
            self.initial_lr * self.multiplier(epoch_like))

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def on_train_batch_begin(self, batch, logs=None):
        if self._epoch < self.start_epoch or (
                self.end_epoch is not None and self._epoch >= self.end_epoch):
            return
        if self.staircase:
            if batch == 0:
                self._set_lr(self._epoch)
        else:
            spe = self.steps_per_epoch or self.params.get("steps")
            if not spe:
                raise ValueError(
                    "non-staircase schedules need steps_per_epoch "
                    "(reference: _autodetect_steps_per_epoch)")
            self._set_lr(self._epoch + batch / spe)

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = float(
                np.asarray(self.model.optimizer.learning_rate))


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Warm the LR up from ``initial_lr / size`` to ``initial_lr`` over
    ``warmup_epochs`` (reference: _keras/callbacks.py:169-190)."""

    def __init__(self, initial_lr: float, warmup_epochs: float = 5,
                 steps_per_epoch=None, verbose: int = 0):
        def multiplier(epoch):
            n = _basics.dp_size() if _basics.is_initialized() else 1
            spe = self.steps_per_epoch or self.params.get("steps") or 1
            epoch += 1.0 / spe
            return 1.0 / n * (epoch * (n - 1) / warmup_epochs + 1)

        super().__init__(initial_lr, multiplier, start_epoch=0,
                         end_epoch=warmup_epochs, staircase=False,
                         steps_per_epoch=steps_per_epoch)
        self.verbose = verbose
