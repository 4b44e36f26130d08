"""Training-loop callbacks for distributed runs (counterpart of
``horovod_tpu/callbacks.py``).

Reference surface: the Keras callback family (horovod/_keras/callbacks.py:
BroadcastGlobalVariablesCallback, MetricAverageCallback,
LearningRateScheduleCallback, LearningRateWarmupCallback). Callbacks
operate on a :class:`TrainingRun` record that the loop threads through the
hooks: ``params`` is the model's ``state_dict()`` (broadcast in place),
and ``lr_scale`` is a factor the loop multiplies into its learning rate.
As in the JAX package, nothing applies ``lr_scale`` by itself (the
Estimator does not either): :func:`scaled_schedule` gives
``base(count) * run.lr_scale`` for the loop to write into its optimizer's
``param_groups``.

Typical loop::

    run = hvd.callbacks.TrainingRun(params=model.state_dict(),
                                    steps_per_epoch=spe)
    cbs = hvd.callbacks.CallbackList(
        [hvd.callbacks.BroadcastGlobalVariablesCallback(0),
         hvd.callbacks.LearningRateWarmupCallback(warmup_epochs=5),
         hvd.callbacks.MetricAverageCallback()], run)
    lr = hvd.callbacks.scaled_schedule(base_lr, run)
    cbs.on_train_begin()
    for epoch in range(E):
        cbs.on_epoch_begin(epoch)
        for batch in range(spe):
            cbs.on_batch_begin(batch)
            for g in opt.param_groups:
                g["lr"] = lr(step)
            logs = train_step(...)
            cbs.on_batch_end(batch, logs)
        cbs.on_epoch_end(epoch, logs)
    cbs.on_train_end(logs)   # drains async checkpoint saves, etc.
"""

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np


@dataclass
class TrainingRun:
    """Mutable record the callbacks read and write."""
    params: Any = None                  # the model's state_dict()
    steps_per_epoch: Optional[int] = None
    lr_scale: float = 1.0               # multiplied into the loop's LR
    epoch: int = 0
    extra_state: Dict[str, Any] = field(default_factory=dict)


class Callback:
    run: TrainingRun = None  # set by CallbackList

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


class CallbackList:
    def __init__(self, callbacks: List[Callback], run: TrainingRun):
        self.callbacks = list(callbacks)
        self.run = run
        for cb in self.callbacks:
            cb.run = run

    def __iter__(self):
        return iter(self.callbacks)

    def _fire(self, hook, *args, **kw):
        for cb in self.callbacks:
            getattr(cb, hook)(*args, **kw)

    def on_train_begin(self, logs=None):
        self._fire("on_train_begin", logs)

    def on_train_end(self, logs=None):
        # fired by the loop after the last epoch; async checkpoint
        # callbacks drain their in-flight saves here
        self._fire("on_train_end", logs)

    def on_epoch_begin(self, epoch, logs=None):
        self.run.epoch = epoch
        self._fire("on_epoch_begin", epoch, logs)

    def on_batch_begin(self, batch, logs=None):
        self._fire("on_batch_begin", batch, logs)

    def on_batch_end(self, batch, logs=None):
        self._fire("on_batch_end", batch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._fire("on_epoch_end", epoch, logs)


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast ``run.params`` from ``root_rank`` into every process's
    tensors once, at the end of the first batch (reference:
    _keras/callbacks.py:22-46; late-restored checkpoints win)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank
        self._done = False

    def on_batch_end(self, batch, logs=None):
        if self._done:
            return
        from .functions import broadcast_parameters
        broadcast_parameters(self.run.params, root_rank=self.root_rank)
        self._done = True


def average_logs(logs, name_prefix: str = "metric") -> None:
    """Average numeric scalar entries of ``logs`` across processes, in
    place, as float64, in sorted-name order so every process submits the
    same collective sequence (reference: _keras/callbacks.py:48-87)."""
    if not logs:
        return
    import torch
    from . import collectives as _c
    for metric in sorted(logs):
        value = logs[metric]
        if isinstance(value, bool) or not (
                isinstance(value, (int, float, np.floating, np.integer))
                or (hasattr(value, "shape") and np.ndim(value) == 0)):
            continue
        if isinstance(value, torch.Tensor):
            value = value.item()
        out = _c.allreduce(torch.tensor(float(value), dtype=torch.float64),
                           op=_c.Average, name=f"{name_prefix}.{metric}")
        logs[metric] = float(out)


class MetricAverageCallback(Callback):
    """Average the epoch-end metric logs across processes in place
    (reference: _keras/callbacks.py:48-87)."""

    def on_epoch_end(self, epoch, logs=None):
        average_logs(logs, "metric")


class LearningRateScheduleCallback(Callback):
    """Scale the loop's LR by ``multiplier(epoch)`` within
    [start_epoch, end_epoch) (reference: _keras/callbacks.py:90-166).
    ``staircase`` updates once per epoch; otherwise the epoch is fractional
    per batch (needs ``run.steps_per_epoch``)."""

    def __init__(self, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        if not callable(multiplier):
            self.staircase = True
            self.multiplier: Callable[[float], float] = lambda e: multiplier
        else:
            self.staircase = staircase
            self.multiplier = multiplier

    def on_batch_begin(self, batch, logs=None):
        epoch = self.run.epoch
        if epoch < self.start_epoch or (
                self.end_epoch is not None and epoch >= self.end_epoch):
            return
        if self.staircase:
            if batch == 0:
                self.run.lr_scale = float(self.multiplier(epoch))
        else:
            spe = self.run.steps_per_epoch
            if not spe:
                raise ValueError(
                    "non-staircase schedules need TrainingRun."
                    "steps_per_epoch (reference: _autodetect_steps_per_epoch)")
            self.run.lr_scale = float(self.multiplier(epoch + batch / spe))

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr_scale"] = self.run.lr_scale


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual warmup from 1x to dp_size()x LR over ``warmup_epochs``
    (reference: _keras/callbacks.py:169-190, formula from Goyal et al.
    "Accurate, Large Minibatch SGD"). The scale starts near 1/size (so
    base_lr * size * scale ~ base_lr) and reaches 1."""

    def __init__(self, warmup_epochs: float = 5, verbose: int = 0,
                 size: Optional[int] = None):
        self._size = size
        self.verbose = verbose

        def multiplier(epoch):
            n = self._world_size()
            epoch += 1.0 / (self.run.steps_per_epoch or 1)
            return 1.0 / n * (epoch * (n - 1) / warmup_epochs + 1)
        super().__init__(multiplier, start_epoch=0, end_epoch=warmup_epochs,
                         staircase=False)

    def _world_size(self) -> int:
        if self._size is not None:
            return self._size
        from . import basics
        return basics.dp_size() if basics.is_initialized() else 1

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if self.verbose and epoch == (self.end_epoch or 0) - 1:
            import logging
            logging.getLogger("horovod_tpu").info(
                "Epoch %d: finished gradual learning rate warmup to scale "
                "%.4f.", epoch + 1, self.run.lr_scale)


def scaled_schedule(base_schedule, run: TrainingRun):
    """``lr(count) = base(count) * run.lr_scale`` for a schedule (a
    callable of the step count) or a constant. The scale is read at call
    time; write the result into the optimizer's ``param_groups`` before
    each step."""
    def schedule(count):
        base = base_schedule(count) if callable(base_schedule) \
            else base_schedule
        return base * run.lr_scale
    return schedule
