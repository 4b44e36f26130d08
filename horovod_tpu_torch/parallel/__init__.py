"""Parallel training of horovod_tpu_torch (counterpart of
``horovod_tpu/parallel``); data parallelism only so far."""

from .train import (  # noqa: F401
    TrainStepBundle, flash_attention_fn, make_transformer_train_step)
