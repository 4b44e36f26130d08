"""Synchronized BatchNorm under the torch frontend's module path
(counterpart of ``horovod_tpu/torch/sync_batch_norm.py``): the core's
:class:`SyncBatchNorm`.
"""

from ..sync_batch_norm import SyncBatchNorm


def get_sync_batch_norm_class():
    """The SyncBatchNorm class (the JAX package builds it on first use, so
    that importing its torch frontend does not import torch)."""
    return SyncBatchNorm
