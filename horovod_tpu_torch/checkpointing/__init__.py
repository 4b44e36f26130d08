"""Async sharded checkpointing of horovod_tpu_torch (the torch counterpart
of ``horovod_tpu/checkpointing``; both write one on-disk format).

* **snapshot-then-persist**: ``CheckpointManager.save(step, tree)``
  copies leaves to host on the training thread, a bounded background
  writer does the serialize/checksum/fsync/commit (:mod:`.manager`,
  :mod:`.snapshot`);
* **sharded multi-writer layout with integrity manifests**: each process
  writes only the blocks it owns (:class:`Shard` leaves); a JSON manifest
  carries per-shard CRC32s and an atomically renamed ``COMMIT`` marker
  gates discovery (:mod:`.layout`);
* **resharding restore**: shards reassemble by global offsets and each
  process takes the blocks its target asks for, so the saving and
  restoring meshes are independent;
* **retention GC**: keep-last-N / keep-every-K from the writer thread
  (:mod:`.gc`).
"""

from .gc import collect, retained_steps                          # noqa: F401
from .layout import (COMMITTED, LEGACY, PARTIAL, IntegrityError,  # noqa: F401
                     classify, completed_steps, latest_step, step_dir)
from .manager import (CheckpointCallback, CheckpointManager,      # noqa: F401
                      CheckpointWriterCrashed, drain_all)
from .snapshot import Shard, snapshot_tree                        # noqa: F401


def save(directory: str, step: int, tree, force: bool = False) -> str:
    """One-shot synchronous save (the facade's contract: returns after
    the step is committed; multi-process runs barrier, or wait for the
    COMMIT when the tree is sharded)."""
    return CheckpointManager(directory).save(step, tree, async_=False,
                                             force=force)


def restore(directory: str, step=None, target=None, sharding=None,
            fallback: bool = False):
    """One-shot restore through a throwaway manager (see
    :meth:`CheckpointManager.restore`)."""
    return CheckpointManager(directory).restore(
        step=step, target=target, sharding=sharding, fallback=fallback)
