"""Cross-replica parameter fingerprints (counterpart of
``horovod_tpu/sdc/fingerprint.py``).

Data-parallel replicas hold bit-identical parameters by construction. A
replica whose parameters drift (a bit flipped after the guard's gradient
check, a corrupted optimizer slot, bad HBM) is invisible to the loss until
the model is poisoned. Every ``HVD_TPU_SDC_FINGERPRINT_EVERY`` guarded
steps each rank folds its parameters into one uint32 checksum
(:func:`fold_fingerprint`) and publishes it through the ``schedule`` KV
scope (``_schedule.py``); a mismatch names the diverging rank(s) by
majority vote, and :class:`FingerprintMonitor` turns it into a
``fingerprint`` detection for the rollback/quarantine policy.

The fold is the JAX package's, bit for bit: each inexact leaf is cast to
float32, its 32-bit patterns are summed mod 2^32, and the sums are chained
FNV-1a style by leaf index (index counted over every leaf). The sums run
on the parameters' device as int64 sums of the int32 patterns (equal to
the unsigned sum mod 2^32, and no uint32 arithmetic is needed from
torch), all leaves' sums come back in one host sync, and the chain is
folded on the host in Python ints. Leaves are taken in the JAX tree's
order (``guard.tree_leaves``: names sorted by dotted path), which the
chain depends on.
"""

import logging
from typing import Dict, List, Optional

import torch

from .. import _schedule
from .. import config as _config
from .. import metrics as _metrics
from .guard import _M_DETECTIONS, Detection, tree_leaves

log = logging.getLogger("horovod_tpu.sdc")

_M_FP_DIVERGENCE = _metrics.counter(
    "hvd_tpu_sdc_fingerprint_divergence_total",
    "Cross-replica parameter fingerprint divergences, by the replica "
    "group they were detected in ('all' for the whole-world compare of "
    "pure-dp runs).",
    labels=("replica_group",))

#: FNV-1a constants
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_MASK = 0xFFFFFFFF


def _leaf_sums(tree) -> Dict[int, int]:
    """Leaf index -> the sum of its float32 bit patterns mod 2^32, for
    every inexact non-empty leaf."""
    idx, sums = [], []
    for i, leaf in enumerate(tree_leaves(tree)):
        t = torch.as_tensor(leaf).detach()
        if not t.is_floating_point() or t.numel() == 0:
            continue
        if t.dtype != torch.float32:
            t = t.to(torch.float32)
        idx.append(i)
        sums.append(torch.sum(t.view(torch.int32), dtype=torch.int64))
    if not sums:
        return {}
    devices = {s.device for s in sums}
    if len(devices) > 1:
        sums = [s.cpu() for s in sums]
    return {i: s & _MASK for i, s in zip(idx, torch.stack(sums).tolist())}


def fold_fingerprint(tree) -> int:
    """One uint32 checksum over every inexact leaf's raw bits."""
    acc = _FNV_OFFSET
    for i, s in _leaf_sums(tree).items():
        acc = ((acc ^ s) * _FNV_PRIME + i) & _MASK
    return acc


def fold_leaf_fingerprints(tree) -> Dict[int, int]:
    """Per-leaf uint32 checksums, keyed by leaf index: the same fold as
    :func:`fold_fingerprint`, not chained across leaves, so a divergence
    can name the corrupted leaf."""
    return {i: ((_FNV_OFFSET ^ s) * _FNV_PRIME + i) & _MASK
            for i, s in _leaf_sums(tree).items()}


def fingerprint_diverged(fp, group) -> torch.Tensor:
    """True (a bool tensor) when the members of ``group`` (a process
    group) disagree on the fingerprint ``fp``: its MAX and MIN over the
    group, through ``parallel.comm.all_reduce_max``."""
    from .. import basics
    from ..parallel.comm import all_reduce_max
    dev = basics.device() if basics.is_initialized() else None
    fp = torch.as_tensor(fp, dtype=torch.int64, device=dev).reshape(1)
    hi = all_reduce_max(fp, group)
    lo = -all_reduce_max(-fp, group)
    return (hi != lo).reshape(())


class FingerprintMonitor:
    """Periodic publish-and-compare through the ``schedule`` KV scope.

    ``maybe_check(step, params)`` is a no-op except every
    ``HVD_TPU_SDC_FINGERPRINT_EVERY``-th step. On a mismatch it returns a
    :class:`Detection` of kind ``fingerprint`` whose ``local`` flag says
    whether THIS rank is in the diverging minority.

    On a sharded (dp x fsdp x tp) mesh only ranks along dp hold
    bit-identical parameters: pass ``replica_group``/``group_ranks`` (or
    build via :meth:`for_mesh`) to fold per-leaf fingerprints and compare
    them only across the ranks of this rank's replica group, published
    under keys scoped by ``(replica_group, rank)``.
    """

    def __init__(self, every: Optional[int] = None,
                 replica_group: Optional[int] = None,
                 group_ranks: Optional[List[int]] = None):
        self.every = int(_config.live_config().get(
            _config.SDC_FINGERPRINT_EVERY)) if every is None else int(every)
        self.replica_group = replica_group
        self.group_ranks = list(group_ranks) if group_ranks else None

    @classmethod
    def for_mesh(cls, world_size: int, rank: int, dp: int,
                 every: Optional[int] = None) -> "FingerprintMonitor":
        """Monitor scoped to ``rank``'s replica group on a mesh with
        ``dp`` data-parallel replicas over ``world_size`` ranks."""
        from ..parallel import mesh_utils
        group = mesh_utils.replica_group_of(rank, world_size, dp)
        ranks = mesh_utils.replica_groups(world_size, dp)[group]
        return cls(every=every, replica_group=group, group_ranks=ranks)

    def maybe_check(self, step: int, params) -> Optional[Detection]:
        if self.every <= 0 or step % self.every != 0:
            return None
        fp = fold_fingerprint(params)
        scoped = self.group_ranks is not None
        leaf_fps = fold_leaf_fingerprints(params) if scoped else None
        rank = _schedule.publish_sdc_fingerprint(
            step, fp, group=self.replica_group, leaf_fps=leaf_fps)
        if scoped:
            if len(self.group_ranks) < 2:
                return None   # lone shard-holder: publish-only
            peers = _schedule.fetch_sdc_fingerprints(
                group=self.replica_group, ranks=self.group_ranks)
        else:
            size = _world_size()
            if size < 2:
                return None
            peers = _schedule.fetch_sdc_fingerprints(size)
        diverged = _schedule.diff_sdc_fingerprints(
            peers, step, group=self.replica_group)
        if diverged is None:
            return None
        ranks, msg = diverged
        _M_DETECTIONS.labels(kind="fingerprint").inc()
        _M_FP_DIVERGENCE.labels(
            replica_group=str(self.replica_group)
            if scoped else "all").inc()
        log.warning("sdc: %s", msg)
        return Detection(kind="fingerprint", local=rank in ranks)


def _world_size() -> int:
    from .. import basics
    if basics.is_initialized():
        return basics.size()
    import os
    try:
        return int(os.environ.get("HVD_TPU_SIZE") or 1)
    except ValueError:
        return 1
