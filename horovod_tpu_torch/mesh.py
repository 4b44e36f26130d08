"""The eager plane's process groups (counterpart of ``WorldMesh`` in
``horovod_tpu/mesh.py``).

The JAX package reduces over the ``'proc'`` axis of a mesh holding one
device per process; here the same role is a ``torch.distributed`` process
group. The world is the default group; a process set (the reference's
subset communicator, ``hvd.init(process_sets=...)``) is a group made by
``dist.new_group``. ``dist.new_group`` is collective over the WHOLE
world: every process must create every set, in the same order, or init
deadlocks, so :meth:`WorldMesh.subset` is only called from ``init()``,
which walks the same list on every process.
"""

from typing import Sequence

import torch.distributed as dist


class WorldMesh:
    """One process group of the eager plane: ``ranks`` are the global
    ranks of its members, in set order; ``group`` is None for the world
    (the default group)."""

    def __init__(self, ranks: Sequence[int], group=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group
        self.num_procs = len(self.ranks)
        #: stable key of the set, the same on every process
        self.cache_key = self.ranks
        me = dist.get_rank()
        self._my_index = self.ranks.index(me) if me in self.ranks else -1

    @property
    def is_member(self) -> bool:
        return self._my_index >= 0

    @property
    def my_index(self) -> int:
        """This process's index in the set; raises for a process outside
        it, as the JAX package's ``anchor_device`` does."""
        if self._my_index < 0:
            raise ValueError(
                "this process has no device in the mesh/process set; only "
                "member processes may call collectives on it")
        return self._my_index

    def global_rank(self, index: int) -> int:
        """The global rank of the member at ``index`` of the set."""
        return self.ranks[index]

    def subset(self, proc_indices: Sequence[int]) -> "WorldMesh":
        """A process set over some of the world's processes, its members
        in rank order (the order of the group ``dist.new_group`` makes).
        Collective over the whole world: every process calls it with the
        same indices."""
        ranks = sorted(self.ranks[i] for i in proc_indices)
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"process set {list(proc_indices)} repeats a "
                             f"process")
        return WorldMesh(ranks, dist.new_group(ranks))
