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

The compiled plane (``DistributedOptimizer(axis_name=, inner_axis=)``)
reduces over named dims of a ``torch.distributed`` DeviceMesh, where the
JAX package reduces over the named axes of the mesh ``shard_map``
supplies. There the inner axis is the devices inside one process, on ICI
(``horovod_tpu/mesh.py:1-18``); a process of the port drives one GPU, so
its inner axis is the processes on one host and its outer axis the
hosts: :func:`cross_local_mesh` is the world as a 2-D DeviceMesh with
dims ("cross", "local") from ``cross_rank``/``cross_size`` and
``local_rank``/``local_size``. Any other DeviceMesh over the world
(``parallel.mesh_utils.make_training_mesh``'s) serves the same way by its
dim names. :func:`flat_group` is one group over the product of several
dims (one collective over two axes at once), and :func:`group_allreduce`
and :func:`group_allgather` are the compiled plane's wire calls, each run
through ``collectives.run_in_order``.
"""

import math
from typing import List, Sequence

import torch
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


MESH_DIMS = ("cross", "local")


def cross_local_mesh():
    """The world as a DeviceMesh with dims ("cross", "local"): a host's
    processes share a row (``local``, ``local_size`` of them) and the
    hosts form the columns (``cross``). Made once per world, collectively:
    every process calls it at the same point. Needs the launcher's host
    by host layout, rank = cross_rank * local_size + local_rank."""
    from . import basics
    w = basics.world()
    mesh = w.groups.get(MESH_DIMS)
    if mesh is None:
        cross, local = basics.cross_size(), basics.local_size()
        if cross * local != w.size or w.rank != (
                basics.cross_rank() * local + basics.local_rank()):
            raise ValueError(
                f"the ('cross', 'local') mesh needs the ranks laid out "
                f"host by host (rank = cross_rank * local_size + "
                f"local_rank, cross_size * local_size = size); rank "
                f"{w.rank} of {w.size} has cross {basics.cross_rank()} of "
                f"{cross} and local {basics.local_rank()} of {local}")
        from torch.distributed.device_mesh import init_device_mesh
        mesh = w.groups[MESH_DIMS] = init_device_mesh(
            w.device.type, (cross, local), mesh_dim_names=MESH_DIMS)
    return mesh


def flat_group(mesh, dims: Sequence[str]):
    """One process group over the product of ``mesh``'s ``dims``: the
    processes that share this process's coordinates on every other dim.
    ``mesh`` must span the world; made once per world, collectively (every
    process makes every such group, in the same order)."""
    from . import basics
    w = basics.world()
    names = tuple(mesh.mesh_dim_names or ())
    missing = [d for d in dims if d not in names]
    if missing:
        raise ValueError(f"mesh has dims {names}, not {missing}")
    layout = mesh.mesh
    if layout.numel() != dist.get_world_size():
        raise ValueError("a group over several mesh dims needs a mesh over "
                         "the whole world")
    key = ("flat", tuple(layout.shape), tuple(layout.flatten().tolist()),
           names, tuple(dims))
    if key not in w.groups:
        idx = [names.index(d) for d in dims]
        rest = [i for i in range(layout.dim()) if i not in idx]
        rows = layout.permute(rest + idx).reshape(
            -1, math.prod(layout.shape[i] for i in idx)).tolist()
        if len(rows) == 1:
            group = dist.group.WORLD
        else:
            for row in rows:
                g = dist.new_group(sorted(row))
                if w.rank in row:
                    group = g
        w.groups[key] = group
    return w.groups[key]


def group_allreduce(tensors: Sequence[torch.Tensor], group,
                    op=dist.ReduceOp.SUM) -> List[torch.Tensor]:
    """``tensors`` (one dtype) reduced over ``group`` with ``op`` in ONE
    wire call on their concatenation (a new buffer; the inputs are not
    written), split back into their shapes."""
    from .collectives import run_in_order
    if len(tensors) == 1:
        buf = tensors[0].detach().reshape(-1).clone()
    else:
        buf = torch.cat([t.detach().reshape(-1) for t in tensors])
    run_in_order(lambda: dist.all_reduce(buf, op=op, group=group),
                 [buf], [buf])
    sizes = [t.numel() for t in tensors]
    return [piece.view(t.shape) for piece, t in
            zip(torch.split(buf, sizes), tensors)]


def group_allgather(t: torch.Tensor, group) -> torch.Tensor:
    """Every member's ``t`` stacked in group order: shape (n,) + t.shape."""
    from .collectives import _all_gather_single, run_in_order
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    out = torch.empty(n * src.numel(), dtype=t.dtype, device=t.device)
    run_in_order(lambda: _all_gather_single(out, src.reshape(-1), group),
                 [src], [out])
    return out.view((n,) + tuple(t.shape))
