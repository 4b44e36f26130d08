"""Hierarchical allreduce over two process groups (counterpart of
``horovod_tpu/parallel/hierarchical.py``).

Reference: NCCLHierarchicalAllreduce — NCCL ReduceScatter within the node,
an allreduce across nodes on the scattered shards, NCCL Allgather back.
Here the inner group carries the scatter and the gather, and the outer
group reduces 1/inner_size of the bytes: ``reduce_scatter_tensor`` over
the inner group, ``all_reduce`` over the outer group,
``all_gather_into_tensor`` over the inner group. Every process of the
world calls it with its own inner and outer group (two axes of a
DeviceMesh, ``mesh.get_group(axis)``); the three calls run in the
process's order of wire calls (``collectives.run_in_order``).
"""

import torch
import torch.distributed as dist

from ..collectives import run_in_order


def hierarchical_allreduce(x: torch.Tensor, inner_group, outer_group,
                           scatter_dimension: int = 0) -> torch.Tensor:
    """Sum ``x`` over both groups: reduce_scatter(inner) -> all_reduce
    (outer) -> all_gather(inner). Equal to a sum over every process of the
    two groups' product, moving 1/inner_size of the bytes over the outer
    group. ``x``'s ``scatter_dimension`` must divide by the inner size."""
    n_in = dist.get_world_size(inner_group)
    d = scatter_dimension % x.dim() if x.dim() else 0
    if x.dim() == 0 or x.shape[d] % n_in:
        raise ValueError(f"dimension {scatter_dimension} of a tensor of "
                         f"shape {tuple(x.shape)} does not divide by the "
                         f"inner group's size {n_in}")
    xs = x.movedim(d, 0).contiguous()
    part = torch.empty((xs.shape[0] // n_in,) + tuple(xs.shape[1:]),
                       dtype=x.dtype, device=x.device)
    out = torch.empty_like(xs)

    def wire():
        dist.reduce_scatter_tensor(part, xs, group=inner_group)
        dist.all_reduce(part, group=outer_group)
        dist.all_gather_into_tensor(out, part, group=inner_group)
    run_in_order(wire, [xs], [part, out])
    return out.movedim(0, d)


def hierarchical_pmean(x: torch.Tensor, inner_group, outer_group,
                       scatter_dimension: int = 0) -> torch.Tensor:
    n = dist.get_world_size(inner_group) * dist.get_world_size(outer_group)
    return hierarchical_allreduce(
        x, inner_group, outer_group, scatter_dimension) / n
