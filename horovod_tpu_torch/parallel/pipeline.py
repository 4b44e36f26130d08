"""Pipeline parallelism over the 'pp' mesh axis (counterpart of
``horovod_tpu/parallel/pipeline.py``).

The GPipe microbatch schedule as a loop over T = M + P - 1 ticks for P
stages and M microbatches: at each tick every stage applies itself to the
activation that arrived, and the result moves one stage on through a
differentiable send/recv (``comm.SendRecv``, the counterpart of the JAX
version's ppermute), and the last stage's slots are summed over the group
(``comm.sum_replicated``). Backward is autograd through the loop: the
send/recv's transpose carries gradients back stage to stage in the drain
order, as reverse-mode AD through the JAX version's ``scan`` does.

Bubble fraction is (P-1)/(M+P-1); pick M >= 4*P for >80% utilization.
"""

from typing import Callable

import torch
import torch.distributed as dist

from .comm import SendRecv, sum_replicated


def pipeline_shard_fn(stage_fn: Callable, stage_params, microbatches,
                      group):
    """One stage's part of the pipeline; every member of ``group`` (stage
    index = its rank in the group) calls it.

    Args:
      stage_fn: (params, x) -> y, the per-stage computation. All stages
        share this structure (e.g. a stack of identical decoder layers).
      stage_params: this stage's parameters.
      microbatches: (M, mb, ...) full input, the same on every stage (only
        stage 0 consumes it).
    Returns (M, mb, ...) final-stage outputs, the same on every stage.
    """
    P = dist.get_world_size(group)
    idx = dist.get_rank(group)
    M = microbatches.shape[0]
    T = M + P - 1
    dst = idx + 1 if idx + 1 < P else None
    src = idx - 1 if idx > 0 else None
    # selections as where() on the stage index, as in the JAX version:
    # every stage's graph then reaches every shift it made, so each
    # stage's backward runs every shift's transpose, in the same order
    first = torch.tensor(idx == 0, device=microbatches.device)
    last = torch.tensor(idx == P - 1, device=microbatches.device)
    incoming = torch.zeros_like(microbatches[0])
    slots = []
    for t in range(T):
        # stage 0 injects microbatch t (clamped; its results after t >= M
        # fall outside the returned slice)
        x = torch.where(first, microbatches[min(t, M - 1)], incoming)
        y = stage_fn(stage_params, x)
        # the last stage's output for microbatch (t - P + 1); other stages'
        # slots are zeros, so the sum over stages is exact
        slots.append(torch.where(last, y, torch.zeros_like(y)))
        if t + 1 < T:  # the final shift is unnecessary
            incoming, = SendRecv.apply(group, dst, src, y)
    outs = sum_replicated(torch.stack(slots), group)
    return outs[P - 1:T]                                 # (M, mb, ...)


def pipeline_apply(stage_fn: Callable, stacked_params, microbatches, mesh,
                   axis_name: str = "pp"):
    """Run the pipeline over ``mesh``'s ``axis_name`` with stage params
    stacked on a leading axis of size P (``stacked_params[name][p]`` is
    stage p's): each pp rank takes its slice. ``stacked_params`` is a dict
    of tensors; ``microbatches`` (M, mb, ...) is the global input, the same
    on every rank. Returns (M, mb, ...) on every rank."""
    from .mesh_utils import axis_size, require_axes
    require_axes(mesh, axis_name)
    P = axis_size(mesh, axis_name)
    idx = mesh.get_local_rank(axis_name)
    for name, leaf in stacked_params.items():
        if leaf.shape[0] != P:
            raise ValueError(f"stacked parameter {name!r} has leading size "
                             f"{leaf.shape[0]}, expected {P} stages")
    params = {name: leaf[idx] for name, leaf in stacked_params.items()}
    return pipeline_shard_fn(stage_fn, params, microbatches,
                             mesh.get_group(axis_name))
