"""Adasum gradient combining (counterpart of ``horovod_tpu/adasum.py``).

The pairwise rule (reference adasum.h:385-396):

    a' = (1 - dot(a,b) / (2·‖a‖²)) · a  +  (1 - dot(a,b) / (2·‖b‖²)) · b

with the reductions over the whole tensor, in fp32 for half types, and a
log2(n)-level tree over the contributions (the reference's
vector-halving distance-doubling schedule), so the number of processes
must be a power of two. The eager allreduce(op=Adasum) gathers each
tensor from every process into an (n, ...) stack and runs the tree on
every process. :func:`adasum_grads` is the compiled plane's form (the
JAX package's in-jit ``adasum_grads``): a plain mean over an inner group
first, then the tree over the gathered rows of an outer group.
"""

from typing import List, Optional

import torch

_HALF = (torch.float16, torch.bfloat16)


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two same-shape tensors with the Adasum rule."""
    acc = torch.float32 if a.dtype in _HALF else a.dtype
    af, bf = a.to(acc), b.to(acc)
    dot = torch.sum(af * bf)
    na = torch.sum(af * af)
    nb = torch.sum(bf * bf)
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * torch.where(na > 0, na, 1.0)),
                     0.0)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * torch.where(nb > 0, nb, 1.0)),
                     0.0)
    return (ca * af + cb * bf).to(a.dtype)


def adasum_tree(stacked: torch.Tensor) -> torch.Tensor:
    """Adasum-combine ``stacked[i]`` over dim 0 (its length a power of two)
    with an unrolled log2(n) reduction tree."""
    n = stacked.shape[0]
    if not _is_pow2(n):
        message = (f"Adasum requires a power-of-two number of contributions, "
                   f"got {n} (reference: horovod/common/util.py "
                   f"num_rank_is_power_2).")
        if torch.compiler.is_compiling():
            # raised at trace time, as the JAX package raises while it traces
            from .collectives import _trace_fail
            _trace_fail(ValueError, message)
        raise ValueError(message)
    level = [stacked[i] for i in range(n)]
    while len(level) > 1:
        level = [adasum_pair(level[2 * i], level[2 * i + 1])
                 for i in range(len(level) // 2)]
    return level[0]


def adasum_eager(world, values: List[torch.Tensor], wm,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """allreduce(op=Adasum) of ``values`` over the set ``wm``: per dtype,
    one all-gather of the flattened members into an (n, total) stack, then
    per member the prescale, the tree and the postscale, in the member's
    dtype. In a set of one only the scales apply, as in the JAX package.
    Results land on each input's device."""
    from .collectives import COUNTS, _all_gather_single
    nproc = wm.num_procs
    if nproc == 1:
        s = prescale_factor * postscale_factor
        return [v.detach().clone() if s == 1.0 else (v * s).to(v.dtype)
                for v in values]
    if not _is_pow2(nproc):
        raise ValueError(
            f"Adasum requires a power-of-two world size, got {nproc}.")
    out: List[Optional[torch.Tensor]] = [None] * len(values)
    by_dtype = {}
    for i, v in enumerate(values):
        by_dtype.setdefault(v.dtype, []).append(i)
    for dt, idxs in by_dtype.items():
        flat = torch.cat([values[i].detach().reshape(-1).to(world.device)
                          for i in idxs])
        stacked = torch.empty(nproc * flat.numel(), dtype=dt,
                              device=world.device)
        _all_gather_single(stacked, flat, wm.group)
        stacked = stacked.view(nproc, flat.numel())
        COUNTS["allreduce"] += 1
        off = 0
        for i in idxs:
            v = values[i]
            n = v.numel()
            s = stacked[:, off:off + n].reshape((nproc,) + tuple(v.shape))
            off += n
            if prescale_factor != 1.0:
                s = (s * prescale_factor).to(dt)
            r = adasum_tree(s)
            if postscale_factor != 1.0:
                r = (r * postscale_factor).to(dt)
            out[i] = r.to(v.device)
    return out


def adasum_grads(grads, outer_group, inner_group=None):
    """Adasum of each gradient over ``outer_group``, after a plain mean
    over ``inner_group`` (the processes that share a model replica; the
    reference's intra-node stage, AdasumGpuAllreduceOp): per tensor, a sum
    over the inner group divided by its size, an all-gather over the outer
    group into an (n, ...) stack, and :func:`adasum_tree` on it, so the
    result is identical on every member. ``grads``: a tensor, or a list,
    tuple or dict of tensors (the same structure comes back). The groups
    are ``torch.distributed`` process groups (``DeviceMesh.get_group``);
    every wire call runs through ``collectives.run_in_order``, or is an
    in-graph collective while torch.compile traces (then a group may also
    be given by its name, and the power-of-two check raises at trace
    time)."""
    from .compression import true_divide
    from .mesh import group_allgather, group_allreduce, group_size

    def combine(g):
        if inner_group is not None:
            g, = group_allreduce([g], inner_group)
            g = true_divide(g, group_size(inner_group))
        return adasum_tree(group_allgather(g, outer_group))

    if isinstance(grads, torch.Tensor):
        return combine(grads)
    if isinstance(grads, dict):
        return {k: combine(v) for k, v in grads.items()}
    return type(grads)(combine(g) for g in grads)
