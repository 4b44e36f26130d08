"""The parallel package's wire calls: differentiable point-to-point
shifts, all-to-all and replicated sums over a process group.

Every call runs through ``collectives.run_in_order``: on the dispatcher
thread, in the process's one order of wire calls, beside the gradient
buckets that the DistributedOptimizer hands it while backward runs (see
there for why two threads must not drive NCCL).

``SendRecv`` is the counterpart of ``jax.lax.ppermute`` for the
permutations that ring attention (every member to the next, cyclic) and
the pipeline (each stage to the next, open at both ends) use. The forward
sends each tensor to group member ``dst`` and receives as many from
member ``src`` (``batch_isend_irecv``); the backward sends the gradients
the other way, to ``src``, and receives from ``dst``. A missing ``src``
receives zeros, as ppermute gives a member nobody sends to; a missing
``dst`` sends nothing. Every member of the group calls it with its own
``dst``/``src`` at the same point of its program, forward and backward.

The sharding collectives of tensor and fully-sharded parameters
(counterparts of what XLA's SPMD partitioner inserts around the JAX
package's ``param_shardings``):

* :func:`all_gather`: a shard gathered along a dim over a group, with a
  reduce-scatter (sum) as its backward (fsdp: ZeRO-3's gather of a weight
  just before use, its gradient summed back onto the shards);
* :func:`copy_to_group` and :func:`sum_replicated`: Megatron's pair for
  tp, an identity whose backward sums over the group (at the input of a
  column-parallel product) and a sum whose backward is the identity (at
  the output of a row-parallel product);
* :func:`all_reduce_max`: the max of the vocab-parallel softmax (no
  gradient: the max only shifts the exponent for range).

While ``torch.compile`` traces (``torch.compiler.is_compiling()``), each
wire call is the in-graph collective of ``torch.distributed.
_functional_collectives`` on the same group instead, and the autograd
Functions around them keep their backward: the shift is one
``all_to_all_single`` with this member's split sizes (as
``collectives.ppermute``), whose transpose is the inverse shift; the
all-to-all, the all-gather and reduce-scatter and the sums are their
functional counterparts, which move and sum the same buffers.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..collectives import (_all_gather, _functional, _reduce_scatter, _shift,
                           run_in_order)


def _exchange(tensors: Sequence[torch.Tensor], group, dst: Optional[int],
              src: Optional[int]) -> Tuple[torch.Tensor, ...]:
    if torch.compiler.is_compiling():
        # the tensors in one buffer, shifted in one in-graph call
        flat = _shift(torch.cat([t.reshape(-1) for t in tensors]), group,
                      dist.get_world_size(group), dst, src)
        return tuple(piece.view(t.shape) for piece, t in zip(
            torch.split(flat, [t.numel() for t in tensors]), tensors))
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) if src is not None else torch.zeros_like(t)
             for t in sends]
    ops = []
    if dst is not None:
        peer = dist.get_global_rank(group, dst)
        ops += [dist.P2POp(dist.isend, t, peer, group) for t in sends]
    if src is not None:
        peer = dist.get_global_rank(group, src)
        ops += [dist.P2POp(dist.irecv, t, peer, group) for t in recvs]

    def wire():
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if ops:
        run_in_order(wire, sends, recvs)
    return tuple(recvs)


class SendRecv(torch.autograd.Function):
    """``SendRecv.apply(group, dst, src, *tensors)``: the shift above with
    its transpose as the backward."""

    @staticmethod
    def forward(ctx, group, dst, src, *tensors):
        ctx.group, ctx.dst, ctx.src = group, dst, src
        return _exchange(tensors, group, dst, src)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(
            _exchange(grads, ctx.group, ctx.src, ctx.dst))


def ring_shift(tensors, group) -> Tuple[torch.Tensor, ...]:
    """Each member's ``tensors`` to the next member of ``group`` (cyclic),
    differentiable."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    return SendRecv.apply(group, (me + 1) % n, (me - 1) % n, *tensors)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()   # all_to_all_single splits and writes dim 0 flat
    if torch.compiler.is_compiling():
        return _functional().all_to_all_single(x, None, None, group)
    out = torch.empty_like(x)
    run_in_order(lambda: dist.all_to_all_single(out, x, group=group),
                 [x], [out])
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        # equal chunks: the exchange is its own transpose
        return None, _all_to_all(g, ctx.group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 of ``x`` in n equal chunks, chunk j to member j; the result
    stacks what arrives by source on dim 0. Differentiable."""
    return _AllToAll.apply(group, x)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``x`` reduced over ``group`` with ``op`` ("sum" or "max") into a new
    contiguous tensor."""
    if torch.compiler.is_compiling():
        return _functional().all_reduce(x.contiguous(), op, group)
    x = x.clone(memory_format=torch.contiguous_format)
    run_in_order(lambda: dist.all_reduce(x, op=_REDUCE_OPS[op], group=group),
                 [], [x])
    return x


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return None, g


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``, for a result that every member then
    uses alike (the same loss from it on every member). In backward each
    member keeps its own cotangent, which is the cotangent of the sum (the
    transpose of JAX's psum under replication tracking); a summing
    backward would count it once per member."""
    return _SumReplicated.apply(group, x)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    if torch.compiler.is_compiling():
        return _all_gather(xs, 0, group).movedim(0, dim)
    out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                      dtype=x.dtype, device=x.device)
    def wire():
        with torch.no_grad():   # gloo writes through views of ``out``
            (getattr(dist, "all_gather_single", None)
             or dist.all_gather_into_tensor)(out, xs, group=group)
    run_in_order(wire, [xs], [out])
    return out.movedim(0, dim)


def _scatter_dim(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    gs = g.movedim(dim, 0).contiguous()
    if torch.compiler.is_compiling():
        return _reduce_scatter(gs, 0, group).movedim(0, dim)
    out = torch.empty((gs.shape[0] // n,) + tuple(gs.shape[1:]),
                      dtype=g.dtype, device=g.device)
    def wire():
        with torch.no_grad():
            (getattr(dist, "reduce_scatter_single", None)
             or dist.reduce_scatter_tensor)(out, gs, group=group)
    run_in_order(wire, [gs], [out])
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return None, None, _scatter_dim(g, ctx.dim, ctx.group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in group order (every
    member gets the whole). Differentiable: the backward reduce-scatters
    the cotangent, each member receiving the sum over the group of its own
    block's cotangent."""
    return _AllGather.apply(group, dim % x.dim(), x)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _all_reduce(g, "sum", ctx.group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, where every member holds the same ``x`` and feeds it
    to its own part of a product (a column-parallel layer's input). In
    backward the members' cotangents, each from its part, are summed over
    ``group``."""
    return _CopyToGroup.apply(group, x)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of ``x`` over ``group`` (a new tensor; not
    differentiable)."""
    return _all_reduce(x.detach(), "max", group)
