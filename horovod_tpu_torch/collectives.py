"""Eager collectives over ``torch.distributed`` (counterpart of the
allreduce, broadcast, handle and barrier verbs of
``horovod_tpu/collectives.py``).

A grouped allreduce is one fusion buffer per dtype: the members are
flattened into one device buffer, reduced by ONE ``dist.all_reduce``
(NCCL on the card, gloo on the CPU) and split back. As in the JAX package,
half-precision members accumulate in fp32 and Average and the pre/post
scale factors fold into one scale applied after the sum
(:func:`_combined_scale`). Async verbs return an integer handle at once;
``synchronize`` waits for the work and returns the result, ``poll`` asks
whether it is done.

The dispatcher thread, consistency exchange, response cache, Join,
allgather, alltoall and Adasum of the JAX package are not ported yet.
"""

import enum
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import basics as _basics


class ReduceOp(enum.Enum):
    """Reduction ops (reference: Average/Sum in
    horovod/torch/mpi_ops.py:40-44)."""
    AVERAGE = "average"
    SUM = "sum"


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM

#: wire collectives launched, by verb (one per ``dist`` call)
COUNTS = {"allreduce": 0, "broadcast": 0}

_HALF = (torch.float16, torch.bfloat16)


def _is_integer(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex
                    or dtype == torch.bool)
    return bool(np.issubdtype(np.dtype(dtype), np.integer))


def _combined_scale(op: ReduceOp, nproc: int, prescale: float,
                    postscale: float, dtype) -> float:
    scale = prescale * postscale
    if op == ReduceOp.AVERAGE:
        scale /= nproc
    if scale != 1.0 and _is_integer(dtype):
        raise ValueError(
            "prescale/postscale/average on integer tensors is not supported; "
            "use op=horovod_tpu_torch.Sum for integer dtypes.")
    return scale


def _resolve_op(average, op) -> ReduceOp:
    if average is not None and op is not None:
        raise ValueError("Set either average or op; not both "
                         "(reference semantics: util.py "
                         "get_average_backwards_compatibility_fun).")
    if op is None:
        if average is None:
            return ReduceOp.AVERAGE
        return ReduceOp.AVERAGE if average else ReduceOp.SUM
    if not isinstance(op, ReduceOp):
        raise TypeError(f"op must be a horovod_tpu_torch.ReduceOp, got {op!r}")
    return op


def _as_tensor(t) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.as_tensor(t)


class _Pending:
    """One async grouped allreduce: per dtype, the flat buffer and its
    in-flight work."""

    def __init__(self, grouped, metas, scales, buckets):
        self.grouped = grouped
        self.metas = metas          # per member: (shape, dtype, device)
        self.scales = scales        # dtype -> combined scale
        self.buckets = buckets      # [(dtype, member indices, flat, work)]


def _register(w, pending) -> int:
    with w.lock:
        w.next_handle += 1
        w.handles[w.next_handle] = pending
        return w.next_handle


def _take(w, handle: int) -> _Pending:
    with w.lock:
        try:
            return w.handles.pop(handle)
        except KeyError:
            raise ValueError(f"unknown or already synchronized handle "
                             f"{handle}") from None


def grouped_allreduce_async(tensors: Sequence, average=None,
                            name: Optional[str] = None,
                            op: Optional[ReduceOp] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0) -> int:
    """Fused async allreduce: one handle for the whole group;
    ``synchronize(handle)`` returns the reduced tensors in input order.
    ``name`` is accepted for API parity (the named-tensor table is not
    ported yet)."""
    return _allreduce_async([_as_tensor(t) for t in tensors], True, average,
                            op, prescale_factor, postscale_factor)


def _allreduce_async(tensors, grouped, average, op, prescale, postscale):
    op = _resolve_op(average, op)
    w = _basics.world()
    scales = {dt: _combined_scale(op, w.size, prescale, postscale, dt)
              for dt in {t.dtype for t in tensors}}
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    buckets = []
    for dt, idxs in by_dtype.items():
        acc = torch.float32 if dt in _HALF else dt
        flat = torch.cat([tensors[i].detach().reshape(-1).to(w.device, acc)
                          for i in idxs])
        work = dist.all_reduce(flat, op=dist.ReduceOp.SUM, async_op=True)
        COUNTS["allreduce"] += 1
        buckets.append((dt, idxs, flat, work))
    metas = [(tuple(t.shape), t.dtype, t.device) for t in tensors]
    return _register(w, _Pending(grouped, metas, scales, buckets))


def grouped_allreduce(tensors: Sequence, average=None,
                      name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Fused allreduce of several tensors (reference: grouped_allreduce,
    torch/mpi_ops.py:202-260)."""
    return synchronize(grouped_allreduce_async(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor))


def allreduce_async(tensor, average=None, name: Optional[str] = None,
                    op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    return _allreduce_async([_as_tensor(tensor)], False, average, op,
                            prescale_factor, postscale_factor)


def allreduce(tensor, average=None, name: Optional[str] = None,
              op: Optional[ReduceOp] = None, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Synchronous allreduce (reference: torch/mpi_ops.py:158-200).
    ``average`` is the legacy boolean knob; ``op`` takes precedence."""
    return synchronize(allreduce_async(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor))


def poll(handle: int) -> bool:
    """True when the collective behind ``handle`` has completed."""
    w = _basics.world()
    with w.lock:
        pending = w.handles.get(handle)
    if pending is None:
        raise ValueError(f"unknown or already synchronized handle {handle}")
    return all(work.is_completed() for _, _, _, work in pending.buckets)


def synchronize(handle: int):
    """Wait for the collective behind ``handle`` and return its result: a
    tensor, or the list of a grouped call's tensors."""
    w = _basics.world()
    pending = _take(w, handle)
    out = [None] * len(pending.metas)
    for dt, idxs, flat, work in pending.buckets:
        work.wait()
        scale = pending.scales[dt]
        if scale != 1.0:
            flat.mul_(scale)
        off = 0
        for i in idxs:
            shape, dtype, device = pending.metas[i]
            n = int(np.prod(shape, dtype=np.int64))
            out[i] = flat[off:off + n].view(shape).to(device, dtype)
            off += n
    return out if pending.grouped else out[0]


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place broadcast from ``root_rank``; returns ``tensor``."""
    w = _basics.world()
    if not 0 <= root_rank < w.size:
        raise ValueError(f"root_rank {root_rank} out of range for world "
                         f"size {w.size}")
    with torch.no_grad():
        if tensor.device == w.device and tensor.is_contiguous():
            dist.broadcast(tensor, src=root_rank)
        else:
            buf = tensor.detach().to(w.device).contiguous()
            dist.broadcast(buf, src=root_rank)
            tensor.copy_(buf)
    COUNTS["broadcast"] += 1
    return tensor


def broadcast(tensor, root_rank: int, name: Optional[str] = None
              ) -> torch.Tensor:
    """Every process receives root's value (reference:
    torch/mpi_ops.py:345-389); the input is left as it is."""
    t = _as_tensor(tensor)
    return broadcast_(t.detach().clone(), root_rank, name=name)


def barrier() -> None:
    """Host barrier across processes (an allreduce of one zero, as in the
    JAX package)."""
    allreduce(torch.zeros(1), op=Sum, name="horovod_tpu_torch.barrier")
