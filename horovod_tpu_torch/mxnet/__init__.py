"""The MXNet frontend on the port's torch core (counterpart of
``horovod_tpu/mxnet``; reference: horovod/mxnet/__init__.py:37-107).

Import-gated: every entry point that touches an NDArray raises a clear
error when mxnet is not installed (it is end-of-life upstream). NDArrays
stage through ``asnumpy()`` into torch tensors, run through the core, and
come back as NDArrays of the input's dtype.
"""

from typing import Optional

import numpy as np
import torch

from .. import collectives as _c
from ..basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
)


def _require_mxnet():
    try:
        import mxnet
        return mxnet
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.mxnet requires mxnet, which is not "
            "installed in this environment (MXNet is end-of-life "
            "upstream). Use the torch core (horovod_tpu_torch or "
            "horovod_tpu_torch.torch) or horovod_tpu_torch.tensorflow "
            "instead.") from e


def _from_mx(nd) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(nd.asnumpy()))


def _to_mx(out: torch.Tensor, like):
    mx = _require_mxnet()
    return mx.nd.array(out.detach().cpu().numpy(), dtype=like.dtype)


def allreduce(tensor, average: bool = True, name: Optional[str] = None):
    _require_mxnet()
    out = _c.allreduce(_from_mx(tensor), average=average, name=name)
    return _to_mx(out, tensor)


def grouped_allreduce(tensors, average: bool = True,
                      name: Optional[str] = None):
    """Fused allreduce of several NDArrays (reference:
    mxnet/mpi_ops.py grouped_allreduce)."""
    _require_mxnet()
    outs = _c.grouped_allreduce([_from_mx(t) for t in tensors],
                                average=average, name=name)
    return [_to_mx(o, t) for o, t in zip(outs, tensors)]


def allgather(tensor, name: Optional[str] = None):
    """Concatenate every process's tensor along dim 0 (reference:
    mxnet/mpi_ops.py:84-107 allgather)."""
    _require_mxnet()
    return _to_mx(_c.allgather(_from_mx(tensor), name=name), tensor)


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None):
    _require_mxnet()
    out = _c.broadcast(_from_mx(tensor), root_rank=root_rank, name=name)
    return _to_mx(out, tensor)


def alltoall(tensor, splits=None, name: Optional[str] = None):
    _require_mxnet()
    out = _c.alltoall(_from_mx(tensor), splits=splits, name=name)
    return _to_mx(out, tensor)


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None):
    from ..functions import broadcast_object as _bo
    return _bo(obj, root_rank=root_rank, name=name)


def broadcast_parameters(params, root_rank: int = 0):
    """Broadcast a dict of parameters (gluon Parameters or NDArrays) from
    ``root_rank`` into each one's data, in sorted name order."""
    mx = _require_mxnet()
    items = sorted(params.items()) if isinstance(params, dict) \
        else sorted(dict(params).items())
    for name, p in items:
        arr = p.data() if hasattr(p, "data") else p
        out = _c.broadcast(_from_mx(arr), root_rank=root_rank,
                           name=f"mx.bcast.{name}")
        arr[:] = mx.nd.array(out.cpu().numpy(), dtype=arr.dtype)


def DistributedOptimizer(optimizer):
    """Wrap an mxnet optimizer so that ``update`` averages the gradient
    across processes first (reference: mxnet/__init__.py:37-76)."""
    _require_mxnet()

    class _Dist(type(optimizer)):
        def update(self, index, weight, grad, state):
            reduced = allreduce(grad, average=True,
                                name=f"mx.grad.{index}")
            super().update(index, weight, reduced, state)

    optimizer.__class__ = _Dist
    return optimizer


def DistributedTrainer(params, optimizer, optimizer_params=None,
                       compression=None, gradient_predivide_factor: float = 1.0):
    """A gluon Trainer whose ``_allreduce_grads`` sums the live gradients
    in one grouped allreduce (reference: mxnet/__init__.py:84-107:
    ``rescale_grad`` divided by the world size, so the sum yields the
    average). ``gradient_predivide_factor`` f moves part of that divide
    before the sum (prescale 1/f, postscale f: numerically neutral);
    ``compression`` is the port's :class:`Compression`. Returns an
    instance; the class is built on call so this module imports without
    mxnet."""
    mx = _require_mxnet()
    from .. import basics as _basics

    if gradient_predivide_factor <= 0:
        raise ValueError(
            f"gradient_predivide_factor must be positive, got "
            f"{gradient_predivide_factor}")

    class _DistributedTrainer(mx.gluon.Trainer):
        def __init__(self, params_, optimizer_, optimizer_params_):
            if type(optimizer_).__name__ == "_Dist":
                raise ValueError(
                    "pass a plain optimizer (or its name) to "
                    "DistributedTrainer; it applies the distributed "
                    "reduction itself (reference mxnet/__init__.py:90)")
            super().__init__(params_, optimizer_,
                             optimizer_params_, kvstore=None)
            self._scale /= _basics.size()
            self._hvd_predivide = gradient_predivide_factor

        def _allreduce_grads(self):
            f = self._hvd_predivide
            live = [p for p in self._params if p.grad_req != "null"]
            if not live:
                return
            grads = [_from_mx(p.list_grad()[0]) for p in live]
            pairs = [compression.compress(g) for g in grads] \
                if compression is not None else [(g, None) for g in grads]
            outs = _c.grouped_allreduce(
                [c for c, _ in pairs], average=False,
                prescale_factor=1.0 / f, postscale_factor=f,
                name="mx.trainer.grads")
            if compression is not None:
                outs = [compression.decompress(o, ctx)
                        for o, (_, ctx) in zip(outs, pairs)]
            for p, out in zip(live, outs):
                g = p.list_grad()[0]
                g[:] = mx.nd.array(out.cpu().numpy(), dtype=g.dtype)

    return _DistributedTrainer(params, optimizer, optimizer_params)
