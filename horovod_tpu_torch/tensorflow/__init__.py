"""The TensorFlow frontend: TF2 eager (and TF1 graph) training on the
port's torch core (counterpart of ``horovod_tpu/tensorflow``).

TF tensors and Variables (through ``.value()``) enter the core as torch
tensors through **DLPack** (``torch.from_dlpack``: the TF buffer itself,
no copy), and results return the same way
(``tf.experimental.dlpack.from_dlpack`` of ``torch.utils.dlpack
.to_dlpack``). A TF buffer is immutable: nothing here hands one to a verb
that writes into its input (the out-of-place verbs copy onto the world's
device before the wire call, and results come back on the input's
device). The JAX package stages through numpy into the XLA core instead.

Usage (the reference's TF2 recipe)::

    import horovod_tpu_torch.tensorflow as hvd
    hvd.init()
    with tf.GradientTape() as tape:
        loss = loss_fn(model(x))
    tape = hvd.DistributedGradientTape(tape)
    grads = tape.gradient(loss, model.trainable_variables)
    opt.apply_gradients(zip(grads, model.trainable_variables))
    if first_batch:
        hvd.broadcast_variables(model.variables, root_rank=0)

TensorFlow itself loads on first use: importing this module does not
import it.
"""

from typing import Any, List, Optional

import numpy as np
import torch

from .. import basics as _basics
from .. import collectives as _c
from .. import config as _config
from ..basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size,
)
from ..collectives import Average, Sum, Adasum  # noqa: F401
from ..compression import Compression


def _tf():
    import tensorflow as tf
    return tf


def _to_torch(t) -> torch.Tensor:
    """A TF tensor or Variable as a torch tensor over the same buffer
    (DLPack; a Variable through its live ``value()``); numpy arrays and
    Python values become tensors too."""
    if isinstance(t, np.ndarray):
        return torch.from_numpy(t)
    value = getattr(t, "value", None)
    src = value() if callable(value) else t
    if hasattr(src, "__dlpack__"):
        return torch.from_dlpack(src)
    return torch.as_tensor(np.asarray(src))


#: TF's kernels check that every buffer they read is aligned to this
#: (EIGEN_MAX_ALIGN_BYTES) and abort the process otherwise
_TF_ALIGN = 64


def _to_tf(out: torch.Tensor, dtype=None):
    """A torch result as a TF tensor over the same buffer (DLPack). TF
    takes only dense row-major strides and 64-byte aligned buffers, so a
    strided view is made contiguous and a view into the middle of a
    buffer (a grouped call's piece of its flat result) is copied first.
    ``dtype`` casts when the result's differs."""
    tf = _tf()
    out = out.detach().contiguous()
    if out.data_ptr() % _TF_ALIGN:
        out = out.clone()
    t = tf.experimental.dlpack.from_dlpack(torch.utils.dlpack.to_dlpack(out))
    if dtype is not None and t.dtype != dtype:
        t = tf.cast(t, dtype)
    return t


def allreduce(tensor, average=None, *, name: Optional[str] = None, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=None, device_dense: str = "",
              device_sparse: str = ""):
    """Allreduce of a tf.Tensor (reference: tensorflow/__init__.py:52-131).
    ``tf.IndexedSlices`` take the sparse path (two allgathers, values
    pre-divided for Average; reference :87-102). ``compression`` (the
    port's :class:`Compression`) casts the wire data and back, on the
    forward and the gradient. ``device_dense``/``device_sparse`` are
    accepted for the reference's signature and ignored: the world's
    device decides placement. Everything past ``average`` is
    keyword-only, as in the JAX package (the reference's third
    positional is ``device_dense``)."""
    tf = _tf()
    del device_dense, device_sparse
    compression = compression or Compression.none
    if isinstance(tensor, tf.IndexedSlices):
        from ..sparse import SparseGradient, allreduce_sparse
        avg = op is None and (average is None or average) or op == Average
        out = allreduce_sparse(
            SparseGradient(indices=_to_torch(tensor.indices),
                           values=_to_torch(tensor.values),
                           dense_shape=tuple(tensor.dense_shape.numpy())),
            average=bool(avg), name=name)
        return tf.IndexedSlices(values=_to_tf(out.values),
                                indices=_to_tf(out.indices),
                                dense_shape=tensor.dense_shape)
    op_r = _c._resolve_op(average, op)

    def reduce(x, name):
        return _to_tf(_c.allreduce(
            _to_torch(x), op=op_r, name=name,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, compression=compression),
            x.dtype)

    # differentiable (reference: RegisterGradient("HorovodAllreduce")):
    # the gradient is the same allreduce of the upstream gradient. In a
    # tf.function use the tape or optimizer wrappers, whose one
    # py_function node is the graph's submission point.
    @tf.custom_gradient
    def _differentiable(x):
        return reduce(x, name), lambda dy: reduce(dy, None)
    return _differentiable(tensor)


def allgather(tensor, name: Optional[str] = None):
    """Differentiable allgather (reference gradient: the sum-allreduce of
    the upstream gradient narrowed to this process's rows,
    RegisterGradient("HorovodAllgather")); the core's
    :func:`~horovod_tpu_torch.collectives.allgather_grad` computes it."""
    tf = _tf()
    if not hasattr(tensor, "dtype"):
        tensor = np.asarray(tensor)   # plain sequences and scalars
    shape = getattr(tensor, "shape", None)
    # tf shapes expose .rank (None when unknown); numpy goes by np.shape
    if hasattr(shape, "rank"):
        nd = shape.rank
    else:
        shape = np.shape(tensor)
        nd = len(shape)
    if nd is None:
        raise ValueError(
            "allgather requires a statically known rank (the gradient "
            "narrows this process's rows by its static dim0); got a "
            "tensor of unknown rank")
    dim0 = int(shape[0]) if nd else 1

    @tf.custom_gradient
    def _differentiable(x):
        out = _to_tf(_c.allgather(_to_torch(x), name=name), x.dtype)

        def grad(dy):
            return _to_tf(_c.allgather_grad(_to_torch(dy), dim0,
                                            was_scalar=nd == 0), dy.dtype)
        return out, grad
    return _differentiable(tensor)


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    """Differentiable broadcast (reference gradient: the sum-allreduce at
    the root, zero elsewhere, RegisterGradient("HorovodBroadcast"))."""
    tf = _tf()

    @tf.custom_gradient
    def _differentiable(x):
        out = _to_tf(_c.broadcast(_to_torch(x), root_rank=root_rank,
                                  name=name), x.dtype)

        def grad(dy):
            return _to_tf(_c.broadcast_grad(_to_torch(dy), root_rank),
                          dy.dtype)
        return out, grad
    return _differentiable(tensor)


def alltoall(tensor, splits=None, name: Optional[str] = None):
    out = _c.alltoall(_to_torch(tensor), splits=splits, name=name)
    return _to_tf(out, tensor.dtype)


# async verbs: the core's handles; synchronize returns a TF tensor
def allreduce_async(tensor, average=None, name: Optional[str] = None,
                    op=None) -> int:
    return _c.allreduce_async(_to_torch(tensor), average=average, name=name,
                              op=op)


def allgather_async(tensor, name: Optional[str] = None) -> int:
    return _c.allgather_async(_to_torch(tensor), name=name)


def broadcast_async(tensor, root_rank: int,
                    name: Optional[str] = None) -> int:
    return _c.broadcast_async(_to_torch(tensor), root_rank=root_rank,
                              name=name)


def alltoall_async(tensor, splits=None, name: Optional[str] = None) -> int:
    return _c.alltoall_async(_to_torch(tensor), splits=splits, name=name)


def synchronize(handle: int):
    return _to_tf(_c.synchronize(handle))


poll = _c.poll


def broadcast_variables(variables: List, root_rank: int = 0) -> None:
    """Assign every variable its root-rank value (reference:
    tensorflow/functions.py broadcast_variables), in the caller's list
    order. The variables are bucketed to the fusion threshold and each
    bucket is one grouped broadcast, not one collective a variable."""
    from ..fusion import plan_buckets
    vars_ = list(variables)
    if not vars_:
        return
    staged = [_to_torch(v) for v in vars_]
    threshold = int(_basics.world().config.get(_config.FUSION_THRESHOLD))
    buckets = plan_buckets([(tuple(t.shape), t.dtype) for t in staged],
                           threshold)
    for bi, idxs in enumerate(buckets):
        outs = _c.grouped_broadcast(
            [staged[i] for i in idxs], root_rank=root_rank,
            name=f"bcast.vars.{bi}.{len(idxs)}")
        for i, out in zip(idxs, outs):
            vars_[i].assign(_to_tf(out, vars_[i].dtype))


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None):
    from ..functions import broadcast_object as _bo
    return _bo(obj, root_rank=root_rank, name=name)


def _reduce_gradients(grads, op, name_prefix: str,
                      prescale: float = 1.0, postscale: float = 1.0,
                      compression=None):
    """Reduce a list of TF gradients (None entries pass through) with ONE
    grouped allreduce.

    Eager tensors reduce directly. Inside a tf.function (Keras 3 traces
    train_step) the whole list reduces through ONE ``tf.py_function``
    node: a single submission point on whichever TF executor thread runs
    it, so every process issues the same wire calls in the same order
    whatever TF's graph scheduling.
    """
    tf = _tf()
    compression = compression or Compression.none
    present = [(i, g) for i, g in enumerate(grads) if g is not None]
    if not present:
        return list(grads)
    dense = [
        (i, tf.convert_to_tensor(g) if isinstance(g, tf.IndexedSlices)
         else g)
        for i, g in present]

    def _eager_reduce(*tensors):
        pairs = [compression.compress(_to_torch(t)) for t in tensors]
        outs = _c.grouped_allreduce(
            [c for c, _ in pairs], op=op, name=name_prefix + ".grads",
            prescale_factor=prescale, postscale_factor=postscale)
        return [_to_tf(compression.decompress(o, cc), t.dtype)
                for o, (_, cc), t in zip(outs, pairs, tensors)]

    tensors = [g for _, g in dense]
    if any(not hasattr(g, "numpy") for g in tensors):
        reduced = tf.py_function(func=_eager_reduce, inp=tensors,
                                 Tout=[g.dtype for g in tensors])
        for r, g in zip(reduced, tensors):
            r.set_shape(g.shape)
    else:
        reduced = _eager_reduce(*tensors)
    out = list(grads)
    for (i, _), r in zip(dense, reduced):
        out[i] = r
    return out


class DistributedGradientTape:
    """Wraps a tf.GradientTape so ``gradient()`` returns allreduced
    gradients (reference: tensorflow/__init__.py:465-518)."""

    def __init__(self, tape, op=Average, compression=None,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0):
        self._tape = tape
        self._op = op
        self._compression = compression
        self._prescale = prescale_factor
        self._postscale = postscale_factor

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        return _reduce_gradients(grads, self._op, "tape",
                                 self._prescale, self._postscale,
                                 compression=self._compression)

    def __getattr__(self, item):
        return getattr(self._tape, item)


def _make_v1_distributed_optimizer(optimizer, op, name_prefix, compression,
                                   prescale_factor, postscale_factor):
    """TF1 graph-mode wrapper (reference: tensorflow/__init__.py:259-301
    _DistributedOptimizer): a ``tf.compat.v1.train.Optimizer`` whose
    ``compute_gradients`` reduces, so legacy session scripts, ``minimize()``
    included, get reduced gradients through the one py_function node of
    :func:`_reduce_gradients`."""
    tf = _tf()

    class _DistributedOptimizerV1(tf.compat.v1.train.Optimizer):
        def __init__(self):
            self._optimizer = optimizer
            super().__init__(use_locking=False,
                             name=name_prefix or "DistributedOptimizerV1")

        def compute_gradients(self, *args, **kwargs):
            gvs = self._optimizer.compute_gradients(*args, **kwargs)
            reduced = _reduce_gradients(
                [g for g, _ in gvs], op, name_prefix,
                prescale_factor, postscale_factor, compression=compression)
            return [(r, v) for r, (_, v) in zip(reduced, gvs)]

        def apply_gradients(self, *args, **kwargs):
            return self._optimizer.apply_gradients(*args, **kwargs)

        def get_slot(self, *args, **kwargs):
            return self._optimizer.get_slot(*args, **kwargs)

        def get_slot_names(self, *args, **kwargs):
            return self._optimizer.get_slot_names(*args, **kwargs)

        def variables(self, *args, **kwargs):
            return self._optimizer.variables(*args, **kwargs)

    return _DistributedOptimizerV1()


def DistributedOptimizer(optimizer, op=Average, name_prefix: str = "opt",
                         compression=None, prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0):
    """Wrap an optimizer so gradients are reduced before they are applied.

    A ``tf.compat.v1.train.Optimizer`` gets the reference's subclass,
    whose ``compute_gradients`` reduces (reference:
    tensorflow/__init__.py:259-301). A Keras/TF2 optimizer is intercepted
    at ``apply_gradients`` on the instance (with Keras 3 the only stable
    hook)."""
    tf = _tf()
    if isinstance(optimizer, tf.compat.v1.train.Optimizer):
        return _make_v1_distributed_optimizer(
            optimizer, op, name_prefix, compression,
            prescale_factor, postscale_factor)

    def apply_gradients(grads_and_vars, *args, **kwargs):
        gv = list(grads_and_vars)
        reduced = _reduce_gradients([g for g, _ in gv], op, name_prefix,
                                    prescale_factor, postscale_factor,
                                    compression=compression)
        return type(optimizer).apply_gradients(
            optimizer, [(r, v) for r, (_, v) in zip(reduced, gv)],
            *args, **kwargs)

    optimizer.apply_gradients = apply_gradients
    return optimizer


def DistributedDeltaOptimizer(optimizer, backward_passes_per_step: int = 1,
                              name_prefix: str = "adasum_delta"):
    """Adasum *delta* optimizer (reference: tensorflow/__init__.py:303-397
    _DistributedAdasumOptimizer): the inner optimizer updates the
    variables locally; every ``backward_passes_per_step`` steps the
    accumulated deltas (var - start) are combined across processes by the
    scale-invariant Adasum rule and every variable is set to start +
    adasum(delta). Runs eagerly, the starts held as non-trainable
    variables."""
    tf = _tf()
    state = {"starts": {}, "step": 0}
    orig_apply = type(optimizer).apply_gradients

    def apply_gradients(grads_and_vars, *args, **kwargs):
        gv = list(grads_and_vars)
        vars_ = [v for _, v in gv]
        for v in vars_:
            if v.ref() not in state["starts"]:
                state["starts"][v.ref()] = tf.Variable(v, trainable=False)
        result = orig_apply(optimizer, gv, *args, **kwargs)
        state["step"] += 1
        if state["step"] % backward_passes_per_step == 0:
            deltas = [_to_torch(v - state["starts"][v.ref()])
                      for v in vars_]
            reduced = _c.grouped_allreduce(
                deltas, op=_c.Adasum,
                name=f"{name_prefix}.{state['step']}")
            for v, rd in zip(vars_, reduced):
                start = state["starts"][v.ref()]
                start.assign_add(_to_tf(rd, start.dtype))
                v.assign(start)
        return result

    optimizer.apply_gradients = apply_gradients
    return optimizer


class BroadcastGlobalVariablesHook:
    """TF1 ``SessionRunHook`` that broadcasts every global variable from
    the root rank once the session exists (reference:
    tensorflow/__init__.py:187-220). The graph carries only
    placeholder-fed assigns; the broadcast runs through the core on the
    session's host values. In TF2 eager code use
    :func:`broadcast_variables`."""

    def __new__(cls, root_rank: int = 0, device: str = ""):
        tf = _tf()

        class _Hook(tf.compat.v1.train.SessionRunHook):
            def __init__(self):
                self.root_rank = root_rank
                self._vars = None
                self._phs = None
                self._assign = None

            def begin(self):
                self._vars = tf.compat.v1.global_variables()
                self._phs = [
                    tf.compat.v1.placeholder(v.dtype.base_dtype, v.shape)
                    for v in self._vars]
                self._assign = tf.group(*[
                    tf.compat.v1.assign(v, p)
                    for v, p in zip(self._vars, self._phs)])

            def after_create_session(self, session, coord):
                vals = session.run(self._vars)
                outs = [_c.broadcast(
                    torch.tensor(np.asarray(val)),
                    root_rank=self.root_rank, name=f"bcast.gv.{i}").numpy()
                    for i, val in enumerate(vals)]
                session.run(self._assign,
                            feed_dict=dict(zip(self._phs, outs)))

        return _Hook()


def __getattr__(name):  # PEP 562, as the JAX package defers its elastic
    if name == "elastic":
        import importlib
        return importlib.import_module(".elastic", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
