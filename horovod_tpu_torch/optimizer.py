"""DistributedOptimizer: bucketed gradient allreduce around a
``torch.optim`` optimizer.

Port of the JAX package's torch frontend (``horovod_tpu/torch/__init__.py``
``_DistributedOptimizer`` and ``_DistributedAdasumDeltaOptimizer``;
reference: torch/optimizer.py:100-186 fused through the fusion buffer,
collective_operations.cc:37-81). A post-accumulate-grad hook on each
parameter marks its gradient ready; buckets are planned once, in reverse
registration order (later layers' gradients materialize first in
backward), so every process forms identical buckets without negotiation;
a bucket fires ONE grouped async allreduce through the dispatcher thread
as soon as all its members are ready, overlapping communication with the
rest of backward; ``step()`` fires what is left, issues one Join round
marker in a world of more than one process, drains the handles, writes
the reduced gradients back and calls the wrapped optimizer's step.

Two modes change when buckets fire. :meth:`DistributedOptimizer.
hold_gradients` keeps a step's local gradients out of the buckets until
:meth:`~DistributedOptimizer.release_gradients` (the Estimator's SDC guard
checks them in between), and :meth:`~DistributedOptimizer.abandon_step`
drops a step's gradients and buckets. With ``HVD_TPU_AUTOTUNE`` the
buckets are planned for the autotuner's threshold, each step's reduction
is timed for it (with a device sync, only while tuning), and the buckets
are re-planned at the step boundary after the threshold changes
(``plans`` lists every plan).

``grad_process_sets`` (the sharded training mesh,
``parallel.mesh_utils.grad_process_sets``) gives a parameter's gradient
its own process set and scale: it is summed over that set and multiplied
by the scale, in buckets of its set (a tp-sharded block averages only
with the processes holding the same block). Without it every gradient
is averaged over the world.

``op=Adasum`` in a world of more than one process is the delta optimizer
(reference: _DistributedAdasumOptimizer, torch/optimizer.py:196-364):
each process steps the wrapped optimizer locally, the parameter deltas
are Adasum-combined, and the parameters advance by the combined delta.

**The compiled plane** (``axis_name=``; counterpart of the JAX package's
``DistributedGradientTransform`` inside ``shard_map``,
``horovod_tpu/optimizer.py:76-299``) reduces over named dims of a
``torch.distributed`` DeviceMesh: ``mesh=`` or, by default, the world's
("cross", "local") mesh (:func:`.mesh.cross_local_mesh`; the dims are
names, not process groups). ``axis_name`` is the outer dim and
``inner_axis`` the inner one. ``reduce_strategy='hierarchical'`` takes
the mean over the inner dim first, then the op over the outer dim;
``'flat'`` is one collective over both (under Sum divided by the inner
size after). ``packing='per_leaf'`` reduces each gradient alone;
``'packed'`` concatenates them per dtype into buffers of at most
``HVD_TPU_INJIT_PACKED_THRESHOLD`` bytes (:func:`.fusion.packed_plan`,
leaves in the JAX package's order, ``models.convert.flax_order`` of the
names) with one wire call each, where ``compression`` applies: bf16 on
the wire, fp16 rounded and summed in fp32, or ``Compression.int8``
(:func:`.compression.int8_pack_reduce`, over the outer dim only under
``hierarchical``) with its error-feedback residual, one fp32 tensor per
parameter, carried in ``state_dict()`` under
``"error_feedback_residual"``. ``op=Adasum`` takes
:func:`.adasum.adasum_grads` (inner mean, then Adasum over the outer
dim), not the delta optimizer. The JAX package reduces in ``update()``,
after the whole backward; so does this plane: no hooks, the reduction
runs at ``synchronize()``/``step()`` as one closure on the dispatcher
thread (every wire call in one order, the same on every process, one
hand-off a step). A parameter with no gradient contributes zeros and
gets the reduced gradient, as every leaf of a JAX gradient tree does.
"""

import time
import zlib
from typing import Any, Dict, List, Optional

import torch

from . import basics as _basics
from . import collectives as _c
from . import config as _config
from .compression import Compression, int8_pack_reduce, true_divide
from .fusion import flatten_bucket, packed_apply, plan_buckets

_RESIDUAL = "error_feedback_residual"


def _packed_threshold() -> int:
    """Bucket cap of the packed buffers: the world's config when
    initialized (so programmatic overrides apply), the env/default
    resolution otherwise."""
    if _basics.is_initialized():
        return _basics.world().config.get(_config.INJIT_PACKED_THRESHOLD)
    return _config.Config().get(_config.INJIT_PACKED_THRESHOLD)


def _check_args(op, axis_name, compression, reduce_strategy,
                packing) -> None:
    """The JAX package's argument checks (``optimizer.py:83-110``)."""
    if op not in (_c.Average, _c.Sum, _c.Adasum):
        raise ValueError(
            "DistributedOptimizer supports op=Average/Sum/Adasum "
            "(reference: torch/optimizer.py op argument).")
    if reduce_strategy not in ("hierarchical", "flat"):
        raise ValueError("reduce_strategy must be 'hierarchical' (inner "
                         "axis first, then outer — the "
                         "NCCLHierarchicalAllreduce shape) or 'flat' (one "
                         "collective over all axes)")
    if packing not in ("per_leaf", "packed"):
        raise ValueError("packing must be 'per_leaf' (one reduction per "
                         "gradient) or 'packed' (one fused collective per "
                         "dtype bucket — the fusion-buffer shape, "
                         "fusion_buffer_manager.h:30-55)")
    if getattr(compression, "stateful", False):
        if axis_name is None or packing != "packed":
            raise ValueError(
                "Compression.int8 requires the compiled packed path: "
                "DistributedOptimizer(axis_name=..., packing='packed').")
        if op not in (_c.Average, _c.Sum):
            raise ValueError(
                "Compression.int8 supports op=Average/Sum (Adasum "
                "reduces in its own dtype-preserving recursion).")


def _named(optimizer, named_parameters) -> list:
    """(name, parameter) of every parameter of ``optimizer``: the given
    names, each parameter named and no name twice, or ``param.<group>.
    <index>``."""
    all_params = [p for group in optimizer.param_groups
                  for p in group["params"]]
    if named_parameters is not None:
        named = list(named_parameters)
        # every optimizer parameter must be named, or its gradients
        # would silently skip synchronization (reference:
        # torch/optimizer.py:57-62 raises for unnamed parameters)
        named_ids = {id(p) for _, p in named}
        missing = [p for p in all_params if id(p) not in named_ids]
        if missing:
            raise ValueError(
                "named_parameters was specified, but one or more model "
                "parameters were not named. Python object ids: " +
                ", ".join(str(id(p)) for p in missing))
    else:
        named = [(f"param.{gi}.{pi}", p)
                 for gi, group in enumerate(optimizer.param_groups)
                 for pi, p in enumerate(group["params"])]
    seen = set()
    for name, _ in named:
        if name in seen:
            raise ValueError(
                f"duplicate parameter name {name!r} (reference "
                f"semantics: optimizer.py name dedup)")
        seen.add(name)
    return named


class DistributedOptimizer:
    """Wraps ``optimizer``; see the module docstring.

    ``backward_passes_per_step``: gradients accumulate locally over that
    many backward passes before their bucket fires (each pass's gradient
    is divided by it); if they fire a second time before ``step()``, the
    hook raises AssertionError (the JAX package's torch frontend does the
    same). ``gradient_predivide_factor`` splits the Average
    scale into a prescale and a postscale, which this data plane folds
    into one scalar (numerically neutral, kept for API parity).
    ``grad_process_sets``: {parameter name: (process set or None for the
    world, scale)}, see the module docstring; needs ``named_parameters``
    and op=Average. ``axis_name`` (with ``inner_axis``, ``mesh``,
    ``reduce_strategy``, ``packing``) selects the compiled plane, see the
    module docstring."""

    def __new__(cls, optimizer=None, named_parameters=None, op=_c.Average,
                *args, **kwargs):
        if cls is DistributedOptimizer:
            if kwargs.get("axis_name") is not None:
                cls = _CompiledPlaneOptimizer
            elif op == _c.Adasum and _basics.size() > 1:
                # reference dispatch (torch/optimizer.py:412-420): op=Adasum
                # in a world of more than one process is the delta
                # optimizer; a single process keeps the gradient path
                # (Adasum of one tensor = identity)
                cls = _DistributedAdasumDeltaOptimizer
        return super().__new__(cls)

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, op=_c.Average,
                 backward_passes_per_step: int = 1,
                 compression=Compression.none,
                 gradient_predivide_factor: float = 1.0,
                 grad_process_sets=None, *, axis_name=None,
                 inner_axis=None, mesh=None,
                 reduce_strategy: str = "hierarchical",
                 packing: str = "per_leaf",
                 fusion_threshold_bytes: Optional[int] = None):
        self._setup(optimizer, op, backward_passes_per_step, compression,
                    gradient_predivide_factor, axis_name, reduce_strategy,
                    packing)
        #: a bucket size fixed for this optimizer, over the
        #: HVD_TPU_FUSION_THRESHOLD knob and the autotuner
        self._fixed_threshold = fusion_threshold_bytes
        if grad_process_sets is not None and (
                op != _c.Average or named_parameters is None):
            raise ValueError("grad_process_sets needs op=Average and "
                             "named_parameters")
        self._pass_count: Dict[int, int] = {}
        self._ctxs: Dict[int, Any] = {}
        hooked = []
        self._names: Dict[int, str] = {}
        self._hooks = []
        for name, p in _named(optimizer, named_parameters):
            if p.requires_grad:
                self._names[id(p)] = name
                hooked.append(p)
                self._hooks.append(
                    p.register_post_accumulate_grad_hook(self._hook))
        self._hooked = hooked
        # one reduction (process set, scale) per bucket: without
        # grad_process_sets every gradient shares the world's
        self._reduction = {id(p): (None, 1.0) for p in hooked}
        if grad_process_sets is not None:
            self._reduction.update({
                id(p): grad_process_sets[self._names[id(p)]]
                for p in hooked})
        self._sharded = grad_process_sets is not None
        self._grad_bytes = sum(p.numel() * p.element_size() for p in hooked)
        #: (threshold, bucket plan as member names) at construction and
        #: after every re-plan the autotuner caused
        self.plans = []
        self._plan(self._configured_threshold())
        # per-step state
        self._bucket_ready: Dict[int, Dict[int, torch.Tensor]] = {}
        self._handles: list = []
        self._fired_ids: set = set()
        self._holding = False
        self._held: list = []
        self._t_first_fire = None

    def _setup(self, optimizer, op, backward_passes_per_step, compression,
               gradient_predivide_factor, axis_name, reduce_strategy,
               packing) -> None:
        """The argument checks and the state both planes share."""
        _check_args(op, axis_name, compression, reduce_strategy, packing)
        if gradient_predivide_factor != 1.0 and op != _c.Average:
            raise ValueError(
                "gradient_predivide_factor only applies to op=Average "
                "(reference: torch/optimizer.py:395-398)")
        self._opt = optimizer
        self._op = op
        self._bpps = backward_passes_per_step
        self._compression = compression
        self._prescale = 1.0 / gradient_predivide_factor
        self._postscale = gradient_predivide_factor

    def _configured_threshold(self) -> int:
        if self._fixed_threshold is not None:
            return int(self._fixed_threshold)
        return _basics.world().config.get(_config.FUSION_THRESHOLD)

    def _plan(self, threshold: int) -> None:
        """Plan the buckets for ``threshold``: in reverse registration
        order (approximate readiness order), one plan per reduction kind,
        the same on every process."""
        ordered = list(reversed(self._hooked))
        kinds = []
        for p in ordered:
            if self._reduction[id(p)] not in kinds:
                kinds.append(self._reduction[id(p)])
        self._bucket_members = []
        self._bucket_reduction = []
        for kind in kinds:
            members = [p for p in ordered if self._reduction[id(p)] == kind]
            buckets = plan_buckets(
                [(tuple(p.shape), p.dtype) for p in members], threshold)
            self._bucket_members += [[members[i] for i in b]
                                     for b in buckets]
            self._bucket_reduction += [kind] * len(buckets)
        self._bucket_of = {id(p): bi for bi, b in
                           enumerate(self._bucket_members) for p in b}
        self._threshold = threshold
        self.plans.append((threshold, [[self._names[id(p)] for p in b]
                                       for b in self._bucket_members]))

    # hooks ------------------------------------------------------------------
    def _stage_payload(self, p) -> torch.Tensor:
        """What a parameter contributes to its bucket: the (accumulated)
        gradient; the Adasum delta optimizer stages its local delta."""
        return p.grad if self._bpps == 1 else p.grad / self._bpps

    def _stage(self, p) -> None:
        bid = self._bucket_of[id(p)]
        ready = self._bucket_ready.setdefault(bid, {})
        compressed, self._ctxs[id(p)] = self._compression.compress(
            self._stage_payload(p))
        ready[id(p)] = compressed
        self._pass_count[id(p)] = 0
        if len(ready) == len(self._bucket_members[bid]):
            self._fire_bucket(bid)

    def _hook(self, p) -> None:
        n = self._pass_count.get(id(p), 0) + 1
        self._pass_count[id(p)] = n
        if n < self._bpps:
            return
        ready = self._bucket_ready.get(self._bucket_of[id(p)], {})
        if id(p) in ready or id(p) in self._fired_ids \
                or any(q is p for q in self._held):
            raise AssertionError(
                "Gradients were computed more than "
                "backward_passes_per_step times before call to "
                "step(). Increase backward_passes_per_step to "
                "accumulate gradients locally (reference: "
                "torch/optimizer.py:122-126).")
        if self._holding:
            self._held.append(p)
            self._pass_count[id(p)] = 0
            return
        self._stage(p)

    def hold_gradients(self) -> None:
        """Keep this step's local gradients out of the buckets until
        :meth:`release_gradients`: the hooks only note which gradients
        are ready. The Estimator's SDC guard checks (and its drill
        corrupts) the local gradients in between, so a poisoned gradient
        is never averaged into another rank's."""
        self._holding = True

    def release_gradients(self) -> None:
        """Stage the held gradients in the order their hooks ran, firing
        each bucket as it fills (the buckets' order of an unheld step),
        and stop holding."""
        self._holding = False
        held, self._held = self._held, []
        for p in held:
            self._stage(p)

    def _fire_bucket(self, bid: int) -> None:
        ready = self._bucket_ready.pop(bid, None)
        if not ready:
            return
        if self._t_first_fire is None:
            self._t_first_fire = time.perf_counter()
        members = [p for p in self._bucket_members[bid] if id(p) in ready]
        # a stable name across steps (the response cache validates each
        # bucket once), with the member names' digest and the partial
        # count in it: processes that disagree on WHICH gradients exist
        # fail the consistency exchange instead of reducing mismatched
        # gradients together
        digest = zlib.crc32("|".join(
            self._names[id(p)] for p in members).encode()) & 0xFFFFFFFF
        name = (f"grad.bucket.{bid}."
                f"{len(members)}of{len(self._bucket_members[bid])}"
                f".{digest:08x}")
        tensors = [ready[id(p)] for p in members]
        if self._sharded:
            process_set, scale = self._bucket_reduction[bid]
            h = _c.grouped_allreduce_async(
                tensors, op=_c.Sum, prescale_factor=self._prescale,
                postscale_factor=self._postscale * scale, name=name,
                process_set=process_set)
        else:
            h = _c.grouped_allreduce_async(
                tensors, op=self._op, prescale_factor=self._prescale,
                postscale_factor=self._postscale, name=name)
        self._handles.append((h, members))
        self._fired_ids.update(id(p) for p in members)

    # torch optimizer protocol ----------------------------------------------
    def _apply_result(self, p, out) -> None:
        """Land a reduced bucket member: overwrite the gradient (the Adasum
        delta optimizer advances the parameter instead)."""
        with torch.no_grad():
            p.grad.copy_(out)

    def _flush_and_drain(self) -> None:
        # partially ready buckets (parameters that got no gradient this
        # step) fire now, with their partial count in the name
        for bid in sorted(self._bucket_ready):
            self._fire_bucket(bid)
        if _basics.size() > 1:
            # the round marker of cooperative Join (uneven data): joined
            # processes pair it with their replay loop
            _c.join_round()
        for h, members in self._handles:
            outs = _c.synchronize(h)
            for p, out in zip(members, outs):
                self._apply_result(p, self._compression.decompress(
                    out, self._ctxs.pop(id(p), None)))
        self._handles = []
        self._bucket_ready = {}
        self._fired_ids = set()
        self._autotune_step()

    def _autotune_step(self) -> None:
        """While the autotuner is active: report this step's gradient
        bytes and the seconds from its first bucket's fire to the drained
        result (after a device sync; only while tuning), then re-plan the
        buckets if the threshold has changed: a step boundary, with no
        bucket in flight."""
        t0, self._t_first_fire = self._t_first_fire, None
        w = _basics.world()
        pm = w.parameter_manager
        if pm is None or not pm.active:
            return
        if t0 is not None:
            if w.device.type == "cuda":
                torch.cuda.synchronize(w.device)
            pm.record(self._grad_bytes, time.perf_counter() - t0)
        threshold = self._configured_threshold()
        if threshold != self._threshold:
            self._plan(threshold)

    def synchronize(self) -> None:
        """Fire partially ready buckets, wait for every bucket and write
        the reduced gradients back."""
        self._flush_and_drain()

    def abandon_step(self) -> None:
        """Forget the staged gradients and in-flight handles of a step
        that will not complete (the elastic reset: its handles belong to
        a world that is gone). The next backward starts a fresh step."""
        self._handles = []
        self._bucket_ready = {}
        self._fired_ids = set()
        self._pass_count = {}
        self._ctxs = {}
        self._holding = False
        self._held = []
        self._t_first_fire = None

    def step(self, closure=None):
        self.synchronize()
        return self._opt.step(closure)

    def zero_grad(self, set_to_none: bool = True):
        return self._opt.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self._opt.state_dict()

    def load_state_dict(self, state_dict):
        return self._opt.load_state_dict(state_dict)

    def remove_hooks(self) -> None:
        """Detach the gradient hooks from the parameters."""
        for h in self._hooks:
            h.remove()
        self._hooks = []

    @property
    def param_groups(self):
        return self._opt.param_groups

    @property
    def state(self):
        return self._opt.state


class _DistributedAdasumDeltaOptimizer(DistributedOptimizer):
    """Adasum on optimizer DELTAS: each hook steps the wrapped optimizer on
    its parameter alone (its ``param_groups`` narrowed to it), stages the
    movement ``-lr·f(g)`` and rolls the parameter back; ``step()``
    Adasum-combines the deltas and advances the parameters by them."""

    def __init__(self, optimizer, named_parameters=None, op=_c.Adasum,
                 backward_passes_per_step: int = 1,
                 compression=Compression.none,
                 gradient_predivide_factor: float = 1.0, **kwargs):
        if gradient_predivide_factor != 1.0:
            raise ValueError(
                "gradient_predivide_factor only applies to op=Average "
                "(reference: torch/optimizer.py:395-398)")
        super().__init__(
            optimizer, named_parameters=named_parameters, op=_c.Adasum,
            backward_passes_per_step=backward_passes_per_step,
            compression=compression, **kwargs)
        self._start: Dict[int, torch.Tensor] = {}

    def _stage_payload(self, p) -> torch.Tensor:
        with torch.no_grad():
            start = self._start.get(id(p))
            if start is None:
                start = self._start[id(p)] = torch.empty_like(p.data)
            start.copy_(p.data)
        stash = []
        for g in self._opt.param_groups:
            stash.append(g["params"])
            g["params"] = [q for q in g["params"] if q is p]
        try:
            self._opt.step()
        finally:
            for s, g in zip(stash, self._opt.param_groups):
                g["params"] = s
        with torch.no_grad():
            delta = p.data - start
            p.data.copy_(start)
        return delta

    def synchronize(self) -> None:
        # deltas land only with the parameter advance in step() (reference:
        # _DistributedAdasumOptimizer.synchronize is a no-op)
        pass

    def _apply_result(self, p, out) -> None:
        with torch.no_grad():
            p.data.add_(out)

    def step(self, closure=None):
        loss = closure() if closure is not None else None
        # parameters whose hooks did not fire this step but carry a
        # gradient contribute their delta now, so every process issues the
        # same collectives (reference: step()'s missing_p path)
        staged = {pid for ready in self._bucket_ready.values()
                  for pid in ready}
        for p in self._hooked:
            if id(p) in self._fired_ids or id(p) in staged \
                    or p.grad is None:
                continue
            self._stage(p)
        self._flush_and_drain()
        return loss

    def zero_grad(self, set_to_none: bool = True):
        if self._handles or any(self._bucket_ready.values()):
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step(); with the Adasum delta "
                "optimizer this races with the in-flight delta reduction "
                "(reference: torch/optimizer.py zero_grad guard).")
        return self._opt.zero_grad(set_to_none=set_to_none)


class _CompiledPlaneOptimizer(DistributedOptimizer):
    """The compiled plane (``axis_name=``, see the module docstring):
    gradients stay local through backward and are reduced at
    :meth:`synchronize`, with the JAX package's numerics (division where
    it divides, one wire call per packed bucket)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, op=_c.Average,
                 backward_passes_per_step: int = 1,
                 compression=Compression.none,
                 gradient_predivide_factor: float = 1.0,
                 grad_process_sets=None, *, axis_name, inner_axis=None,
                 mesh=None, reduce_strategy: str = "hierarchical",
                 packing: str = "per_leaf",
                 fusion_threshold_bytes: Optional[int] = None):
        from .mesh import cross_local_mesh, flat_group
        from .models.convert import flax_order
        self._setup(optimizer, op, backward_passes_per_step, compression,
                    gradient_predivide_factor, axis_name, reduce_strategy,
                    packing)
        if grad_process_sets is not None \
                or fusion_threshold_bytes is not None:
            raise ValueError("grad_process_sets and fusion_threshold_bytes "
                             "belong to the eager plane (axis_name=None); "
                             "the compiled plane's buckets are sized by "
                             "HVD_TPU_INJIT_PACKED_THRESHOLD")
        self._strategy = reduce_strategy
        self._packing = packing
        named = {n: p for n, p in _named(optimizer, named_parameters)
                 if p.requires_grad}
        #: (name, parameter) in the JAX package's leaf order
        self._params = [(n, named[n]) for n in flax_order(named)]
        self._hooks = []
        self.plans = []
        self.mesh = mesh if mesh is not None else cross_local_mesh()
        dims = tuple(self.mesh.mesh_dim_names or ())
        for axis in (axis_name, inner_axis):
            if axis is not None and axis not in dims:
                raise ValueError(f"axis {axis!r} is not a dim of the mesh "
                                 f"{dims}")
        self._outer = self.mesh.get_group(axis_name)
        self._inner = None if inner_axis is None \
            else self.mesh.get_group(inner_axis)
        self._flat = None
        if self._inner is not None and reduce_strategy == "flat":
            self._flat = flat_group(self.mesh, (inner_axis, axis_name))
        self._residual = None
        if getattr(compression, "stateful", False):
            self._residual = {n: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                              for n, p in self._params}

    # gradients stay local until synchronize(): nothing to hold or drop
    def hold_gradients(self) -> None:
        pass

    def release_gradients(self) -> None:
        pass

    def abandon_step(self) -> None:
        pass

    def synchronize(self) -> None:
        """Reduce every gradient (a missing one as zeros) and write the
        results back, in one closure on the dispatcher thread."""
        grads = []
        for _, p in self._params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads.append(g if self._bpps == 1 else g / self._bpps)
        out: List[torch.Tensor] = []
        _c.run_in_order(lambda: out.extend(self._reduce(grads)), grads, out)
        with torch.no_grad():
            for (_, p), g in zip(self._params, out):
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.copy_(g)

    def step(self, closure=None):
        self.synchronize()
        return self._opt.step(closure)

    def state_dict(self):
        sd = self._opt.state_dict()
        if self._residual is not None:
            sd = dict(sd, **{_RESIDUAL: dict(self._residual)})
        return sd

    def load_state_dict(self, state_dict):
        if self._residual is not None:
            if _RESIDUAL not in state_dict:
                raise TypeError(
                    "Compression.int8 carries an error-feedback residual "
                    "as optimizer state, made at construction (the JAX "
                    "transform's init()); load a state_dict() saved by "
                    f"such an optimizer (this one has no {_RESIDUAL!r})")
            saved = state_dict[_RESIDUAL]
            if set(saved) != set(self._residual):
                raise ValueError(
                    "error-feedback residual does not match the "
                    "parameters (did the parameter structure change?)")
            with torch.no_grad():
                for n, t in self._residual.items():
                    t.copy_(saved[n])
        state_dict = {k: v for k, v in state_dict.items() if k != _RESIDUAL}
        return self._opt.load_state_dict(state_dict)

    # the reduction ---------------------------------------------------------
    def _reduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        from .adasum import adasum_grads
        if self._op == _c.Adasum:
            return adasum_grads(grads, self._outer, self._inner)
        if self._residual is not None:
            res = [self._residual[n] for n, _ in self._params]
            out, new_res = packed_apply(grads, _packed_threshold(),
                                        self._reduce_bucket, residuals=res)
            for r, nr in zip(res, new_res):
                r.copy_(nr)
            return out
        if self._packing == "packed":
            return packed_apply(grads, _packed_threshold(),
                                self._reduce_bucket)[0]
        return [self._reduce_bucket([g], None)[0][0] for g in grads]

    @staticmethod
    def _mean(gs, group):
        from .mesh import group_allreduce
        n = torch.distributed.get_world_size(group)
        return [true_divide(g, n) for g in group_allreduce(gs, group)]

    def _reduce_bucket(self, vals, rvals):
        """Reduce ONE bucket (same-dtype gradients; one gradient on the
        per-leaf path) with one wire call per stage: prescale -> [inner
        mean] -> the op with the wire compression -> [inner division]
        -> postscale, elementwise in the JAX package's order, so fp32
        packed and per-leaf agree bit for bit. Returns ``(out,
        new_residuals | None)``."""
        from .mesh import group_allreduce
        orig_dtype = vals[0].dtype
        gs = list(vals)
        if self._prescale != 1.0:
            gs = [g * self._prescale for g in gs]
        if self._inner is not None and self._strategy == "hierarchical":
            # the inner mean rides uncompressed; the wire compressor
            # targets the outer collective
            gs = self._mean(gs, self._inner)
        group = self._flat if self._flat is not None else self._outer
        comp = self._compression
        floating = orig_dtype.is_floating_point
        average = self._op == _c.Average
        new_r = rvals
        if getattr(comp, "stateful", False) and floating:
            flat, unflatten = flatten_bucket(gs)
            rflat = None if rvals is None else flatten_bucket(rvals)[0]
            r, nr = int8_pack_reduce(flat, rflat, group, average)
            gs = unflatten(r)
            new_r = None if rvals is None else unflatten(nr)
        elif getattr(comp, "wire_dtype", None) is not None and floating \
                and self._packing == "packed":
            # (the JAX package's per-leaf reduction ignores compression)
            gw = [g.to(comp.wire_dtype) for g in gs]     # the wire
            if not comp.sum_safe_wire:
                # upcast-sum: fp16's 5-bit exponent overflows under a
                # cross-rank sum, so it accumulates in fp32
                gw = [g.to(torch.float32) for g in gw]
            red = self._mean(gw, group) if average \
                else group_allreduce(gw, group)
            gs = [g.to(torch.float32) for g in red]
        else:
            gs = self._mean(gs, group) if average \
                else group_allreduce(gs, group)
        if not average and self._flat is not None:
            # division, not a reciprocal multiply: the JAX package's
            # numerics
            n_inner = torch.distributed.get_world_size(self._inner)
            gs = [true_divide(g, n_inner) for g in gs]
        if self._postscale != 1.0:
            gs = [g * self._postscale for g in gs]
        return [g.to(orig_dtype) for g in gs], new_r
