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
"""

import zlib
from typing import Any, Dict

import torch

from . import basics as _basics
from . import collectives as _c
from . import config as _config
from .compression import Compression
from .fusion import plan_buckets


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
    and op=Average."""

    def __new__(cls, optimizer=None, named_parameters=None, op=_c.Average,
                *args, **kwargs):
        # reference dispatch (torch/optimizer.py:412-420): op=Adasum in a
        # world of more than one process is the delta optimizer; a single
        # process keeps the gradient path (Adasum of one tensor = identity)
        if cls is DistributedOptimizer and op == _c.Adasum \
                and _basics.size() > 1:
            cls = _DistributedAdasumDeltaOptimizer
        return super().__new__(cls)

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, op=_c.Average,
                 backward_passes_per_step: int = 1,
                 compression=Compression.none,
                 gradient_predivide_factor: float = 1.0,
                 grad_process_sets=None):
        if gradient_predivide_factor != 1.0 and op != _c.Average:
            raise ValueError(
                "gradient_predivide_factor only applies to op=Average "
                "(reference: torch/optimizer.py:395-398)")
        if grad_process_sets is not None and (
                op != _c.Average or named_parameters is None):
            raise ValueError("grad_process_sets needs op=Average and "
                             "named_parameters")
        self._opt = optimizer
        self._op = op
        self._bpps = backward_passes_per_step
        self._compression = compression
        self._prescale = 1.0 / gradient_predivide_factor
        self._postscale = gradient_predivide_factor
        self._pass_count: Dict[int, int] = {}
        self._ctxs: Dict[int, Any] = {}
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
        hooked = []
        self._names: Dict[int, str] = {}
        self._hooks = []
        for name, p in named:
            if name in seen:
                raise ValueError(
                    f"duplicate parameter name {name!r} (reference "
                    f"semantics: optimizer.py name dedup)")
            seen.add(name)
            if p.requires_grad:
                self._names[id(p)] = name
                hooked.append(p)
                self._hooks.append(
                    p.register_post_accumulate_grad_hook(self._hook))
        self._hooked = hooked
        ordered = list(reversed(hooked))   # approximate readiness order
        threshold = _basics.world().config.get(_config.FUSION_THRESHOLD)
        # one reduction (process set, scale) per bucket: without
        # grad_process_sets every gradient shares the world's
        reduction = {id(p): (None, 1.0) for p in ordered}
        if grad_process_sets is not None:
            reduction.update({id(p): grad_process_sets[self._names[id(p)]]
                              for p in ordered})
        kinds = []
        for p in ordered:
            if reduction[id(p)] not in kinds:
                kinds.append(reduction[id(p)])
        self._bucket_members = []
        self._bucket_reduction = []
        for kind in kinds:
            members = [p for p in ordered if reduction[id(p)] == kind]
            buckets = plan_buckets(
                [(tuple(p.shape), p.dtype) for p in members], threshold)
            self._bucket_members += [[members[i] for i in b]
                                     for b in buckets]
            self._bucket_reduction += [kind] * len(buckets)
        self._sharded = grad_process_sets is not None
        self._bucket_of = {id(p): bi for bi, b in
                           enumerate(self._bucket_members) for p in b}
        # per-step state
        self._bucket_ready: Dict[int, Dict[int, torch.Tensor]] = {}
        self._handles: list = []
        self._fired_ids: set = set()

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
        if id(p) in ready or id(p) in self._fired_ids:
            raise AssertionError(
                "Gradients were computed more than "
                "backward_passes_per_step times before call to "
                "step(). Increase backward_passes_per_step to "
                "accumulate gradients locally (reference: "
                "torch/optimizer.py:122-126).")
        self._stage(p)

    def _fire_bucket(self, bid: int) -> None:
        ready = self._bucket_ready.pop(bid, None)
        if not ready:
            return
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

    def synchronize(self) -> None:
        """Fire partially ready buckets, wait for every bucket and write
        the reduced gradients back."""
        self._flush_and_drain()

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
                 gradient_predivide_factor: float = 1.0):
        if gradient_predivide_factor != 1.0:
            raise ValueError(
                "gradient_predivide_factor only applies to op=Average "
                "(reference: torch/optimizer.py:395-398)")
        super().__init__(
            optimizer, named_parameters=named_parameters, op=_c.Adasum,
            backward_passes_per_step=backward_passes_per_step,
            compression=compression)
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
