"""DistributedOptimizer: bucketed gradient allreduce around a
``torch.optim`` optimizer.

Port of the JAX package's torch frontend (``horovod_tpu/torch/__init__.py``
``_DistributedOptimizer``; reference: torch/optimizer.py:100-186 fused
through the fusion buffer, collective_operations.cc:37-81). A
post-accumulate-grad hook on each parameter marks its gradient ready;
buckets are planned once, in reverse registration order (later layers'
gradients materialize first in backward), so every process forms
identical buckets without negotiation; a bucket fires ONE grouped async
allreduce as soon as all its members are ready, overlapping communication
with the rest of backward; ``step()`` drains the handles, writes the
reduced gradients back and calls the wrapped optimizer's step.

The reduction stays on the device: each bucket is flattened, reduced by
``dist.all_reduce`` and split back (collectives.py).
"""

from typing import Any, Dict, Optional

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
    into one scalar (numerically neutral, kept for API parity)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, op=_c.Average,
                 backward_passes_per_step: int = 1,
                 compression=Compression.none,
                 gradient_predivide_factor: float = 1.0):
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
        self._hooks = []
        for name, p in named:
            if name in seen:
                raise ValueError(
                    f"duplicate parameter name {name!r} (reference "
                    f"semantics: optimizer.py name dedup)")
            seen.add(name)
            if p.requires_grad:
                hooked.append(p)
                self._hooks.append(
                    p.register_post_accumulate_grad_hook(self._hook))
        ordered = list(reversed(hooked))   # approximate readiness order
        threshold = _basics.world().config.get(_config.FUSION_THRESHOLD)
        buckets = plan_buckets([(tuple(p.shape), p.dtype) for p in ordered],
                               threshold)
        self._bucket_members = [[ordered[i] for i in b] for b in buckets]
        self._bucket_of = {id(p): bi for bi, b in
                           enumerate(self._bucket_members) for p in b}
        # per-step state
        self._bucket_ready: Dict[int, Dict[int, torch.Tensor]] = {}
        self._handles: list = []
        self._fired_ids: set = set()

    # hooks ------------------------------------------------------------------
    def _hook(self, p) -> None:
        n = self._pass_count.get(id(p), 0) + 1
        self._pass_count[id(p)] = n
        if n < self._bpps:
            return
        bid = self._bucket_of[id(p)]
        ready = self._bucket_ready.setdefault(bid, {})
        if id(p) in ready or id(p) in self._fired_ids:
            raise AssertionError(
                "Gradients were computed more than "
                "backward_passes_per_step times before call to "
                "step(). Increase backward_passes_per_step to "
                "accumulate gradients locally (reference: "
                "torch/optimizer.py:122-126).")
        self._pass_count[id(p)] = 0
        grad = p.grad if self._bpps == 1 else p.grad / self._bpps
        compressed, self._ctxs[id(p)] = self._compression.compress(grad)
        ready[id(p)] = compressed
        if len(ready) == len(self._bucket_members[bid]):
            self._fire_bucket(bid)

    def _fire_bucket(self, bid: int) -> None:
        ready = self._bucket_ready.pop(bid, None)
        if not ready:
            return
        members = [p for p in self._bucket_members[bid] if id(p) in ready]
        h = _c.grouped_allreduce_async(
            [ready[id(p)] for p in members], op=self._op,
            prescale_factor=self._prescale,
            postscale_factor=self._postscale,
            name=f"grad.bucket.{bid}")
        self._handles.append((h, members))
        self._fired_ids.update(id(p) for p in members)

    # torch optimizer protocol ----------------------------------------------
    def synchronize(self) -> None:
        """Fire partially ready buckets (parameters that got no gradient
        this step), wait for every bucket and write the reduced gradients
        back."""
        for bid in sorted(self._bucket_ready):
            self._fire_bucket(bid)
        for h, members in self._handles:
            outs = _c.synchronize(h)
            with torch.no_grad():
                for p, out in zip(members, outs):
                    out = self._compression.decompress(
                        out, self._ctxs.pop(id(p), None))
                    p.grad.copy_(out)
        self._handles = []
        self._bucket_ready = {}
        self._fired_ids = set()

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
