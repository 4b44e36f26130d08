"""SDC step guard: finite/magnitude checks, loss-spike bound, and the
``worker.grads`` corruption site (counterpart of ``horovod_tpu/sdc/guard.py``).

Two surfaces share the same math and verdict codes:

* :func:`guard_update`: a tensor function (no host sync) that MAX-reduces
  the verdict over an optional process group through
  ``parallel.comm.all_reduce_max``, so every member takes the same branch;
* :class:`StepGuard`: the eager variant the Estimator uses. The JAX guard
  copies every gradient leaf to the host; this one reduces on the
  gradients' device instead, one ``max(|g|)`` a leaf
  (``torch.linalg.vector_norm(ord=inf)``, which propagates NaN and Inf as
  ``jnp.max(jnp.abs(...))`` does), ``~(m <= GRAD_ABS_LIMIT)`` catching NaN,
  Inf and out-of-range values at once, and one host sync a step. The
  verdict is MAX-allreduced across processes so every rank skips or rolls
  back the same step.

Gradients are given as a mapping of name to tensor (taken in the JAX
tree's leaf order: names sorted by their dotted path, as
``jax.tree_util`` flattens the flax dict) or as a sequence in that order.
The ``worker.grads`` fault point is the drill entry: a ``bitflip``/``nan``
rule corrupts one element of one leaf through :func:`corrupt_grads`. For
the same rule seed and the same leaves (in flax layout: see
``models.convert.flax_view``) it picks the leaf, element and bit the JAX
package picks.
"""

import logging
import math
from typing import Callable, List, Mapping, NamedTuple, Optional

import torch

from .. import config as _config
from .. import faults as _faults
from .. import metrics as _metrics

log = logging.getLogger("horovod_tpu.sdc")

_M_DETECTIONS = _metrics.counter(
    "hvd_tpu_sdc_detections_total",
    "Silent-data-corruption detections, by kind: 'nonfinite' (NaN/Inf "
    "gradient or loss), 'loss_spike' (finite loss beyond the EWMA "
    "bound), 'fingerprint' (cross-replica parameter fingerprint "
    "divergence).",
    labels=("kind",))

# Chaos site for silent data corruption: fired once per guarded step on
# the freshly computed LOCAL gradients, before any reduction would spread
# the poison. Leaf, element and bit come from the rule's seeded RNG.
_FP_GRADS = _faults.FaultPoint("worker.grads")

#: EWMA smoothing for the loss-spike bound
_EWMA_ALPHA = 0.1

#: verdict codes shared by the tensor and eager guards (MAX-reduced, so
#: the hard failure wins when replicas disagree on the kind)
_OK, _SPIKE, _NONFINITE = 0, 1, 2
_KIND_BY_CODE = {_SPIKE: "loss_spike", _NONFINITE: "nonfinite"}

#: any float32 gradient beyond this is corruption (one flipped exponent
#: bit multiplies a value by ~2^128 and usually stays finite)
GRAD_ABS_LIMIT = 1e12

#: elements below this are numerically zero; the bitflip drill skips them
_DRILL_FLOOR = 1e-20

_INT_OF_SIZE = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of ``tree`` in the JAX package's order: a mapping's
    entries sorted by dotted path (nested mappings flattened first), a
    sequence as given, a tensor alone."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        from ..models.convert import flax_order
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, Mapping):
                    walk(v, f"{prefix}{k}.")
                else:
                    flat[f"{prefix}{k}"] = v
        walk(tree, "")
        return [flat[n] for n in flax_order(flat)]
    return list(tree)


def _corrupt_tensor(t: torch.Tensor, kind: str, rng) -> torch.Tensor:
    """A corrupted contiguous copy of ``t``: the JAX ``_corrupt_array``,
    draw for draw."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    flat = out.view(-1)
    if kind == "nan":
        flat[rng.randrange(flat.numel())] = float("nan")
        return out
    # bitflip: XOR the top exponent bit of one non-negligible element;
    # an all-zero leaf falls back to a NaN overwrite
    candidates = torch.nonzero(flat.abs() >= _DRILL_FLOOR).flatten()
    if candidates.numel() == 0:
        flat[rng.randrange(flat.numel())] = float("nan")
        return out
    idx = int(candidates[rng.randrange(candidates.numel())])
    nbits = out.element_size() * 8
    bits = flat.view(_INT_OF_SIZE[out.element_size()])
    bits[idx] = bits[idx] ^ (1 << (nbits - 2))
    return out


def corrupt_grads(grads):
    """Fire the ``worker.grads`` site; a matched ``bitflip``/``nan`` rule
    returns a list of the leaves (:func:`tree_leaves` order) with one
    leaf replaced by a corrupted copy, otherwise ``grads`` unchanged. Call
    on the local gradients before they are reduced."""
    box = [grads]

    def handler(kind: str, rng) -> None:
        leaves = tree_leaves(box[0])
        targets = [i for i, g in enumerate(leaves)
                   if g.is_floating_point() and g.numel() > 0]
        if not targets:
            return
        i = targets[rng.randrange(len(targets))]
        leaves[i] = _corrupt_tensor(leaves[i], kind, rng)
        box[0] = leaves

    _FP_GRADS.fire(corrupt=handler)
    return box[0]


def _grads_ok(leaves) -> Optional[torch.Tensor]:
    """A bool tensor on the gradients' device: every inexact leaf's
    max |g| is <= GRAD_ABS_LIMIT (False for NaN and Inf). None without
    inexact leaves."""
    maxes = [torch.linalg.vector_norm(g.detach(), ord=math.inf,
                                      dtype=torch.float32)
             for g in leaves if g.is_floating_point() and g.numel() > 0]
    if not maxes:
        return None
    return torch.all(torch.stack(maxes) <= GRAD_ABS_LIMIT)


def guard_update(grads, loss, ewma=None, factor: Optional[float] = None,
                 group=None):
    """Tensor step guard: ``(code, new_ewma)``, both tensors on the
    loss's device, with no host sync.

    ``code`` is an int32 scalar: 0 (clean), 1 (loss spike), 2 (non-finite
    or out-of-range gradient, or non-finite loss), MAX-reduced over
    ``group`` (a process group) when given. ``new_ewma`` advances the
    loss EWMA only on clean steps; pass ``ewma=None`` on the first step."""
    if factor is None:
        factor = float(
            _config.live_config().get(_config.SDC_LOSS_SPIKE_FACTOR))
    loss = torch.as_tensor(loss).detach().to(torch.float32)
    bad = ~torch.isfinite(loss)
    ok = _grads_ok(tree_leaves(grads))
    if ok is not None:
        bad = bad | ~ok.to(bad.device)
    zero = torch.zeros((), dtype=torch.int32, device=loss.device)
    code = torch.where(bad, zero + _NONFINITE, zero)
    if ewma is None:
        new_ewma = loss.abs()
    else:
        ewma = torch.as_tensor(ewma, dtype=torch.float32,
                               device=loss.device)
        if factor > 0:
            spike = loss.abs() > factor * torch.clamp(ewma, min=1e-12)
            code = torch.maximum(code, torch.where(spike, zero + _SPIKE,
                                                   zero))
        new_ewma = (1.0 - _EWMA_ALPHA) * ewma + _EWMA_ALPHA * loss.abs()
    if group is not None:
        from ..parallel.comm import all_reduce_max
        code = all_reduce_max(code.reshape(1), group).reshape(())
    new_ewma = torch.where(code > 0, ewma if ewma is not None
                           else new_ewma, new_ewma)
    return code, new_ewma


class Detection(NamedTuple):
    kind: str      # "nonfinite" | "loss_spike" | "fingerprint"
    local: bool    # True when THIS rank's data tripped the guard


class StepGuard:
    """Eager step guard for the Estimator loop.

    ``check(grads, loss)`` returns a :class:`Detection` when the step is
    poisoned, else None. The checks run on the gradients' device with one
    host sync (the loss and the gradients' verdict together); the verdict
    is then MAX-allreduced across processes (when initialized), so all
    ranks agree, and ``local`` tells the quarantine policy whether to
    charge the strike to this host.
    """

    def __init__(self, loss_spike_factor: Optional[float] = None,
                 sync: Optional[Callable[[int], int]] = None):
        cfg = _config.live_config()
        self.factor = float(cfg.get(_config.SDC_LOSS_SPIKE_FACTOR)) \
            if loss_spike_factor is None else float(loss_spike_factor)
        self._sync = sync if sync is not None else _sync_verdict
        self._ewma: Optional[float] = None
        #: the last checked loss as a host float (read by the Estimator
        #: instead of a second sync)
        self.last_loss = float("nan")

    def check(self, grads, loss) -> Optional[Detection]:
        loss_t = torch.as_tensor(loss).detach().reshape(())
        ok = _grads_ok(tree_leaves(grads))
        if ok is None:
            ok = torch.ones((), dtype=torch.bool, device=loss_t.device)
        loss, grads_ok = torch.stack(
            [loss_t.to(torch.float64), ok.to(loss_t.device, torch.float64)]
        ).tolist()                                  # the one host sync
        self.last_loss = loss
        local = _NONFINITE if not math.isfinite(loss) or not grads_ok \
            else _OK
        if local == _OK and self._ewma is not None and self.factor > 0 \
                and abs(loss) > self.factor * max(self._ewma, 1e-12):
            local = _SPIKE
        code = self._sync(local)
        if code == _OK:
            self._ewma = abs(loss) if self._ewma is None else \
                (1.0 - _EWMA_ALPHA) * self._ewma + _EWMA_ALPHA * abs(loss)
            return None
        kind = _KIND_BY_CODE[code]
        _M_DETECTIONS.labels(kind=kind).inc()
        log.warning("sdc: step guard tripped (%s%s) — loss=%r, "
                    "ewma=%r", kind, "" if local else " on a peer rank",
                    loss, self._ewma)
        return Detection(kind=kind, local=local != _OK)


def _sync_verdict(code: int) -> int:
    """MAX-allreduce the local verdict code so every rank skips (or
    rolls back) the same step; identity in single-process runs."""
    from .. import basics
    if not basics.is_initialized() or basics.size() <= 1:
        return code
    from .. import collectives as _c
    return int(_c.allreduce(torch.tensor([code], dtype=torch.int32),
                            name="sdc.guard.verdict", op=_c.Max)[0])
