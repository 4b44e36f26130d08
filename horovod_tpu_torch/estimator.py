"""High-level Estimator: fit / evaluate / predict for torch modules
(counterpart of ``horovod_tpu/estimator.py``).

Reference surface: the Spark ML estimators (horovod/spark/torch/
estimator.py TorchEstimator: wrap a model, optimizer and loss, fit on
prepared data across workers). The estimator owns the training loop over
the data-parallel plane (``DistributedOptimizer`` bucketed allreduce),
uses :mod:`.data` for sharding and the host-to-device prefetch,
:mod:`.callbacks` for broadcast, metric averaging and LR hooks, and
:mod:`.checkpoint` for persistence. ``fit`` returns a :class:`History`.

The port's differences:

* ``model`` is an ``nn.Module`` with its weights (the JAX Estimator
  initializes a flax module from ``seed``; here ``seed`` only seeds the
  shuffle, ``seed + epoch`` as there). ``params`` is the model's
  ``state_dict()`` once fitted or loaded.
* ``optimizer`` is a ``torch.optim.Optimizer`` over the model's
  parameters, or a callable that makes one from them. The default is
  ``torch.optim.Adam(lr=1e-3 * dp_size())`` (optax's ``adam(1e-3 *
  dp_size())``); either is wrapped in the port's ``DistributedOptimizer``.
* The default loss is cross-entropy with integer labels over the last
  axis, averaged over everything else (optax's
  ``softmax_cross_entropy_with_integer_labels(...).mean()``).
* The estimator runs on ``device``: the card unless the caller passes
  ``device="cpu"``. Batches reach it through the prefetcher.

Under ``HVD_TPU_SDC_GUARD`` every step runs through the guard
(:meth:`Estimator._guarded_step`). The JAX package reduces gradients only
in ``opt.update``, after the guard; the port's ``DistributedOptimizer``
fires each bucket's allreduce from the gradient hooks during backward. So
under the guard the step holds this rank's local gradients
(``hold_gradients``) until the ``worker.grads`` drill and the guard have
run, and only then fires the buckets; a skipped or retried step drops its
gradients (``abandon_step``). Otherwise the poison would be averaged into
every rank and ``Detection.local`` would charge the wrong host. The
unguarded step keeps its overlap of the buckets with backward.
"""

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

log = logging.getLogger("horovod_tpu.estimator")


@dataclass
class History:
    """Per-epoch metric logs (shape of keras History.history)."""
    history: Dict[str, List[float]] = field(default_factory=dict)

    def append(self, logs: Dict[str, float]):
        for k, v in logs.items():
            self.history.setdefault(k, []).append(v)


class _SdcSentry:
    """Per-``fit()`` silent-data-corruption defense wiring, built only
    when ``HVD_TPU_SDC_GUARD`` is on: every step runs through the guard,
    parameters are fingerprinted every ``HVD_TPU_SDC_FINGERPRINT_EVERY``
    applied steps, and the policy escalates detections to skip, rollback
    or quarantine."""

    def __init__(self, manager):
        from . import sdc as _sdc
        self.sdc = _sdc
        self.guard = _sdc.StepGuard()
        self.monitor = _sdc.FingerprintMonitor()
        self.policy = _sdc.SdcPolicy()
        self.manager = manager      # CheckpointManager (rollback target)
        self.step = 0               # applied (non-skipped) steps
        self.dropped = 0
        self.rollbacks = 0

    def safe_loss(self, loss: float) -> float:
        # a poisoned step must not leak NaN into the epoch logs (the
        # metric-average callback allreduces them): report the EWMA
        if np.isfinite(loss):
            return loss
        ewma = self.guard._ewma
        return float(ewma) if ewma is not None else 0.0


def cross_entropy_loss(outputs: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels over the last axis,
    averaged over every other axis."""
    return F.cross_entropy(outputs.reshape(-1, outputs.shape[-1]),
                           targets.reshape(-1).long())


class Estimator:
    """Train a torch module data-parallel with the reference's 5-line
    recipe folded in (LR scaling, optimizer wrapping, initial broadcast,
    metric averaging). See the module docstring.

    Args:
      model: ``nn.Module`` on ``device``.
      optimizer: ``torch.optim.Optimizer`` over ``model.parameters()``, or
        a callable ``params -> Optimizer``; default Adam at
        ``1e-3 * dp_size()`` (unscaled with ``scale_lr_by_world=False``).
      loss_fn: ``(outputs, targets) -> scalar`` (default
        :func:`cross_entropy_loss`).
      metrics: dict name -> ``(outputs, targets) -> scalar``.
      device: where training runs; the card unless ``"cpu"`` is passed.
    """

    def __init__(self, model: torch.nn.Module, optimizer=None,
                 loss_fn: Optional[Callable] = None,
                 metrics: Optional[Dict[str, Callable]] = None,
                 scale_lr_by_world: bool = True,
                 checkpoint_dir: Optional[str] = None,
                 seed: int = 0, device=None):
        from .basics import resolve_device
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self._base_optimizer = optimizer
        self.loss_fn = loss_fn or cross_entropy_loss
        self.metrics = metrics or {}
        self.scale_lr = scale_lr_by_world
        self.checkpoint_dir = checkpoint_dir
        self.seed = seed
        self.params = None
        self._opt = None
        self._predict_cache = None
        from .models.convert import flax_order
        named = dict(self.model.named_parameters())
        #: trainable parameters in the JAX tree's leaf order (what the
        #: guard, the drill and the fingerprints index)
        self._leaf_names = flax_order(n for n, p in named.items()
                                      if p.requires_grad)

    # -- internals -----------------------------------------------------------
    def _build(self):
        from . import basics
        from .optimizer import DistributedOptimizer
        opt = self._base_optimizer
        if opt is None:
            lr = 1e-3 * (basics.dp_size() if self.scale_lr else 1)
            opt = torch.optim.Adam(self.model.parameters(), lr=lr)
        elif not isinstance(opt, torch.optim.Optimizer):
            opt = opt(self.model.parameters())
        self._opt = DistributedOptimizer(
            opt, named_parameters=self.model.named_parameters())

    def _to_device(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.ascontiguousarray(a))
        return t.to(self.device)

    def _leaf_grads(self) -> List[torch.Tensor]:
        """This step's local gradients in the JAX leaf order and the flax
        module's layout (views, so the drill's writes land in ``.grad``);
        an unused parameter's gradient is zeros, as JAX's is."""
        from .models.convert import flax_view
        named = dict(self.model.named_parameters())
        out = []
        for n in self._leaf_names:
            p = named[n]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            out.append(flax_view(n, p.grad))
        return out

    # -- public API ----------------------------------------------------------
    def fit(self, x, y, epochs: int = 1, batch_size: int = 32,
            callbacks: Optional[Sequence] = None,
            validation_data=None, shard: bool = True,
            verbose: bool = False) -> History:
        from . import basics
        from . import callbacks as cbs
        from . import config as _config
        from . import data as hdata

        if shard:
            x, y = hdata.shard_dataset((np.asarray(x), np.asarray(y)))
        if self._opt is None:
            self._build()

        steps = len(x) // batch_size
        if steps == 0:
            raise ValueError(
                f"per-process shard has {len(x)} samples, fewer than "
                f"batch_size={batch_size}: no full batch to train on. "
                f"Reduce batch_size or provide more data per process "
                f"(static shapes require full batches).")
        run = cbs.TrainingRun(params=self.model.state_dict(),
                              steps_per_epoch=steps)
        cb_list = [cbs.BroadcastGlobalVariablesCallback(0),
                   cbs.MetricAverageCallback()]
        cb_list += list(callbacks or [])
        if self.checkpoint_dir:
            from .checkpoint import CheckpointCallback
            cb_list.append(CheckpointCallback(self.checkpoint_dir))
        cl = cbs.CallbackList(cb_list, run)

        sentry = None
        if _config.live_config().get(_config.SDC_GUARD):
            manager = None
            for cb in cb_list:
                if hasattr(cb, "manager"):       # CheckpointCallback
                    manager = cb.manager
                    break
            sentry = _SdcSentry(manager)

        history = History()
        cl.on_train_begin()
        logs: Dict[str, float] = {}
        for epoch in range(epochs):
            cl.on_epoch_begin(epoch)
            logs = {}
            feed = hdata.prefetch_to_device(
                hdata.batches((x, y), batch_size, seed=self.seed + epoch),
                device=self.device)
            try:
                for batch, (bx, by) in enumerate(feed):
                    cl.on_batch_begin(batch)
                    if sentry is None:
                        self._opt.zero_grad(set_to_none=True)
                        loss = self.loss_fn(self.model(bx), by)
                        loss.backward()
                        self._opt.step()
                        logs = {"loss": loss.item()}
                    else:
                        logs = self._guarded_step(run, bx, by, sentry)
                    cl.on_batch_end(batch, logs)
            finally:
                feed.close()
            if self.metrics:
                with torch.no_grad():
                    outputs = self.model(self._to_device(x))
                    targets = self._to_device(y)
                    for mname, mfn in self.metrics.items():
                        logs[mname] = float(mfn(outputs, targets))
            if validation_data is not None:
                vx, vy = validation_data
                logs["val_loss"] = float(self._eval_loss(vx, vy))
            cl.on_epoch_end(epoch, logs)
            if sentry is not None and "checkpoint_step" in logs:
                # the save is only a rollback candidate: it becomes
                # last-good after HVD_TPU_SDC_CONFIRM_STEPS clean steps
                sentry.policy.on_saved(logs["checkpoint_step"])
            history.append(logs)
            if verbose and basics.rank() == 0:
                print(f"epoch {epoch}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in logs.items()))
        cl.on_train_end(logs if epochs > 0 else None)  # drains async saves
        self.params = run.params
        return history

    # -- SDC defense ---------------------------------------------------------
    def _guarded_step(self, run, bx, by, sentry) -> Dict[str, float]:
        """One training step under the SDC guard. The local gradients are
        held (see the module docstring) while the drill site and the
        guard run; a tripped guard drops them and retries the batch ONCE
        (a one-shot corruption recomputes clean, keeping the run
        bit-identical to an uncorrupted one); a second trip drops the
        batch. Fingerprint divergence or a repeat pattern escalates to a
        rollback to last-good."""
        sdc = sentry.sdc
        loss_value = float("nan")
        for attempt in (0, 1):
            self._opt.zero_grad(set_to_none=True)
            self._opt.hold_gradients()
            loss = self.loss_fn(self.model(bx), by)
            loss.backward()
            grads = self._leaf_grads()
            corrupted = sdc.corrupt_grads(grads)  # worker.grads drill site
            if corrupted is not grads:
                with torch.no_grad():
                    for g, c in zip(grads, corrupted):
                        if c is not g:
                            g.copy_(c)
            det = sentry.guard.check(grads, loss)
            loss_value = sentry.guard.last_loss
            if det is None:
                self._opt.release_gradients()
                self._opt.step()
                sentry.step += 1
                promoted = sentry.policy.on_clean_step()
                if promoted is not None and sentry.manager is not None:
                    sentry.manager.promote_last_good(promoted)
                fdet = sentry.monitor.maybe_check(
                    sentry.step, self._fingerprint_leaves())
                if fdet is not None and \
                        sentry.policy.on_detection(fdet) == sdc.ROLLBACK:
                    self._sdc_rollback(run, sentry)
                return {"loss": sentry.safe_loss(loss_value)}
            self._opt.abandon_step()
            if sentry.policy.on_detection(det) == sdc.ROLLBACK:
                self._sdc_rollback(run, sentry)
                return {"loss": sentry.safe_loss(loss_value)}
        sentry.dropped += 1
        log.warning("sdc: batch dropped — the guard tripped on the "
                    "retry too (persistent corruption on this input)")
        return {"loss": sentry.safe_loss(loss_value)}

    def _fingerprint_leaves(self) -> List[torch.Tensor]:
        named = dict(self.model.named_parameters())
        return [named[n].detach() for n in self._leaf_names]

    def _sdc_rollback(self, run, sentry) -> None:
        """Restore the parameters from the last-good checkpoint and reset
        the optimizer state (it postdates them). Without a promoted
        last-good target the poisoned update is skipped instead."""
        mgr = sentry.manager
        if mgr is None or mgr.last_good_step is None:
            log.warning("sdc: rollback requested but no last-good "
                        "checkpoint promoted yet; skipping the poisoned "
                        "update instead")
            return
        mgr.wait_until_finished()
        restored = mgr.restore_last_good(target=run.params)
        self.model.load_state_dict(restored)
        self._opt.state.clear()
        self.params = run.params
        sentry.policy.on_rollback()
        sentry.rollbacks += 1
        log.warning("sdc: rolled back to last-good step %d",
                    mgr.last_good_step)

    def _eval_loss(self, x, y) -> torch.Tensor:
        with torch.no_grad():
            return self.loss_fn(self.model(self._to_device(x)),
                                self._to_device(y))

    def evaluate(self, x, y) -> Dict[str, float]:
        """Loss + metrics on (x, y), averaged across processes."""
        from . import basics
        from . import collectives as _c
        if self.params is None:
            raise RuntimeError("call fit() before evaluate()")
        out: Dict[str, float] = {"loss": float(self._eval_loss(x, y))}
        with torch.no_grad():
            preds = self.model(self._to_device(x))
            for mname, mfn in self.metrics.items():
                out[mname] = float(mfn(preds, self._to_device(y)))
        if basics.is_initialized() and basics.size() > 1:
            for k in sorted(out):
                out[k] = float(_c.allreduce(
                    torch.tensor(out[k], dtype=torch.float64),
                    name=f"estimator.eval.{k}"))
        return out

    def predict(self, x) -> torch.Tensor:
        """Forward pass on ``x`` (leading dim = batch), returned unpadded.

        Inputs are zero-padded to power-of-two buckets
        (:class:`horovod_tpu_torch.serving.batcher.BucketedForward`), so
        repeated predicts of varying sizes run at a handful of shapes.
        The returned rows are the live rows of the forward at the padded
        shape (the model must be row-wise)."""
        if self.params is None:
            raise RuntimeError("call fit() before predict()")
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        if x.ndim < 2:
            # a single unbatched sample: no leading batch dim to bucket
            with torch.no_grad():
                return self.model(self._to_device(x))
        if self._predict_cache is None:
            from .serving.batcher import BucketedForward
            self._predict_cache = BucketedForward(self.model,
                                                  device=self.device)
        return self._predict_cache.apply_padded(x)

    # -- persistence ---------------------------------------------------------
    def save(self, directory: str, step: int = 0):
        from . import checkpoint as ckpt
        return ckpt.save(directory, step, self.params, force=True)

    def load(self, directory: str, step: Optional[int] = None):
        from . import checkpoint as ckpt
        restored = ckpt.restore(directory, step=step)
        self.model.load_state_dict(restored)
        self.params = self.model.state_dict()
        return self
