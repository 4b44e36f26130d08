"""The inference engine: params lifecycle and the batched forward
(counterpart of ``horovod_tpu/serving/engine.py``).

* :class:`ParamsLifecycle`: the checkpoint side of serving. Params come
  from the port's :class:`~horovod_tpu_torch.checkpointing.CheckpointManager`
  (which also reads the JAX package's checkpoints), as a flat dict of
  tensors by dotted name placed on ``device`` (the card unless asked
  otherwise). **Zero-downtime hot-reload**: a background thread polls
  ``latest_step()`` every ``HVD_TPU_SERVING_RELOAD_POLL_SECONDS``; a newer
  committed step is restored and copied to the device in the background,
  every host-to-device copy finished, and only then is the params
  reference swapped, so a forward never reads half-copied params. A
  reload that fails (corrupt step, injected ``serving.reload`` fault,
  crash mid-restore) leaves the old params serving and retries on the
  next poll.
* :class:`InferenceEngine`: a :class:`ParamsLifecycle` glued to dynamic
  micro-batching: requests flow through a
  :class:`~horovod_tpu_torch.serving.batcher.MicroBatcher` into a
  :class:`~horovod_tpu_torch.serving.batcher.BucketedForward` (static
  shape buckets, optional warmup), whose forward runs
  ``apply_fn(params, x)`` under ``torch.inference_mode()`` on the
  batcher's thread. The forward snapshots the (params, step) pair once per
  micro-batch, so every request is answered entirely by one checkpoint.

``apply_fn(params, x)`` takes the params as that flat dict; for an
``nn.Module`` it is ``torch.func.functional_call(model, params, (x,))``.
``sharding=`` keeps the JAX package's place in the signatures and takes
what the port's restore takes (None).

Fault sites: ``serving.forward`` (each micro-batch forward) and
``serving.reload`` (each hot-reload attempt; ``crash`` kills the reloader
mid-swap and the engine keeps serving the old params).
"""

import logging
import threading
import time
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _locks
from .. import config as _config
from .. import faults as _faults
from .. import metrics as _metrics
from ..basics import resolve_device
from ..models.convert import flatten
from .batcher import BucketedForward, MicroBatcher, parse_buckets

log = logging.getLogger("horovod_tpu_torch.serving")

_M_HOT_SWAPS = _metrics.counter(
    "hvd_tpu_serving_hot_swaps_total",
    "Checkpoint hot-reloads completed, by serving plane (inference / "
    "generation): a newer committed step was restored in the "
    "background and atomically swapped into serving without dropping "
    "in-flight requests.",
    labels=("plane",))
_M_STEP = _metrics.gauge(
    "hvd_tpu_serving_checkpoint_step",
    "Checkpoint step currently serving, by serving plane (inference / "
    "generation — one front-end can run both, each with its own "
    "params lifecycle; -1 = params were supplied directly, not "
    "restored from a checkpoint directory).",
    labels=("plane",))

_FP_FORWARD = _faults.FaultPoint("serving.forward")
_FP_RELOAD = _faults.FaultPoint("serving.reload", exc=OSError)


class ReloadCrashed(RuntimeError):
    """An injected ``serving.reload:crash`` fault killed the reloader
    component mid-reload. The swap never happened; the previous params
    keep serving (the hot-reload drill's assertion)."""


def _reload_crash() -> None:
    raise ReloadCrashed(
        "serving hot-reload killed mid-swap (injected crash)")


def _place(tree, device: torch.device) -> dict:
    """``tree``'s arrays (a mapping, nested or flat) as a flat dict of
    tensors by dotted name on ``device``, every host-to-device copy
    finished when this returns."""
    if not isinstance(tree, Mapping):
        raise TypeError(f"serving params must be a mapping of arrays by "
                        f"name, got {type(tree).__name__}")
    params = {}
    for name, leaf in flatten(tree).items():
        t = leaf if isinstance(leaf, torch.Tensor) \
            else torch.as_tensor(np.asarray(leaf))
        params[name] = t.detach().to(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return params


class ParamsLifecycle:
    """Restore-then-hot-reload params management, engine-agnostic.

    Exactly one of ``params`` (serve directly, no checkpoint lifecycle)
    or ``checkpoint_dir`` (restore latest committed step — or ``step`` —
    and hot-reload newer ones) is required. The params are held as a flat
    dict of tensors by dotted name, on ``device`` (the card unless asked
    otherwise). ``sharding`` takes what the port's restore takes (None).
    ``reload_poll_seconds`` defaults to the
    ``HVD_TPU_SERVING_RELOAD_POLL_SECONDS`` knob; 0 disables the poller
    (:meth:`reload` stays available). ``plane`` labels this lifecycle's
    metric series (one front-end can run an inference and a generation
    lifecycle side by side).

    The owning engine must call :meth:`start_poller` as the LAST step
    of its own construction: started any earlier, a failure later in
    the engine's ``__init__`` would leak a live poller (and the params
    it pins) with no handle left to stop it.
    """

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 params: Any = None, sharding=None,
                 step: Optional[int] = None,
                 reload_poll_seconds: Optional[float] = None,
                 plane: str = "inference", device="cuda"):
        if (params is None) == (checkpoint_dir is None):
            raise ValueError(
                "provide exactly one of params= or checkpoint_dir=")
        cfg = _config.live_config()
        self.checkpoint_dir = checkpoint_dir
        self.plane = plane
        self.device = resolve_device(device)
        self._sharding = sharding
        self._reload_poll = float(
            cfg.get(_config.SERVING_RELOAD_POLL_SECONDS)
            if reload_poll_seconds is None else reload_poll_seconds)
        self._params_lock = _locks.lock(
            "serving.ParamsLifecycle._params_lock")
        self._reload_lock = _locks.lock(
            "serving.ParamsLifecycle._reload_lock")
        self._stop = threading.Event()
        self._poller: Optional[threading.Thread] = None
        self._manager = None
        if checkpoint_dir is not None:
            from ..checkpointing import CheckpointManager
            self._manager = CheckpointManager(checkpoint_dir)
            if step is None:
                step = self._manager.latest_step()
                if step is None:
                    raise FileNotFoundError(
                        f"no committed checkpoints under {checkpoint_dir!r}")
            params = self._manager.restore(step=step, sharding=sharding)
            self.step = int(step)
        else:
            if sharding is not None:
                raise ValueError(
                    f"sharding={sharding!r}: the serving params are placed "
                    f"whole on device=")
            self.step = -1
        self._params = _place(params, self.device)
        #: the last hot reload's phases in seconds: the restore from disk
        #: (read and checksum), the copy to the device, the swap
        self.last_reload_seconds = None
        _M_STEP.labels(plane=self.plane).set(self.step)

    def start_poller(self) -> None:
        """Start the background hot-reload poller (idempotent; a no-op
        without a checkpoint dir or with polling disabled). Call only
        once the owning engine is fully constructed."""
        if self._manager is not None and self._reload_poll > 0 \
                and self._poller is None:
            self._poller = threading.Thread(
                target=self._poll_loop, name="hvd-tpu-serving-reload",
                daemon=True)
            self._poller.start()

    def snapshot(self) -> Tuple[Any, int]:
        """The (params, step) pair, read under one lock — a concurrent
        hot-swap can never hand a caller params from one checkpoint
        labeled with another's step."""
        with self._params_lock:
            return self._params, self.step

    @property
    def params(self):
        with self._params_lock:
            return self._params

    def reload(self, step: Optional[int] = None) -> bool:
        """Load ``step`` (default: latest committed) and atomically swap
        it into serving. Returns True when a swap happened. Everything
        expensive (disk read, checksum verify, device_put) runs before
        the swap, outside the params lock, and every host-to-device copy
        has finished before it; the swap itself is one reference
        assignment. Exceptions propagate — the poll loop (and
        any caller that wants old-params-keep-serving semantics) catches
        them."""
        if self._manager is None:
            raise RuntimeError("no checkpoint_dir: nothing to reload from")
        with self._reload_lock:     # one reload at a time
            if step is None:
                step = self._manager.latest_step()
            if step is None or int(step) == self.step:
                return False
            _FP_RELOAD.fire(crash=_reload_crash)
            t0 = time.perf_counter()
            tree = self._manager.restore(step=int(step),
                                         sharding=self._sharding)
            t1 = time.perf_counter()
            fresh = _place(tree, self.device)
            t2 = time.perf_counter()
            with self._params_lock:
                self._params = fresh
                self.step = int(step)
            self.last_reload_seconds = {
                "restore": t1 - t0, "copy": t2 - t1,
                "swap": time.perf_counter() - t2}
            _M_STEP.labels(plane=self.plane).set(self.step)
            _M_HOT_SWAPS.labels(plane=self.plane).inc()
            log.info("serving: hot-swapped checkpoint step %d from %s",
                     self.step, self.checkpoint_dir)
            return True

    def _poll_loop(self) -> None:
        while not self._stop.wait(self._reload_poll):
            try:
                self.reload()
            except Exception:   # noqa: BLE001 — old params keep serving
                log.warning(
                    "serving: hot-reload failed; previous step %d keeps "
                    "serving (will retry in %.1fs)", self.step,
                    self._reload_poll, exc_info=True)

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent: stop the reload poller."""
        self._stop.set()
        poller, self._poller = self._poller, None
        if poller is not None:
            poller.join(timeout=timeout)


class InferenceEngine:
    """Serve ``apply_fn(params, x)`` with micro-batching and hot-reload.

    Args:
      apply_fn: the forward ``apply_fn(params, x)``, ``params`` the flat
        dict of tensors, ``x`` the padded batch on ``device`` (e.g.
        ``torch.func.functional_call(model, params, (x,))``); must be
        row-wise (padding rows must not perturb live rows' outputs).
      checkpoint_dir: restore params from here (latest committed step by
        default) and hot-reload newer steps as training commits them.
      params: serve these params directly (no checkpoint lifecycle);
        exactly one of ``params`` / ``checkpoint_dir`` is required.
      sharding: what the port's restore takes (None).
      example: one input row (no batch dim) — enables bucket warmup at
        start when ``HVD_TPU_SERVING_WARMUP`` is on, so no live request
        pays a first call's costs.
      device: where the params live and the forward runs (default the
        card).

    Knob-backed arguments (``max_batch``, ``batch_timeout_ms``,
    ``buckets``, ``queue_depth``, ``deadline_ms``,
    ``reload_poll_seconds``, ``warmup``) default to their registered
    serving knobs (docs/configuration.md).
    """

    def __init__(self, apply_fn: Callable, checkpoint_dir: Optional[str] = None,
                 params: Any = None, sharding=None, step: Optional[int] = None,
                 example: Optional[np.ndarray] = None,
                 max_batch: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 reload_poll_seconds: Optional[float] = None,
                 warmup: Optional[bool] = None, device="cuda"):
        cfg = _config.live_config()
        self._lifecycle = ParamsLifecycle(
            checkpoint_dir=checkpoint_dir, params=params, sharding=sharding,
            step=step, reload_poll_seconds=reload_poll_seconds,
            device=device)
        self._warmup = bool(cfg.get(_config.SERVING_WARMUP)
                            if warmup is None else warmup)
        self._example = None if example is None else np.asarray(example)

        resolved_max = int(cfg.get(_config.SERVING_MAX_BATCH)
                           if max_batch is None else max_batch)
        bucket_list = tuple(buckets) if buckets else parse_buckets(
            cfg.get(_config.SERVING_BUCKETS), resolved_max)
        self._bucketed = BucketedForward(apply_fn, buckets=bucket_list,
                                         device=self._lifecycle.device)
        self._batcher = MicroBatcher(
            self._forward, max_batch=resolved_max,
            timeout_ms=batch_timeout_ms, buckets=bucket_list,
            queue_depth=queue_depth, default_deadline_ms=deadline_ms,
            row_shape=None if self._example is None
            else self._example.shape)
        if self._warmup and self._example is not None:
            with torch.inference_mode():
                self._bucketed.warmup(self._example.shape,
                                      dtype=self._example.dtype,
                                      args=(self._lifecycle.params,))
        self._lifecycle.start_poller()    # last: nothing can fail past here

    # -- serving -------------------------------------------------------------

    def _forward(self, x_padded, n_valid: int):
        """One micro-batch forward. The (params, step) pair is read under
        one lock, so a concurrent hot-swap can never split this batch
        across two checkpoints — and the step returned as batch metadata
        is the one that actually produced the outputs."""
        _FP_FORWARD.fire()
        params, step = self._lifecycle.snapshot()
        with torch.inference_mode():
            return self._bucketed(params, x_padded), step

    def infer(self, x, deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None):
        """Synchronous inference: rows in, rows out (unpadded). Raises
        :class:`~horovod_tpu_torch.serving.batcher.QueueFullError` /
        :class:`~horovod_tpu_torch.serving.batcher.DeadlineExceededError`
        under overload — callers (the HTTP front-end) map them to
        503/429."""
        return self._batcher.infer(x, deadline_ms=deadline_ms,
                                   timeout=timeout)

    def infer_with_step(self, x, deadline_ms: Optional[float] = None,
                        timeout: Optional[float] = None):
        """:meth:`infer` plus the checkpoint step whose params produced
        the outputs (NOT necessarily ``self.step``, which a hot-swap may
        have already moved past by the time the caller reads it)."""
        req = self._batcher.submit(x, deadline_ms=deadline_ms)
        out, step = self._batcher.result_with_meta(req, timeout=timeout)
        return out, (self.step if step is None else step)

    @property
    def checkpoint_dir(self):
        return self._lifecycle.checkpoint_dir

    @property
    def step(self) -> int:
        return self._lifecycle.step

    @property
    def params(self):
        return self._lifecycle.params

    @property
    def device(self) -> torch.device:
        return self._lifecycle.device

    @property
    def queue_depth(self) -> int:
        return self._batcher.queue_depth

    @property
    def batcher(self) -> MicroBatcher:
        return self._batcher

    # -- hot-reload ----------------------------------------------------------

    def reload(self, step: Optional[int] = None) -> bool:
        """Force a hot-reload now; see :meth:`ParamsLifecycle.reload`."""
        return self._lifecycle.reload(step=step)

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent: stop the reload poller and the batcher thread."""
        self._lifecycle.close(timeout=timeout)
        self._batcher.stop(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def wait_for_step(directory: str, min_step: int = 0,
                  timeout: float = 60.0) -> int:
    """Serving-side startup helper: block until ``directory`` holds a
    committed step >= ``min_step`` (training may still be warming up)."""
    from ..checkpointing import latest_step
    deadline = time.monotonic() + timeout
    while True:
        step = latest_step(directory)
        if step is not None and step >= min_step:
            return step
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"no committed checkpoint step >= {min_step} under "
                f"{directory!r} within {timeout}s")
        time.sleep(0.2)
