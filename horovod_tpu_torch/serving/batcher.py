"""Dynamic micro-batching and static shape buckets for inference
(counterpart of ``horovod_tpu/serving/batcher.py``).

* :class:`MicroBatcher`: a **bounded** request queue (admission control:
  a full queue rejects at once instead of growing a backlog every queued
  request would time out in) drained by a batcher thread that opens a
  micro-batch on the first request and holds it up to
  ``HVD_TPU_SERVING_BATCH_TIMEOUT_MS`` or ``HVD_TPU_SERVING_MAX_BATCH``
  rows, whichever comes first. The batch is zero-padded to the smallest
  bucket that holds it, the forward runs (on the card for the engine),
  and only the live rows are copied back to the host and sliced back per
  request.
* static **shape buckets**: :func:`parse_buckets`, :func:`bucket_for` and
  :func:`next_pow2` are the JAX package's, copied. A handful of shapes
  serve every size: the JAX package's compiled-program cache, and here
  the shapes a CUDA graph or cuBLAS's per-shape choices are made for.
* :class:`BucketedForward` pads to the bucket, runs the forward under
  ``torch.no_grad()`` and records the buckets it has run
  (``compiled_buckets``); :meth:`~BucketedForward.warmup` runs each bucket
  once. It is the engine's forward and the one behind
  ``Estimator.predict``.

Per-request **deadlines** are enforced at admission and again when the
batcher pops the request: an expired request is answered with
:class:`DeadlineExceededError` (HTTP 429 at the front-end) without
touching the device. Metrics, the ``serving.admit`` and ``serving.batch``
fault sites, and the ``batch.queue`` and ``batch.forward`` spans are the
JAX package's.
"""

import queue
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _locks
from .. import config as _config
from .. import data as _data
from .. import faults as _faults
from .. import metrics as _metrics
from .. import tracing as _tracing

_M_QUEUE_DEPTH = _metrics.gauge(
    "hvd_tpu_serving_queue_depth",
    "Inference requests admitted but not yet dispatched in a "
    "micro-batch. Bounded by HVD_TPU_SERVING_QUEUE_DEPTH; pinning at "
    "the bound means overload (new requests are being 503'd).")
_M_BATCH_SIZE = _metrics.histogram(
    "hvd_tpu_serving_batch_size",
    "Rows per dispatched serving micro-batch (pre-padding). Mass above "
    "1 is the coalescing win; mass at HVD_TPU_SERVING_MAX_BATCH means "
    "the batcher is saturated and the knob may be raised.",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
_M_LATENCY = _metrics.histogram(
    "hvd_tpu_serving_latency_seconds",
    "Serving latency by phase: 'queue' is admission to micro-batch "
    "dispatch (the coalescing wait), 'forward' is the padded forward "
    "pass including any first-hit bucket compile.",
    labels=("phase",))
_M_REJECTED = _metrics.counter(
    "hvd_tpu_serving_rejected_total",
    "Requests rejected by admission control, by reason: 'queue_full' "
    "(bounded queue at capacity, HTTP 503) or 'deadline' (per-request "
    "deadline expired before dispatch, HTTP 429).",
    labels=("reason",))
_M_DEADLINE_STAGE = _metrics.counter(
    "hvd_tpu_serving_deadline_stage_total",
    "Requests shed because their end-to-end budget (X-HVD-TPU-Deadline-"
    "Ms) died, by the pipeline stage that noticed: 'route' (router "
    "proxy, budget gone before any replica was touched), 'queue' "
    "(fair-queue / micro-batch / prefill-admission wait), 'transfer' "
    "(the disagg prefill->decode KV hop: budget spent before or "
    "during /v1/kv/offer), 'prefill' (mid-prefill, before the next "
    "chunk ran), 'decode' (between generated tokens). The same stage "
    "is returned to the client in the X-HVD-TPU-Deadline-Exceeded "
    "response header.",
    labels=("stage",))

#: end-to-end budget header: remaining milliseconds, minted at the
#: fleet router and re-stamped (decremented) on every forwarded hop
DEADLINE_HEADER = "X-HVD-TPU-Deadline-Ms"
#: stamped on 429 responses: the pipeline stage where the budget died
#: (route | queue | transfer | prefill | decode)
DEADLINE_STAGE_HEADER = "X-HVD-TPU-Deadline-Exceeded"


class RejectedError(RuntimeError):
    """Base for admission-control rejections (fast backpressure, not
    failure — the client should back off and retry)."""


class QueueFullError(RejectedError):
    """The bounded request queue is at HVD_TPU_SERVING_QUEUE_DEPTH
    (HTTP 503 at the front-end)."""


class DeadlineExceededError(RejectedError):
    """The request's deadline expired (HTTP 429 at the front-end).
    ``stage`` names the pipeline stage that noticed the dead budget
    (route | queue | transfer | prefill | decode) for the
    X-HVD-TPU-Deadline-Exceeded response header; shedding sites that
    know their stage count it in
    ``hvd_tpu_serving_deadline_stage_total``."""

    def __init__(self, message: str, stage: Optional[str] = None):
        super().__init__(message)
        self.stage = stage
        if stage is not None:
            _M_DEADLINE_STAGE.labels(stage=stage).inc()


#: an injected ``serving.admit`` error looks like what it simulates —
#: an admission rejection (503 at the front-end), not a forward failure
_FP_ADMIT = _faults.FaultPoint("serving.admit", exc=QueueFullError)
_FP_BATCH = _faults.FaultPoint("serving.batch")


def parse_buckets(spec: str, max_batch: int) -> Tuple[int, ...]:
    """Bucket sizes from HVD_TPU_SERVING_BUCKETS (comma-separated rows),
    or powers of two up to ``max_batch`` when empty. ``max_batch`` is
    always a bucket: every admissible batch must have a home."""
    if spec and spec.strip():
        try:
            buckets = sorted({int(b) for b in spec.split(",") if b.strip()})
        except ValueError as e:
            raise ValueError(
                f"HVD_TPU_SERVING_BUCKETS={spec!r}: want comma-separated "
                f"integers") from e
        if not buckets or buckets[0] < 1:
            raise ValueError(
                f"HVD_TPU_SERVING_BUCKETS={spec!r}: buckets must be >= 1")
        if buckets[-1] > max_batch:
            raise ValueError(
                f"HVD_TPU_SERVING_BUCKETS={spec!r}: bucket "
                f"{buckets[-1]} exceeds HVD_TPU_SERVING_MAX_BATCH="
                f"{max_batch}; raise the max or drop the bucket")
    else:
        buckets, b = [], 1
        while b < max_batch:
            buckets.append(b)
            b *= 2
    if max_batch not in buckets:
        buckets.append(max_batch)
    return tuple(sorted(buckets))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding ``n`` rows."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} rows exceed the largest bucket {buckets[-1]}")


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class BucketedForward:
    """A forward ``fn(x)`` (or ``fn(params, x)``) run at bucket shapes.

    ``buckets=None`` is open-ended powers of two (the ``Estimator.predict``
    mode). ``device`` is where padded inputs go (the model's device).
    ``compiled_buckets`` records the bucket shapes this instance has run.
    """

    def __init__(self, fn: Callable, buckets: Optional[Sequence[int]] = None,
                 device=None):
        self._fn = fn
        self._buckets = tuple(sorted(buckets)) if buckets else None
        self._device = torch.device(device) if device is not None else None
        self._lock = _locks.lock("serving.BucketedForward._lock")
        self.compiled_buckets: set = set()

    def bucket(self, n: int) -> int:
        if self._buckets is not None:
            return bucket_for(n, self._buckets)
        return next_pow2(n)

    def __call__(self, *args) -> torch.Tensor:
        """Apply to an already-padded ``x`` (the last argument, leading
        dim = some bucket); leading arguments (the engine's params) pass
        through: ``fn(*args[:-1], x)``."""
        *lead, x = args
        x = torch.as_tensor(x)
        if self._device is not None:
            x = x.to(self._device)
        with self._lock:
            self.compiled_buckets.add(int(x.shape[0]))
        with torch.no_grad():
            return self._fn(*lead, x)

    def apply_padded(self, x) -> torch.Tensor:
        """Pad ``x`` to its bucket, apply, return the live rows only."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        n = len(x)
        padded, _mask = _data.pad_to_size(x, self.bucket(n))
        return self(padded)[:n]

    def warmup(self, row_shape: Sequence[int], dtype=np.float32,
               buckets: Optional[Sequence[int]] = None,
               args: Sequence = ()) -> None:
        """Run every bucket once with zero inputs, so no live request
        pays a first call's costs. ``row_shape`` is one row (no batch
        dim); ``args`` are the leading arguments of ``__call__``."""
        for b in (buckets or self._buckets or ()):
            self(*args, np.zeros((b, *row_shape), dtype=dtype))


class _Request:
    """One admitted inference request: ``n`` rows in flight, an event the
    caller waits on, and exactly one of result/error set by the batcher
    (plus the forward's metadata, e.g. the checkpoint step that produced
    the result)."""

    __slots__ = ("x", "n", "deadline", "enqueued_at", "event", "result",
                 "error", "meta", "trace")

    def __init__(self, x: np.ndarray, deadline: float):
        self.x = x
        self.n = len(x)
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.meta = None
        # the submitting thread's trace context (None unless the request
        # is sampled): the batcher thread emits this request's queue-wait
        # and forward spans under it
        self.trace = _tracing.current()


_STOP = object()


class MicroBatcher:
    """The request-to-batch loop: bounded queue in, padded micro-batches
    out through ``forward(x_padded, n_valid)``.

    ``forward`` receives a bucket-shaped numpy array whose first
    ``n_valid`` rows are live (the rest zero padding) and returns outputs
    with the same leading dim (a tensor, on the card or the host, or an
    array), of which only the live rows are copied to the host — or an
    ``(outputs, meta)`` pair, where ``meta`` is
    attached to every request of the batch (the engine threads the
    producing checkpoint step through it). The batcher slices results
    back per request. The engine supplies a forward that snapshots the
    live params once per batch, so a hot-reload can never split one
    micro-batch across two checkpoints.

    ``row_shape``: expected trailing shape of one request row; when None
    it is learned from the first admitted request. Mismatching requests
    are rejected at admission (their own ``ValueError``) instead of
    poisoning the micro-batch they would have been coalesced into.
    """

    def __init__(self, forward: Callable, max_batch: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None,
                 queue_depth: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 row_shape: Optional[Sequence[int]] = None):
        cfg = _config.live_config()
        self._forward = forward
        self._row_shape = tuple(row_shape) if row_shape is not None else None
        self.max_batch = int(cfg.get(_config.SERVING_MAX_BATCH)
                             if max_batch is None else max_batch)
        self.timeout_s = float(cfg.get(_config.SERVING_BATCH_TIMEOUT_MS)
                               if timeout_ms is None else timeout_ms) / 1e3
        self.buckets = tuple(buckets) if buckets else parse_buckets(
            cfg.get(_config.SERVING_BUCKETS), self.max_batch)
        depth = int(cfg.get(_config.SERVING_QUEUE_DEPTH)
                    if queue_depth is None else queue_depth)
        self.default_deadline_s = float(
            cfg.get(_config.SERVING_DEADLINE_MS)
            if default_deadline_ms is None else default_deadline_ms) / 1e3
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._carry: Optional[_Request] = None
        self._lock = _locks.lock("serving.MicroBatcher._lock")
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    # -- admission -----------------------------------------------------------

    def submit(self, x, deadline_ms: Optional[float] = None) -> _Request:
        """Admit one request (``x``: rows to infer, leading batch dim).
        Raises :class:`QueueFullError` on a full queue — immediately, so
        overload is fast backpressure — and ``ValueError`` when the
        request alone exceeds the largest bucket."""
        _FP_ADMIT.fire()
        x = np.asarray(x)
        if x.ndim < 1 or len(x) < 1:
            raise ValueError("request needs at least one row")
        if len(x) > self.max_batch:
            raise ValueError(
                f"request has {len(x)} rows, more than "
                f"HVD_TPU_SERVING_MAX_BATCH={self.max_batch}")
        row_shape = tuple(x.shape[1:])
        with self._lock:
            if self._row_shape is None:
                self._row_shape = row_shape     # learned from first request
            elif row_shape != self._row_shape:
                # reject HERE: coalesced into a batch, the mismatch would
                # fail every innocent request sharing the micro-batch
                raise ValueError(
                    f"request row shape {row_shape} does not match the "
                    f"serving row shape {self._row_shape}")
        ddl_s = (self.default_deadline_s if deadline_ms is None
                 else float(deadline_ms) / 1e3)
        if deadline_ms is not None and ddl_s < 0:
            # an explicitly negative per-request budget is already spent
            # (a client's remaining = total - elapsed went negative):
            # shed it NOW — only 0/unset means "no deadline"
            _M_REJECTED.labels(reason="deadline").inc()
            raise DeadlineExceededError(
                f"request deadline_ms={deadline_ms} is negative: "
                f"budget already spent before admission", stage="queue")
        deadline = time.monotonic() + ddl_s if ddl_s > 0 else float("inf")
        req = _Request(x, deadline)
        self._ensure_thread()
        try:
            self._q.put_nowait(req)
        except queue.Full:
            _M_REJECTED.labels(reason="queue_full").inc()
            raise QueueFullError(
                f"serving queue at capacity ({self._q.maxsize}); "
                f"back off and retry") from None
        _M_QUEUE_DEPTH.set(self._q.qsize())
        if self._stopped:
            # stop() raced this submit past its drain; fail the request
            # rather than leaving its caller waiting on a dead loop
            self._drain_failed(RuntimeError("serving batcher stopped"))
        return req

    def result(self, req: _Request, timeout: Optional[float] = None):
        """Block until ``req``'s micro-batch completed; return this
        request's (unpadded) output rows or raise its error."""
        if not req.event.wait(timeout):
            raise TimeoutError("inference result not ready in time")
        if req.error is not None:
            raise req.error
        return req.result

    def result_with_meta(self, req: _Request,
                         timeout: Optional[float] = None):
        """Like :meth:`result`, plus the forward's metadata for the
        micro-batch that served this request (None when the forward
        returned no metadata)."""
        return self.result(req, timeout), req.meta

    def infer(self, x, deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None):
        """submit + result in one call (the engine's synchronous path)."""
        return self.result(self.submit(x, deadline_ms), timeout)

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    # -- the batching loop ---------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._stopped:
                raise RuntimeError("MicroBatcher is stopped")
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="hvd-tpu-serving-batcher",
                    daemon=True)
                self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        """Idempotent: stop the batcher thread; queued requests are
        failed (the owner is shutting down, not the fabric). Never
        blocks on a full queue — with the batcher wedged in a hung
        forward at capacity, a blocking sentinel put would hang every
        ``close()`` path forever."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            thread, self._thread = self._thread, None
        err = RuntimeError("serving batcher stopped")
        while True:
            try:
                self._q.put_nowait(_STOP)
                break
            except queue.Full:
                # make room by failing a queued request — stop() fails
                # them all anyway; shutdown must not wait for capacity
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    continue
                if item is not _STOP:
                    item.error = err
                    item.event.set()
        if thread is not None:
            thread.join(timeout=timeout)
        self._drain_failed(err)

    def _drain_failed(self, err: BaseException) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                item.error = err
                item.event.set()
        _M_QUEUE_DEPTH.set(0)

    def _pop(self, timeout: Optional[float]):
        """Next request: the carry-over left by the previous batch first,
        then the queue. Returns _STOP/None/​_Request."""
        if self._carry is not None:
            req, self._carry = self._carry, None
            return req
        try:
            req = self._q.get(timeout=timeout) if timeout is not None \
                else self._q.get()
        except queue.Empty:
            return None
        _M_QUEUE_DEPTH.set(self._q.qsize())
        return req

    def _expired(self, req: _Request, now: float) -> bool:
        if now <= req.deadline:
            return False
        _M_REJECTED.labels(reason="deadline").inc()
        req.error = DeadlineExceededError(
            f"deadline expired {now - req.deadline:.3f}s before dispatch",
            stage="queue")
        req.event.set()
        return True

    def _loop(self) -> None:
        stop_err = RuntimeError("serving batcher stopped")
        while True:
            req = self._pop(timeout=None)      # idle: block for work
            if req is _STOP:
                return
            if self._stopped:
                # stop() raced this pop: it set _stopped and is draining
                # the queue, but this request was already in our hands —
                # fail it here, or its waiter would hang on a micro-batch
                # that will never dispatch
                self._fail([req], stop_err)
                continue
            if self._expired(req, time.monotonic()):
                continue
            batch = [req]
            rows = req.n
            window = time.monotonic() + self.timeout_s
            while rows < self.max_batch:
                remaining = window - time.monotonic()
                if remaining <= 0:
                    break
                nxt = self._pop(timeout=remaining)
                if nxt is _STOP:
                    self._fail(batch, RuntimeError(
                        "serving batcher stopped mid-batch"))
                    return
                if nxt is None:
                    break
                if self._stopped:
                    self._fail(batch + [nxt], stop_err)
                    return
                if self._expired(nxt, time.monotonic()):
                    continue
                if rows + nxt.n > self.max_batch:
                    self._carry = nxt     # opens the NEXT micro-batch
                    break
                batch.append(nxt)
                rows += nxt.n
            self._dispatch(batch, rows)

    def _fail(self, batch, err: BaseException) -> None:
        for r in batch:
            r.error = err
            r.event.set()

    def _dispatch(self, batch, rows: int) -> None:
        now = time.monotonic()
        for r in batch:
            # traced requests stamp their trace id as the histogram
            # exemplar, linking a latency outlier to its full timeline
            _M_LATENCY.labels(phase="queue").observe(
                now - r.enqueued_at,
                exemplar=r.trace.trace_id if r.trace is not None else None)
            if r.trace is not None:
                _tracing.emit_span(r.trace, "batch.queue", r.enqueued_at,
                                   now, args={"rows": r.n})
        _M_BATCH_SIZE.observe(rows)
        try:
            _FP_BATCH.fire()
            x = batch[0].x if len(batch) == 1 else np.concatenate(
                [r.x for r in batch], axis=0)
            padded, _mask = _data.pad_to_size(
                np.asarray(x), bucket_for(rows, self.buckets))
            t0 = time.monotonic()
            res = self._forward(padded, rows)
            out, meta = res if (isinstance(res, tuple) and len(res) == 2) \
                else (res, None)
            # the live rows only cross to the host: on the card this copy
            # is the micro-batch's one sync
            out = out[:rows]
            out = out.cpu().numpy() if isinstance(out, torch.Tensor) \
                else np.asarray(out)
            t1 = time.monotonic()
            traced = [r for r in batch if r.trace is not None]
            _M_LATENCY.labels(phase="forward").observe(
                t1 - t0,
                exemplar=traced[0].trace.trace_id if traced else None)
            for r in traced:
                # one forward span per traced request sharing the batch:
                # each request's timeline shows the whole fused forward
                _tracing.emit_span(r.trace, "batch.forward", t0, t1,
                                   args={"rows": rows,
                                         "batched_requests": len(batch)})
        except BaseException as e:  # noqa: BLE001 — surfaced per request
            if isinstance(e, ValueError):
                # a batch-time ValueError is a SERVER-side failure for
                # every request in the batch; keep it distinguishable
                # from an admission-time client error (the front-end
                # maps ValueError to 400)
                err = RuntimeError(f"serving micro-batch failed: {e}")
                err.__cause__ = e
                self._fail(batch, err)
            else:
                self._fail(batch, e)
            return
        lo = 0
        for r in batch:
            r.result = out[lo:lo + r.n]
            r.meta = meta
            lo += r.n
            r.event.set()


