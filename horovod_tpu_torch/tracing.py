"""Per-request distributed tracing for horovod_tpu_torch (a copy of
``horovod_tpu/tracing.py``; the span names, the span record, the sampling
hash and the header encoding are the JAX package's, so one merge tool
reads both packages' span files). Of the spans below, the port emits
``server.infer``, ``batch.queue``, ``batch.forward`` and the collective
spans; the router and generation spans come with those planes.

The chrome-tracing timeline (timeline.py) answers *what was this
process doing*; this module answers *where did this request's time go*
across every process it touched. A trace is keyed by the serving
request id (``X-HVD-TPU-Request-Id``) and is made of spans — one named
interval per layer the request crossed:

==========================  =================================================
span                        emitted by
==========================  =================================================
``router.route``            ``FleetRouter._proxy`` — root span on the router
``router.admission``        ``FairScheduler.acquire`` (fair-queue wait)
``server.infer`` /          replica HTTP handler; child of the router span
``server.generate``         via the ``X-HVD-TPU-Trace-Parent`` header
``batch.queue``             MicroBatcher admission -> dispatch coalescing wait
``batch.forward``           the padded micro-batch forward
``gen.prefill``             ContinuousBatcher, one span per prefill chunk
``gen.decode``              one span per decode step that emitted a token
``gen.preempt``             KV-block preemption (the recompute is the next
                            ``gen.prefill`` under the same trace)
``collective:<verb>:<name>``  eager collective submission, via the
                            ``collectives._record_round`` hook
==========================  =================================================

Each span records trace id, span id, parent span id, the owning rank,
an **epoch**-microsecond start timestamp (``time.time()`` — the one
clock comparable across hosts; durations are measured on the monotonic
clock) and free-form args. Spans collect per process in a bounded ring,
stream to a per-rank ``spans-rank<N>.jsonl`` file when
``HVD_TPU_TRACE_DIR`` is set (through timeline.py's bounded
``RecordWriter``, so a dead disk drops records into
``hvd_tpu_timeline_dropped_total`` instead of growing a queue), and
publish best-effort to the rendezvous ``trace`` KV scope for live
fleets. ``python -m tools.trace`` merges either source into one
cross-host chrome://tracing timeline for a request id.

Sampling is head-based and deterministic: ``HVD_TPU_TRACE_SAMPLE`` is
the traced fraction, and the decision is a hash of the request id (not
``hash()`` — PYTHONHASHSEED must not split the decision across hosts),
so the router and every replica rank independently agree on whether a
request is traced with zero coordination. The default 0 disables
tracing entirely; the hot-path cost is then one module-global load and
an is-None test per call site, the same discipline ``_schedule.record``
and the timeline's no-op guard follow.
"""

import collections
import hashlib
import json
import os
import threading
import time
import uuid
from typing import Optional

from . import _locks

__all__ = ["TraceContext", "Tracer", "Span", "tracer", "reset",
           "request_span", "span", "span_for", "emit_span", "collective",
           "current", "set_current", "sampled", "note_request",
           "last_request_id", "new_request_id", "TRACE_PARENT_HEADER",
           "ATTEMPT_HEADER", "KV_SCOPE"]

#: header carrying the upstream hop's encoded TraceContext so a
#: replica's server span nests under the router's proxy span
TRACE_PARENT_HEADER = "X-HVD-TPU-Trace-Parent"

#: attempt ordinal for a request's forwarded tries (0 = first send; a
#: hedge, connect-error failover, or mid-stream resume increments it).
#: The router keeps TRACE_PARENT_HEADER and the request id UNCHANGED
#: across re-submissions and stamps this instead, so every attempt's
#: spans land in the one trace, numbered, rather than minting
#: fresh-looking requests
ATTEMPT_HEADER = "X-HVD-TPU-Attempt"

#: rendezvous KV scope holding each rank's published span list
KV_SCOPE = "trace"

#: spans retained in the per-process ring (oldest evicted first); the
#: jsonl span file, when configured, keeps everything the writer's
#: bounded queue admitted
_BUFFER_DEPTH = 8192

_TRACER: Optional["Tracer"] = None
_RESOLVED = False
_RESOLVE_LOCK = threading.Lock()

_tls = threading.local()

#: last request id whose work touched this process — stamped into
#: StallError and preemption/deadline log lines regardless of the
#: sampling knob (failure attribution must not depend on tracing being
#: on). A bare global assignment: the one writer race (two concurrent
#: requests) just picks one of two truthful answers.
_LAST_REQUEST: Optional[str] = None


def note_request(request_id: Optional[str]) -> None:
    """Remember ``request_id`` as the most recent request this process
    worked for (see ``last_request_id``)."""
    global _LAST_REQUEST
    if request_id:
        _LAST_REQUEST = request_id


def last_request_id() -> Optional[str]:
    """The most recently noted request id, or None. Used by the stall
    inspector and the generation scheduler to say *whose* request was
    in flight when something went wrong."""
    return _LAST_REQUEST


def new_request_id() -> str:
    """A server-generated request id for clients that sent none —
    the same 16-hex shape the router mints."""
    return uuid.uuid4().hex[:16]


class TraceContext:
    """Identity of one request's trace as it crosses threads and
    hosts: the trace id plus the span the next child should nest
    under. ``encode``/``decode`` round-trip it through an HTTP header
    or a KV value."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def encode(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    @classmethod
    def decode(cls, raw) -> Optional["TraceContext"]:
        if not raw or not isinstance(raw, str) or ":" not in raw:
            return None
        trace_id, span_id = raw.split(":", 1)
        if not trace_id:
            return None
        return cls(trace_id, span_id)

    def __repr__(self):
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


def current() -> Optional[TraceContext]:
    """The calling thread's active trace context, or None."""
    return getattr(_tls, "ctx", None)


def set_current(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` as the thread's context; returns the previous
    one so callers can restore it."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


def sampled(trace_id: str, rate: float) -> bool:
    """The deterministic head-sampling decision for ``trace_id``: true
    for a ``rate`` fraction of ids, computed identically on every
    process from a sha1 of the id."""
    if rate <= 0.0 or not trace_id:
        return False
    if rate >= 1.0:
        return True
    h = int(hashlib.sha1(trace_id.encode()).hexdigest()[:8], 16)
    return h / float(0x100000000) < rate


class Tracer:
    """Per-process span collector: bounded in-memory ring, optional
    per-rank jsonl span file, best-effort KV publish. One instance per
    process, resolved lazily by :func:`tracer`."""

    def __init__(self, rate: float, trace_dir: str = ""):
        self.rate = float(rate)
        self._dir = trace_dir or ""
        self._lock = _locks.lock("tracing.Tracer._lock")
        self._spans: "collections.deque" = collections.deque(
            maxlen=_BUFFER_DEPTH)
        self._writer = None
        self._writer_resolved = False
        self.span_path: Optional[str] = None
        self._client = None
        self._client_resolved = False
        self._rank: Optional[int] = None

    # -- identity ------------------------------------------------------------
    def rank(self) -> int:
        if self._rank is None:
            from . import basics
            if basics.is_initialized():
                self._rank = basics.rank()
            else:
                try:
                    self._rank = int(os.environ.get("HVD_TPU_RANK") or 0)
                except ValueError:
                    self._rank = 0
        return self._rank

    # -- collection ----------------------------------------------------------
    def emit(self, name: str, trace_id: str, span_id: str,
             parent_id: Optional[str], ts_us: float, dur_us: float,
             args: Optional[dict] = None) -> None:
        span = {"trace": trace_id, "span": span_id, "parent": parent_id,
                "name": name, "rank": self.rank(), "ts": ts_us,
                "dur": dur_us}
        if args:
            span["args"] = args
        with self._lock:
            self._spans.append(span)
        w = self._file_writer()
        if w is not None:
            w.put(span)

    def spans(self, trace_id: Optional[str] = None) -> list:
        """Snapshot of the in-memory ring, optionally filtered to one
        trace id (oldest first)."""
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s["trace"] == trace_id]
        return out

    # -- span file (shared bounded writer with timeline.py) ------------------
    def _file_writer(self):
        if self._writer_resolved:
            return self._writer
        with self._lock:
            if not self._writer_resolved:
                if self._dir:
                    from .timeline import RecordWriter
                    os.makedirs(self._dir, exist_ok=True)
                    self.span_path = os.path.join(
                        self._dir, f"spans-rank{self.rank()}.jsonl")
                    self._writer = RecordWriter(self.span_path,
                                                mode="jsonl")
                self._writer_resolved = True
        return self._writer

    # -- KV publication (live fleets) ----------------------------------------
    def _kv_client(self):
        """A rendezvous KV client when the launcher's server is
        reachable from config, else None — same single-attempt,
        short-timeout recipe as ``_schedule.ScheduleLedger``: publishes
        ride the request path, so a dead KV server must cost one
        bounded probe, never a retry chain."""
        if not self._client_resolved:
            from . import config as _config
            from . import retry as _retry
            cfg = _config.live_config()
            addr = cfg.get(_config.RENDEZVOUS_ADDR)
            port = cfg.get(_config.RENDEZVOUS_PORT)
            if addr and port and int(port) > 0:
                from .runner.rendezvous import KVStoreClient
                self._client = KVStoreClient(
                    addr, int(port), timeout=2.0,
                    retry=_retry.RetryPolicy(
                        max_attempts=1, initial_backoff=0.05,
                        max_backoff=0.1, deadline=2.0))
            self._client_resolved = True
        return self._client

    def publish(self) -> bool:
        """Best-effort publish of the in-memory ring to the rendezvous
        ``trace`` scope (key ``rank<N>``) so ``tools/trace --kv`` can
        merge a live fleet's spans without touching its disks. Returns
        True when the PUT landed."""
        client = self._kv_client()
        if client is None:
            return False
        payload = json.dumps(self.spans())
        try:
            client.put(KV_SCOPE, f"rank{self.rank()}", payload.encode())
            return True
        except Exception:
            return False

    def close(self) -> None:
        w = self._writer
        if w is not None:
            w.close()


def tracer() -> Optional[Tracer]:
    """The process tracer when ``HVD_TPU_TRACE_SAMPLE`` > 0, else None.
    Resolved once; :func:`reset` re-reads the knobs."""
    global _TRACER, _RESOLVED
    if not _RESOLVED:
        with _RESOLVE_LOCK:
            if not _RESOLVED:
                from . import config as _config
                cfg = _config.live_config()
                rate = float(cfg.get(_config.TRACE_SAMPLE))
                _TRACER = Tracer(rate, cfg.get(_config.TRACE_DIR)) \
                    if rate > 0.0 else None
                _RESOLVED = True
    return _TRACER


def reset() -> None:
    """Close the span writer, drop the tracer and the thread's context,
    and re-read the knobs — tests and elastic resets."""
    global _TRACER, _RESOLVED, _LAST_REQUEST
    tr = _TRACER
    if tr is not None:
        try:
            tr.close()
        except Exception:
            pass
    with _RESOLVE_LOCK:
        _TRACER = None
        _RESOLVED = False
    _LAST_REQUEST = None
    _tls.ctx = None


# ---------------------------------------------------------------------------
# span context managers
# ---------------------------------------------------------------------------

class _NullSpan:
    """Singleton no-op span: what every span helper returns when the
    tracer is off or the request is unsampled."""

    __slots__ = ()
    span_id = None
    trace_id = None
    sampled = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kw):
        pass

    def context(self):
        return None


_NULL_SPAN = _NullSpan()


class Span:
    """Context manager recording one span. Entering installs the span
    as the thread's current context (so nested ``span()`` calls and
    collective submissions bind under it); exiting restores the
    previous context and emits the record."""

    __slots__ = ("_tr", "name", "trace_id", "span_id", "parent_id",
                 "_args", "_ts", "_t0", "_prev")

    sampled = True

    def __init__(self, tr: Tracer, name: str, trace_id: str,
                 parent_id: Optional[str], args: Optional[dict] = None):
        self._tr = tr
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self._args = dict(args) if args else None

    def annotate(self, **kw) -> None:
        """Attach args to the span before it closes."""
        if self._args is None:
            self._args = {}
        self._args.update(kw)

    def context(self) -> TraceContext:
        """A TraceContext naming this span as the parent — for header
        propagation (``TRACE_PARENT_HEADER``) or KV handoff."""
        return TraceContext(self.trace_id, self.span_id)

    def __enter__(self):
        self._prev = set_current(TraceContext(self.trace_id, self.span_id))
        self._ts = time.time() * 1e6
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, etype, exc, tb):
        dur = (time.perf_counter() - self._t0) * 1e6
        set_current(self._prev)
        if etype is not None:
            self.annotate(error=repr(exc))
        self._tr.emit(self.name, self.trace_id, self.span_id,
                      self.parent_id, self._ts, dur, self._args)
        return False


def request_span(name: str, request_id: Optional[str],
                 parent: Optional[str] = None,
                 args: Optional[dict] = None):
    """Root span for a request arriving at this process. Returns a
    no-op unless the tracer is on AND the deterministic head-sampling
    decision for ``request_id`` says trace. ``parent`` is the upstream
    hop's encoded context (the ``X-HVD-TPU-Trace-Parent`` header), so a
    replica's server span nests under the router's proxy span. Always
    notes the request id for failure attribution, sampled or not."""
    note_request(request_id)
    tr = _TRACER if _RESOLVED else tracer()
    if tr is None or not request_id or not sampled(request_id, tr.rate):
        return _NULL_SPAN
    parent_id = None
    if parent:
        ctx = TraceContext.decode(parent)
        if ctx is not None and ctx.trace_id == request_id:
            parent_id = ctx.span_id
    return Span(tr, name, request_id, parent_id, args)


def span(name: str, args: Optional[dict] = None):
    """Child span under the calling thread's current context; a no-op
    when the thread carries no sampled request."""
    tr = _TRACER if _RESOLVED else tracer()
    if tr is None:
        return _NULL_SPAN
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return _NULL_SPAN
    return Span(tr, name, ctx.trace_id, ctx.span_id, args)


def span_for(ctx: Optional[TraceContext], name: str,
             args: Optional[dict] = None):
    """Child span bound to an explicit context — for worker threads
    (batcher dispatch, generation scheduler) that carry the request's
    context in a data structure rather than thread-local state."""
    tr = _TRACER if _RESOLVED else tracer()
    if tr is None or ctx is None:
        return _NULL_SPAN
    return Span(tr, name, ctx.trace_id, ctx.span_id, args)


def emit_span(ctx: Optional[TraceContext], name: str,
              start_monotonic: float,
              end_monotonic: Optional[float] = None,
              args: Optional[dict] = None) -> None:
    """Record a span for an interval measured on ``time.monotonic()``
    that already ended when tracing code ran — the batcher's queue wait
    is only known at dispatch. The interval is mapped onto the epoch
    clock through the current monotonic/epoch pair."""
    tr = _TRACER if _RESOLVED else tracer()
    if tr is None or ctx is None:
        return
    now_mono = time.monotonic()
    end_mono = now_mono if end_monotonic is None else end_monotonic
    ts = time.time() * 1e6 - (now_mono - start_monotonic) * 1e6
    dur = max(0.0, (end_mono - start_monotonic) * 1e6)
    tr.emit(name, ctx.trace_id, uuid.uuid4().hex[:16], ctx.span_id,
            ts, dur, args)


def collective(entry: tuple) -> None:
    """``collectives._record_round`` hook: an instant span naming the
    submitted collective's verb and tensor name, bound to whatever
    sampled request the submitting thread is working for. The first
    line is the zero-overhead guard — with ``HVD_TPU_TRACE_SAMPLE=0``
    (the default) this costs one module-global load and an is-None
    test per collective submission."""
    tr = _TRACER if _RESOLVED else tracer()
    if tr is None:
        return
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return
    tr.emit(f"collective:{entry[0]}:{entry[1]}", ctx.trace_id,
            uuid.uuid4().hex[:16], ctx.span_id, time.time() * 1e6, 0.0)
