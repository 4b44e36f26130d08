"""Eager collectives over ``torch.distributed`` (counterpart of
``horovod_tpu/collectives.py``).

Verbs: ``allreduce``, ``grouped_allreduce``, ``allgather``, ``broadcast``,
``grouped_broadcast`` and ``alltoall``, each with an ``*_async`` form
returning an integer handle that ``synchronize`` resolves and ``poll``
asks about; ``release``, ``barrier`` and the Join protocol (``join``,
``join_round``, ``joined``). Every verb takes ``process_set=`` (a set made
by ``init(process_sets=...)``, see :mod:`.mesh`); a process outside the
set raises.

The data plane is the world's backend: NCCL on the card, gloo on the CPU.
Every verb goes through the wire, even in a world of one (there NCCL is a
device copy), except Adasum, which at size 1 only applies its scales, as
the JAX package does. A CUDA tensor goes through NCCL or raises: in a gloo
(CPU) world a CUDA tensor is refused, never staged on the host. A CPU
tensor in an NCCL world is copied to the card and its result copied back.

* **One dispatcher thread** (:class:`_Dispatcher`) runs every verb's
  work: ``*_async`` hands it a closure and returns at once, so the wire
  calls of a process keep one order whatever thread submits them (the
  autograd engine's hooks, the main thread). On the card the dispatcher
  issues NCCL on its own current stream, so the caller's stream must be
  waited for: an event recorded on the caller's current stream at submit
  is waited on by the dispatcher's stream before it touches the inputs,
  and ``synchronize`` makes the caller's current stream wait on an event
  recorded after the dispatcher's last use of the result
  (:class:`_StreamOrder`). Neither wait blocks the host.
* **Fusion**: a grouped allreduce (and a grouped broadcast) is one flat
  buffer per dtype and one wire call per dtype, split back after. Half
  types accumulate in fp32 for every op; Average and the pre/post scale
  factors fold into one scale applied after the sum
  (:func:`_combined_scale`).
* **Consistency exchange** (:func:`_check_consistency`): in a world of
  more than one process, before a verb's data moves, every process
  all-gathers (exchange sequence number, CRC-32 fingerprint of the
  request's wire message) and raises TensorValidationError, with the JAX
  package's messages, when they differ; a fingerprint validated once is
  skipped through the response cache. The two words travel as int64
  (torch has no uint32 that every backend reduces or gathers).
* **Ragged allgather**: first dims are exchanged, every process pads to
  the largest, all-gathers and trims; one path for NCCL and gloo.
  **alltoall** exchanges the split table, then ``all_to_all_single``
  with uneven input and output splits.
* **Join**: see the section below; after ``join()`` a process contributes
  zeros to every reduction.

Telemetry and chaos sites of the dispatch path, as in the JAX package:

* **metrics** (:mod:`.metrics`): ``hvd_tpu_collective_ops_total``,
  ``hvd_tpu_collective_bytes_total`` and
  ``hvd_tpu_collective_dispatch_seconds`` by verb (pre-bound per verb at
  import, so the hot path pays plain increments),
  ``hvd_tpu_dispatcher_queue_depth`` and
  ``hvd_tpu_consistency_checks_total`` by result, and
  ``hvd_tpu_injit_lowerings_total`` by verb, which counts the in-jit
  route's lowerings (see below) once per compilation;
* **fault sites** (:mod:`.faults`): one ``collective.<verb>`` point per
  verb, fired at the top of the dispatched closure, before the
  consistency exchange, so an injected fault (or its retry) can never
  leave this process's exchange sequence mispaired with its peers';
* **retry** (:mod:`.retry`): the dispatcher's ``RetryPolicy`` wraps only
  that host-plane stage. A wire call (gloo, NCCL, CUDA) is never retried,
  since a retried collective would desynchronize the ranks; its error
  surfaces as HorovodInternalError;
* **timeline** (:mod:`.timeline`): the verb's top-level span opens at
  submit and the wire activity (``NCCL_ALLREDUCE``, ``GLOO_ALLGATHER``,
  ...) spans the data's wire calls on the dispatcher;
* **schedule ledger and tracing** (:mod:`._schedule`, :mod:`.tracing`):
  every submission is recorded in the ledger (``HVD_TPU_SCHEDULE_CHECK``)
  and, when the submitting thread works for a sampled request or a
  traced training step, spanned as ``collective:<verb>:<name>``; the
  handle carries that span's context to the dispatcher, which emits
  ``dispatch.queue`` (the wait in its queue) and ``dispatch.run`` (the
  closure, with the consistency check's outcome) under it. The host's
  reads of device values on the step path are counted in
  :data:`HOST_SYNCS` and spanned as ``host.sync``.

**The in-jit route** (the JAX package's ``_injit_*``, its
``docs/injit.md``): a verb called while ``torch.compile`` traces
(``torch.compiler.is_compiling()``) lowers at trace time to the in-graph
collectives of ``torch.distributed._functional_collectives`` over the
DeviceMesh in scope (``with mesh:``; all its dims), and skips the
dispatcher, the consistency exchange, the timeline, the fault sites and
the ledger: every process runs the same compiled graph, which is the
agreement the exchange exists to establish. Eager calls never take it.
With no mesh in scope the route lowers over the world, so a compiled
call equals the eager verb (the JAX package's plain jit uses size-1
semantics there, because its arrays are global; a torch process holds
its own tensor, and an identity would leave it unreduced). Sum and
Average accumulate half types in fp32 and scale in the accumulation
dtype; a grouped allreduce rides one collective per
:func:`.fusion.packed_plan` bucket (``HVD_TPU_INJIT_PACKED_THRESHOLD``);
Product gathers and multiplies; allgather is tiled (a 0-d input gives
one row each); broadcast is the gather's ``root_rank`` row; alltoall
takes even splits only. ``*_async`` returns a completed handle that
``synchronize`` and ``poll`` accept in the graph and out of it.
``HVD_TPU_INJIT_FASTPATH=0`` makes a traced call raise TypeError and
``process_set=`` raises ValueError (a compiled graph lowers over the
mesh in scope), both while the graph is traced, as the JAX package
raises while it traces. Adasum is, per member, the prescale, an
all-gather over the scope's group and the Adasum tree
(:func:`.adasum.adasum_grads`), then the postscale; with a mesh of
several dims in scope it raises ValueError, as the JAX package does (an
explicit hierarchy is ``adasum_grads``' inner and outer groups).
allreduce, allgather and broadcast keep their gradients in the graph:
allreduce's is the same allreduce, allgather's the reduce-scatter (sum)
of the cotangent onto this process's rows, broadcast's the sum of every
process's cotangent at the root and zeros elsewhere, as JAX's autodiff
of ``lax.all_gather`` gives them. :func:`psum`,
:func:`pmean`, :func:`all_gather_in_jit`, :func:`reduce_scatter_in_jit`,
:func:`all_to_all_in_jit` and :func:`ppermute` are the named in-graph
collectives over one dim of the mesh in scope.
"""

import enum
import functools
import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import _schedule as _sched
from . import basics as _basics
from . import config as _config
from . import faults as _faults
from . import metrics as _metrics
from . import retry as _retry
from . import timeline as _tl
from . import tracing as _tracing
from .compression import Compression
from .exceptions import HorovodInternalError, TensorValidationError
from .tensor_table import Handle, dtype_str, metadata_fingerprint

_VERBS = ("allreduce", "grouped_allreduce", "allgather", "broadcast",
          "grouped_broadcast", "alltoall")

# -- telemetry (metrics.py): the JAX package's families, children pre-bound
# per verb at import so the submit/dispatch hot path pays plain
# increments, no label lookups; eager registration also makes every series
# visible in scrapes before the first collective.
_M_OPS = _metrics.counter(
    "hvd_tpu_collective_ops_total",
    "Eager collectives submitted, by verb.", labels=("op",))
_M_BYTES = _metrics.counter(
    "hvd_tpu_collective_bytes_total",
    "Payload bytes submitted to eager collectives, by verb.",
    labels=("op",))
_M_LATENCY = _metrics.histogram(
    "hvd_tpu_collective_dispatch_seconds",
    "Dispatcher-thread stage+dispatch wall time per eager collective, by "
    "verb (consistency exchange, staging, XLA dispatch; device "
    "completion is asynchronous).", labels=("op",))
_OP_METRICS = {
    kind: (_M_OPS.labels(op=kind), _M_BYTES.labels(op=kind),
           _M_LATENCY.labels(op=kind))
    for kind in _VERBS}
_M_QUEUE_DEPTH = _metrics.gauge(
    "hvd_tpu_dispatcher_queue_depth",
    "Eager collectives currently queued on the dispatcher thread.")
_M_CONSISTENCY = _metrics.counter(
    "hvd_tpu_consistency_checks_total",
    "Cross-process metadata consistency checks, by result "
    "(cached = ResponseCache fast path skipped the exchange).",
    labels=("result",))
_M_CONSISTENCY_CACHED = _M_CONSISTENCY.labels(result="cached")
_M_CONSISTENCY_EXCHANGED = _M_CONSISTENCY.labels(result="exchanged")
_M_CONSISTENCY_FAILED = _M_CONSISTENCY.labels(result="failed")
# Trace-time lowerings (the in-jit route): incremented while torch.compile
# traces a verb, so this counts compilations, not steps; a steady compiled
# loop leaves it and hvd_tpu_collective_ops_total flat. The help text is
# the JAX package's.
_M_INJIT = _metrics.counter(
    "hvd_tpu_injit_lowerings_total",
    "Collective verbs lowered in-trace to XLA collectives (counted per "
    "compilation, not per step), by verb.", labels=("op",))
_INJIT_METRICS = {kind: _M_INJIT.labels(op=kind) for kind in _VERBS}

# Chaos sites (faults.py): one point per verb, fired at the top of the
# dispatched closure. Without HVD_TPU_FAULT_SPEC they are single-branch
# no-ops.
_FAULT_POINTS = {kind: _faults.FaultPoint(f"collective.{kind}")
                 for kind in _VERBS}


def _observed(w, kind: str, nbytes: int, fn):
    """Count a submission now (caller thread: submissions are recorded
    even if the dispatcher never runs them) and wrap ``fn`` so that its
    fault site fires first, under the dispatcher's retry policy, and its
    dispatcher-thread wall time lands in the verb's latency histogram."""
    ops_c, bytes_c, lat_h = _OP_METRICS[kind]
    ops_c.inc()
    bytes_c.inc(nbytes)
    fp = _FAULT_POINTS[kind]
    retry = _dispatcher(w).retry

    def wrapped():
        t0 = time.perf_counter()
        try:
            retry.call(fp.fire, site="collective.dispatch")
            return fn()
        finally:
            lat_h.observe(time.perf_counter() - t0)
    return wrapped


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class ReduceOp(enum.Enum):
    """Reduction ops (reference: Average/Sum/Adasum in
    horovod/torch/mpi_ops.py:40-44; Min/Max/Product as in the JAX
    package)."""
    AVERAGE = "average"
    SUM = "sum"
    ADASUM = "adasum"
    MIN = "min"
    MAX = "max"
    PRODUCT = "product"


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

_WIRE_OP = {ReduceOp.AVERAGE: dist.ReduceOp.SUM,
            ReduceOp.SUM: dist.ReduceOp.SUM,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}

#: wire calls that move a verb's data, by verb (one per ``dist`` call; the
#: consistency, size and split-table exchanges are not counted)
COUNTS = {"allreduce": 0, "broadcast": 0, "allgather": 0, "alltoall": 0}
#: reads of a device value by the host on the training step's path (the
#: host waits there for the device to run everything queued before it)
HOST_SYNCS = 0

_HALF = (torch.float16, torch.bfloat16)
_SHUT_DOWN = "Horovod has been shut down; collective was not dispatched."


def _is_integer(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex
                    or dtype == torch.bool)
    return bool(np.issubdtype(np.dtype(dtype), np.integer))


def _combined_scale(op: ReduceOp, nproc: int, prescale: float,
                    postscale: float, dtype) -> float:
    if op in (ReduceOp.MIN, ReduceOp.MAX, ReduceOp.PRODUCT) and (
            prescale != 1.0 or postscale != 1.0):
        raise ValueError(
            "prescale_factor/postscale_factor are only supported for "
            "Sum/Average/Adasum (reference semantics).")
    scale = prescale * postscale
    if op == ReduceOp.AVERAGE:
        scale /= nproc
    if scale != 1.0 and _is_integer(dtype):
        raise ValueError(
            "prescale/postscale/average on integer tensors is not supported; "
            "use op=horovod_tpu_torch.Sum for integer dtypes.")
    return scale


def _resolve_op(average, op) -> ReduceOp:
    if average is not None and op is not None:
        raise ValueError("Set either average or op; not both "
                         "(reference semantics: util.py "
                         "get_average_backwards_compatibility_fun).")
    if op is None:
        if average is None:
            return ReduceOp.AVERAGE
        return ReduceOp.AVERAGE if average else ReduceOp.SUM
    if not isinstance(op, ReduceOp):
        raise TypeError(f"op must be a horovod_tpu_torch.ReduceOp, got {op!r}")
    return op


def _world():
    return _basics.world()


def _auto_name(w, kind: str) -> str:
    with w.lock:
        w.name_counter += 1
        return f"{kind}.noname.{w.name_counter}"


def _mesh(w, process_set):
    """The group a verb runs on; a process outside it raises here, at the
    call site."""
    wm = process_set or w.world_mesh
    wm.my_index  # noqa: B018 — raises ValueError for a non-member
    return wm


def _input(w, t) -> torch.Tensor:
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
    if t.is_cuda and w.device.type != "cuda":
        raise ValueError(
            "a CUDA tensor was given to a collective of a gloo (CPU) world; "
            "call horovod_tpu_torch.init() on CUDA to reduce it over NCCL")
    return t


def _check_root(wm, root_rank: int) -> None:
    if not 0 <= root_rank < wm.num_procs:
        raise ValueError(f"root_rank {root_rank} out of range for world "
                         f"size {wm.num_procs}")


def _on_device(w, t: torch.Tensor, dtype=None) -> torch.Tensor:
    """A contiguous copy of ``t`` on the world's device that the
    collective may overwrite (never ``t``'s own storage)."""
    out = torch.empty(t.shape, dtype=dtype or t.dtype, device=w.device)
    out.copy_(t.detach())
    return out


def _all_gather_single(out, t, group):
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, t, group=group)


def _exchange_ints(w, wm, values) -> List[List[int]]:
    """Every member's ``values`` (a list of ints), by set index: one
    all-gather of int64 words on the world's device."""
    mine = torch.tensor(values, dtype=torch.int64, device=w.device)
    out = torch.empty(wm.num_procs * len(values), dtype=torch.int64,
                      device=w.device)
    _all_gather_single(out, mine, wm.group)
    return out.view(wm.num_procs, len(values)).tolist()


# ---------------------------------------------------------------------------
# CUDA stream order between a caller and the dispatcher thread
# ---------------------------------------------------------------------------

class _StreamOrder:
    """Orders the dispatcher's CUDA work after the caller's and the
    caller's use of a result after the dispatcher's. Made at submit, on the
    caller's thread: records ``ready`` on the caller's current stream.
    Where the two threads' current streams are one stream (the default
    stream on both, as in training), stream order already holds and the
    waits and the allocator bookkeeping are skipped."""

    __slots__ = ("device", "caller", "ready", "stream", "done")

    def __init__(self, device: torch.device):
        self.device = device
        self.caller = torch.cuda.current_stream(device)
        self.ready = torch.cuda.Event()
        self.ready.record(self.caller)
        self.stream = None
        self.done = None

    def enter(self, inputs) -> None:
        """On the dispatcher, before it reads ``inputs``: its stream waits
        for the caller's, and the caching allocator learns that the inputs
        are in use on it (the caller may drop them before they are read)."""
        s = torch.cuda.current_stream(self.device)
        self.stream = s
        if s == self.caller:
            return
        s.wait_event(self.ready)
        for t in inputs:
            if t.is_cuda:
                t.record_stream(s)

    def leave(self) -> None:
        """On the dispatcher, after its last use of the result."""
        self.done = torch.cuda.Event()
        self.done.record(self.stream)

    def land(self, outputs) -> None:
        """At synchronize: the caller's current stream waits for the
        result, which the allocator then knows is in use on it."""
        s = torch.cuda.current_stream(self.device)
        if s == self.stream:
            return
        s.wait_event(self.done)
        for t in outputs:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(s)


def _stream_order(w) -> Optional[_StreamOrder]:
    return _StreamOrder(w.device) if w.device.type == "cuda" else None


# ---------------------------------------------------------------------------
# The dispatcher thread (counterpart of the JAX package's _Dispatcher,
# itself the descendant of the reference's background thread,
# operations.cc:557-607): one process-wide order of wire calls.
# ---------------------------------------------------------------------------

def _wrap_error(e: BaseException) -> BaseException:
    if isinstance(e, (TensorValidationError, ValueError, TypeError,
                      HorovodInternalError)):
        return e
    return HorovodInternalError(str(e))


class _Dispatcher:
    def __init__(self, device: torch.device, cfg: _config.Config):
        self._device = device
        self._q: "queue.Queue" = queue.Queue()
        self._stopped = False
        #: transient-vs-fatal policy of the host-plane stage of a dispatch
        #: (the fault site, see _observed); wire calls are never retried
        self.retry = _retry.RetryPolicy.from_config(cfg)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hvd-tpu-torch-dispatcher")
        self._thread.start()

    @staticmethod
    def _execute(h: Handle, fn) -> None:
        try:
            h.result = fn()
        except Exception as e:  # noqa: BLE001 — surfaced at synchronize
            h.error = _wrap_error(e)
            if isinstance(h.error, HorovodInternalError):
                _basics.mark_failed()
        finally:
            h.event.set()

    def submit(self, h: Handle, fn) -> None:
        h.event = threading.Event()
        if self._stopped:
            # shutdown raced with submission: fail the handle instead of
            # queueing to a dead thread
            h.error = HorovodInternalError(_SHUT_DOWN)
            h.event.set()
        elif threading.current_thread() is self._thread:
            # re-entrant submission from a dispatched closure: already
            # inside the single order, run inline
            self._execute(h, fn)
        else:
            # inc BEFORE put: the dispatcher may pop and dec the instant
            # the item lands, and inc-after would let a scrape read a
            # negative depth
            _M_QUEUE_DEPTH.inc()
            self._q.put((h, fn))

    def run_sync(self, fn):
        """Run ``fn`` on the dispatcher thread and wait for it: for verbs
        with no async form, so they keep the single order. The wait
        honours the stall inspector's deadline."""
        h = Handle(-1, "run_sync")
        self.submit(h, fn)
        _wait(_world(), h)
        if h.error is not None:
            raise h.error
        return h.result

    def _run(self):
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            item = self._q.get()
            if item is None:
                break   # the stop() sentinel is never counted in the depth
            _M_QUEUE_DEPTH.dec()
            self._execute(*item)
        # fail anything queued concurrently with stop(): do not hang it
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                _M_QUEUE_DEPTH.dec()
                h, _ = item
                h.error = HorovodInternalError(_SHUT_DOWN)
                h.event.set()

    def stop(self):
        self._stopped = True
        self._q.put(None)
        self._thread.join(timeout=5.0)


def _dispatcher(w) -> _Dispatcher:
    with w.lock:
        if w.dispatcher is None:
            w.dispatcher = _Dispatcher(w.device, w.config)
        return w.dispatcher


def run_in_order(fn, inputs=(), outputs=()):
    """Run ``fn``, wire calls on any process group, on the dispatcher
    thread, in this process's single order of wire calls, and return its
    result. ``inputs`` are the tensors it reads and ``outputs`` those it
    writes, allocated by the caller: the dispatcher's stream waits for the
    caller's, and the caller's for the result.

    The parallel package sends, receives and reduces through here, so
    that its wire calls and the gradient buckets reach NCCL from one
    thread in program order, the same order on every rank. Made from the
    backward's thread instead, beside the dispatcher's buckets, the ring
    hangs in its first step on NCCL at 2 and 4 ranks
    (``tests/test_torch_port_parallel_cuda.py order-probe``): every
    dispatcher blocks reading a bucket's consistency all-gather, which
    one rank never issues because its backward thread is blocked in a
    ring send whose peer's backward thread has stopped short of it."""
    w = _world()
    order = _stream_order(w)

    def run():
        if order is not None:
            order.enter(list(inputs) + list(outputs))
        out = fn()
        if order is not None:
            order.leave()
        return out
    out = _dispatcher(w).run_sync(run)
    if order is not None:
        order.land(outputs)
    return out


def _submit(w, h: Handle, kind: str, inputs, check, run,
            span=None) -> int:
    """Hand verb ``kind`` to the dispatcher: its timeline span opens now;
    on the dispatcher its fault site fires, ``check`` (the consistency
    exchange) runs, the dispatcher's stream waits for the caller's, and
    ``run`` moves the data inside the wire activity. ``span``, the
    submission's trace span from :func:`_record_round`, closes once the
    item is queued; the dispatcher spans its queue wait and its run
    under it."""
    try:
        order = _stream_order(w)
        h.order = order
        tl = w.timeline
        name = h.name
        tl.start(name, kind)
        nbytes = _nbytes(inputs)
        trace = queued = None
        if span is not None:
            span.annotate(bytes=nbytes, tensors=len(inputs))
            trace, queued = span.context(), time.monotonic()

        def work(sp=None):
            consistency = check()
            if sp is not None:
                sp.annotate(consistency=consistency)
            if order is not None:
                order.enter(inputs)
            tl.activity_start(name, _tl.wire_activity(w.backend, kind))
            out = run()
            tl.activity_end(name)
            # close the verb's own span, opened at submit (the JAX package
            # leaves it open, so later spans nest inside it in a viewer)
            tl.end(name)
            if order is not None:
                order.leave()
            return out

        def dispatch():
            if trace is None:
                return work()
            with _tracing.dispatch_span(trace, queued) as sp:
                return work(sp)
        _dispatcher(w).submit(h, _observed(w, kind, nbytes, dispatch))
        return h.id
    finally:
        if span is not None:
            span.__exit__(None, None, None)


# ---------------------------------------------------------------------------
# Consistency exchange (controller.cc:378-611 analogue)
# ---------------------------------------------------------------------------

def _check_consistency(w, wm, name, shape, dtype, kind, extra="") -> str:
    """Cross-process metadata validation: all-gathers (exchange sequence
    number, metadata fingerprint) across the set and raises listing the
    processes that differ. Skipped in a set of one and when
    ``HVD_TPU_CHECK_CONSISTENCY=0``; a fingerprint validated once is not
    exchanged again until the response cache evicts it. Returns what
    happened: ``skipped``, ``cached`` or ``exchanged``.

    The cache decision is per process, so processes that submit different
    sequences (the user error this check exists for) may skip an exchange
    another one runs; the sequence number makes that mispairing an error
    on the next exchange. A process that never exchanges again is caught
    by the stall inspector."""
    if wm.num_procs <= 1 or not w.config.get(_config.CHECK_CONSISTENCY):
        return "skipped"
    if callable(extra):
        extra = extra()
    fp = metadata_fingerprint(name, shape, dtype, kind, extra)
    cache_key = (hash(wm.cache_key) & 0xFFFFFFFF) << 32 | fp
    with w.consistency_lock:
        if w.response_cache.lookup(cache_key):
            _M_CONSISTENCY_CACHED.inc()
            return "cached"
        w.consistency_seq = (w.consistency_seq + 1) & 0x7FFFFFFF
        words = _exchange_ints(w, wm, [w.consistency_seq, fp])
        seqs = [s for s, _ in words]
        fps = [f for _, f in words]
        join_hint = ""
        if w.joined:
            join_hint = (
                " This process has join()ed and is replaying its last "
                f"recorded round; the mispaired entry is {name!r} ({kind}, "
                f"shape {tuple(shape)}, dtype {dtype_str(dtype)}). The "
                "collective round pattern changed after join(): Join "
                "requires a steady per-round sequence — submit the same "
                "collectives every step and call join_round() once per "
                "step.")
        if len(set(seqs)) > 1:
            _M_CONSISTENCY_FAILED.inc()
            raise TensorValidationError(
                f"Consistency-exchange sequence mismatch at collective "
                f"{name!r} ({kind}): per-process exchange counts "
                f"{dict(enumerate(seqs))} differ, meaning processes have "
                f"submitted different collective sequences (or their "
                f"response caches diverged). All processes must submit the "
                f"same collectives in the same order." + join_hint)
        if len(set(fps)) > 1:
            _M_CONSISTENCY_FAILED.inc()
            mine = fps[wm.my_index]
            bad = [i for i, x in enumerate(fps) if x != mine]
            raise TensorValidationError(
                f"Mismatched metadata for collective {name!r} ({kind}): "
                f"processes {bad} submitted a different shape/dtype/op than "
                f"process {wm.my_index}. All processes must submit "
                f"identical requests for the same tensor name." + join_hint)
        _M_CONSISTENCY_EXCHANGED.inc()
        w.response_cache.put(cache_key)
        return "exchanged"


# ---------------------------------------------------------------------------
# The in-jit route (see the module docstring; the JAX package's _injit_*,
# horovod_tpu/collectives.py:1497-1721). Everything on it must trace
# without a graph break: no lock, no dispatcher, no handle table. What
# needs plain Python at trace time (the world's config, the group a
# verb lowers over, the bucket plan, the counter, the errors) runs in
# functions marked constant, which Dynamo calls once per trace and
# whose results become constants of the graph, unguarded: so
# basics.shutdown() drops every compiled graph, and a function called
# again in the next world traces again.
# ---------------------------------------------------------------------------

_PASSING = {}


def _passing(kind):
    """``kind`` as an exception that torch.compile lets through as itself:
    Dynamo re-raises an error from a traced function as its own
    InternalTorchDynamoError, with the type in the message only, except a
    few kinds, AssertionError among them. So the in-jit route raises a
    subclass of both, which ``except kind`` catches as the JAX package's
    trace-time error is caught."""
    if kind not in _PASSING:
        _PASSING[kind] = type(kind.__name__, (kind, AssertionError),
                              {"__module__": __name__})
    return _PASSING[kind]


def _trace_constant(fn):
    """``fn`` marked as ``torch.compiler.assume_constant_result`` marks it
    (the attribute it sets), without importing ``torch._dynamo`` when this
    module loads: while Dynamo traces, a call runs ``fn`` in Python and
    its result is a constant of the graph; its arguments must be Python
    constants (a DeviceMesh, ints, strings, dtypes, tuples of them). Its
    TypeError, ValueError, NameError and NotImplementedError reach the
    caller as themselves (:func:`_passing`)."""
    @functools.wraps(fn)
    def constant(*args):
        try:
            return fn(*args)
        except (TypeError, ValueError, NameError,
                NotImplementedError) as e:
            if isinstance(e, AssertionError):
                raise
            raise _passing(type(e))(*e.args) from e
    constant._dynamo_marked_constant = True
    return constant


def _functional():
    import torch.distributed._functional_collectives as fc
    return fc


def _all_gather(x, dim: int, group):
    """The in-graph all-gather along ``dim`` (``all_gather_single`` where
    this torch has it: it deprecates ``all_gather_tensor``). On a tensor
    that requires grad, the differentiable all-gather: its gradient is
    the reduce-scatter (sum) of the cotangent onto this member's block,
    the transpose JAX's autodiff takes of ``lax.all_gather``."""
    fc = _functional()
    if x.requires_grad and torch.is_grad_enabled():
        return fc.all_gather_tensor_autograd(x.contiguous(), dim, group)
    fn = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
    return fn(x.contiguous(), dim, group)


def _reduce_scatter(x, dim: int, group):
    """The in-graph reduce-scatter (sum) along ``dim``
    (``reduce_scatter_single`` where this torch has it)."""
    fc = _functional()
    fn = getattr(fc, "reduce_scatter_single", None) \
        or fc.reduce_scatter_tensor
    return fn(x.contiguous(), "sum", dim, group)


def _shift(x, group, n: int, dst: Optional[int],
           src: Optional[int]) -> torch.Tensor:
    """The 1-D ``x`` sent to member ``dst`` of ``group`` (of ``n``; None:
    nowhere) and as many elements received from member ``src`` (None:
    zeros, as ``jax.lax.ppermute`` gives), in one in-graph
    ``all_to_all_single`` with this member's split sizes."""
    send, recv = [0] * n, [0] * n
    if dst is not None:
        send[dst] = x.numel()
    if src is not None:
        recv[src] = x.numel()
    got = _functional().all_to_all_single(x[:sum(send)].contiguous(), recv,
                                          send, group)
    if src is None:
        # nothing arrives; still wait for the call, which this member's
        # send rides on
        _functional().wait_tensor(got)
        return torch.zeros_like(x)
    return got


@_trace_constant
def _trace_fail(kind, message: str):
    """Raise ``kind(message)`` at trace time, as the JAX package raises
    while it traces. A ``raise`` in traced code would end a compile with
    ``fullgraph`` in Dynamo's Unsupported and make one without it fall
    back to the eager verb."""
    raise kind(message)


@_trace_constant
def _injit_scope(mesh, with_process_set: bool) -> tuple:
    """``(group name, size, this process's index, mapped, dims)`` of the
    group a traced verb lowers over: the DeviceMesh in scope, all its
    ``dims`` (``mapped``), or the world when there is none (``dims`` 0).
    Raises as the JAX package's ``_injit_route`` does."""
    w = _world()
    if not w.config.get(_config.INJIT_FASTPATH):
        raise TypeError(
            "collective called while torch.compile traces, with the in-jit "
            "fast path disabled (HVD_TPU_INJIT_FASTPATH=0). Eager "
            "collectives cannot dispatch traced values; call the verb "
            "outside the compiled function or re-enable the fast path.")
    if with_process_set:
        raise ValueError(
            "process_set is an eager-plane concept; under torch.compile the "
            "collective lowers over the DeviceMesh in scope: scope the "
            "reduction with `with mesh:` (or the named in-graph "
            "collectives) instead.")
    if mesh is None:
        group = dist.group.WORLD
    elif mesh.ndim == 1:
        group = mesh.get_group(0)
    else:
        if mesh.mesh.flatten().tolist() != list(range(w.size)):
            raise ValueError(
                f"a traced verb lowers over every dim of the mesh in scope "
                f"{tuple(mesh.mesh_dim_names or ())}; a mesh of several "
                f"dims must span the world in rank order for that. Reduce "
                f"over one of its dims with psum/pmean(x, dim) instead.")
        group = dist.group.WORLD
    return (group.group_name, dist.get_world_size(group),
            dist.get_rank(group), mesh is not None,
            0 if mesh is None else mesh.ndim)


@_trace_constant
def _injit_axis(mesh, axis_name) -> tuple:
    """``(group name, size, index)`` of the named dim(s) ``axis_name`` of
    the DeviceMesh in scope (the named in-graph collectives)."""
    names = tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)
    if mesh is None:
        raise NameError(f"unbound axis name: {axis_name!r} (no DeviceMesh "
                        f"in scope; enter one with `with mesh:`)")
    dims = tuple(mesh.mesh_dim_names or ())
    missing = [n for n in names if n not in dims]
    if missing:
        raise NameError(f"unbound axis name: {missing[0]!r} (the mesh in "
                        f"scope has dims {dims})")
    if len(names) == 1:
        group = mesh.get_group(names[0])
    else:
        if names != dims:
            raise ValueError(f"several axes {names} need every dim of the "
                             f"mesh in scope, in its order {dims}")
        return _injit_scope(mesh, False)[:3]
    return (group.group_name, dist.get_world_size(group),
            dist.get_rank(group))


@_trace_constant
def _injit_plan(shapes: tuple, dtypes: tuple) -> tuple:
    """The packed bucket plan at the world's
    ``HVD_TPU_INJIT_PACKED_THRESHOLD``."""
    from .fusion import packed_plan
    return packed_plan(shapes, dtypes,
                       _world().config.get(_config.INJIT_PACKED_THRESHOLD))


@_trace_constant
def _injit_scale(op, nproc: int, prescale: float, postscale: float,
                 dtype) -> float:
    return _combined_scale(op, nproc, prescale, postscale, dtype)


@_trace_constant
def _injit_count(kind: str) -> bool:
    """One lowering of verb ``kind``: called once per trace."""
    _INJIT_METRICS[kind].inc()
    return True


class _InjitHandle:
    """The handle of a verb lowered in a compiled graph: complete from the
    start (there is nothing to wait for), so ``synchronize`` returns its
    result, writing it into ``target`` for the in-place verbs."""

    def __init__(self, result, target=None):
        self.result = result
        self.target = target

    def land(self):
        if self.target is None:
            return self.result
        with torch.no_grad():
            self.target.copy_(self.result)
        return self.target


def _injit_route(process_set) -> Optional[tuple]:
    """The scope (see :func:`_injit_scope`) when this call is traced by
    torch.compile, else None: the eager dispatcher path."""
    if not torch.compiler.is_compiling():
        return None
    return _injit_scope(_basics.current_mesh(), process_set is not None)


def _as_tensor(t) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.as_tensor(t)


def _injit_all_reduce(xs, reduce_op: str, group) -> list:
    fc = _functional()
    if len(xs) == 1:
        return [fc.all_reduce(xs[0].contiguous(), reduce_op, group)]
    return fc.all_reduce_coalesced([x.contiguous() for x in xs], reduce_op,
                                   group)


def _injit_reduce_bucket(xs, op: ReduceOp, scale: float, group) -> list:
    """One bucket of same-dtype members in one in-graph collective, with
    the eager numerics: Sum and Average accumulate half types in fp32,
    the scale applies in the accumulation dtype, the result casts back;
    Product gathers the members and multiplies."""
    if op in (ReduceOp.SUM, ReduceOp.AVERAGE):
        accs = [x.float() if x.dtype in _HALF else x for x in xs]
        rs = _injit_all_reduce(accs, "sum", group)
        return [(r * scale if scale != 1.0 else r).to(x.dtype)
                for x, r in zip(xs, rs)]
    if op in (ReduceOp.MIN, ReduceOp.MAX):
        return _injit_all_reduce(list(xs), op.value, group)
    return [torch.prod(_all_gather(x.unsqueeze(0), 0, group), dim=0)
            for x in xs]


def _injit_set_reduce(values, group, nproc: int, prescale: float,
                      postscale: float) -> list:
    """A process set's bucket summed in the graph, as the eager verb
    reduces it (:func:`_reduce` under Sum): per dtype, in order of first
    appearance, one flat buffer in the accumulation dtype and one
    all-reduce over ``group`` (a group name), then the combined scale,
    split back to the members' shapes and dtypes. The buffer is the eager
    call's, so each element sums in the same order on the wire."""
    out = [None] * len(values)
    by_dtype = {}
    for i, v in enumerate(values):
        by_dtype.setdefault(v.dtype, []).append(i)
    for dt, idxs in by_dtype.items():
        scale = _injit_scale(ReduceOp.SUM, nproc, prescale, postscale, dt)
        acc = torch.float32 if dt in _HALF else dt
        flat = torch.cat([values[i].reshape(-1).to(acc) for i in idxs])
        flat, = _injit_all_reduce([flat], "sum", group)
        if scale != 1.0:
            flat = flat * scale
        off = 0
        for i in idxs:
            n = values[i].numel()
            out[i] = flat[off:off + n].view(values[i].shape).to(dt)
            off += n
    return out


def _injit_adasum(values, prescale: float, postscale: float,
                  scope) -> list:
    """Adasum of each member over the scope's group, in the graph (the
    JAX package's in-jit Adasum, ``horovod_tpu/collectives.py:1619-1634``):
    prescale, :func:`.adasum.adasum_grads` (an all-gather and the tree),
    postscale, in the member's dtype, as the eager verb computes it."""
    from .adasum import adasum_grads
    if scope[4] > 1:
        _trace_fail(ValueError,
                    "in-jit Adasum over multiple mapped axes needs an "
                    "explicit hierarchy; use adasum_grads(outer_group, "
                    "inner_group) or DistributedOptimizer(inner_axis=...).")
    vals = [_as_tensor(v) for v in values]
    if scope[1] == 1:
        # a group of one: the scales only, as one product, as eagerly
        s = prescale * postscale
        return [v.clone() if s == 1.0 else (v * s).to(v.dtype)
                for v in vals]
    out = []
    for g in vals:
        if prescale != 1.0:
            g = (g * prescale).to(g.dtype)
        g = adasum_grads(g, scope[0])
        if postscale != 1.0:
            g = (g * postscale).to(g.dtype)
        out.append(g)
    return out


def _injit_allreduce(values, op: ReduceOp, prescale: float,
                     postscale: float, scope) -> list:
    """An allreduce of a member list lowered in the graph: same-dtype
    members ride one collective per :func:`.fusion.packed_plan`
    bucket."""
    group, nproc = scope[0], scope[1]
    if op == ReduceOp.ADASUM:
        return _injit_adasum(values, prescale, postscale, scope)
    vals = [_as_tensor(v) for v in values]
    scales = {}
    for v in vals:
        if v.dtype not in scales:
            scales[v.dtype] = _injit_scale(op, nproc, prescale, postscale,
                                           v.dtype)
    plan = _injit_plan(tuple(tuple(v.shape) for v in vals),
                       tuple(dtype_str(v.dtype) for v in vals))
    out = [None] * len(vals)
    for _dt, idxs in plan:
        rs = _injit_reduce_bucket([vals[i] for i in idxs], op,
                                  scales[vals[idxs[0]].dtype], group)
        for i, r in zip(idxs, rs):
            out[i] = r
    return out


def _injit_allgather(x, scope) -> torch.Tensor:
    x = _as_tensor(x)
    rows = x.reshape(1) if x.dim() == 0 else x
    return _all_gather(rows, 0, scope[0])


def _injit_broadcast(x, root_rank: int, scope) -> torch.Tensor:
    """Root's ``x``: an all-gather indexed at the root, whose gradient
    (the transpose of the gather) gives the root the sum of every
    process's cotangent and the others zeros, as JAX's autodiff of
    ``all_gather(x)[root]`` does."""
    group, nproc, _, mapped = scope[:4]
    if not 0 <= root_rank < nproc:
        _trace_fail(ValueError, f"root_rank {root_rank} out of range for "
                    + ("mapped axis size" if mapped else "world size")
                    + f" {nproc}")
    x = _as_tensor(x)
    return _all_gather(x.unsqueeze(0), 0, group)[root_rank]


def _injit_alltoall(x, splits, scope) -> torch.Tensor:
    group, nproc = scope[0], scope[1]
    x = _as_tensor(x)
    if x.dim() == 0:
        _trace_fail(ValueError,
                    "alltoall needs a tensor with a first dimension")
    if splits is not None:
        splits = [int(s) for s in splits]
        if len(set(splits)) > 1:
            _trace_fail(ValueError,
                        "in-jit alltoall supports uniform splits only "
                        "(ragged splits are per-rank data, which a "
                        "compiled SPMD program cannot express); use the "
                        "eager verb for alltoallv.")
        if len(splits) != nproc or sum(splits) != x.shape[0]:
            _trace_fail(ValueError,
                        "splits must have one entry per process and sum to "
                        f"the tensor's first dimension: got {len(splits)} "
                        f"entries summing to {sum(splits)} for first dim "
                        f"{x.shape[0]} over mapped axis size {nproc}")
    if x.shape[0] % nproc != 0:
        _trace_fail(ValueError, f"alltoall tensor first dim {x.shape[0]} not "
                    f"divisible by mapped axis size {nproc}")
    return _functional().all_to_all_single(x.contiguous(), None, None, group)


# -- the named in-graph collectives (horovod_tpu/collectives.py:1724-1759):
#    over one dim (or every dim) of the DeviceMesh in scope, eager or traced

def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Sum over the mesh dim ``axis_name`` (``jax.lax.psum``)."""
    group = _injit_axis(_basics.current_mesh(), axis_name)[0]
    return _functional().all_reduce(x.contiguous(), "sum", group)


def pmean(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Mean over the mesh dim ``axis_name`` (``jax.lax.pmean``: the sum
    divided by the dim's size)."""
    from .compression import true_divide
    group, n, _ = _injit_axis(_basics.current_mesh(), axis_name)
    return true_divide(_functional().all_reduce(x.contiguous(), "sum",
                                                group), n)


def all_gather_in_jit(x: torch.Tensor, axis_name, axis: int = 0,
                      tiled: bool = True) -> torch.Tensor:
    """Every member's ``x`` along ``axis``: concatenated (``tiled``) or
    stacked on a new dim there (``jax.lax.all_gather``)."""
    group = _injit_axis(_basics.current_mesh(), axis_name)[0]
    axis = axis % (x.dim() + (0 if tiled else 1))
    if not tiled:
        x = x.unsqueeze(axis)
    return _all_gather(x, axis, group)


def reduce_scatter_in_jit(x: torch.Tensor, axis_name,
                          scatter_dimension: int = 0) -> torch.Tensor:
    """The sum over ``axis_name``, each member keeping its block along
    ``scatter_dimension`` (``jax.lax.psum_scatter(tiled=True)``)."""
    group = _injit_axis(_basics.current_mesh(), axis_name)[0]
    return _reduce_scatter(x, scatter_dimension % x.dim(), group)


def all_to_all_in_jit(x: torch.Tensor, axis_name, split_axis: int,
                      concat_axis: int) -> torch.Tensor:
    """Block ``i`` of ``x`` along ``split_axis`` goes to member ``i``; the
    blocks received are concatenated along ``concat_axis`` in member
    order (``jax.lax.all_to_all(tiled=True)``)."""
    group, n, _ = _injit_axis(_basics.current_mesh(), axis_name)
    blocks = torch.stack(torch.chunk(x, n, dim=split_axis % x.dim()))
    got = _functional().all_to_all_single(blocks.contiguous(), None, None,
                                          group)
    return torch.cat(list(got.unbind(0)), dim=concat_axis % x.dim())


def ppermute(x: torch.Tensor, axis_name, perm) -> torch.Tensor:
    """Member ``src`` sends ``x`` to member ``dst`` for each ``(src,
    dst)`` pair of ``perm``; a member no pair sends to gets zeros
    (``jax.lax.ppermute``). One ``all_to_all_single`` with this member's
    split sizes (``permute_tensor`` takes whole permutations only)."""
    group, n, me = _injit_axis(_basics.current_mesh(), axis_name)
    dst = src = None
    for s, d in perm:
        if int(s) == me:
            dst = int(d)
        if int(d) == me:
            src = int(s)
    return _shift(x.reshape(-1), group, n, dst, src).reshape(x.shape)


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

def _reduce(w, wm, values, op, prescale, postscale) -> List[torch.Tensor]:
    """Fused reduction of ``values``, in input order: per dtype one flat
    buffer on the world's device (fp32 for half types), one wire call, the
    combined scale, then split back to each input's device and dtype."""
    if op == ReduceOp.ADASUM:
        from .adasum import adasum_eager
        return adasum_eager(w, values, wm, prescale, postscale)
    out: List[Optional[torch.Tensor]] = [None] * len(values)
    by_dtype = {}
    for i, v in enumerate(values):
        by_dtype.setdefault(v.dtype, []).append(i)
    for dt, idxs in by_dtype.items():
        scale = _combined_scale(op, wm.num_procs, prescale, postscale, dt)
        acc = torch.float32 if dt in _HALF else dt
        flat = torch.cat([values[i].detach().reshape(-1).to(w.device, acc)
                          for i in idxs])
        dist.all_reduce(flat, op=_WIRE_OP[op], group=wm.group)
        COUNTS["allreduce"] += 1
        if scale != 1.0:
            flat.mul_(scale)
        off = 0
        for i in idxs:
            v = values[i]
            n = v.numel()
            piece = flat[off:off + n].view(v.shape)
            out[i] = piece if acc == dt and v.device == flat.device \
                else piece.to(v.device, dt)
            off += n
    return out


def _allreduce_submit(tensors, grouped, average, name, op, prescale,
                      postscale, process_set) -> int:
    op = _resolve_op(average, op)
    kind = "grouped_allreduce" if grouped else "allreduce"
    scope = _injit_route(process_set)
    if scope is not None:
        outs = _injit_allreduce(list(tensors), op, prescale, postscale,
                                scope)
        _injit_count(kind)
        return _InjitHandle(outs if grouped else outs[0])
    w = _world()
    wm = _mesh(w, process_set)
    ts = [_input(w, t) for t in tensors]
    # scale validity depends only on (op, factors, dtype): misuse raises
    # at the call site
    for dt in {t.dtype for t in ts}:
        _combined_scale(op, wm.num_procs, prescale, postscale, dt)
    name = name or _auto_name(w, kind)
    h = w.tensor_table.begin(name, kind)
    shapes = tuple(tuple(t.shape) for t in ts)
    dtypes = tuple(t.dtype for t in ts)
    if grouped:
        span = _record_round(w, (kind, name, shapes, dtypes, op.value,
                                 prescale, postscale), process_set)
    else:
        span = _record_round(w, (kind, name, shapes[0], dtypes[0], op.value,
                                 prescale, postscale), process_set)
    # join state at submit: a collective submitted before join() carries
    # real data even if the dispatcher runs it after
    joined_at_submit = w.joined

    def check():
        if grouped:
            wire_dtypes = tuple(dtype_str(d) for d in dtypes)
            return _check_consistency(
                w, wm, name, (len(ts),), "grouped", kind,
                extra=lambda: f"{shapes}|{wire_dtypes}|{op.value}")
        return _check_consistency(w, wm, name, shapes[0], dtypes[0], kind,
                                  op.value)

    def run():
        vals = [torch.zeros_like(t) for t in ts] if joined_at_submit else ts
        outs = _reduce(w, wm, vals, op, prescale, postscale)
        return outs if grouped else outs[0]
    return _submit(w, h, kind, ts, check, run, span)


def allreduce_async(tensor, average=None, name: Optional[str] = None,
                    op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, process_set=None) -> int:
    """Returns a handle at once; the reduction runs on the dispatcher
    thread."""
    return _allreduce_submit([tensor], False, average, name, op,
                             prescale_factor, postscale_factor, process_set)


def _differentiable(tensor) -> bool:
    return isinstance(tensor, torch.Tensor) and tensor.requires_grad \
        and torch.is_grad_enabled()


def _allreduce_compressed(tensor, op, prescale, postscale, name,
                          process_set, compression):
    compressed, cctx = compression.compress(tensor)
    out = synchronize(allreduce_async(
        compressed, name=name, op=op, prescale_factor=prescale,
        postscale_factor=postscale, process_set=process_set))
    return compression.decompress(out, cctx)


class _AllreduceFn(torch.autograd.Function):
    """allreduce's gradient is the same allreduce of the upstream
    gradient: same op, same scales, same compression (reference:
    torch/mpi_ops.py:144-157)."""

    @staticmethod
    def forward(ctx, tensor, op, prescale, postscale, name, process_set,
                compression):
        ctx.args = (op, prescale, postscale, process_set, compression)
        return _allreduce_compressed(tensor.detach(), op, prescale,
                                     postscale, name, process_set,
                                     compression)

    @staticmethod
    def backward(ctx, grad):
        op, pre, post, process_set, compression = ctx.args
        return (_allreduce_compressed(grad, op, pre, post, None,
                                      process_set, compression),
                None, None, None, None, None, None)


def allreduce(tensor, average=None, name: Optional[str] = None,
              op: Optional[ReduceOp] = None, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0, process_set=None,
              compression=Compression.none) -> torch.Tensor:
    """Synchronous allreduce (reference: torch/mpi_ops.py:158-224).
    ``average`` is the legacy boolean knob; ``op`` takes precedence.
    ``compression`` casts the wire data and back (e.g.
    ``Compression.bf16``). Differentiable: on a tensor that requires grad
    (with grad mode on) the result has a ``grad_fn``, and the gradient
    is the same allreduce of the upstream gradient."""
    op = _resolve_op(average, op)
    if _differentiable(tensor):
        return _AllreduceFn.apply(tensor, op, prescale_factor,
                                  postscale_factor, name, process_set,
                                  compression)
    return _allreduce_compressed(tensor, op, prescale_factor,
                                 postscale_factor, name, process_set,
                                 compression)


def allreduce_async_(tensor: torch.Tensor, average=None,
                     name: Optional[str] = None,
                     op: Optional[ReduceOp] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     process_set=None) -> int:
    """Async in-place allreduce: ``synchronize(handle)`` writes the
    reduced value into ``tensor`` and returns that same object
    (reference: torch/mpi_ops.py allreduce_async_). The handle holds
    ``tensor`` until then, so a temporary wrapper over live storage
    (``p.grad.data``) still receives the write. Do not change ``tensor``
    before synchronize."""
    hid = allreduce_async(tensor, average=average, name=name, op=op,
                          prescale_factor=prescale_factor,
                          postscale_factor=postscale_factor,
                          process_set=process_set)
    return _set_target(hid, tensor)


def allreduce_(tensor: torch.Tensor, average=None,
               name: Optional[str] = None, op: Optional[ReduceOp] = None,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               process_set=None) -> torch.Tensor:
    """In-place allreduce: ``tensor`` holds the reduced value on return,
    and is returned (reference: torch/mpi_ops.py:225-253)."""
    return synchronize(allreduce_async_(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set))


def grouped_allreduce_async(tensors: Sequence, average=None,
                            name: Optional[str] = None,
                            op: Optional[ReduceOp] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set=None) -> int:
    """Fused async allreduce: ONE dispatcher job and ONE handle for the
    group; ``synchronize(handle)`` returns the reduced tensors in input
    order (reference: grouped_allreduce_async_, torch/mpi_ops.py)."""
    return _allreduce_submit(list(tensors), True, average, name, op,
                             prescale_factor, postscale_factor, process_set)


def grouped_allreduce(tensors: Sequence, average=None,
                      name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set=None) -> List[torch.Tensor]:
    """Fused allreduce of several tensors (reference: grouped_allreduce,
    torch/mpi_ops.py:202-260)."""
    return synchronize(grouped_allreduce_async(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set))


# ---------------------------------------------------------------------------
# allgather
# ---------------------------------------------------------------------------

def _allgather(w, wm, t: torch.Tensor) -> torch.Tensor:
    """Concatenation of every member's rows along dim 0, first dims free
    to differ: exchange the first dims, pad to the largest, all-gather,
    trim. A 0-d tensor counts as one row."""
    rows = t.detach().reshape((t.shape[0] if t.dim() else 1,)
                              + tuple(t.shape[1:]))
    dim0, rest = rows.shape[0], tuple(rows.shape[1:])
    n = wm.num_procs
    sizes = [dim0] if n == 1 else [s for (s,) in _exchange_ints(w, wm,
                                                                 [dim0])]
    maxd = max(sizes)
    padded = torch.empty((maxd,) + rest, dtype=t.dtype, device=w.device)
    padded[:dim0].copy_(rows)
    padded[dim0:].zero_()
    out = torch.empty((n * maxd,) + rest, dtype=t.dtype, device=w.device)
    if out.numel():
        _all_gather_single(out, padded, wm.group)
        COUNTS["allgather"] += 1
    if any(s != maxd for s in sizes):
        out = torch.cat([out[i * maxd:i * maxd + s]
                         for i, s in enumerate(sizes)])
    return out.to(t.device)


def allgather_async(tensor, name: Optional[str] = None,
                    process_set=None) -> int:
    scope = _injit_route(process_set)
    if scope is not None:
        out = _injit_allgather(tensor, scope)
        _injit_count("allgather")
        return _InjitHandle(out)
    w = _world()
    wm = _mesh(w, process_set)
    t = _input(w, tensor)
    name = name or _auto_name(w, "allgather")
    h = w.tensor_table.begin(name, "allgather")
    span = _record_round(w, ("allgather", name, tuple(t.shape), t.dtype),
                         process_set)

    def check():
        # only non-first dims must match across processes
        return _check_consistency(w, wm, name, t.shape[1:], t.dtype,
                                  "allgather")
    return _submit(w, h, "allgather", [t], check,
                   lambda: _allgather(w, wm, t), span)


class _AllgatherFn(torch.autograd.Function):
    """allgather's gradient: a sum-allreduce of the upstream gradient,
    narrowed to this process's rows, whose offset comes from an
    allgather of every process's first dim (ragged first dims allowed;
    reference: torch/mpi_ops.py:290-308)."""

    @staticmethod
    def forward(ctx, tensor, name, process_set):
        ctx.was_scalar = tensor.dim() == 0
        ctx.dim0 = int(tensor.shape[0]) if tensor.dim() else 1
        ctx.process_set = process_set
        return synchronize(allgather_async(tensor.detach(), name=name,
                                           process_set=process_set))

    @staticmethod
    def backward(ctx, grad):
        return (allgather_grad(grad, ctx.dim0, ctx.was_scalar,
                               ctx.process_set), None, None)


def allgather_grad(grad: torch.Tensor, dim0: int, was_scalar: bool = False,
                   process_set=None) -> torch.Tensor:
    """The gradient of an allgather of ``dim0`` rows (a 0-d input when
    ``was_scalar``): the sum-allreduce of the upstream ``grad``, narrowed
    to this process's rows. Shared by the autograd Function and the
    framework frontends' gradients."""
    reduced = allreduce(grad, op=Sum, process_set=process_set)
    if reduced.dim() == 0:
        return reduced
    dims = allgather(torch.tensor([dim0], dtype=torch.int64),
                     process_set=process_set)
    me = _mesh(_world(), process_set).my_index
    offset = int(dims[:me].sum())
    piece = reduced[offset:offset + dim0]
    if was_scalar:
        piece = piece.reshape(())
    return piece


def allgather(tensor, name: Optional[str] = None,
              process_set=None) -> torch.Tensor:
    """Concatenate each process's tensor along dim 0 (reference:
    torch/mpi_ops.py:310-343). First dims may differ across processes;
    other dims must match. Differentiable like the reference (in a
    compiled graph through the in-graph gather's own gradient)."""
    if _differentiable(tensor) and not torch.compiler.is_compiling():
        return _AllgatherFn.apply(tensor, name, process_set)
    return synchronize(allgather_async(tensor, name=name,
                                       process_set=process_set))


# ---------------------------------------------------------------------------
# broadcast
# ---------------------------------------------------------------------------

def _broadcast_flat(w, wm, tensors, root_rank) -> List[torch.Tensor]:
    """Root's values of ``tensors``: one flat buffer and one wire call
    per dtype, split back to each input's device."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dt, idxs in by_dtype.items():
        flat = torch.cat([tensors[i].detach().reshape(-1).to(w.device)
                          for i in idxs])
        dist.broadcast(flat, src=wm.global_rank(root_rank), group=wm.group)
        COUNTS["broadcast"] += 1
        off = 0
        for i in idxs:
            t = tensors[i]
            n = t.numel()
            out[i] = flat[off:off + n].view(t.shape).to(t.device)
            off += n
    return out


def broadcast_async(tensor, root_rank: int, name: Optional[str] = None,
                    process_set=None) -> int:
    scope = _injit_route(process_set)
    if scope is not None:
        out = _injit_broadcast(tensor, root_rank, scope)
        _injit_count("broadcast")
        return _InjitHandle(out)
    w = _world()
    wm = _mesh(w, process_set)
    _check_root(wm, root_rank)
    t = _input(w, tensor)
    name = name or _auto_name(w, "broadcast")
    h = w.tensor_table.begin(name, "broadcast")
    span = _record_round(w, ("broadcast", name, tuple(t.shape), t.dtype,
                             root_rank), process_set)

    def check():
        return _check_consistency(w, wm, name, t.shape, t.dtype, "broadcast",
                                  str(root_rank))

    def run():
        buf = _on_device(w, t)
        dist.broadcast(buf, src=wm.global_rank(root_rank), group=wm.group)
        COUNTS["broadcast"] += 1
        return buf.to(t.device)
    return _submit(w, h, "broadcast", [t], check, run, span)


class _BroadcastFn(torch.autograd.Function):
    """broadcast's gradient: a sum-allreduce of the upstream gradient,
    kept at the root and zero on every other process (reference:
    torch/mpi_ops.py:375-389)."""

    @staticmethod
    def forward(ctx, tensor, root_rank, name, process_set):
        ctx.root_rank = root_rank
        ctx.process_set = process_set
        return synchronize(broadcast_async(tensor.detach(), root_rank,
                                           name=name,
                                           process_set=process_set))

    @staticmethod
    def backward(ctx, grad):
        return (broadcast_grad(grad, ctx.root_rank, ctx.process_set),
                None, None, None)


def broadcast_grad(grad: torch.Tensor, root_rank: int,
                   process_set=None) -> torch.Tensor:
    """The gradient of a broadcast from ``root_rank``: the sum-allreduce
    of the upstream ``grad`` at the root, zero on every other process."""
    reduced = allreduce(grad, op=Sum, process_set=process_set)
    if _mesh(_world(), process_set).my_index != root_rank:
        reduced = torch.zeros_like(reduced)
    return reduced


def broadcast(tensor, root_rank: int, name: Optional[str] = None,
              process_set=None) -> torch.Tensor:
    """Every process receives root's value (reference:
    torch/mpi_ops.py:345-389); the input is left as it is.
    Differentiable like the reference (in a compiled graph through the
    in-graph gather's own gradient)."""
    if _differentiable(tensor) and not torch.compiler.is_compiling():
        return _BroadcastFn.apply(tensor, root_rank, name, process_set)
    return synchronize(broadcast_async(tensor, root_rank, name=name,
                                       process_set=process_set))


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None, process_set=None) -> int:
    """Async in-place broadcast: ``synchronize(handle)`` writes root's
    value into ``tensor`` and returns that same object (reference:
    torch/mpi_ops.py broadcast_async_)."""
    hid = broadcast_async(tensor, root_rank, name=name,
                          process_set=process_set)
    return _set_target(hid, tensor)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None,
               process_set=None) -> torch.Tensor:
    """In-place broadcast from ``root_rank``; returns ``tensor``. It has
    no async form, so it runs through the dispatcher's ``run_sync``."""
    if torch.compiler.is_compiling():
        return synchronize(broadcast_async_(tensor, root_rank, name=name,
                                            process_set=process_set))
    w = _world()
    wm = _mesh(w, process_set)
    _check_root(wm, root_rank)
    _input(w, tensor)
    name = name or _auto_name(w, "broadcast")
    h = w.tensor_table.begin(name, "broadcast")
    span = None
    try:
        span = _record_round(w, ("broadcast", name, tuple(tensor.shape),
                                 tensor.dtype, root_rank), process_set)
        order = _stream_order(w)
        tl = w.timeline
        tl.start(name, "broadcast")

        def run():
            _check_consistency(w, wm, name, tensor.shape, tensor.dtype,
                               "broadcast", str(root_rank))
            if order is not None:
                order.enter([tensor])
            tl.activity_start(name, _tl.wire_activity(w.backend,
                                                      "broadcast"))
            src = wm.global_rank(root_rank)
            with torch.no_grad():
                if tensor.device == w.device and tensor.is_contiguous():
                    dist.broadcast(tensor, src=src, group=wm.group)
                else:
                    buf = _on_device(w, tensor)
                    dist.broadcast(buf, src=src, group=wm.group)
                    tensor.copy_(buf)
            COUNTS["broadcast"] += 1
            tl.activity_end(name)
            tl.end(name)
            if order is not None:
                order.leave()
        _dispatcher(w).run_sync(_observed(w, "broadcast", _nbytes([tensor]),
                                          run))
        if order is not None:
            order.land([tensor])
    finally:
        if span is not None:
            span.__exit__(None, None, None)
        w.tensor_table.finish(h)
    return tensor


def grouped_broadcast_async(tensors: Sequence, root_rank: int,
                            name: Optional[str] = None,
                            process_set=None) -> int:
    """One dispatcher job and one handle broadcasting a tensor list from
    ``root_rank``; ``synchronize`` returns the list in input order."""
    scope = _injit_route(process_set)
    if scope is not None:
        outs = [_injit_broadcast(t, root_rank, scope) for t in tensors]
        _injit_count("grouped_broadcast")
        return _InjitHandle(outs)
    w = _world()
    wm = _mesh(w, process_set)
    _check_root(wm, root_rank)
    ts = [_input(w, t) for t in tensors]
    name = name or _auto_name(w, "grouped_broadcast")
    h = w.tensor_table.begin(name, "grouped_broadcast")
    shapes = tuple(tuple(t.shape) for t in ts)
    dtypes = tuple(t.dtype for t in ts)
    span = _record_round(w, ("grouped_broadcast", name, shapes, dtypes,
                             root_rank), process_set)

    def check():
        wire_dtypes = tuple(dtype_str(d) for d in dtypes)
        return _check_consistency(
            w, wm, name, (len(ts),), "grouped", "grouped_broadcast",
            extra=lambda: f"{shapes}|{wire_dtypes}|{root_rank}")
    return _submit(w, h, "grouped_broadcast", ts, check,
                   lambda: _broadcast_flat(w, wm, ts, root_rank), span)


def grouped_broadcast(tensors: Sequence, root_rank: int,
                      name: Optional[str] = None,
                      process_set=None) -> List[torch.Tensor]:
    """Fused broadcast of several tensors in one dispatch."""
    return synchronize(grouped_broadcast_async(
        tensors, root_rank, name=name, process_set=process_set))


# ---------------------------------------------------------------------------
# alltoall
# ---------------------------------------------------------------------------

def alltoall_async(tensor, splits=None, name: Optional[str] = None,
                   process_set=None) -> int:
    scope = _injit_route(process_set)
    if scope is not None:
        out = _injit_alltoall(tensor, splits, scope)
        _injit_count("alltoall")
        return _InjitHandle(out)
    w = _world()
    wm = _mesh(w, process_set)
    nproc = wm.num_procs
    t = _input(w, tensor)
    if t.dim() == 0:
        raise ValueError("alltoall needs a tensor with a first dimension")
    if splits is None:
        if t.shape[0] % nproc != 0:
            raise ValueError(
                f"alltoall tensor first dim {t.shape[0]} not "
                f"divisible by world size {nproc}; pass explicit splits")
        splits = [t.shape[0] // nproc] * nproc
    splits = [int(s) for s in splits]
    if len(splits) != nproc or sum(splits) != t.shape[0] \
            or min(splits) < 0:
        raise ValueError("splits must have one entry per process and sum "
                         "to the tensor's first dimension")
    name = name or _auto_name(w, "alltoall")
    h = w.tensor_table.begin(name, "alltoall")
    span = _record_round(w, ("alltoall", name, tuple(t.shape), t.dtype,
                             tuple(splits)), process_set)

    def check():
        # splits are per-process data (alltoallv), not metadata
        return _check_consistency(w, wm, name, t.shape[1:], t.dtype,
                                  "alltoall")

    def run():
        table = [splits] if nproc == 1 else _exchange_ints(w, wm, splits)
        incoming = [row[wm.my_index] for row in table]
        src = t if t.device == w.device and t.is_contiguous() \
            else _on_device(w, t)
        out = torch.empty((sum(incoming),) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=w.device)
        dist.all_to_all_single(out, src, output_split_sizes=incoming,
                               input_split_sizes=splits, group=wm.group)
        COUNTS["alltoall"] += 1
        return out.to(t.device)
    return _submit(w, h, "alltoall", [t], check, run, span)


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set=None) -> torch.Tensor:
    """Scatter slices of ``tensor`` to every process and gather the
    received slices, concatenated along dim 0. ``splits`` (one entry per
    process) gives the rows sent to each; the default is an even split."""
    return synchronize(alltoall_async(tensor, splits=splits, name=name,
                                      process_set=process_set))


# ---------------------------------------------------------------------------
# handles (reference: torch/mpi_ops.py poll/synchronize)
# ---------------------------------------------------------------------------

def _wait(w, h: Handle) -> None:
    """Wait for the dispatcher to finish ``h``, raising StallError once
    the stall inspector's shutdown deadline is hit."""
    while not h.event.wait(timeout=0.05):
        w.stall_inspector.check_shutdown()


def _set_target(handle, tensor):
    """Make ``handle``'s synchronize write its result into ``tensor``
    (the in-place verbs); returns the handle."""
    if isinstance(handle, _InjitHandle):
        handle.target = tensor
    else:
        _world().tensor_table.get(handle).target = tensor
    return handle


def poll(handle: int) -> bool:
    """True when the collective behind ``handle`` has completed, on the
    device included (reference: torch/mpi_ops.py:476-485)."""
    if isinstance(handle, _InjitHandle):
        return True
    h = _world().tensor_table.get(handle)
    if not h.event.is_set():
        return False  # still queued or running on the dispatcher
    if h.error is not None or h.order is None:
        return True
    return h.order.done.query()


def release(handle: int) -> None:
    """Drop a COMPLETED handle without consuming its result; an in-flight
    one is left alone (finishing it early would free its name for reuse
    while the dispatcher still runs it)."""
    if isinstance(handle, _InjitHandle):
        return
    w = _world()
    try:
        h = w.tensor_table.get(handle)
    except ValueError:
        return
    if poll(handle):
        w.tensor_table.finish(h)


def synchronize(handle: int):
    """Wait for the collective behind ``handle`` and return its result: a
    tensor, or the list of a grouped call's tensors (reference:
    torch/mpi_ops.py:487-499). On the card it returns once the caller's
    current stream is ordered after the result, without waiting for the
    device; the host wait for the dispatcher honours the stall deadline."""
    if isinstance(handle, _InjitHandle):
        return handle.land()
    w = _world()
    h = w.tensor_table.get(handle)
    try:
        _wait(w, h)
        if h.error is not None:
            raise h.error
        r = h.result
        if h.order is not None:
            h.order.land(r if isinstance(r, list) else [r])
        if h.target is not None:
            # an in-place verb (allreduce_async_, broadcast_async_)
            with torch.no_grad():
                h.target.copy_(r)
            r = h.target
        return r
    finally:
        w.tensor_table.finish(h)


# ---------------------------------------------------------------------------
# Join: uneven-data termination (reference Join op, operations.cc:942-966),
# as the JAX package's round protocol:
#
# * join-aware loops (DistributedOptimizer.step, or join_round() by hand)
#   issue one round-marker allreduce a step, in which every process
#   contributes 1 if it still has data;
# * every submission is recorded in the round log (in a world of more than
#   one process: a world of one has nobody to replay for);
# * join() flips this process to zero contributions and REPLAYS its last
#   recorded round in lockstep with the active processes until the marker
#   reports that no process has data.
#
# This assumes the same collectives every round, as training loops submit.
# ---------------------------------------------------------------------------

_JOIN_ROUND_NAME = "hvd.join.round"


def _wire_entry(entry) -> tuple:
    """``entry`` with torch dtypes written as the JAX package writes them
    (``float32``), so both packages' ledgers hash one sequence of verbs
    alike."""
    def conv(x):
        if isinstance(x, torch.dtype):
            return dtype_str(x)
        if isinstance(x, tuple):
            return tuple(conv(y) for y in x)
        return x
    return tuple(conv(x) for x in entry)


def _record_round(w, entry, pset=None):
    """Record a submission; returns its entered trace span, or None."""
    # schedule ledger first (HVD_TPU_SCHEDULE_CHECK, _schedule.py): the
    # join markers are part of the cross-rank schedule even though the
    # replay log below excludes them; then the tracer (HVD_TPU_TRACE_SAMPLE
    # or a profiler, tracing.py). Both are a global load and an is-None
    # test when off.
    _sched.record(_wire_entry(entry), pset)
    span = _tracing.collective(entry)
    if w.size > 1 and not entry[1].startswith(("hvd.join.",
                                               "horovod_tpu.join.")):
        w.join_round_log.append(entry)
    return span


def join_round() -> int:
    """Round marker for cooperative Join: returns how many processes still
    have data. Training wrappers call it once per step; custom loops that
    want Join semantics must do the same."""
    global HOST_SYNCS
    w = _world()
    if w.world_mesh.num_procs == 1:
        return 0 if w.joined else 1
    me = torch.full((1,), 0.0 if w.joined else 1.0, device=w.device)
    if not w.joined:
        w.join_active_rounds += 1
    out = allreduce(me, op=ReduceOp.SUM, name=_JOIN_ROUND_NAME)
    # what was submitted since the last marker is one full round: the
    # replay script for join()
    w.join_last_round = w.join_round_log
    w.join_round_log = []
    HOST_SYNCS += 1
    with _tracing.span("host.sync", {"what": "join marker"}):
        return int(round(float(out[0])))


def _replay_round(w, entries) -> None:
    """Re-issue one round's collectives with zero or empty contributions
    (the reference's zero-tensor substitution for joined ranks)."""
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=w.device)
    for e in entries:
        kind = e[0]
        if kind == "allreduce":
            _, name, shape, dtype, opv, pre, post = e
            allreduce(zeros(shape, dtype), op=ReduceOp(opv), name=name,
                      prescale_factor=pre, postscale_factor=post)
        elif kind == "grouped_allreduce":
            _, name, shapes, dtypes, opv, pre, post = e
            grouped_allreduce([zeros(s, d) for s, d in zip(shapes, dtypes)],
                              op=ReduceOp(opv), name=name,
                              prescale_factor=pre, postscale_factor=post)
        elif kind == "allgather":
            _, name, shape, dtype = e
            # zero rows: this process contributes nothing to the gather
            allgather(zeros((0,) + tuple(shape[1:]), dtype), name=name)
        elif kind == "broadcast":
            _, name, shape, dtype, root = e
            broadcast(zeros(shape, dtype), root_rank=root, name=name)
        elif kind == "grouped_broadcast":
            _, name, shapes, dtypes, root = e
            grouped_broadcast([zeros(s, d) for s, d in zip(shapes, dtypes)],
                              root_rank=root, name=name)
        elif kind == "alltoall":
            _, name, shape, dtype, splits = e
            alltoall(zeros(shape, dtype), splits=splits, name=name)


def join(device: int = -1) -> int:
    """Block until every process has joined; this process contributes
    zeros to every collective issued meanwhile. Returns the rank that
    joined last. Needs a join-aware loop (one ``join_round()`` a step; the
    DistributedOptimizer does it in a world of more than one process)."""
    w = _world()
    already = w.joined
    w.joined = True
    if w.world_mesh.num_procs > 1 and not already:
        replay = list(w.join_last_round)
        # lockstep with the active processes: one replayed round and one
        # marker per round of theirs, until nobody has data
        while True:
            _replay_round(w, replay)
            if join_round() == 0:
                break
    # the last to join stayed active for the most rounds (every process
    # leaves the loop in the same round)
    rounds = torch.tensor([float(w.join_active_rounds)],
                          dtype=torch.float64, device=w.device)
    counts = allgather(rounds, name="horovod_tpu.join.ts")
    return int(torch.argmax(counts).item())


def joined() -> bool:
    return _world().joined


def barrier() -> None:
    """Host barrier across processes (an allreduce of one zero, as in the
    JAX package)."""
    allreduce(torch.zeros(1), op=Sum, name="horovod_tpu_torch.barrier")
