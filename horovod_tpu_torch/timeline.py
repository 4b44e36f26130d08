"""Chrome-tracing timeline of horovod_tpu_torch (counterpart of
``horovod_tpu/timeline.py``).

The analogue of the reference Timeline (horovod/common/timeline.{h,cc}): a
writer thread drains a record queue and streams chrome://tracing JSON.
When the native runtime loads, the writer thread, the timestamps and the
formatting are C++ (``_native/csrc/timeline.cc``), as in the JAX
package; under ``HVD_TPU_NATIVE=0`` :class:`RecordWriter` does the same
job. Only RecordWriter bounds its queue (``HVD_TPU_TIMELINE_QUEUE_EVENTS``)
and counts its drops (``hvd_tpu_timeline_dropped_total``): the native
writer's queue is unbounded, so on the default path a disk slower than
the emit rate costs memory, not records. The per-tensor state machine
(timeline.h:77-99) is kept for the host side of every eager collective:
the verb opens a top-level span on the tensor's lane when it is
submitted (``ALLREDUCE``, ``GROUPED_ALLREDUCE``, ...) and the dispatcher
thread opens and closes the wire activity inside it. The event sequence
is the JAX package's, event for event, but for one thing: the port
closes the top-level span after the wire activity, which the JAX package
leaves open (ROADMAP C).

Wire activities are named after the backend the call really took, as
Horovod names its own (``NCCL_ALLREDUCE``, ``MPI_ALLREDUCE``, ...): the
JAX package's ``XLA_<VERB>`` becomes ``NCCL_<VERB>`` for a world on the
card and ``GLOO_<VERB>`` for a world on the CPU, where ``<VERB>`` is
``ALLREDUCE`` (allreduce, grouped allreduce, Adasum), ``ALLGATHER``,
``BROADCAST`` (broadcast, grouped broadcast) or ``ALLTOALL``
(:func:`wire_activity`). The host activity names of the reference
(``QUEUE``, ``FUSE``, ``DISPATCH``, ``WAIT_FOR_DATA``,
``MEMCPY_IN_FUSION_BUFFER``, ``MEMCPY_OUT_FUSION_BUFFER``, ``NEGOTIATE``)
are kept as constants for callers that mark those phases.

Device side: :meth:`Timeline.start_torch_trace` captures a
``torch.profiler`` session (CPU ops and the CUDA kernels) whose exported
Chrome trace is spliced into the timeline file at :meth:`Timeline.close`,
device processes moved to ``pid + DEVICE_PID_OFFSET`` and every event
shifted onto the timeline's clock through two ``record_function`` markers,
one after the session starts and one before it stops, whose host times
are bounded from below (the profiler's export has its own time base).
The host times are read on the clock of the writer that stamps the file:
the native writer's own (``hvd_tl_now_us``) or ``perf_counter`` from the
Timeline's creation.

Enable with ``HVD_TPU_TIMELINE=<file>`` (alias ``HOROVOD_TIMELINE``); only
process 0 writes (reference: operations.cc:407-415).
"""

import json
import os
import queue
import threading
import time
from typing import Dict, Optional

from . import config as _config
from . import metrics as _metrics
from ._native import get as _native_get

# The observability layer observes itself: emission volume is how an
# operator notices a timeline silently eating disk (or silently dead).
_M_TL_EVENTS = _metrics.counter(
    "hvd_tpu_timeline_events_total",
    "Chrome-tracing events emitted by the timeline writer.")
_M_TL_DROPPED = _metrics.counter(
    "hvd_tpu_timeline_dropped_total",
    "Records dropped because the bounded timeline/tracer writer queue "
    "was full (HVD_TPU_TIMELINE_QUEUE_EVENTS) — the disk is slower "
    "than the emit rate, or dead.")

# Host-side activity names, mirroring the reference's
# (horovod/common/common.h:31-59).
QUEUE = "QUEUE"
FUSE = "FUSE"
DISPATCH = "DISPATCH"
WAIT_FOR_DATA = "WAIT_FOR_DATA"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
NEGOTIATE = "NEGOTIATE"

#: the wire verb of each collective verb
_WIRE_VERB = {"allreduce": "ALLREDUCE", "grouped_allreduce": "ALLREDUCE",
              "adasum": "ALLREDUCE", "allgather": "ALLGATHER",
              "broadcast": "BROADCAST", "grouped_broadcast": "BROADCAST",
              "alltoall": "ALLTOALL"}

#: names of the record_function markers that align a profiler session:
#: one entered right after the session starts, one right before it stops
SYNC_MARKER = "hvd_tpu_timeline_sync"
SYNC_END_MARKER = "hvd_tpu_timeline_sync_end"

#: pid offset separating spliced device-trace processes from the host
#: timeline's pid 0 lanes in the merged Chrome trace
DEVICE_PID_OFFSET = 10000


def wire_activity(backend: str, verb: str) -> str:
    """The wire activity of ``verb`` on ``backend`` ("nccl" or "gloo"):
    ``NCCL_ALLREDUCE``, ``GLOO_BROADCAST``, ..."""
    return f"{backend.upper()}_{_WIRE_VERB[verb]}"


class RecordWriter:
    """Bounded-queue background writer shared by the Timeline and the
    request tracer (tracing.py). ``mode="chrome"`` streams a
    chrome-tracing JSON array (comma-terminated records, tolerant of a
    missing ``]`` on abnormal exit); ``mode="jsonl"`` writes one JSON
    object per line. ``put`` never blocks: past the bound
    (``HVD_TPU_TIMELINE_QUEUE_EVENTS``) records are dropped and counted
    in ``hvd_tpu_timeline_dropped_total``: a slow or dead disk must cost
    trace completeness, never memory or the emitting thread."""

    def __init__(self, path: str, mode: str = "chrome",
                 maxsize: Optional[int] = None):
        if maxsize is None:
            maxsize = int(_config.live_config().get(
                _config.TIMELINE_QUEUE_EVENTS))
        self._path = path
        self._mode = mode
        self._q: "queue.Queue[Optional[dict]]" = queue.Queue(
            maxsize=max(0, maxsize))
        self._thread = threading.Thread(
            target=self._drain, name="hvd_tpu_record_writer", daemon=True)
        self._thread.start()

    def put(self, record: dict) -> bool:
        """Enqueue one record; False (and a drop count) when full."""
        try:
            self._q.put_nowait(record)
            return True
        except queue.Full:
            _M_TL_DROPPED.inc()
            return False

    def _drain(self):
        # Stream records to disk as they arrive (reference: timeline.cc
        # writer thread appends continuously) so the trace survives
        # abnormal exit. Chrome tracing's JSON-array format tolerates a
        # missing ']'; jsonl is line-framed and needs no closer.
        chrome = self._mode == "chrome"
        with open(self._path, "w") as f:
            if chrome:
                f.write("[\n")
            n = 0
            while True:
                rec = self._q.get()
                if rec is None:
                    break
                f.write(json.dumps(rec))
                f.write(",\n" if chrome else "\n")
                n += 1
                if n % 50 == 0 or self._q.empty():
                    f.flush()
            if chrome:
                f.write("{}]\n")

    def close(self, timeout: float = 10.0) -> bool:
        """Stop the writer; True when it drained and exited in time. The
        close sentinel waits for queue room (a full queue must not lose
        the shutdown), bounded by the same timeout."""
        deadline = time.monotonic() + timeout
        try:
            self._q.put(None, timeout=timeout)
        except queue.Full:
            return False
        self._thread.join(timeout=max(0.0, deadline - time.monotonic()))
        return not self._thread.is_alive()


class Timeline:
    """Thread-safe chrome-tracing writer; every public method is cheap
    once closed. When the native runtime loads, formatting, timestamps and
    the writer thread live in C++ and this class maps the per-tensor state
    machine onto native emit calls; otherwise :class:`RecordWriter` is the
    writer."""

    def __init__(self, path: str, mark_cycles: bool = False):
        self._path = path
        self._mark_cycles = mark_cycles
        self._tids = {}
        self._next_tid = 1
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._closed = False
        self._nat = _native_get()
        self._h = None
        # serializes native calls against close(), which frees the C++
        # object: no emitter may be inside a call on it then
        self._native_lock = threading.Lock()
        if self._nat is not None:
            self._h = self._nat.cdll.hvd_tl_create(path.encode())
        self._w = None
        if self._h is None:
            self._nat = None
            self._w = RecordWriter(path, mode="chrome")
        self._profiler = None
        #: (exported profiler trace, {marker name: host time in us at
        #: which it was about to be entered})
        self._torch_traces = []

    @property
    def enabled(self) -> bool:
        return not self._closed

    def _now_us(self) -> float:
        """Microseconds on the clock that stamps this file's events."""
        if self._h is not None:
            with self._native_lock:
                if self._h is not None:
                    return float(self._nat.cdll.hvd_tl_now_us(self._h))
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self, tensor_name: str) -> int:
        if self._h is not None:
            with self._native_lock:
                if self._h is None:
                    return 0
                return int(self._nat.cdll.hvd_tl_tid(
                    self._h, tensor_name.encode()))
        with self._lock:
            tid = self._tids.get(tensor_name)
            if tid is None:
                tid = self._next_tid
                self._next_tid += 1
                self._tids[tensor_name] = tid
                self._w.put({"name": "thread_name", "ph": "M", "pid": 0,
                             "tid": tid, "args": {"name": tensor_name}})
            return tid

    def _emit(self, name, ph, tensor_name, args=None, tid=None):
        if self._closed:
            return
        _M_TL_EVENTS.inc()
        if tid is None:
            tid = self._tid(tensor_name)
        if self._h is not None:
            with self._native_lock:
                if self._h is None:
                    return
                self._nat.cdll.hvd_tl_emit(
                    self._h, name.encode(), ph.encode(), tid,
                    json.dumps(args).encode() if args else None)
            return
        ev = {"name": name, "ph": ph, "pid": 0, "tid": tid,
              "ts": self._now_us()}
        if args:
            ev["args"] = args
        self._w.put(ev)

    # -- per-tensor lifecycle (reference: timeline.h:77-99) ------------------
    def negotiate_start(self, tensor_name: str, op_name: str):
        self._emit(NEGOTIATE + "_" + op_name.upper(), "B", tensor_name)

    def negotiate_rank_ready(self, tensor_name: str, rank: int):
        self._emit("RANK_READY", "i", tensor_name, {"rank": rank})

    def negotiate_end(self, tensor_name: str):
        self._emit("NEGOTIATE", "E", tensor_name)

    def start(self, tensor_name: str, op_name: str, nbytes: int = 0):
        self._emit(op_name.upper(), "B", tensor_name,
                   {"bytes": nbytes} if nbytes else None)

    def activity_start(self, tensor_name: str, activity: str):
        self._emit(activity, "B", tensor_name)

    def activity_end(self, tensor_name: str):
        # chrome tracing closes the innermost open B for this tid
        self._emit("", "E", tensor_name)

    def end(self, tensor_name: str):
        self.activity_end(tensor_name)

    def mark_cycle(self):
        if not self._mark_cycles or self._closed:
            return
        if self._h is not None:
            self._emit("CYCLE", "i", None, tid=0)
            return
        _M_TL_EVENTS.inc()
        self._w.put({"name": "CYCLE", "ph": "i", "pid": 0, "tid": 0,
                     "ts": self._now_us(), "s": "g"})

    # -- device side: splice in a torch.profiler session ---------------------
    def _enter_marker(self, name: str) -> float:
        """Enter and leave a ``record_function`` marker; returns this
        timeline's clock read just before it. The profiler stamps the
        marker later than that read, by as much as the thread waited in
        between (for the interpreter lock, under load, milliseconds), so
        the read bounds the marker's host time from below only."""
        from torch.profiler import record_function
        before = self._now_us()
        with record_function(name):
            pass
        return before

    def start_torch_trace(self, logdir: str):
        """Capture a ``torch.profiler`` session (CPU ops and CUDA kernels)
        whose events are spliced into this timeline file at close();
        counterpart of the JAX package's ``Timeline.start_jax_trace``,
        which captures an XLA device trace. Right after the session
        starts, a ``record_function`` marker (:data:`SYNC_MARKER`) is
        entered, and :meth:`stop_torch_trace` enters a second one
        (:data:`SYNC_END_MARKER`) right before the session stops; the
        splice shifts the session's events onto this timeline's clock
        from the two (the profiler's export has its own time base)."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
        self._profiler = (prof, logdir,
                          {SYNC_MARKER: self._enter_marker(SYNC_MARKER)})

    def stop_torch_trace(self) -> str:
        """Stop the session of :meth:`start_torch_trace` and export its
        Chrome trace into its logdir; returns the file's path. Counterpart
        of ``Timeline.stop_jax_trace``."""
        import torch
        prof, logdir, markers = self._profiler
        self._profiler = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        markers[SYNC_END_MARKER] = self._enter_marker(SYNC_END_MARKER)
        prof.stop()
        path = os.path.join(logdir,
                            f"torch_trace_{len(self._torch_traces)}.json")
        prof.export_chrome_trace(path)
        self._torch_traces.append((path, markers))
        return path

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._profiler is not None:
            self.stop_torch_trace()
        if self._h is not None:
            with self._native_lock:
                h, self._h = self._h, None
            self._nat.cdll.hvd_tl_close(h)   # drains and joins the writer
        elif not self._w.close(timeout=10):
            # a backlogged writer still owns the file handle; splicing
            # would interleave two writers into an unparseable trace:
            # keep the host-only file intact instead
            import logging
            logging.getLogger("horovod_tpu_torch").warning(
                "timeline: writer thread still draining at close; "
                "skipping device-trace splice to avoid corrupting %s",
                self._path)
            return
        # the splice happens at the FILE level after the writer finishes:
        # profiler events carry past timestamps the stamp-now emit path
        # cannot represent
        for trace_path, markers in self._torch_traces:
            try:
                splice_torch_trace(self._path, trace_path, markers)
            except Exception as e:  # a bad trace must not eat the timeline
                import logging
                logging.getLogger("horovod_tpu_torch").warning(
                    "timeline: could not splice device trace from %s: %s",
                    trace_path, e)


class _NullTimeline:
    enabled = False

    def __getattr__(self, name):
        return lambda *a, **k: None

    def close(self):
        pass


NULL_TIMELINE = _NullTimeline()


def maybe_start_timeline(world) -> object:
    """A Timeline on process 0 when ``HVD_TPU_TIMELINE`` names a file,
    else :data:`NULL_TIMELINE`."""
    path = world.config.get(_config.TIMELINE)
    if not path or world.rank != 0:
        return NULL_TIMELINE
    return Timeline(path, world.config.get(_config.TIMELINE_MARK_CYCLES))


def _read_events(path: str) -> list:
    """The events of a streamed JSON-array file (tolerant of a missing
    ``]``) or of a ``{"traceEvents": [...]}`` document."""
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("{"):
        return [e for e in json.loads(text).get("traceEvents", []) if e]
    if not text.endswith("]"):
        text = text.rstrip(",\n ") + "\n]"
    return [e for e in json.loads(text) if e]


def splice_torch_trace(timeline_path: str, trace_path: str,
                       markers: Dict[str, float]) -> int:
    """Merge an exported ``torch.profiler`` Chrome trace into a written
    host timeline file; counterpart of the JAX package's
    ``splice_jax_trace``, which merges an XLA profiler session.

    The profiler's events keep their process/thread structure but move to
    ``pid + DEVICE_PID_OFFSET`` (the card's kernels, on pid = device
    index, and the profiled CPU ops, on the OS pid) so they render as
    separate lanes. ``markers`` maps a marker's name (:data:`SYNC_MARKER`,
    :data:`SYNC_END_MARKER`) to a host time, in us on the timeline's
    clock, read just before the marker was entered. Each marker found in
    the trace bounds the shift from the profiler's clock to the host's
    from below (host time minus the marker's own timestamp), and the
    splice shifts by the largest of these bounds: the tightest one that
    places no event later than the host could have seen it. Returns the
    number of spliced events (0 when the trace holds no marker or no
    event)."""
    events = _read_events(trace_path)
    bounds = []
    for name, host_us in markers.items():
        stamps = [float(e["ts"]) for e in events if e.get("name") == name
                  and e.get("ph") == "X"]
        if stamps:
            bounds.append(host_us - min(stamps))
    if not bounds:
        return 0
    shift = max(bounds)
    device_events = []
    for ev in events:
        ev = dict(ev)
        if "pid" in ev:
            try:
                ev["pid"] = int(ev["pid"]) + DEVICE_PID_OFFSET
            except (TypeError, ValueError):
                # the profiler's session-wide markers carry pid ""
                ev["pid"] = DEVICE_PID_OFFSET
        if "ts" in ev:
            ev["ts"] = float(ev["ts"]) + shift
        device_events.append(ev)
    host = _read_events(timeline_path)
    with open(timeline_path, "w") as f:
        f.write("[\n")
        for ev in host + device_events:
            f.write(json.dumps(ev))
            f.write(",\n")
        f.write("{}]\n")
    return len(device_events)


_PROFILER = None


def start_torch_profiler(logdir: str) -> None:
    """Capture a ``torch.profiler`` session (CPU ops and CUDA kernels)
    alongside the host timeline; counterpart of the JAX package's
    ``start_jax_profiler``. :func:`stop_torch_profiler` writes its Chrome
    trace into ``logdir``."""
    global _PROFILER
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    _PROFILER = (prof, logdir)


def stop_torch_profiler() -> str:
    """Stop :func:`start_torch_profiler`'s session and export its Chrome
    trace; returns the file's path. Counterpart of ``stop_jax_profiler``."""
    global _PROFILER
    import torch
    prof, logdir = _PROFILER
    _PROFILER = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(logdir, "torch_trace.json")
    prof.export_chrome_trace(path)
    return path
