"""Stall inspector (counterpart of ``horovod_tpu/stall.py``, its
pure-Python table).

Tracks when each named collective was submitted and logs a warning when
one has waited longer than ``HVD_TPU_STALL_CHECK_TIME_SECONDS`` (default
60 s). With ``HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS`` > 0, a collective
pending past that deadline makes ``synchronize()`` raise
:class:`~horovod_tpu_torch.exceptions.StallError` on the waiting thread
(reference: stall_inspector.h:75-80). A stall here is a collective whose
dispatch never finished: a peer that never submitted it, so the
consistency exchange or the gloo collective waits on the host.

The inspector reports into the metrics (``hvd_tpu_stall_warnings_total``,
``hvd_tpu_stall_shutdowns_total``), keeps this rank's schedule ledger
published while a collective blocks (:func:`._schedule.flush_local`), and
names in its warnings and in the StallError the first mismatched call
site across ranks (:func:`._schedule.divergence_hint`, with
``HVD_TPU_SCHEDULE_CHECK``) and the request that was in flight
(:func:`.tracing.last_request_id`).
"""

import logging
import threading
import time
from typing import Dict

from . import _locks
from . import _schedule
from . import config as _config
from . import metrics as _metrics
from . import tracing as _tracing
from .exceptions import StallError

_log = logging.getLogger("horovod_tpu_torch")

# The stall subsystem reports its own events into the metrics, so an alert
# can fire on a stall long before anyone reads the rank logs.
_M_STALL_WARNINGS = _metrics.counter(
    "hvd_tpu_stall_warnings_total",
    "Collectives that exceeded the stall warning deadline "
    "(HVD_TPU_STALL_CHECK_TIME_SECONDS).")
_M_STALL_SHUTDOWNS = _metrics.counter(
    "hvd_tpu_stall_shutdowns_total",
    "Stall shutdown deadlines hit (StallError raised to waiters).")


class StallInspector:
    def __init__(self, world):
        self._cfg = world.config
        self._world = world
        #: the last schedule-ledger diagnosis: set by the poll thread on a
        #: stall, appended to warnings and to the StallError; cleared when
        #: the episode resolves and refreshed when older than the warn
        #: deadline, so a transient stall's hint never labels a later one
        self._divergence_hint = ""
        self._hint_time = 0.0
        self._lock = _locks.lock("stall.StallInspector._lock")
        self._pending: Dict[str, float] = {}
        self._warned: Dict[str, bool] = {}
        self._stop_evt = threading.Event()
        self._shutdown_deadline_hit = False
        self._stopped = False
        self._thread = None
        if not self._cfg.get(_config.STALL_CHECK_DISABLE):
            self._thread = threading.Thread(
                target=self._loop, name="hvd_tpu_torch_stall", daemon=True)
            self._thread.start()

    def record_submit(self, name: str):
        if self._stopped:
            return
        with self._lock:
            self._pending.setdefault(name, time.monotonic())

    def record_done(self, name: str):
        if self._stopped:
            return
        with self._lock:
            self._pending.pop(name, None)
            self._warned.pop(name, None)

    def check_shutdown(self):
        """Called from synchronize(); raises once the shutdown deadline
        was hit."""
        if self._shutdown_deadline_hit:
            from . import basics
            basics.mark_failed()
            if not self._divergence_hint:
                # cache the diagnosis so N waiter threads hitting the
                # deadline pay one cross-rank KV sweep, not one each
                self._divergence_hint = _schedule.divergence_hint(
                    self._world)
                self._hint_time = time.monotonic()
                if self._divergence_hint:
                    _schedule.note_divergence()
            hint = self._divergence_hint
            rid = _tracing.last_request_id()
            raise StallError(
                "horovod_tpu_torch: collective stalled beyond "
                "HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS; shutting down."
                + (f" {hint}" if hint else "")
                + (f" (request {rid} in flight)" if rid else ""))

    def _loop(self):
        warn_after = self._cfg.get(_config.STALL_CHECK_TIME_SECONDS)
        shutdown_after = self._cfg.get(_config.STALL_SHUTDOWN_TIME_SECONDS)
        poll = min(max(warn_after / 4.0, 0.25), 10.0)
        while not self._stop_evt.wait(poll):
            # keep this rank's ledger visible to its peers while its
            # submitters block in a collective (a no-op when the ledger is
            # off or nothing new was recorded)
            _schedule.flush_local()
            stalled = self._scan(warn_after, shutdown_after)
            now = time.monotonic()
            if stalled:
                if not self._divergence_hint or \
                        now - self._hint_time > warn_after:
                    prior = self._divergence_hint
                    self._divergence_hint = _schedule.divergence_hint(
                        self._world)
                    self._hint_time = now
                    if self._divergence_hint and not prior:
                        _schedule.note_divergence()
            elif self._divergence_hint and \
                    not self._shutdown_deadline_hit and self._quiet():
                self._divergence_hint = ""
            rid = _tracing.last_request_id() if stalled else None
            for name in stalled:
                _M_STALL_WARNINGS.inc()
                _log.warning(
                    "One or more collectives stalled for over %.0fs: %s. "
                    "This may indicate that a peer process is down or a "
                    "different subset of collectives was submitted on "
                    "another process.%s%s", warn_after, name,
                    " " + self._divergence_hint
                    if self._divergence_hint else "",
                    f" (request {rid} in flight)" if rid else "")

    def _quiet(self) -> bool:
        """No collective is still flagged stalled."""
        with self._lock:
            return not self._warned

    def _scan(self, warn_after, shutdown_after):
        """One inspection pass: returns the newly stalled names and sets
        the shutdown flag when a pending entry is past the deadline."""
        if self._stopped:
            return []
        prior_hit = self._shutdown_deadline_hit
        now = time.monotonic()
        newly = []
        with self._lock:
            items = list(self._pending.items())
            for name, t0 in items:
                if now - t0 > warn_after and not self._warned.get(name):
                    self._warned[name] = True
                    newly.append(name)
        hit = shutdown_after > 0 and any(now - t0 > shutdown_after
                                         for _, t0 in items)
        # re-check _stopped: a pass in flight while stop() ran must not
        # re-arm the flag stop() just cleared
        if hit and not self._stopped:
            self._shutdown_deadline_hit = True
        if self._shutdown_deadline_hit and not prior_hit:
            _M_STALL_SHUTDOWNS.inc()
        return newly

    def stop(self):
        """Idempotent teardown, called from ``basics.shutdown()``: stops
        the poll thread and clears the pending, warned and deadline state
        so a later init() starts clean."""
        if self._stopped:
            return
        self._stopped = True
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if not self._thread.is_alive():
                self._thread = None
        with self._lock:
            self._pending.clear()
            self._warned.clear()
        self._shutdown_deadline_hit = False
        self._divergence_hint = ""
