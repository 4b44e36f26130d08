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
"""

import logging
import threading
import time
from typing import Dict

from . import _locks
from . import config as _config
from .exceptions import StallError

_log = logging.getLogger("horovod_tpu_torch")


class StallInspector:
    def __init__(self, world):
        self._cfg = world.config
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
            raise StallError(
                "horovod_tpu_torch: collective stalled beyond "
                "HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS; shutting down.")

    def _loop(self):
        warn_after = self._cfg.get(_config.STALL_CHECK_TIME_SECONDS)
        shutdown_after = self._cfg.get(_config.STALL_SHUTDOWN_TIME_SECONDS)
        poll = min(max(warn_after / 4.0, 0.25), 10.0)
        while not self._stop_evt.wait(poll):
            for name in self._scan(warn_after, shutdown_after):
                _log.warning(
                    "One or more collectives stalled for over %.0fs: %s. "
                    "This may indicate that a peer process is down or a "
                    "different subset of collectives was submitted on "
                    "another process.", warn_after, name)

    def _scan(self, warn_after, shutdown_after):
        """One inspection pass: returns the newly stalled names and sets
        the shutdown flag when a pending entry is past the deadline."""
        if self._stopped:
            return []
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
