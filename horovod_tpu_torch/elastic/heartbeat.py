"""Host-plane heartbeat/liveness layer for elastic jobs.

The reference (and the fault-injection hardening) detects worker death
two ways: the launcher's per-worker runner observes the process *exit*,
or the data plane times out a peer inside a collective (in the port, the
process group's wire-call bound, ``basics.wire_timeout``). Neither covers
a worker that is silently wedged — process alive, not participating, not
exiting — which otherwise stalls the job until the stall-inspector
shutdown deadline (870s-scale) fires.

This module closes that gap with a third signal that needs no data-plane
cooperation:

* :class:`HeartbeatSender` (worker side) PUTs a per-rank beat to the
  rendezvous KV store (scope ``heartbeat``, key ``hostname:local_rank``)
  every ``HVD_TPU_HEARTBEAT_INTERVAL`` seconds. Beats ride the same
  KV channel as registration, so they also keep the client's coordinator-
  epoch view fresh (a restarted coordinator is noticed within one
  interval, triggering re-registration).
* :class:`HeartbeatMonitor` (driver side) records each beat's *receipt*
  time — launcher clock only, so worker clock skew cannot misdeclare —
  and declares a slot dead after ``HVD_TPU_HEARTBEAT_TIMEOUT`` seconds of
  silence. Declaration fires the host's change event, which kills the
  wedged worker process through the existing watcher, whose nonzero exit
  then drives the normal FAILURE -> blacklist -> re-rendezvous flow. No
  new recovery machinery: the monitor only converts silence into the
  signal the recovery path already understands.

A slot is only armed once its first beat arrives and tracking is cleared
on every generation reset and worker exit, so slow startups, resets and
already-recorded failures are never declared dead.

Chaos site ``heartbeat.miss``: fired on the worker's send path; an
injected error suppresses the beat (the wedged-worker simulation the
fault-spec grammar can schedule deterministically).
"""

import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from .. import _locks
from .. import config as _config
from .. import faults as _faults
from .. import metrics as _metrics

log = logging.getLogger("horovod_tpu_torch.elastic")

HEARTBEAT_SCOPE = "heartbeat"

_FP_MISS = _faults.FaultPoint("heartbeat.miss",
                              exc=_faults.InjectedTransientFault)

_M_MISSES = _metrics.counter(
    "hvd_tpu_heartbeat_misses_total",
    "Workers declared dead by the driver's heartbeat monitor (no beat "
    "within HVD_TPU_HEARTBEAT_TIMEOUT), by last-known rank.",
    labels=("rank",))


def heartbeat_key(hostname: str, local_rank) -> str:
    return f"{hostname}:{local_rank}"


class HeartbeatSender:
    """Worker-side beat loop (daemon thread).

    ``client`` is a KVStoreClient; beats are strictly best-effort — a
    failed PUT is skipped, not retried beyond the client's own policy,
    because the next interval is a retry by construction and a beat that
    arrives late is worse than one that is simply missing.
    """

    def __init__(self, client, hostname: str, local_rank, rank,
                 interval: Optional[float] = None,
                 key: Optional[str] = None):
        self._client = client
        # key= overrides the elastic host:slot scheme — the serving
        # fleet reuses this loop with opaque replica-id keys
        self._key = key if key is not None else heartbeat_key(
            hostname, local_rank)
        self._rank = rank
        self._interval = interval if interval is not None else float(
            _config.Config().get(_config.HEARTBEAT_INTERVAL))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._interval <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="hvd-heartbeat-sender", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2)

    def beat_once(self) -> bool:
        """One beat; True when it reached the store."""
        try:
            _FP_MISS.fire()
            self._client.put(HEARTBEAT_SCOPE, self._key,
                             str(self._rank).encode())
            return True
        except Exception:
            # includes injected heartbeat.miss faults: a wedged worker
            # doesn't log its own wedging either
            log.debug("elastic: heartbeat for %s not delivered", self._key,
                      exc_info=True)
            return False

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.beat_once()
            self._stop.wait(self._interval)


class LivenessMonitor:
    """Generic armed-then-silent liveness bookkeeping over opaque keys.

    The mechanism the elastic driver trusts — a key is *armed* by its
    first beat, *declared dead* after ``timeout`` seconds of beat
    silence (receipt clock only, so sender clock skew cannot
    misdeclare), declared exactly once, never declared before arming —
    with nothing elastic-specific in it, so the serving fleet's router
    can reuse it for replica liveness with replica-id keys.

    ``on_dead(key, meta)`` runs on the monitor thread (or a direct
    :meth:`check_now` caller) for each declaration; ``meta`` is whatever
    string the last :meth:`observe` recorded. Unlike the elastic flow —
    where death is terminal for the process and re-arming means a fresh
    worker — a declared key is remembered in a dead-set, and when its
    beats *resume* the optional ``on_alive(key)`` callback fires
    (the router's re-admission signal).

    ``timeout`` is clamped to at least 2x ``poll_interval`` so a single
    dropped beat can never declare a healthy sender; detection latency
    is bounded by timeout + poll < 2x timeout.
    """

    def __init__(self, on_dead: Callable[[str, str], None],
                 timeout: float, poll_interval: float,
                 on_alive: Optional[Callable[[str], None]] = None,
                 label: str = "liveness",
                 thread_name: str = "hvd-liveness-monitor"):
        self._on_dead_key = on_dead
        self._on_alive = on_alive
        self._label = label
        self._thread_name = thread_name
        self._timeout = float(timeout)
        self._poll = max(0.05, float(poll_interval))
        # A timeout at or below the beat interval would declare perfectly
        # healthy senders dead between beats — clamp to 2x the interval so
        # a single dropped beat never triggers a declaration either.
        floor = 2.0 * self._poll
        if 0 < self._timeout < floor:
            log.warning(
                "%s: heartbeat timeout (%.1fs) is below 2x the beat "
                "interval; clamping to %.1fs",
                self._label, self._timeout, floor)
            self._timeout = floor
        self._lock = _locks.lock("heartbeat.LivenessMonitor._lock")
        #: key -> (last receipt monotonic, last reported meta)
        self._beats: Dict[str, Tuple[float, str]] = {}
        #: keys declared dead whose next beat is a recovery, not an arming
        self._dead_keys: Dict[str, bool] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def timeout(self) -> float:
        return self._timeout

    def start(self) -> None:
        if self._timeout <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=self._thread_name, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2)

    # -- bookkeeping ---------------------------------------------------------
    def observe_key(self, key: str, meta: str = "?") -> None:
        """Record a beat's receipt for ``key``; fires ``on_alive`` when
        the key was previously declared dead."""
        with self._lock:
            self._beats[key] = (time.monotonic(), meta)
            revived = self._dead_keys.pop(key, None) is not None
        if revived and self._on_alive is not None:
            log.info("%s: beats from %s resumed", self._label, key)
            try:
                self._on_alive(key)
            except Exception:
                log.exception("%s: recovery handler failed for %s",
                              self._label, key)

    def forget_key(self, key: str) -> None:
        """Drop a key (its sender left on purpose — silence is now
        expected and a later return is a fresh arming, not a recovery)."""
        with self._lock:
            self._beats.pop(key, None)
            self._dead_keys.pop(key, None)

    def reset(self) -> None:
        """New generation: nothing already observed still applies."""
        with self._lock:
            self._beats.clear()
            self._dead_keys.clear()

    def key_age(self, key: str) -> Optional[float]:
        with self._lock:
            entry = self._beats.get(key)
        return None if entry is None else time.monotonic() - entry[0]

    # -- declaration ---------------------------------------------------------
    def check_now(self) -> None:
        """One declaration sweep (the thread loop body; callable directly
        from tests for deterministic timing)."""
        now = time.monotonic()
        with self._lock:
            dead = [(key, meta) for key, (t, meta) in self._beats.items()
                    if now - t > self._timeout]
            for key, _meta in dead:
                del self._beats[key]
                self._dead_keys[key] = True
        for key, meta in dead:
            try:
                self._declare_dead(key, meta)
            except Exception:
                log.exception("%s: death handler failed for %s",
                              self._label, key)

    def _declare_dead(self, key: str, meta: str) -> None:
        self._on_dead_key(key, meta)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self._poll)
            if self._stop.is_set():
                return
            self.check_now()


class HeartbeatMonitor(LivenessMonitor):
    """Driver-side liveness bookkeeping + declaration thread.

    ``on_dead(host, slot, rank)`` runs on the monitor thread when a slot
    armed by a first beat goes silent past the timeout. The driver passes
    a callback that fires the host event (kill -> exit -> FAILURE ->
    blacklist), keeping recovery single-pathed.

    This is the elastic skin over :class:`LivenessMonitor`: keys are
    ``hostname:local_rank``, metadata is the worker's reported rank
    (labels the miss counter), and defaults come from the
    ``HVD_TPU_HEARTBEAT_TIMEOUT`` / ``HVD_TPU_HEARTBEAT_INTERVAL``
    knobs.
    """

    def __init__(self, on_dead: Callable[[str, int, str], None],
                 timeout: Optional[float] = None,
                 poll_interval: Optional[float] = None):
        cfg = _config.Config()
        self._on_dead = on_dead
        if timeout is None:
            timeout = float(cfg.get(_config.HEARTBEAT_TIMEOUT))
        # poll at the beat interval: detection latency is then bounded by
        # timeout + interval < 2 x timeout for any sane interval
        if poll_interval is None:
            poll_interval = max(
                0.1, float(cfg.get(_config.HEARTBEAT_INTERVAL)))
        super().__init__(on_dead=self._unused_, timeout=timeout,
                         poll_interval=poll_interval, label="elastic",
                         thread_name="hvd-heartbeat-monitor")

    @staticmethod
    def _unused_(key: str, meta: str) -> None:  # _declare_dead overrides
        raise AssertionError("unreachable")

    # -- bookkeeping (driver/rendezvous callbacks) ---------------------------
    def observe(self, key: str, value: bytes) -> None:
        """Record a beat's receipt (wired as the ``heartbeat`` scope's PUT
        handler). The key is ``hostname:local_rank``; the value is the
        worker's rank, used only to label the miss counter."""
        host, _, local_rank = key.rpartition(":")
        try:
            int(local_rank)
        except ValueError:
            return
        rank = value.decode(errors="replace") if value else "?"
        self.observe_key(heartbeat_key(host, int(local_rank)), meta=rank)

    def forget(self, host: str, slot: int) -> None:
        """Drop a slot (its worker exited — silence is now expected)."""
        self.forget_key(heartbeat_key(host, slot))

    def last_beat_age(self, host: str, slot: int) -> Optional[float]:
        return self.key_age(heartbeat_key(host, slot))

    # -- declaration ---------------------------------------------------------
    def _declare_dead(self, key: str, meta: str) -> None:
        host, _, local_rank = key.rpartition(":")
        slot, rank = int(local_rank), meta
        _M_MISSES.labels(rank=rank).inc()
        log.warning(
            "elastic: no heartbeat from %s[%s] (rank %s) for more than "
            "%.1fs; declaring it dead and triggering blacklist/"
            "re-rendezvous", host, slot, rank, self._timeout)
        self._on_dead(host, slot, rank)
