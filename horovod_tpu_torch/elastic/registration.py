"""Worker state registry: barriers worker generations through resets.

Reference: horovod/runner/elastic/registration.py.
Every worker generation records READY (re-rendezvoused) / SUCCESS /
FAILURE; a threading.Barrier sized to the world fires the transition
action once all are in: stop on any SUCCESS or total failure, otherwise
blacklist failing hosts and resume with a fresh rendezvous. A worker that
recorded READY but later fails resets the barrier so it is not counted
twice.
"""

import logging
import threading
from typing import Optional, Set, Tuple

from .. import metrics as _metrics

#: Recovery activity, launcher-side: dashboards watch the blacklist gauge
#: climb and the restart counter (elastic/run.py) tick to see a job
#: surviving failures — neither is visible from any single worker.
_M_BLACKLISTED = _metrics.gauge(
    "hvd_tpu_elastic_blacklisted_hosts",
    "Hosts currently blacklisted after worker failures.")

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"

RESET_LIMIT_EXCEEDED_MESSAGE = (
    "Exceeded the permitted number of elastic resets ({}); terminating the "
    "job. A reset limit typically guards against thrashing clusters; raise "
    "--reset-limit if frequent membership changes are expected.")

log = logging.getLogger("horovod_tpu_torch.elastic")


class WorkerStateRegistry:
    def __init__(self, driver, host_manager, reset_limit: Optional[int] = None):
        self._driver = driver
        self._host_manager = host_manager
        self._reset_limit = reset_limit
        self._reset_count = 0
        self._lock = threading.Lock()
        self._states: dict = {}
        self._by_state: dict = {READY: set(), SUCCESS: set(), FAILURE: set()}
        self._failure_order: list = []   # ((host, slot), exit_ts, arrival_i)
        self._barrier: Optional[threading.Barrier] = None
        self._rendezvous_id = 0
        self._size = 0

    # -- introspection ------------------------------------------------------
    def get(self, state: str) -> Set[Tuple[str, int]]:
        return self._by_state.setdefault(state, set())

    def count(self, state: str) -> int:
        return len(self.get(state))

    def recorded_slots(self):
        return self._states.keys()

    def size(self) -> int:
        return self._size

    def last_rendezvous(self) -> int:
        return self._rendezvous_id

    # -- lifecycle ----------------------------------------------------------
    def reset(self, size: int) -> None:
        with self._lock:
            self._states.clear()
            for s in self._by_state.values():
                s.clear()
            self._failure_order.clear()
            self._barrier = threading.Barrier(parties=size,
                                              action=self._on_all_recorded)
            self._rendezvous_id += 1
            self._size = size

    def record_ready(self, host: str, slot: int) -> int:
        return self._record(host, slot, READY)

    def record_success(self, host: str, slot: int) -> int:
        return self._record(host, slot, SUCCESS)

    def record_failure(self, host: str, slot: int,
                       timestamp: Optional[float] = None) -> int:
        return self._record(host, slot, FAILURE, timestamp=timestamp)

    def _record(self, host: str, slot: int, state: str,
                timestamp: Optional[float] = None) -> int:
        if self._driver.finished():
            return self._rendezvous_id
        if self._host_manager.is_blacklisted(host):
            return self._rendezvous_id

        key = (host, slot)
        with self._lock:
            prior = self._states.get(key)
            if prior is not None:
                if state == FAILURE and prior != FAILURE:
                    # The READY thread for this worker is already parked at
                    # the barrier; reset it so the worker is counted once.
                    log.info("elastic: %s[%s] %s -> FAILURE, resetting "
                             "barrier", host, slot, prior)
                    self._barrier.reset()
                else:
                    # Duplicate record (e.g. a retried rendezvous GET):
                    # do NOT wait at the barrier again or the party count
                    # would be inflated and the generation would hang.
                    log.debug("elastic: ignoring duplicate state %s for "
                              "%s[%s] (have %s)", state, host, slot, prior)
                    return self._rendezvous_id
            self._states[key] = state
            self.get(state).add(key)
            if state == FAILURE:
                # (A duplicate FAILURE for this key early-returned above,
                # so each key appears at most once.) Record the worker-
                # reported exit timestamp alongside the arrival index:
                # record ARRIVAL order is not causal order (a slow
                # notification path can invert it), but exit timestamps
                # are captured at wait() by the per-worker runner threads
                # on the launcher host, so they share a clock and order
                # causally — the cascade-root heuristic sorts on them.
                self._failure_order.append(
                    (key, timestamp if timestamp is not None
                     else float("inf"), len(self._failure_order)))
            rid = self._rendezvous_id

        return self._wait(key, state, rid)

    def _wait(self, key, state, rendezvous_id: int) -> int:
        while True:
            try:
                self._barrier.wait()
                return rendezvous_id
            except threading.BrokenBarrierError:
                if self._barrier.broken:
                    raise
                with self._lock:
                    rendezvous_id = self._rendezvous_id
                    saved = self._states.get(key, state)
                    if saved != state:
                        raise RuntimeError(
                            f"elastic worker state {state} overridden by "
                            f"{saved}") from None

    def _blacklist(self, host: str) -> None:
        # Through the driver when it has the persistent path (rendezvous-
        # journaled blacklist survives coordinator restarts); the plain
        # host-manager call keeps driver-less unit doubles working.
        if hasattr(self._driver, "blacklist_host"):
            self._driver.blacklist_host(host)
        else:
            self._host_manager.blacklist(host)

    # -- barrier action (runs on the last arriving thread) -------------------
    def _on_all_recorded(self):
        if self.count(SUCCESS) > 0:
            log.info("elastic: %d worker(s) succeeded; stopping job",
                     self.count(SUCCESS))
            self._driver.stop()
            return
        respawn_all = False
        if self.count(FAILURE) == self._size:
            # Total loss of the generation. A single hard worker death can
            # take down every peer: survivors block in a collective until
            # the data plane gives up on the dead peer (NCCL's watchdog
            # ends the process at the wire-call bound; the JAX package's
            # coordination service does the same at its heartbeat).
            # "All failed" therefore does NOT mean every host is bad —
            # the root cause is the FIRST recorded failure (peers die a
            # wire-call bound later).
            # Blacklist only the root host and respawn the remainder; a
            # genuinely-broken job converges anyway (one blacklist per
            # generation until min_np is unreachable or reset_limit hits).
            # Root = earliest worker-reported exit timestamp (arrival
            # index breaks ties and covers records without a timestamp).
            ordered = sorted(self._failure_order,
                             key=lambda e: (e[1], e[2]))
            root = ordered[0][0] if ordered else None
            survivors = [h for h, _ in self.recorded_slots()
                         if root is not None and h != root[0]
                         and not self._host_manager.is_blacklisted(h)]
            if root is None or not survivors:
                log.error("elastic: all %d workers failed with no "
                          "surviving host; stopping job", self._size)
                self._driver.stop(error_message=(
                    f"all {self._size} elastic worker(s) failed and no "
                    "healthy host remains to recover on; terminating the "
                    "job. Check the per-worker logs for the root failure."))
                return
            log.warning(
                "elastic: all %d workers failed; treating as a cascade "
                "rooted at %s[%s] (first failure) — blacklisting %s and "
                "respawning the surviving hosts %s",
                self._size, root[0], root[1], root[0], survivors)
            self._blacklist(root[0])
            respawn_all = True
        else:
            for host, _slot in self.get(FAILURE):
                self._blacklist(host)
        _M_BLACKLISTED.set(self._host_manager.blacklisted_count())
        if all(self._host_manager.is_blacklisted(h)
               for h, _ in self.recorded_slots()):
            log.error("elastic: every active host is blacklisted; stopping")
            self._driver.stop(error_message=(
                "every host in the job has been blacklisted after worker "
                "failures; no host remains to run on. Terminating the job."))
            return
        if self._reset_limit is not None \
                and self._reset_count >= self._reset_limit:
            self._driver.stop(error_message=RESET_LIMIT_EXCEEDED_MESSAGE
                              .format(self._reset_limit))
            return
        try:
            self._reset_count += 1
            self._driver.resume(respawn_all=respawn_all)
        except Exception as e:
            log.exception("elastic: failed to resume with new hosts")
            # Without an error message a job whose every worker died before
            # finishing would report success (empty worker_results).
            self._driver.stop(error_message=(
                f"elastic job could not form a new generation after worker "
                f"failures: {e}"))
