"""Launcher-side elastic driver.

Reference: horovod/runner/elastic/driver.py — ElasticDriver
owns a 1 Hz discovery thread, computes stable host/rank assignments on
membership change, re-publishes them to the rendezvous, notifies the
coordinator (rank-0) worker so it can interrupt training, and (re)spawns
worker processes on newly assigned slots. A copy of
``horovod_tpu/elastic/driver.py``; the mesh plane replans with the port's
``parallel.mesh_utils``. Every reset the workers re-form their process
group in-process (``elastic/run.py``); the driver only manages host
membership.
"""

import json
import logging
import queue
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from .. import config as _config
from .. import metrics as _metrics
from ..runner.hosts import HostInfo, SlotInfo, get_host_assignments
from .discovery import DiscoveredHosts, HostManager
from .heartbeat import HeartbeatMonitor
from ..sdc.report import SDC_SCOPE, decode_report, encode_report
from .preemption import PREEMPT_SCOPE, decode_notice, encode_notice
from .registration import WorkerStateRegistry
from .worker import PUT_WORKER_ADDRESSES, WorkerNotificationClient

#: rendezvous scope persisting blacklisted hostnames — journaled with the
#: rest of the store, so a restarted coordinator does not re-run doomed
#: hosts it already learned about. Values are the blacklist *reason*
#: (b"failure", ...); gracefully-drained hosts are never written here —
#: their durable record lives in the ``preempt`` scope instead, and is
#: deleted when the drain completes.
BLACKLIST_SCOPE = "blacklist"

#: rendezvous scope carrying the driver's current mesh plan (key
#: ``shape`` -> JSON ``{"axes": {...}, "policy": ..., "dropped": N}``).
#: Journaled like the blacklist, so a restarted coordinator resumes the
#: reshaped mesh instead of replanning from the configured one; workers
#: read it on reset (:func:`horovod_tpu_torch.elastic.run.fetch_mesh_shape`)
#: to re-form the survivor mesh.
MESH_SCOPE = "mesh"

# Elastic membership events as counters: a flapping host shows up as a
# climbing add/remove rate on the driver's scrape, which no single worker
# can observe from inside its own generation.
_M_RESETS = _metrics.counter(
    "hvd_tpu_elastic_resets_total",
    "Elastic generation resets (resume() after membership change or "
    "worker failure).")
_M_RANK_ADDED = _metrics.counter(
    "hvd_tpu_elastic_rank_added_total",
    "Worker slots added relative to the previous elastic generation.")
_M_RANK_REMOVED = _metrics.counter(
    "hvd_tpu_elastic_rank_removed_total",
    "Worker slots removed relative to the previous elastic generation.")
_M_PREEMPTIONS = _metrics.counter(
    "hvd_tpu_elastic_preemptions_total",
    "Preemption notices processed by the elastic driver, by outcome: "
    "'drained' (graceful drain completed), 'immediate' (scale-down policy "
    "killed the host instead of draining).",
    labels=("outcome",))
_M_DRAIN_SECONDS = _metrics.histogram(
    "hvd_tpu_elastic_drain_seconds",
    "Wall time from a preemption notice to the drained host leaving the "
    "generation (final commit drained, survivors re-rendezvoused).")
_M_SCALE_EVENTS = _metrics.counter(
    "hvd_tpu_elastic_scale_events_total",
    "Deliberate elastic resizes, by direction: 'up' (debounced growth "
    "into new capacity), 'down' (preemption-notice shrink).",
    labels=("direction",))
_M_MESH_RESHAPES = _metrics.counter(
    "hvd_tpu_elastic_mesh_reshapes_total",
    "Mesh replans taken by the elastic driver's mesh plane "
    "(HVD_TPU_MESH_SHAPE set), by the reshape policy that produced the "
    "new shape ('shrink'/'degrade'/'strict') and the capacity direction "
    "('down' after host loss or drain, 'up' after re-admission). "
    "Launcher-side, like the reset counters.",
    labels=("policy", "direction"))
_M_QUARANTINED = _metrics.gauge(
    "hvd_tpu_sdc_quarantined_hosts",
    "Hosts quarantined for silent data corruption (blacklisted with "
    "reason 'sdc' after repeated guard/fingerprint strikes; persisted "
    "across coordinator restarts).")

DISCOVER_HOSTS_FREQUENCY_SECS = 1.0

log = logging.getLogger("horovod_tpu_torch.elastic")

#: Placeholder returned for (host, slot) pairs with no current assignment.
INVALID_SLOT_INFO = SlotInfo(hostname="", rank=-1, local_rank=-1,
                             cross_rank=-1, size=-1, local_size=-1,
                             cross_size=-1)


class Timeout:
    """Deadline helper (reference runner/common/util/timeout.py)."""

    def __init__(self, seconds: float, message: str):
        self._deadline = time.monotonic() + seconds
        self._message = message

    def remaining(self) -> float:
        return max(0.0, self._deadline - time.monotonic())

    def check(self, activity: str) -> None:
        if time.monotonic() > self._deadline:
            raise TimeoutError(self._message.format(activity=activity))


class Results:
    def __init__(self, error_message: Optional[str],
                 worker_results: Dict[str, Tuple[int, float]]):
        self.error_message = error_message
        self.worker_results = worker_results


class ResultsRecorder:
    """Collects (exit_code, timestamp) per worker of the final generation
    (reference driver.py:44-66)."""

    def __init__(self):
        self._error_message: Optional[str] = None
        self._worker_results: Dict[str, Tuple[int, float]] = {}
        self._threads: "queue.Queue" = queue.Queue()

    def expect(self, worker_thread: threading.Thread) -> None:
        self._threads.put(worker_thread)

    def set_error_message(self, msg: Optional[str]) -> None:
        self._error_message = msg

    def add_result(self, key: str, value: Tuple[int, float]) -> None:
        self._worker_results.setdefault(key, value)

    def get_results(self) -> Results:
        while not self._threads.empty():
            self._threads.get().join()
        return Results(self._error_message, self._worker_results)


class ElasticDriver:
    """Drives elastic membership for one job.

    ``create_worker_fn(slot_info, events) -> (exit_code, timestamp)`` is
    supplied by the launcher (it execs the user command over ssh/local) or
    by tests (a stub). ``events`` are [shutdown_event, host_event]: the
    worker runner should terminate its process when either fires.
    """

    def __init__(self, rendezvous, discovery, min_np: int,
                 max_np: Optional[int] = None,
                 timeout: Optional[float] = None,
                 reset_limit: Optional[int] = None):
        self._rendezvous = rendezvous
        self._discovery = discovery
        self._host_manager = HostManager(discovery)
        self._min_np = min_np
        self._max_np = max_np
        # resolved through the knob registry (HVD_TPU_ELASTIC_TIMEOUT /
        # HOROVOD_ELASTIC_TIMEOUT alias / default) so the launcher-side
        # driver and the documented config table can never disagree
        cfg = _config.Config()
        self._timeout = timeout or float(cfg.get(_config.ELASTIC_TIMEOUT))
        # Policy knobs: growth waits out flapping discovery before a
        # resize; shrink either drains (default) or kills (legacy).
        self._scale_up_delay = float(
            cfg.get(_config.ELASTIC_SCALE_UP_DELAY))
        self._scale_down_policy = str(
            cfg.get(_config.ELASTIC_SCALE_DOWN_POLICY)).strip().lower()
        # Mesh plane: when HVD_TPU_MESH_SHAPE names a parallelism grid,
        # every generation replans it from the survivor count
        # (HVD_TPU_MESH_RESHAPE_POLICY) and publishes the result to the
        # journaled 'mesh' scope for workers to adopt on reset.
        self._mesh_policy = str(
            cfg.get(_config.MESH_RESHAPE_POLICY)).strip().lower()
        self._mesh_config = None
        self._mesh_error: Optional[str] = None
        mesh_spec = str(cfg.get(_config.MESH_SHAPE) or "").strip()
        if mesh_spec:
            from ..parallel import mesh_utils
            self._mesh_config = mesh_utils.mesh_config_from_spec(mesh_spec)
        #: host -> blacklist reason ("failure"/"sdc"/...; "drained" for
        #: graceful departures). Rebuilt from the journaled blacklist
        #: scope on coordinator restart, so re-admission decisions (an
        #: SDC-quarantined host must stay out of a reshaped mesh) never
        #: lose their reason.
        self._blacklist_reasons: Dict[str, str] = {}
        #: host -> {"grace": s, "ts": notice unix time, "start": monotonic}
        #: for in-flight graceful drains (host also flagged in HostManager)
        self._draining: Dict[str, dict] = {}
        #: monotonic time a grow-only membership delta was first seen
        #: (scale-up debounce anchor); None when no growth is pending
        self._scaleup_since: Optional[float] = None

        self._host_assignments: Dict[str, List[SlotInfo]] = {}
        self._rank_assignments: Dict[int, SlotInfo] = {}
        self._world_size = 0

        self._wait_hosts_cond = threading.Condition()
        self._create_worker_fn: Optional[Callable] = None
        self._assignments_callback: Optional[Callable] = None
        self._worker_clients: Dict[Tuple[str, int],
                                   WorkerNotificationClient] = {}

        #: hosts quarantined for SDC this driver lifetime (gauge source;
        #: the durable record is the journaled blacklist scope)
        self._quarantined: set = set()

        self._pending_notice_ts: Optional[float] = None
        self._worker_registry = WorkerStateRegistry(
            self, self._host_manager, reset_limit=reset_limit)
        self._results = ResultsRecorder()
        self._shutdown = threading.Event()

        # Heartbeat liveness: beats observed via the rendezvous PUT handler
        # (elastic/rendezvous.py) feed the monitor; a silent slot past the
        # timeout gets its host event fired, which kills the wedged process
        # and lets the normal exit path drive blacklist + re-rendezvous.
        self._heartbeat_monitor = HeartbeatMonitor(
            on_dead=self._on_heartbeat_timeout)
        self._heartbeat_monitor.start()

        self._discovery_thread = threading.Thread(
            target=self._discover_hosts, name="hvd-elastic-discovery",
            daemon=True)
        self._discovery_thread.start()

    def set_assignments_callback(self, fn: Callable) -> None:
        """``fn(assignment_list)`` runs after each re-assignment has been
        published to the rendezvous — the launcher uses it to publish the
        new generation's coordinator address (its TCP store)."""
        self._assignments_callback = fn

    # -- lifecycle ----------------------------------------------------------
    def start(self, np: int, create_worker_fn: Callable) -> None:
        self._create_worker_fn = create_worker_fn
        self._activate_workers(np)

    def resume(self, respawn_all: bool = False) -> None:
        """Form the next generation. ``respawn_all=True`` means every
        process of the previous generation is known dead (peer-death
        cascade), so every slot of the new generation must be spawned —
        not only slots that were previously unassigned."""
        _M_RESETS.inc()
        self._activate_workers(self._min_np, respawn_all=respawn_all)

    def stop(self, error_message: Optional[str] = None) -> None:
        self._results.set_error_message(error_message)
        self._shutdown.set()
        self._heartbeat_monitor.stop()
        with self._wait_hosts_cond:
            self._wait_hosts_cond.notify_all()
        if self._rendezvous is not None:
            self._rendezvous.stop()
        self._discovery_thread.join(timeout=10)

    def finished(self) -> bool:
        return self._shutdown.is_set()

    def get_results(self) -> Results:
        return self._results.get_results()

    # -- worker notification channel -----------------------------------------
    def register_worker_server(self, host: str, slot: int, addresses,
                               secret_key: bytes) -> None:
        self._worker_clients[(host, slot)] = WorkerNotificationClient(
            addresses, secret_key)

    def get_worker_client(self, slot_info: SlotInfo
                          ) -> Optional[WorkerNotificationClient]:
        return self._worker_clients.get(
            (slot_info.hostname, slot_info.local_rank))

    def record_ready(self, host: str, slot: int) -> None:
        self._worker_registry.record_ready(host, slot)

    # -- liveness / blacklist ------------------------------------------------
    def record_heartbeat(self, key: str, value: bytes) -> None:
        """PUT handler for the ``heartbeat`` scope (elastic/rendezvous.py)."""
        host, _, _ = key.rpartition(":")
        if host and self._host_manager.is_draining(host):
            # A draining host's sender may still be beating through its
            # grace window; observing it would re-arm the slot the drain
            # already forgot, and its eventual (expected) silence would
            # then tick the miss counter and fire a spurious timeout.
            return
        self._heartbeat_monitor.observe(key, value)

    def _on_heartbeat_timeout(self, host: str, slot: int, rank) -> None:
        if self.finished() or not self.has_rank_assignment(host, slot):
            return   # already gone: blacklisted, stale generation, shutdown
        # Fire (don't blacklist): the watcher kills the wedged process, its
        # nonzero exit records FAILURE, and the registry blacklists the
        # host on the barrier — one recovery path for every death signal.
        self._host_manager.fire_host_event(host)

    def blacklist_host(self, host: str, reason: str = "failure") -> None:
        """Exclude ``host`` from assignment, by ``reason``:

        * ``"failure"`` (default, and what the registry's barrier uses):
          hard blacklist, persisted to the journaled ``blacklist`` scope so
          a journal-restarted coordinator re-seeds it instead of re-running
          a host it already knows is bad. Permanent for the job.
        * ``"drained"``: graceful departure — the host is excluded from
          new assignments via the *draining* flag, never written to the
          blacklist scope, and re-admitted when its drain completes and
          discovery reports it again.
        """
        if reason == "drained":
            self._blacklist_reasons.setdefault(host, reason)
            self._host_manager.mark_draining(host)
            return
        self._blacklist_reasons[host] = reason
        self._host_manager.blacklist(host)
        try:
            self._rendezvous.put(BLACKLIST_SCOPE, host, reason.encode())
        except Exception:
            log.debug("elastic: could not persist blacklist entry for %s",
                      host, exc_info=True)

    def blacklist_reason(self, host: str) -> Optional[str]:
        """Why ``host`` was excluded (``failure``/``sdc``/``drained``),
        or None if it never was. Survives coordinator restarts via the
        journaled blacklist scope (:meth:`restore_from_rendezvous`)."""
        return self._blacklist_reasons.get(host)

    def record_preemption_notice(self, host: str, grace: float = 0.0,
                                 ts: Optional[float] = None,
                                 persist: bool = True) -> None:
        """One path in for every preemption producer — the ``preempt``
        fault kind (worker PUT), the HTTP ``preempt`` scope, and
        ``HostDiscovery.find_preempted_hosts`` polling all land here.

        Under the default ``drain`` scale-down policy the host is marked
        draining (excluded from the next generation, never blacklisted,
        heartbeat tracking dropped before its beats stop); the discovery
        loop then owes the coordinator a membership notice and the normal
        re-rendezvous retires the host's workers cleanly. ``immediate``
        policy falls back to the legacy kill path (host event -> nonzero
        exit -> FAILURE -> blacklist). Idempotent per in-flight drain.

        ``persist=False`` is used by the rendezvous PUT handler (the
        notice is already in the journaled store) and by journal restore.
        """
        if self.finished() or self._host_manager.is_blacklisted(host):
            return
        if self._scale_down_policy == "immediate":
            if host in self._host_assignments:
                log.warning("elastic: preemption notice for %s; scale-down "
                            "policy 'immediate' kills it now", host)
                _M_PREEMPTIONS.labels(outcome="immediate").inc()
                _M_SCALE_EVENTS.labels(direction="down").inc()
                self._host_manager.fire_host_event(host)
            return
        with self._wait_hosts_cond:
            if self._host_manager.is_draining(host):
                return  # drain already in flight
            log.warning(
                "elastic: preemption notice for %s (grace=%.1fs); draining "
                "gracefully — excluded from new assignments, not "
                "blacklisted, re-admittable when capacity returns",
                host, grace)
            self._host_manager.mark_draining(host)
            self._draining[host] = {
                "grace": float(grace),
                "ts": float(ts) if ts is not None else time.time(),
                "start": time.monotonic()}
            # Forget the host's heartbeat slots BEFORE their beats stop:
            # the armed-then-silent detector must not declare a clean
            # departure dead (record_heartbeat also drops new beats while
            # the drain is in flight, so the slot cannot re-arm).
            for slot_info in self._host_assignments.get(host, []):
                self._heartbeat_monitor.forget(host, slot_info.local_rank)
            _M_SCALE_EVENTS.labels(direction="down").inc()
            self._wait_hosts_cond.notify_all()
        if persist:
            try:
                self._rendezvous.put(PREEMPT_SCOPE, host,
                                     encode_notice(grace, ts))
            except Exception:
                log.debug("elastic: could not persist preemption notice "
                          "for %s", host, exc_info=True)

    def record_sdc_report(self, host: str, kind: str = "nonfinite",
                          strikes: int = 1, ts: Optional[float] = None,
                          persist: bool = True) -> None:
        """One path in for every SDC quarantine producer — the
        worker-side policy's PUT (``send_sdc_report``, routed through
        the rendezvous ``sdc`` scope handler), an operator's HTTP PUT,
        and journal restore all land here.

        The report already encodes the policy verdict (the worker
        counted ``strikes`` locally-attributed detections inside its
        window), so the reaction is immediate: quarantine the host via
        :meth:`blacklist_host` with ``reason='sdc'`` — which persists
        to the journaled blacklist scope, unlike a graceful drain, so a
        flaky chip stays out across coordinator restarts. Idempotent
        per host.

        ``persist=False`` is used by the rendezvous PUT handler (the
        report is already in the journaled store) and by journal
        restore.
        """
        if self.finished():
            return
        if host in self._quarantined or \
                self._host_manager.is_blacklisted(host):
            self._quarantined.add(host)
            _M_QUARANTINED.set(len(self._quarantined))
            return
        log.warning(
            "elastic: SDC quarantine report for %s (kind=%s, strikes=%d) "
            "— blacklisting with reason 'sdc' (persisted: a corrupting "
            "host stays out across restarts)", host, kind, strikes)
        self._quarantined.add(host)
        _M_QUARANTINED.set(len(self._quarantined))
        self.blacklist_host(host, reason="sdc")
        if persist:
            try:
                self._rendezvous.put(SDC_SCOPE, host,
                                     encode_report(kind, strikes, ts))
            except Exception:
                log.debug("elastic: could not persist SDC report for %s",
                          host, exc_info=True)

    def is_draining(self, host: str) -> bool:
        return self._host_manager.is_draining(host)

    def _complete_drain(self, host: str) -> None:
        """The drained host has left the generation: observe the drain
        latency, count the outcome, clear the draining flag (re-admission
        on the next discovery poll) and retire the journaled notice.
        Idempotent (inline reform detection and the poll sweep can race)."""
        if not self._host_manager.is_draining(host):
            return
        info = self._draining.pop(host, None)
        if info is not None:
            _M_DRAIN_SECONDS.observe(time.monotonic() - info["start"])
        _M_PREEMPTIONS.labels(outcome="drained").inc()
        self._host_manager.clear_draining(host)
        log.warning("elastic: drain of %s complete; host is re-admittable "
                    "when discovery reports it again", host)
        try:
            self._rendezvous.delete(PREEMPT_SCOPE, host)
        except Exception:
            log.debug("elastic: could not retire preemption notice for %s",
                      host, exc_info=True)

    def restore_from_rendezvous(self) -> int:
        """Re-seed driver state from a journal-restored KV store: worker
        notification addresses, the blacklist *with reasons*, in-flight
        preemption drains, and the mesh plan. Called by the launcher
        after ``attach_elastic_handlers`` when the rendezvous came back
        from disk (coordinator hot-restart path); a fresh store holds
        nothing and this is a no-op. Returns the number of re-seeded
        entries.

        Reasons matter across a restart that also changes the mesh: an
        SDC-quarantined host must stay quarantined (not degrade to a
        generic failure that a later operator unblacklist would
        re-admit into the reshaped mesh), so the blacklist scope's
        *values* are decoded, not just its keys."""
        import pickle

        count = 0
        for host, blob in self._rendezvous.items(BLACKLIST_SCOPE).items():
            try:
                reason = bytes(blob).decode().strip() or "failure"
            except Exception:
                reason = "failure"
            self._blacklist_reasons.setdefault(host, reason)
            if reason == "sdc" and host not in self._quarantined:
                self._quarantined.add(host)
                _M_QUARANTINED.set(len(self._quarantined))
            if not self._host_manager.is_blacklisted(host):
                self._host_manager.blacklist(host)
                count += 1
        # The mesh plan survives with the blacklist: the restarted
        # coordinator must resume the *reshaped* mesh, not replan from
        # the configured shape as if nothing had been lost.
        mesh_blob = self._rendezvous.items(MESH_SCOPE).get("shape")
        if mesh_blob:
            try:
                from ..parallel import mesh_utils
                axes = json.loads(bytes(mesh_blob).decode()).get("axes", {})
                self._mesh_config = mesh_utils.MeshConfig(**{
                    a: int(v) for a, v in axes.items()
                    if a in mesh_utils.AXIS_ORDER})
                count += 1
            except Exception:
                log.warning("elastic: stale mesh-shape entry not restored",
                            exc_info=True)
        # Drains survive a coordinator restart: the preempt scope is
        # journaled, so a notice recorded before the crash keeps its host
        # out of the restarted coordinator's first generation too.
        for host, blob in self._rendezvous.items(PREEMPT_SCOPE).items():
            if not self._host_manager.is_draining(host):
                grace, ts = decode_notice(blob)
                self.record_preemption_notice(host, grace, ts=ts,
                                              persist=False)
                count += 1
        # SDC quarantines re-seed twice over — the blacklist scope above
        # already re-excluded the host; replaying the sdc scope restores
        # the quarantine bookkeeping (gauge + reason) behind it.
        for host, blob in self._rendezvous.items(SDC_SCOPE).items():
            if host not in self._quarantined:
                kind, strikes, ts = decode_report(blob)
                self.record_sdc_report(host, kind, strikes=strikes, ts=ts,
                                       persist=False)
                count += 1
        for key, blob in self._rendezvous.items(PUT_WORKER_ADDRESSES).items():
            host, _, local_rank = key.rpartition(":")
            try:
                addresses, secret_key = pickle.loads(blob)
                self.register_worker_server(host, int(local_rank),
                                            addresses, secret_key)
                count += 1
            except Exception:
                log.warning("elastic: stale worker-address entry %r not "
                            "restored", key, exc_info=True)
        if count:
            log.warning("elastic: re-seeded %d registry/blacklist entr%s "
                        "from the restored rendezvous", count,
                        "y" if count == 1 else "ies")
        return count

    # -- mesh plane ----------------------------------------------------------
    def mesh_shape(self) -> Optional[Dict[str, int]]:
        """The driver's current mesh plan as axis -> size (None when the
        mesh plane is off, i.e. HVD_TPU_MESH_SHAPE unset)."""
        if self._mesh_config is None:
            return None
        from ..parallel.mesh_utils import AXIS_ORDER
        return {a: int(getattr(self._mesh_config, a)) for a in AXIS_ORDER}

    def mesh_error(self) -> Optional[str]:
        """The last mesh replan failure (MeshShapeError text), cleared by
        the next successful replan. The generation still forms at the old
        shape — a refused replan must be visible, not fatal to the
        control plane."""
        return self._mesh_error

    def _replan_mesh(self, world: int) -> None:
        """Recompute the mesh from the new generation's world size and
        publish it to the journaled ``mesh`` scope. On MeshShapeError
        (survivors don't divide, or policy 'strict' refuses) the old plan
        is kept and the error recorded — the flat-world generation still
        forms, and the operator sees exactly which policy refused which
        counts instead of a pjit shape error."""
        if self._mesh_config is None:
            return
        from ..parallel import mesh_utils
        try:
            plan = mesh_utils.plan_reshape(self._mesh_config, world,
                                           policy=self._mesh_policy)
        except mesh_utils.MeshShapeError as e:
            self._mesh_error = str(e)
            log.error("elastic: mesh replan for world size %d failed: %s "
                      "— keeping the previous mesh plan", world, e)
            return
        self._mesh_error = None
        if plan.direction != "none":
            _M_MESH_RESHAPES.labels(policy=plan.policy,
                                    direction=plan.direction).inc()
            log.warning(
                "elastic: mesh reshaped %s for %d survivor(s): now %s "
                "(policy=%s%s)", plan.direction, world,
                {a: getattr(plan.config, a)
                 for a in mesh_utils.AXIS_ORDER},
                plan.policy,
                f", {plan.dropped} survivor(s) idle" if plan.dropped
                else "")
        self._mesh_config = plan.config
        payload = {
            "axes": {a: int(getattr(plan.config, a))
                     for a in mesh_utils.AXIS_ORDER},
            "policy": plan.policy,
            "dropped": int(plan.dropped),
        }
        try:
            self._rendezvous.put(MESH_SCOPE, "shape",
                                 json.dumps(payload).encode())
        except Exception:
            log.debug("elastic: could not publish mesh shape",
                      exc_info=True)

    # -- assignment queries --------------------------------------------------
    def world_size(self) -> int:
        return self._world_size

    def local_size(self, host: str) -> int:
        return len(self._host_assignments.get(host, []))

    def get_slot_info(self, host: str, slot: int) -> SlotInfo:
        if not self.has_rank_assignment(host, slot):
            return INVALID_SLOT_INFO
        return self._host_assignments[host][slot]

    def get_coordinator_info(self) -> Optional[SlotInfo]:
        return self._rank_assignments.get(0)

    def has_rank_assignment(self, host: str, slot: int) -> bool:
        if self._host_manager.is_blacklisted(host):
            return False
        return host in self._host_assignments \
            and len(self._host_assignments[host]) > slot

    @property
    def host_assignments(self) -> Dict[str, List[SlotInfo]]:
        return self._host_assignments

    # -- internals ----------------------------------------------------------
    def wait_for_available_slots(self, min_np: int,
                                 min_hosts: int = 1) -> DiscoveredHosts:
        tmout = Timeout(
            self._timeout,
            "Timed out waiting for {activity}. Ensure that at least "
            f"{min_np} slots are discoverable.")
        with self._wait_hosts_cond:
            while True:
                current = self._host_manager.current_hosts
                if current.count_available_slots() >= min_np \
                        and len(current.available_hosts) >= min_hosts:
                    return current
                if self._shutdown.is_set():
                    raise RuntimeError(
                        "elastic job has been shut down while waiting for "
                        "available slots")
                self._wait_hosts_cond.wait(min(tmout.remaining(), 1.0))
                tmout.check("minimum number of slots to become available")

    def _activate_workers(self, min_np: int,
                          respawn_all: bool = False) -> None:
        current = self.wait_for_available_slots(min_np)
        pending = self._update_host_assignments(current,
                                                respawn_all=respawn_all)
        self._worker_registry.reset(self.world_size())
        # Liveness restarts with the generation: old beats (and old
        # silences — e.g. a worker that spent the formation resetting)
        # say nothing about the new membership.
        self._heartbeat_monitor.reset()
        for slot_info in pending:
            self._start_worker_process(slot_info)

    def _discover_hosts(self) -> None:
        first = True
        while not self._shutdown.is_set():
            with self._wait_hosts_cond:
                try:
                    if self._host_manager.update_available_hosts():
                        self._wait_hosts_cond.notify_all()
                except RuntimeError:
                    if first:
                        # Fail fast on a broken discovery script.
                        self._shutdown.set()
                        self._wait_hosts_cond.notify_all()
                        raise
                    log.warning("elastic: discovery failed; retrying",
                                exc_info=True)
            first = False
            # Scheduler-announced reclaims ride the same notice path as
            # the preempt scope and fault kind: poll the discovery
            # object's preemption view each cycle.
            try:
                preempted = self._discovery.find_preempted_hosts()
            except Exception:
                preempted = {}
                log.warning("elastic: preemption discovery failed; "
                            "retrying", exc_info=True)
            for host, grace in (preempted or {}).items():
                self.record_preemption_notice(host, grace)
            self._sweep_completed_drains()
            # Every poll: (re)derive whether a host-change notice is owed
            # and deliver it. Deriving from current state each cycle (not
            # only on a discovery delta) makes the notice self-healing —
            # a notice cleared by a concurrently forming generation, or a
            # delivery that raced worker startup (coordinator service not
            # registered yet), is simply recreated/retried a second later.
            self._refresh_pending_notice()
            self._deliver_pending_notice()
            self._shutdown.wait(DISCOVER_HOSTS_FREQUENCY_SECS)

    def _sweep_completed_drains(self) -> None:
        """A drain is complete once the draining host no longer holds any
        assignment — the re-rendezvous formed a generation without it (the
        common case, also detected inline by ``_update_host_assignments``)
        or it never held one (a spare being reclaimed)."""
        with self._wait_hosts_cond:
            if not self._host_assignments:
                # No generation yet (startup / journal restore): a drain
                # can't be "complete" before the first generation forms
                # without the host.
                return
            done = [h for h in self._host_manager.draining_hosts()
                    if h not in self._host_assignments]
            for host in done:
                self._complete_drain(host)
            if done:
                self._wait_hosts_cond.notify_all()

    def _refresh_pending_notice(self) -> None:
        with self._wait_hosts_cond:
            current = self._host_manager.current_hosts
            next_assignments = {}
            if current.count_available_slots() >= self._min_np:
                next_assignments, _ = self._compute_assignments(current)
            if next_assignments == self.host_assignments:
                # Current generation already reflects the membership.
                self._pending_notice_ts = None
                self._scaleup_since = None
            elif self._pending_notice_ts is None and self._host_assignments:
                if self._is_grow_only(next_assignments):
                    # Pure growth is deliberate, not reactive: wait out
                    # HVD_TPU_ELASTIC_SCALE_UP_DELAY before interrupting
                    # the running generation, so one flapping discovery
                    # poll can't trigger a resize. Any shrink (host lost
                    # or draining) still interrupts immediately.
                    now = time.monotonic()
                    if self._scaleup_since is None:
                        self._scaleup_since = now
                    if now - self._scaleup_since < self._scale_up_delay:
                        return
                self._scaleup_since = None
                self._pending_notice_ts = time.time()

    def _is_grow_only(self, next_assignments: Dict[str, List[SlotInfo]]
                      ) -> bool:
        """True when the pending membership delta only ADDS slots — every
        currently assigned (host, slot) survives into the next layout."""
        prev = {(host, s.local_rank)
                for host, slots in self._host_assignments.items()
                for s in slots}
        new = {(host, s.local_rank)
               for host, slots in next_assignments.items() for s in slots}
        return bool(new - prev) and not (prev - new)

    def _deliver_pending_notice(self) -> None:
        ts = self._pending_notice_ts
        if ts is None:
            return
        coord = self.get_coordinator_info()
        if not coord:
            return
        client = self.get_worker_client(coord)
        if not client:
            return
        try:
            client.notify_hosts_updated(ts)
            self._pending_notice_ts = None
        except Exception:
            log.debug("elastic: failed to notify coordinator of host "
                      "changes; will retry", exc_info=True)

    def _compute_assignments(self, current: DiscoveredHosts):
        host_list = [HostInfo(h, current.get_slots(h))
                     for h in current.host_assignment_order]
        assignment_list, _size = get_host_assignments(
            host_list, self._min_np, self._max_np)
        by_host = defaultdict(list)
        for s in assignment_list:
            by_host[s.hostname].append(s)
        return dict(by_host), assignment_list

    def _update_host_assignments(self, current: DiscoveredHosts,
                                 respawn_all: bool = False
                                 ) -> List[SlotInfo]:
        active = set() if respawn_all else {
            (host, s.local_rank)
            for host, slots in self._host_assignments.items()
            for s in slots}
        by_host, assignment_list = self._compute_assignments(current)
        if self._host_assignments:
            if not (self._host_assignments.keys() & by_host.keys()):
                raise RuntimeError(
                    "no hosts from the previous generation remain; there is "
                    "no surviving rank to broadcast state from")
            # membership delta vs the previous generation (the initial
            # start is not a membership "change")
            prev = {(host, s.local_rank)
                    for host, slots in self._host_assignments.items()
                    for s in slots}
            new = {(host, s.local_rank)
                   for host, slots in by_host.items() for s in slots}
            if new - prev:
                _M_RANK_ADDED.inc(len(new - prev))
                _M_SCALE_EVENTS.labels(direction="up").inc()
            if prev - new:
                _M_RANK_REMOVED.inc(len(prev - new))
        self._host_assignments = by_host
        # Drains complete the moment a generation forms without the host
        # (precise hvd_tpu_elastic_drain_seconds; the 1 Hz sweep is the
        # backstop for hosts that never held an assignment).
        with self._wait_hosts_cond:
            for host in self._host_manager.draining_hosts():
                if host not in by_host:
                    self._complete_drain(host)
        self._world_size = len(assignment_list)
        # Mesh replan BEFORE the rendezvous init: a worker whose blocking
        # rank_and_size GET returns must already be able to read the new
        # generation's mesh shape.
        self._replan_mesh(self._world_size)
        # The generation being formed already reflects current membership;
        # a pending host-change notice would only re-interrupt it.
        self._pending_notice_ts = None
        self._rendezvous.init(assignment_list)
        if self._assignments_callback is not None:
            self._assignments_callback(assignment_list)
        self._rank_assignments = {s.rank: s for s in assignment_list}
        return [s for host, slots in by_host.items() for s in slots
                if (host, s.local_rank) not in active]

    def _start_worker_process(self, slot_info: SlotInfo) -> None:
        create_worker_fn = self._create_worker_fn
        shutdown_event = self._shutdown
        host_event = self._host_manager.get_host_event(slot_info.hostname)

        def run_worker():
            res = create_worker_fn(slot_info, [shutdown_event, host_event])
            exit_code, timestamp = res
            self._handle_worker_exit(slot_info, exit_code, timestamp)

        thread = threading.Thread(target=run_worker, daemon=True,
                                  name=f"hvd-elastic-worker-{slot_info.rank}")
        thread.start()
        self._results.expect(thread)

    def _handle_worker_exit(self, slot_info: SlotInfo, exit_code: int,
                            timestamp: float) -> None:
        # An exited worker's silence is expected; a stale declaration must
        # never fire a host event into a successor generation's worker.
        self._heartbeat_monitor.forget(slot_info.hostname,
                                       slot_info.local_rank)
        if not self.has_rank_assignment(slot_info.hostname,
                                        slot_info.local_rank):
            return  # blacklisted or stale generation
        if exit_code == 0:
            rid = self._worker_registry.record_success(
                slot_info.hostname, slot_info.local_rank)
        else:
            rid = self._worker_registry.record_failure(
                slot_info.hostname, slot_info.local_rank,
                timestamp=timestamp)
        if self.finished() and self._worker_registry.last_rendezvous() == rid:
            name = f"{slot_info.hostname}[{slot_info.local_rank}]"
            self._results.add_result(name, (exit_code, timestamp))
