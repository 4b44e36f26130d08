"""Worker-side notification channel for host membership changes.

Reference: horovod/runner/elastic/worker.py — the rank-0
worker runs a small authenticated TCP service; the driver pushes
"hosts updated" timestamps to it; the manager fans the timestamp out to
registered elastic State objects, which raise HostsUpdatedInterrupt at the
next commit. The worker advertises the service's addresses + per-job
secret to the launcher through the rendezvous KV store
(scope ``worker_addresses``, key ``hostname:local_rank``).
"""

import logging
import os
import pickle
import threading
from typing import Optional

from .. import faults as _faults
from .. import retry as _retry
from ..runner.network import (AckResponse, BasicClient, BasicService,
                              make_secret_key)
from .heartbeat import HeartbeatSender

log = logging.getLogger("horovod_tpu_torch.elastic")

PUT_WORKER_ADDRESSES = "worker_addresses"

# Chaos sites for the worker<->driver control channel: registration (the
# KV put advertising this worker's notification service) and the driver's
# hosts-updated pushes. Both simulate as transient network failures.
_FP_REGISTER = _faults.FaultPoint("worker.register",
                                  exc=_faults.InjectedTransientFault)
_FP_NOTIFY = _faults.FaultPoint("elastic.notify",
                                exc=_faults.InjectedTransientFault)


class HostsUpdatedRequest:
    def __init__(self, timestamp: float):
        self.timestamp = timestamp


class WorkerNotificationService(BasicService):
    NAME = "hvd-tpu worker notification service"

    def __init__(self, key: bytes, manager: "WorkerNotificationManager"):
        super().__init__(self.NAME, key)
        self._manager = manager

    def _handle(self, req, client_address):
        if isinstance(req, HostsUpdatedRequest):
            self._manager.handle_hosts_updated(req.timestamp)
            return AckResponse()
        return super()._handle(req, client_address)


class WorkerNotificationClient(BasicClient):
    def __init__(self, addresses, key: bytes, timeout: float = 10.0):
        super().__init__(WorkerNotificationService.NAME, addresses, key,
                         timeout=timeout)

    def notify_hosts_updated(self, timestamp: float) -> None:
        _FP_NOTIFY.fire()
        self._send(HostsUpdatedRequest(timestamp))


class WorkerNotificationManager:
    """Process-wide singleton on each worker (reference worker.py:37-81)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._service: Optional[WorkerNotificationService] = None
        self._listeners = set()
        self._heartbeat: Optional[HeartbeatSender] = None
        self._client = None
        self._hostname: Optional[str] = None

    def init(self, rendezvous_addr: Optional[str] = None,
             rendezvous_port: Optional[int] = None,
             hostname: Optional[str] = None,
             local_rank: Optional[int] = None) -> None:
        with self._lock:
            if self._service:
                return
            rendezvous_addr = rendezvous_addr or \
                os.environ.get("HVD_TPU_RENDEZVOUS_ADDR") or \
                os.environ.get("HOROVOD_GLOO_RENDEZVOUS_ADDR")
            if not rendezvous_addr:
                return   # not an elastic launch; nothing to register with
            rendezvous_port = rendezvous_port if rendezvous_port is not None \
                else int(os.environ.get(
                    "HVD_TPU_RENDEZVOUS_PORT",
                    os.environ.get("HOROVOD_GLOO_RENDEZVOUS_PORT", 0)))
            hostname = hostname or os.environ.get(
                "HVD_TPU_HOSTNAME", os.environ.get("HOROVOD_HOSTNAME", ""))
            if local_rank is None:
                local_rank = int(os.environ.get(
                    "HVD_TPU_LOCAL_RANK",
                    os.environ.get("HOROVOD_LOCAL_RANK", 0)))

            key = make_secret_key()
            self._service = WorkerNotificationService(key, self)

            from ..runner.rendezvous import KVStoreClient

            # Registration is the driver's only way to interrupt this
            # worker on membership changes; a transient blip here must be
            # retried, not silently drop the worker off the notification
            # plane. ONE policy owns the budget: the client is built with
            # max_attempts=1 so its internal rendezvous.put policy cannot
            # nest inside this one and multiply attempts/deadline.
            client = KVStoreClient(rendezvous_addr, rendezvous_port,
                                   retry=_retry.RetryPolicy(max_attempts=1))
            payload = pickle.dumps((self._service.addresses(), key))

            def register():
                _FP_REGISTER.fire()
                client.put(PUT_WORKER_ADDRESSES,
                           f"{hostname}:{local_rank}", payload)

            def register_with_retries():
                _retry.RetryPolicy.from_config().call(
                    register, site="worker.register")

            # A coordinator epoch bump means the KV store restarted: any
            # scoped key the old incarnation lost (most critically our
            # notification address — the driver's only way to interrupt
            # this worker) must be re-registered, under the same retry
            # policy as first registration, instead of wedging on stale
            # state. The bump is observed on whatever op touches the
            # store next — in steady state, the next heartbeat PUT.
            def on_epoch_bump(old, new):
                log.warning(
                    "elastic: coordinator epoch bumped %d -> %d "
                    "(rendezvous restarted); re-registering this worker",
                    old, new)
                register_with_retries()
            client.on_epoch_bump = on_epoch_bump

            register_with_retries()

            # Per-rank liveness beats over the same client/channel. Rank
            # comes from the launch env; heartbeats pre-date init() so the
            # world may not exist yet.
            rank = os.environ.get("HVD_TPU_RANK",
                                  os.environ.get("HOROVOD_RANK", "?"))
            self._heartbeat = HeartbeatSender(client, hostname, local_rank,
                                              rank)
            self._heartbeat.start()
            # Kept for the preemption-notice PUT (send_preemption_notice):
            # notices ride the same KV channel as registration/beats.
            self._client = client
            self._hostname = hostname

    def send_preemption_notice(self, grace: float = 0.0) -> bool:
        """PUT a preemption notice for THIS worker's host to the journaled
        ``preempt`` scope — the drill path of the shared notice channel
        (the ``preempt`` fault kind lands here via the elastic State's
        commit fault point). Returns True when the notice reached the
        store; False on a non-elastic launch or a delivery failure (the
        driver's discovery poll is the production backstop, so best-effort
        is correct here)."""
        with self._lock:
            client, hostname = self._client, self._hostname
        if client is None or not hostname:
            return False
        from .preemption import PREEMPT_SCOPE, encode_notice
        try:
            client.put(PREEMPT_SCOPE, hostname, encode_notice(grace))
            log.warning("elastic: preemption notice sent for %s "
                        "(grace=%.1fs)", hostname, grace)
            return True
        except Exception:
            log.warning("elastic: preemption notice for %s not delivered",
                        hostname, exc_info=True)
            return False

    def send_sdc_report(self, kind: str, strikes: int = 1) -> bool:
        """PUT a silent-data-corruption quarantine report for THIS
        worker's host to the journaled ``sdc`` scope — the SDC policy
        calls it when local detections cross HVD_TPU_SDC_STRIKES
        (horovod_tpu/sdc/policy.py). Returns True when the report
        reached the store; False on a non-elastic launch or a delivery
        failure (best-effort, like the preemption notice: the training
        loop's skip/rollback reactions do not depend on the driver
        hearing about the offender)."""
        with self._lock:
            client, hostname = self._client, self._hostname
        if client is None or not hostname:
            return False
        from ..sdc.report import SDC_SCOPE, encode_report
        try:
            client.put(SDC_SCOPE, hostname, encode_report(kind, strikes))
            log.warning("elastic: SDC quarantine report sent for %s "
                        "(kind=%s, strikes=%d)", hostname, kind, strikes)
            return True
        except Exception:
            log.warning("elastic: SDC quarantine report for %s not "
                        "delivered", hostname, exc_info=True)
            return False

    def set_rank(self, rank) -> None:
        """The rank this worker's beats name, after an in-process reset
        gave it a new one."""
        with self._lock:
            if self._heartbeat is not None:
                self._heartbeat._rank = rank

    def register_listener(self, listener) -> None:
        self._listeners.add(listener)

    def remove_listener(self, listener) -> None:
        self._listeners.discard(listener)

    def handle_hosts_updated(self, timestamp: float) -> None:
        for listener in list(self._listeners):
            listener.on_hosts_updated(timestamp)

    def shutdown(self) -> None:
        with self._lock:
            if self._heartbeat:
                self._heartbeat.stop()
                self._heartbeat = None
            if self._service:
                self._service.shutdown()
                self._service = None
            self._client = None
            self._hostname = None


notification_manager = WorkerNotificationManager()
