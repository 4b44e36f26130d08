"""Per-tenant admission for the fleet router: quota, priority, and
weighted fair dequeue (a copy of ``horovod_tpu/serving/fleet/tenancy.py``;
grant order and virtual times are the JAX package's).

The single-replica serving plane already degrades overload to fast
backpressure (bounded queue -> 503, deadline -> 429), but it is
tenant-blind: one hot client fills the queue and every other client
inherits its 503s. This module puts admission *in front of* the fleet's
dispatch so each tenant owns its own failure budget:

* **resolution** — :class:`TenantRegistry` maps a request's
  ``X-HVD-TPU-API-Key`` (or explicit ``X-HVD-TPU-Tenant``) header to a
  :class:`Tenant`; unknown keys fall back to the built-in ``default``
  tenant, so tenancy is opt-in per deployment.
* **quota** — a tenant at its concurrent cap queues; past its queue cap
  it is rejected with :class:`TenantQuotaError` (HTTP 429,
  ``reason="quota"``) *immediately*, while other tenants keep being
  admitted. Overload is the flooding tenant's own problem.
* **weighted fair dequeue** — :class:`FairScheduler` grants fleet
  capacity by priority class first, then stride scheduling over tenant
  weights (a weight-2 tenant dequeues twice as often as a weight-1
  tenant under contention), EDF within a tenant: among one tenant's
  queued requests the earliest deadline dispatches first (FIFO between
  deadline-less requests), so a near-deadline request is not starved
  behind fresh arrivals. Fleet capacity is
  ``routable replicas x HVD_TPU_FLEET_REPLICA_CONCURRENCY``, supplied
  live by the router so ejections shrink admission instead of piling
  requests onto dead replicas; when capacity collapses to **zero**
  (last replica ejected) the router flushes every queued waiter with a
  fast :class:`NoCapacityError` (HTTP 503) instead of letting each one
  burn its own deadline against a fleet that cannot serve it.
* **retry budget** — :class:`RetryBudget` is the per-tenant token
  bucket bounding router-issued retries, hedges, and mid-stream
  failovers: each primary request earns
  ``HVD_TPU_FLEET_RETRY_BUDGET_RATIO`` tokens (capped at
  ``HVD_TPU_FLEET_RETRY_BUDGET_BURST``) and each retry spends one, so
  a failing fleet degrades to pass-through instead of amplifying load
  into a retry storm.

Fairness is observable: ``hvd_tpu_fleet_tenant_admitted_total``,
``hvd_tpu_fleet_tenant_rejected_total{reason}``, and the per-tenant
queue-wait histogram ``hvd_tpu_fleet_tenant_queue_wait_seconds``.
"""

import collections
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Optional, Tuple

from ... import config as _config
from ... import metrics as _metrics
from ... import tracing as _tracing
from ..batcher import DeadlineExceededError

TENANT_HEADER = "X-HVD-TPU-Tenant"
API_KEY_HEADER = "X-HVD-TPU-API-Key"
DEFAULT_TENANT = "default"

_M_ADMITTED = _metrics.counter(
    "hvd_tpu_fleet_tenant_admitted_total",
    "Requests granted fleet capacity by the router's fair scheduler, "
    "per tenant.",
    labels=("tenant",))
_M_REJECTED = _metrics.counter(
    "hvd_tpu_fleet_tenant_rejected_total",
    "Requests rejected by per-tenant admission: reason=quota (the "
    "tenant's own queue cap, HTTP 429), reason=deadline (expired "
    "while waiting in the fair queue, HTTP 429), or reason="
    "no_capacity (queue flushed because the routable-replica count "
    "hit zero, HTTP 503).",
    labels=("tenant", "reason"))
_M_RETRY_BUDGET = _metrics.counter(
    "hvd_tpu_fleet_retry_budget_total",
    "Retry-budget decisions by the fleet router, per tenant: outcome="
    "granted (a retry/hedge/failover spent a token) or outcome=denied "
    "(bucket empty — the router passed the failure through instead of "
    "retrying). A rising denied rate under fleet trouble is the "
    "retry-storm guard doing its job.",
    labels=("tenant", "outcome"))
_M_QUEUE_WAIT = _metrics.histogram(
    "hvd_tpu_fleet_tenant_queue_wait_seconds",
    "Seconds an admitted request waited in the router's weighted fair "
    "queue before dispatch, per tenant — the fairness evidence: a "
    "well-behaved tenant's tail stays bounded while another tenant "
    "floods.",
    labels=("tenant",))


class TenantQuotaError(Exception):
    """The tenant's own queue cap is exceeded (HTTP 429)."""


class NoCapacityError(Exception):
    """Fleet capacity hit zero while the request was queued — the last
    routable replica was ejected, so waiting longer can only burn the
    client's deadline (HTTP 503, fail fast and let the client retry
    against a fleet that may have recovered)."""


class RetryBudget:
    """Per-tenant token bucket bounding router-issued retries.

    Every primary request earns ``ratio`` tokens
    (``HVD_TPU_FLEET_RETRY_BUDGET_RATIO``); every retry/hedge/failover
    spends one whole token. Buckets start (and cap) at ``burst``
    (``HVD_TPU_FLEET_RETRY_BUDGET_BURST``), so early failures can
    still fail over while a sustained failure rate above ``ratio`` of
    offered load drains the bucket and the router degrades to
    pass-through.
    """

    def __init__(self, ratio: Optional[float] = None,
                 burst: Optional[float] = None):
        cfg = _config.live_config()
        self._ratio = float(cfg.get(_config.FLEET_RETRY_BUDGET_RATIO)
                            if ratio is None else ratio)
        self._burst = max(0.0, float(
            cfg.get(_config.FLEET_RETRY_BUDGET_BURST)
            if burst is None else burst))
        self._tokens: Dict[str, float] = {}
        self._lock = threading.Lock()

    def note_request(self, tenant: str) -> None:
        """A primary request accrues ``ratio`` tokens for its tenant."""
        with self._lock:
            self._tokens[tenant] = min(
                self._burst,
                self._tokens.get(tenant, self._burst) + self._ratio)

    def try_spend(self, tenant: str) -> bool:
        """Spend one retry token; False means the budget is exhausted
        and the caller must pass the failure through."""
        with self._lock:
            tokens = self._tokens.get(tenant, self._burst)
            if tokens >= 1.0:
                self._tokens[tenant] = tokens - 1.0
                granted = True
            else:
                granted = False
        _M_RETRY_BUDGET.labels(
            tenant=tenant,
            outcome="granted" if granted else "denied").inc()
        return granted

    def tokens(self, tenant: str) -> float:
        with self._lock:
            return self._tokens.get(tenant, self._burst)


@dataclass(frozen=True)
class Tenant:
    """One tenant's admission contract."""
    name: str
    keys: Tuple[str, ...] = ()
    max_concurrent: int = 4
    max_queued: int = 16
    weight: float = 1.0
    priority: int = 0


class TenantRegistry:
    """Tenant table + request-header resolution.

    ``spec`` is the ``HVD_TPU_FLEET_TENANTS`` JSON object (tenant name
    -> overrides); omitted fields take the per-tenant default knobs
    (``HVD_TPU_FLEET_TENANT_CONCURRENT``,
    ``HVD_TPU_FLEET_TENANT_QUEUE_DEPTH``,
    ``HVD_TPU_FLEET_TENANT_WEIGHT``). The registry is immutable after
    construction — admission state lives in :class:`FairScheduler`,
    keyed by tenant name.
    """

    def __init__(self, spec: Optional[str] = None, cfg=None):
        cfg = cfg or _config.live_config()
        self._defaults = dict(
            max_concurrent=int(cfg.get(_config.FLEET_TENANT_CONCURRENT)),
            max_queued=int(cfg.get(_config.FLEET_TENANT_QUEUE_DEPTH)),
            weight=float(cfg.get(_config.FLEET_TENANT_WEIGHT)),
            priority=0)
        raw = spec if spec is not None else str(
            cfg.get(_config.FLEET_TENANTS))
        self._tenants: Dict[str, Tenant] = {}
        self._by_key: Dict[str, str] = {}
        for name, doc in (json.loads(raw) if raw.strip() else {}).items():
            tenant = Tenant(
                name=str(name),
                keys=tuple(str(k) for k in doc.get("keys", ())),
                max_concurrent=int(doc.get("max_concurrent",
                                           self._defaults["max_concurrent"])),
                max_queued=int(doc.get("max_queued",
                                       self._defaults["max_queued"])),
                weight=max(1e-6, float(doc.get("weight",
                                               self._defaults["weight"]))),
                priority=int(doc.get("priority", 0)))
            self._tenants[tenant.name] = tenant
            for key in tenant.keys:
                self._by_key[key] = tenant.name
        if DEFAULT_TENANT not in self._tenants:
            self._tenants[DEFAULT_TENANT] = Tenant(
                name=DEFAULT_TENANT, **self._defaults)

    def get(self, name: str) -> Tenant:
        return self._tenants.get(name) or self._tenants[DEFAULT_TENANT]

    def tenants(self) -> Dict[str, Tenant]:
        return dict(self._tenants)

    def resolve(self, headers) -> Tenant:
        """Tenant for one request: API key first (authoritative), then an
        explicit tenant header naming a *configured* tenant, else the
        default tenant. ``headers`` is any ``.get(name)`` mapping
        (``email.message.Message`` included)."""
        api_key = headers.get(API_KEY_HEADER)
        if api_key and api_key in self._by_key:
            return self._tenants[self._by_key[api_key]]
        name = headers.get(TENANT_HEADER)
        if name and name in self._tenants:
            return self._tenants[name]
        return self._tenants[DEFAULT_TENANT]


class _Waiter:
    __slots__ = ("tenant", "granted", "enqueued_at", "deadline_ts",
                 "error")

    def __init__(self, tenant: Tenant, enqueued_at: float,
                 deadline_ts: Optional[float] = None):
        self.tenant = tenant
        self.granted = False
        self.enqueued_at = enqueued_at
        #: absolute (monotonic) deadline, None = no deadline; the
        #: EDF-within-tenant dequeue key
        self.deadline_ts = deadline_ts
        #: terminal error delivered by a queue flush (capacity hit 0)
        self.error: Optional[BaseException] = None

    @property
    def edf_key(self) -> Tuple[float, float]:
        return (self.deadline_ts if self.deadline_ts is not None
                else float("inf"), self.enqueued_at)


@dataclass
class _TenantState:
    active: int = 0
    virtual_time: float = 0.0
    queue: Deque[_Waiter] = field(default_factory=collections.deque)


class FairScheduler:
    """Weighted fair admission over a live fleet capacity.

    ``capacity_fn()`` returns the momentary fleet-wide concurrent
    budget (router: routable replicas x per-replica concurrency); it is
    called under the scheduler lock and must not block or take locks.

    ``acquire(tenant)`` blocks until granted (bounded waits, so a
    deadline or shutdown is honored within one tick) and every
    ``acquire`` must be paired with ``release(tenant)``.
    """

    def __init__(self, capacity_fn: Callable[[], int],
                 capacity_detail_fn: Optional[Callable[[], Dict]] = None):
        self._capacity_fn = capacity_fn
        # optional breakdown of WHERE the capacity number comes from
        # (the disagg router: per-pool routable counts — the fleet-wide
        # budget is per_replica x the NARROWEST pool); surfaced by
        # :meth:`capacity` into /healthz and /fleet/health
        self._capacity_detail_fn = capacity_detail_fn
        # a plain Condition (the elastic layer's idiom): the checked-lock
        # factory can't back one, because Condition._is_owned probes with a
        # speculative re-acquire the sentinel would flag
        self._cond = threading.Condition()
        self._fleet_active = 0
        self._states: Dict[str, _TenantState] = {}
        self._closed = False

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._cond:
            return {name: {"active": st.active, "queued": len(st.queue),
                           "virtual_time": round(st.virtual_time, 6)}
                    for name, st in sorted(self._states.items())}

    def capacity(self) -> Dict:
        """The momentary admission budget and its provenance:
        ``{"total", "active"}`` plus whatever the capacity-detail hook
        adds (the disagg router: ``per_replica``, ``routable``, and
        per-``pools`` routable counts)."""
        with self._cond:
            doc = {"total": int(self._capacity_fn()),
                   "active": self._fleet_active}
        if self._capacity_detail_fn is not None:
            doc.update(self._capacity_detail_fn())
        return doc

    # -- admission -----------------------------------------------------------
    def acquire(self, tenant: Tenant,
                deadline_ts: Optional[float] = None) -> None:
        """Wait for a dispatch grant. Raises :class:`TenantQuotaError`
        when the tenant's queue cap is already full (its own 429) and
        :class:`DeadlineExceededError` when ``deadline_ts`` (monotonic)
        passes before a grant."""
        start = time.monotonic()
        with self._cond:
            state = self._states.setdefault(tenant.name, _TenantState())
            if not state.queue and state.active == 0:
                # a tenant returning from idle re-enters at the busy
                # tenants' stride frontier — it neither owes virtual time
                # for its idle period nor gets to monopolize repaying it
                busy = [st.virtual_time for st in self._states.values()
                        if st.queue or st.active]
                if busy:
                    state.virtual_time = max(state.virtual_time, min(busy))
            if len(state.queue) >= max(1, tenant.max_queued):
                _M_REJECTED.labels(tenant=tenant.name, reason="quota").inc()
                raise TenantQuotaError(
                    f"tenant {tenant.name!r} has {len(state.queue)} requests "
                    f"queued (cap {tenant.max_queued}); retry later")
            waiter = _Waiter(tenant, start, deadline_ts)
            state.queue.append(waiter)
            self._grant_locked()
            while not waiter.granted:
                now = time.monotonic()
                if waiter.error is not None:
                    # a flush already removed the waiter from the queue
                    raise waiter.error
                if self._closed:
                    state.queue.remove(waiter)
                    raise RuntimeError("scheduler closed")
                if deadline_ts is not None and now >= deadline_ts:
                    state.queue.remove(waiter)
                    self._grant_locked()
                    _M_REJECTED.labels(tenant=tenant.name,
                                       reason="deadline").inc()
                    raise DeadlineExceededError(
                        f"tenant {tenant.name!r}: deadline expired after "
                        f"{now - start:.3f}s in the fair queue",
                        stage="queue")
                wait_s = 0.05 if deadline_ts is None else max(
                    0.001, min(0.05, deadline_ts - now))
                self._cond.wait(timeout=wait_s)
        waited = time.monotonic() - start
        _M_ADMITTED.labels(tenant=tenant.name).inc()
        # a traced request stamps its trace id as the exemplar, so a
        # queue-wait outlier links straight to its cross-host timeline
        ctx = _tracing.current()
        _M_QUEUE_WAIT.labels(tenant=tenant.name).observe(
            waited, exemplar=ctx.trace_id if ctx is not None else None)

    def release(self, tenant: Tenant) -> None:
        with self._cond:
            state = self._states.setdefault(tenant.name, _TenantState())
            state.active = max(0, state.active - 1)
            self._fleet_active = max(0, self._fleet_active - 1)
            self._grant_locked()

    def kick(self) -> None:
        """Capacity changed (replica admitted/ejected): re-run grants."""
        with self._cond:
            self._grant_locked()

    def flush_no_capacity(self) -> None:
        """Fleet capacity hit zero: fail every queued waiter with a fast
        :class:`NoCapacityError` (HTTP 503) instead of letting each one
        wait out its own deadline against a fleet that cannot dispatch
        it. The router calls this when the routable-replica count
        reaches 0; new arrivals are already fast-503'd by the router's
        own pre-admission check. Explicitly signal-driven — a plain
        ``capacity_fn() == 0`` reading is NOT a flush trigger, because
        direct FairScheduler users legitimately queue against a
        momentarily-zero capacity."""
        with self._cond:
            flushed = False
            for name, state in self._states.items():
                for waiter in state.queue:
                    waiter.error = NoCapacityError(
                        f"tenant {name!r}: all replicas became "
                        f"unroutable while queued; failing fast")
                    _M_REJECTED.labels(tenant=name,
                                       reason="no_capacity").inc()
                    flushed = True
                state.queue.clear()
            if flushed:
                self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- grant policy (lock held) --------------------------------------------
    def _grant_locked(self) -> None:
        granted_any = False
        while self._fleet_active < max(0, int(self._capacity_fn())):
            best: Optional[Tuple[int, float, str]] = None
            for name, state in self._states.items():
                if not state.queue:
                    continue
                tenant = state.queue[0].tenant
                if state.active >= max(1, tenant.max_concurrent):
                    continue
                rank = (-tenant.priority, state.virtual_time, name)
                if best is None or rank < best:
                    best = rank
            if best is None:
                break
            state = self._states[best[2]]
            # EDF within the tenant: the earliest-deadline waiter
            # dispatches first (deadline-less waiters rank last, FIFO
            # among themselves) — a near-deadline request is not
            # starved behind fresh arrivals. Cross-tenant order stays
            # priority-then-stride, so weighted fairness and the
            # flooding-tenant isolation are unchanged.
            waiter = min(state.queue, key=lambda w: w.edf_key)
            state.queue.remove(waiter)
            waiter.granted = True
            state.active += 1
            self._fleet_active += 1
            state.virtual_time += 1.0 / waiter.tenant.weight
            granted_any = True
        if granted_any:
            self._cond.notify_all()
