"""The fleet router: health-aware balancing over N replica servers (a
copy of ``horovod_tpu/serving/fleet/router.py`` over the port's HTTP
plumbing, heartbeat monitor, retry policy, metrics and tracing).

:class:`FleetRouter` fronts a set of replica endpoints (each an
:class:`~horovod_tpu_torch.serving.server.InferenceServer`, infer and/or
generate plane) behind one async HTTP front-end and owns three jobs:

* **balancing** — each proxied request goes to the routable replica
  with the fewest outstanding requests (the router's own in-flight
  count, so no replica cooperation is needed), published per replica as
  ``hvd_tpu_fleet_outstanding{replica}``.
* **health** — two independent signals remove a replica from routing:

  - *active*: replicas beat ``POST /fleet/heartbeat/<replica>`` every
    ``HVD_TPU_FLEET_HEARTBEAT_INTERVAL`` seconds (the elastic
    :class:`~horovod_tpu_torch.elastic.heartbeat.LivenessMonitor` reused with
    replica-id keys). An armed-then-silent replica is ejected within
    2x ``HVD_TPU_FLEET_HEARTBEAT_TIMEOUT`` and re-admitted the moment
    its beats resume.
  - *passive*: ``HVD_TPU_FLEET_CIRCUIT_THRESHOLD`` consecutive
    connect errors / 5xx responses open the replica's circuit; a
    half-open ``GET /healthz`` probe (full-jitter backoff via
    :mod:`horovod_tpu_torch.retry`) re-closes it on success. Connect errors
    additionally fail the request over to the next routable replica.

  Ejections from either signal are
  ``hvd_tpu_fleet_ejections_total{replica,reason}``.
* **admission** — every proxied request passes the per-tenant
  :class:`~horovod_tpu_torch.serving.fleet.tenancy.FairScheduler` first
  (quota 429s, weighted fair dequeue); fleet capacity follows the live
  routable-replica count, so an ejection shrinks admission instead of
  stacking requests on a corpse.

Requests carry ``X-HVD-TPU-Request-Id`` (stamped here when absent,
forwarded to the replica, echoed in both responses) so one failed
request is traceable across tiers.

**Request survivability** rides on top:

* **end-to-end deadlines** — the router mints a per-request budget
  (client ``X-HVD-TPU-Deadline-Ms`` header, else
  ``HVD_TPU_FLEET_DEFAULT_DEADLINE_MS`` when set) and re-stamps the
  *remaining* milliseconds on every forwarded attempt, so the replica's
  queue/prefill/decode stages shed what can no longer finish; a 429
  names the stage that died in ``X-HVD-TPU-Deadline-Exceeded``
  (``route`` when the budget lapsed inside the router itself).
* **hedged retries** — a non-streaming request still unanswered after
  the ``HVD_TPU_FLEET_HEDGE_QUANTILE`` of observed proxy latency is
  re-issued to a second replica; first response wins, the loser is
  cancelled (``POST /v1/cancel``). Hedges, connect-error failovers, and
  mid-stream resumes ALL draw from a per-tenant token-bucket retry
  budget (``HVD_TPU_FLEET_RETRY_BUDGET_RATIO`` earned per primary
  request, ``HVD_TPU_FLEET_RETRY_BUDGET_BURST`` cap) so a failing
  fleet degrades to pass-through instead of amplifying into a retry
  storm.
* **mid-stream failover** — ``POST /v1/generate/stream`` responses are
  journaled token by token (plus the replica's meta record carrying
  the effective seed); when the stream is severed (replica death,
  heartbeat ejection, injected ``fleet.stream`` fault) the router
  re-submits ``prompt + emitted_tokens`` with ``sample_offset`` set to
  a surviving replica and splices the continuation into the client's
  stream — bit-identical to the uninterrupted run (seeded sampling
  folds the key by ABSOLUTE emission ordinal; the prefix cache makes
  re-prefill cheap). ``hvd_tpu_fleet_failovers_total{outcome}`` counts
  resumed/failed takeovers.

Every attempt carries ``X-HVD-TPU-Attempt`` (0 = primary) while the
request id and trace parent stay UNCHANGED across re-submissions, so a
retried request is one numbered trace, not several fresh-looking ones.
When the last routable replica is ejected the scheduler's queue is
flushed with fast 503s (see ``FairScheduler.flush_no_capacity``).

Chaos sites: ``fleet.route`` — fired after admission, before replica
selection; an injected error answers 503 without touching any replica
(the router's own blast-radius drill). ``fleet.stream`` — fired per
streamed record read from the serving replica; an injected error
severs the stream mid-generation exactly like a replica crash and must
be absorbed by the failover resume.
"""

import collections
import json
import logging
import queue
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, Iterable, List, Mapping, Optional, Tuple, Union

from ... import _http
from ... import _locks
from ... import config as _config
from ... import faults as _faults
from ... import metrics as _metrics
from ... import retry as _retry
from ... import tracing as _tracing
from ...elastic.heartbeat import HeartbeatSender, LivenessMonitor
from .tenancy import (FairScheduler, NoCapacityError, RetryBudget,
                      TenantQuotaError, TenantRegistry)
from ..batcher import (DEADLINE_HEADER, DEADLINE_STAGE_HEADER,
                       DeadlineExceededError)

log = logging.getLogger("horovod_tpu_torch.fleet")

HEARTBEAT_PATH = "/fleet/heartbeat/"
REQUEST_ID_HEADER = "X-HVD-TPU-Request-Id"

#: proxy latency samples kept for the hedge-delay quantile
_LATENCY_WINDOW = 256
#: samples required before hedging arms (a quantile over less is noise)
_MIN_HEDGE_SAMPLES = 8

_FP_ROUTE = _faults.FaultPoint("fleet.route")
_FP_HEALTH = _faults.FaultPoint("fleet.health",
                                exc=_faults.InjectedTransientFault)
# mid-stream kill drill: fired for every record the router reads off a
# replica's generation stream; an injected error severs the stream at
# exactly that token — the failover-resume path must absorb it
_FP_STREAM = _faults.FaultPoint("fleet.stream",
                                exc=_faults.InjectedTransientFault)

_M_OUTSTANDING = _metrics.gauge(
    "hvd_tpu_fleet_outstanding",
    "Requests the router currently has in flight against each replica "
    "(the least-outstanding balancing signal; a draining replica must "
    "reach 0 before its rolling-reload swap).",
    labels=("replica",))
_M_EJECTIONS = _metrics.counter(
    "hvd_tpu_fleet_ejections_total",
    "Replicas removed from routing, by reason: heartbeat (armed then "
    "silent past the timeout) or circuit (consecutive connect-error/5xx "
    "streak). Re-admission is automatic on recovery.",
    labels=("replica", "reason"))
_M_REQUESTS = _metrics.counter(
    "hvd_tpu_fleet_requests_total",
    "Router HTTP responses by code: 200 proxied OK, 429 tenant "
    "quota/deadline, 503 no routable replica or injected fleet.route, "
    "plus replica codes relayed verbatim.",
    labels=("code",))
_M_FAILOVERS = _metrics.counter(
    "hvd_tpu_fleet_failovers_total",
    "Mid-stream generation takeovers after a severed stream: resumed "
    "(a surviving replica delivered the continuation's first token) or "
    "failed (no surviving replica / retry budget exhausted / the "
    "resume was rejected).",
    labels=("outcome",))
_M_HEDGES = _metrics.counter(
    "hvd_tpu_fleet_hedges_total",
    "Hedged retries: launched (primary outlived the hedge quantile and "
    "a second replica was raced) and won (the hedge's response is the "
    "one the client got; the primary was cancelled).",
    labels=("outcome",))


class _Replica:
    """Router-side record for one replica endpoint (state guarded by the
    router lock; ``outstanding`` also mirrors to the gauge)."""

    __slots__ = ("id", "base_url", "pool", "outstanding", "draining",
                 "hb_dead", "circuit_open", "failure_streak",
                 "probe_attempt", "next_probe_at", "capabilities")

    def __init__(self, replica_id: str, base_url: str,
                 pool: str = "colocated"):
        self.id = replica_id
        self.base_url = base_url.rstrip("/")
        # disagg pool membership: "prefill" | "decode" | "colocated"
        # (a colocated replica serves BOTH pools)
        self.pool = pool
        #: feature advertisement carried on the replica's heartbeats
        #: (spec_mode / spec_tokens / max_beams, ...): lets operators
        #: assert a decode pool homogeneous from /fleet/health before
        #: prestaging spec or beam traffic onto it. None until the
        #: first capability-bearing beat arrives.
        self.capabilities: Optional[dict] = None
        self.outstanding = 0
        self.draining = False
        self.hb_dead = False
        self.circuit_open = False
        self.failure_streak = 0
        self.probe_attempt = 0
        self.next_probe_at = 0.0

    def in_pool(self, pool: Optional[str]) -> bool:
        return pool is None or self.pool == pool \
            or self.pool == "colocated"

    @property
    def routable(self) -> bool:
        return not (self.draining or self.hb_dead or self.circuit_open)

    def state(self) -> str:
        if self.hb_dead:
            return "dead"
        if self.circuit_open:
            return "circuit_open"
        if self.draining:
            return "draining"
        return "up"


class _RouterHandler(_http.QuietHandler):
    """Front-end handler; all logic lives on ``self.server.router``."""

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        # /fleet/health is the control-plane alias of /healthz: same
        # document (pool topology, per-pool routable counts, tenants)
        if self.path.split("?", 1)[0] not in ("/healthz", "/fleet/health"):
            self._send(404, {"error": "not found"})
            return
        self._send(200, self.server.router.health_doc())

    def do_POST(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        if path.startswith(HEARTBEAT_PATH):
            replica_id = path[len(HEARTBEAT_PATH):]
            # the beat body is an optional JSON capability document
            # (spec/beam enablement etc.); plain liveness beats carry
            # an opaque placeholder and leave capabilities untouched
            caps = None
            try:
                raw = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                doc = json.loads(raw) if raw.strip() else None
                if isinstance(doc, dict):
                    caps = doc
            except (ValueError, TypeError):
                pass
            if self.server.router.observe_beat(replica_id, caps):
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": f"unknown replica {replica_id!r}"})
            return
        if path not in ("/v1/infer", "/v1/generate",
                        "/v1/generate/stream"):
            self._send(404, {"error": "not found"})
            return
        self.server.router._proxy(self, path)

    def _send(self, code: int, doc: dict,
              request_id: Optional[str] = None,
              headers: Optional[dict] = None) -> None:
        if request_id and code >= 400 and "request_id" not in doc:
            # error bodies carry the request id too: a client that lost
            # the headers (proxies, log scrapers) can still correlate
            doc = dict(doc, request_id=request_id)
        body = json.dumps(doc).encode("utf-8")
        _M_REQUESTS.labels(code=str(code)).inc()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if request_id:
                self.send_header(REQUEST_ID_HEADER, request_id)
            for k, v in (headers or {}).items():
                if v is not None:
                    self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            self.close_connection = True


class FleetRouter:
    """Router tier over replica serving endpoints (see module docstring).

    ``replicas`` maps replica id -> base URL (``"http://host:port"``; a
    bare ``"host:port"`` is accepted) or is an iterable of base URLs
    (ids are assigned ``r0..rN``). The set is fixed at construction;
    health state (heartbeat, circuit, draining) changes at runtime.

    ``start()`` binds the async HTTP front-end (``HVD_TPU_FLEET_PORT``,
    0 = ephemeral) and starts the liveness monitor + circuit-probe
    thread; ``stop()`` tears all three down. Requests proxied:
    ``POST /v1/infer`` and ``POST /v1/generate``; control plane:
    ``GET /healthz``, ``POST /fleet/heartbeat/<replica-id>``.
    """

    def __init__(self,
                 replicas: Union[Mapping[str, str], Iterable[str]],
                 port: Optional[int] = None, addr: str = "0.0.0.0",
                 verbose: bool = False,
                 tenants: Optional[TenantRegistry] = None,
                 heartbeat_timeout: Optional[float] = None,
                 heartbeat_interval: Optional[float] = None,
                 request_timeout: Optional[float] = None,
                 pools: Optional[Mapping[str, str]] = None):
        cfg = _config.live_config()
        if isinstance(replicas, Mapping):
            items = list(replicas.items())
        else:
            items = [(f"r{i}", url) for i, url in enumerate(replicas)]
        if not items:
            raise ValueError("FleetRouter needs at least one replica")
        # disagg pool membership (replica id -> prefill|decode|colocated;
        # ids absent from ``pools`` stay colocated). Must mirror each
        # replica's own HVD_TPU_DISAGG_ROLE — the router routes by this
        # map, the replica behaves by its role knob.
        pools = dict(pools or {})
        self._replicas: Dict[str, _Replica] = {}
        for replica_id, url in items:
            url = str(url)
            if "//" not in url:
                url = "http://" + url
            pool = str(pools.pop(str(replica_id), "colocated"))
            if pool not in ("prefill", "decode", "colocated"):
                raise ValueError(
                    f"replica {replica_id!r}: pool must be one of "
                    f"prefill|decode|colocated, got {pool!r}")
            self._replicas[str(replica_id)] = _Replica(
                str(replica_id), url, pool=pool)
        if pools:
            raise ValueError(f"pools= names unknown replicas: "
                             f"{sorted(pools)}")
        # the fleet runs disaggregated iff any replica is pool-split;
        # fixed at construction, so the request path reads it lock-free
        self._disagg = any(r.pool != "colocated"
                           for r in self._replicas.values())
        if self._disagg and not all(
                any(r.in_pool(p) for r in self._replicas.values())
                for p in ("prefill", "decode")):
            raise ValueError("a disaggregated fleet needs at least one "
                             "replica in each of the prefill and decode "
                             "pools (colocated replicas count for both)")
        self._lock = _locks.lock("fleet.FleetRouter._lock")
        self._requested_port = int(cfg.get(_config.FLEET_PORT)
                                   if port is None else port)
        self._addr = addr
        self._verbose = verbose
        self._request_timeout = float(
            cfg.get(_config.HTTP_READ_TIMEOUT)
            if request_timeout is None else request_timeout) or 30.0
        self._per_replica = max(1, int(
            cfg.get(_config.FLEET_REPLICA_CONCURRENCY)))
        self._circuit_threshold = max(1, int(
            cfg.get(_config.FLEET_CIRCUIT_THRESHOLD)))
        self._probe_policy = _retry.RetryPolicy(
            max_attempts=1,
            initial_backoff=float(cfg.get(_config.FLEET_PROBE_BACKOFF)),
            max_backoff=float(cfg.get(_config.FLEET_PROBE_MAX_BACKOFF)))
        self.tenants = tenants if tenants is not None else TenantRegistry(
            cfg=cfg)
        self.scheduler = FairScheduler(
            capacity_fn=self._capacity,
            capacity_detail_fn=self._capacity_detail)
        self.retry_budget = RetryBudget()
        self._default_deadline_ms = float(
            cfg.get(_config.FLEET_DEFAULT_DEADLINE_MS))
        self._hedge_quantile = float(cfg.get(_config.FLEET_HEDGE_QUANTILE))
        #: successful proxy latencies (seconds), the hedge-delay sample
        self._latencies: "collections.deque" = collections.deque(
            maxlen=_LATENCY_WINDOW)
        #: replica id -> {request_id: budget_ts or None} for active
        #: generation streams — rolling_reload bounds a draining
        #: replica's wait by the streams' own end-to-end budgets
        self._active_streams: Dict[str, Dict[str, Optional[float]]] = {}
        hb_interval = float(cfg.get(_config.FLEET_HEARTBEAT_INTERVAL)
                            if heartbeat_interval is None
                            else heartbeat_interval)
        hb_timeout = float(cfg.get(_config.FLEET_HEARTBEAT_TIMEOUT)
                           if heartbeat_timeout is None
                           else heartbeat_timeout)
        self.monitor = LivenessMonitor(
            on_dead=self._on_replica_dead, on_alive=self._on_replica_alive,
            timeout=hb_timeout, poll_interval=max(0.05, hb_interval),
            label="fleet", thread_name="hvd-fleet-hb-monitor")
        #: routable-replica counts, mirrored on every health/drain
        #: change; read lock-free by the scheduler's capacity_fn. The
        #: per-pool counts include colocated replicas in both pools.
        self._routable_count = len(self._replicas)
        self._pool_routable = {
            p: sum(1 for r in self._replicas.values() if r.in_pool(p))
            for p in ("prefill", "decode")}
        self._httpd = None
        self._stop_probe = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        for replica in self._replicas.values():
            _M_OUTSTANDING.labels(replica=replica.id).set(0)

    # -- lifecycle -----------------------------------------------------------
    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("FleetRouter not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> int:
        if self._httpd is None:
            self._httpd = _http.start_server(
                _RouterHandler, port=self._requested_port, addr=self._addr,
                name="hvd-tpu-fleet-http", verbose=self._verbose)
            self._httpd.router = self
            self.monitor.start()
            self._stop_probe.clear()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="hvd-fleet-probe", daemon=True)
            self._probe_thread.start()
            log.info("fleet: router on %s:%d fronting %d replica(s)",
                     self._addr, self.port, len(self._replicas))
        return self.port

    def stop(self) -> None:
        self._stop_probe.set()
        thread, self._probe_thread = self._probe_thread, None
        if thread is not None:
            thread.join(timeout=2)
        self.monitor.stop()
        self.scheduler.close()
        httpd, self._httpd = self._httpd, None
        _http.stop_server(httpd)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- introspection / control plane ---------------------------------------
    def replica_ids(self) -> Tuple[str, ...]:
        return tuple(sorted(self._replicas))

    def replica_url(self, replica_id: str) -> str:
        return self._replicas[replica_id].base_url

    def outstanding(self, replica_id: str) -> int:
        with self._lock:
            return self._replicas[replica_id].outstanding

    def routable_count(self) -> int:
        return self._routable_count

    def health_doc(self) -> dict:
        with self._lock:
            replicas = {r.id: {"state": r.state(),
                               "pool": r.pool,
                               "outstanding": r.outstanding,
                               "url": r.base_url,
                               "capabilities": r.capabilities}
                        for r in self._replicas.values()}
            routable = self._routable_count
            effective = self._effective_routable()
            pool_routable = dict(self._pool_routable)
        doc = {"status": "routing" if effective else "degraded",
               "routable": routable, "replicas": replicas,
               "disagg": self._disagg,
               "admission": self.scheduler.capacity(),
               "tenants": self.scheduler.stats()}
        if self._disagg:
            # per-pool routable counts: the min is the fleet's
            # effective width (colocated replicas count in both)
            doc["pools"] = pool_routable
        return doc

    def observe_beat(self, replica_id: str,
                     capabilities: Optional[dict] = None) -> bool:
        if replica_id not in self._replicas:
            return False
        if capabilities is not None:
            with self._lock:
                self._replicas[replica_id].capabilities = capabilities
        self.monitor.observe_key(replica_id, meta=replica_id)
        return True

    def set_draining(self, replica_id: str, draining: bool) -> None:
        with self._lock:
            self._replicas[replica_id].draining = bool(draining)
            self._recount_locked()
        self._kick_scheduler()

    def stream_drain_extension(self, replica_id: str) -> float:
        """Seconds until the last active generation stream on
        ``replica_id`` must shed at its own end-to-end budget (0.0 =
        no budgeted stream). ``rolling_reload`` adds this to its drain
        bound: a long-lived stream may legitimately hold a draining
        replica, but only as long as its budget allows."""
        with self._lock:
            budgets = list(self._active_streams.get(replica_id,
                                                    {}).values())
        now = time.monotonic()
        finite = [b for b in budgets if b is not None]
        return max([0.0] + [b - now for b in finite])

    def _stream_enter(self, replica_id: str, request_id: str,
                      budget_ts: Optional[float]) -> None:
        with self._lock:
            self._active_streams.setdefault(replica_id,
                                            {})[request_id] = budget_ts

    def _stream_exit(self, replica_id: str, request_id: str) -> None:
        with self._lock:
            self._active_streams.get(replica_id, {}).pop(request_id, None)

    # -- health state transitions --------------------------------------------
    def _recount_locked(self) -> None:
        self._routable_count = sum(
            1 for r in self._replicas.values() if r.routable)
        self._pool_routable = {
            p: sum(1 for r in self._replicas.values()
                   if r.routable and r.in_pool(p))
            for p in ("prefill", "decode")}

    def _effective_routable(self) -> int:
        """Replicas that bound fleet capacity: the full routable count
        colocated, the NARROWEST pool disaggregated — every request
        crosses both pools, so the thin pool is the throughput wall."""
        if not self._disagg:
            return self._routable_count
        return min(self._pool_routable.values())

    def _capacity(self) -> int:
        # lock-free read (called under the scheduler lock; taking the
        # router lock here would nest the two in the opposite order of
        # set_draining -> scheduler.kick)
        return self._effective_routable() * self._per_replica

    def _capacity_detail(self) -> dict:
        """Per-pool capacity breakdown for FairScheduler introspection
        (lock-free, same rationale as :meth:`_capacity`)."""
        doc = {"per_replica": self._per_replica,
               "routable": self._routable_count}
        if self._disagg:
            doc["pools"] = dict(self._pool_routable)
        return doc

    def _kick_scheduler(self) -> None:
        """Re-run grants after a capacity change; when the change took
        the fleet to ZERO routable replicas, flush the queue with fast
        503s — every queued waiter would otherwise sit out its own
        deadline against a fleet that cannot dispatch anything. The
        flush is an explicit transition signal, never inferred from a
        capacity_fn()==0 read: a scheduler constructed with zero
        capacity (unit tests, pre-start wiring) must still queue."""
        self.scheduler.kick()
        if self._effective_routable() == 0:
            # disaggregated: an EMPTY pool zeroes capacity even with
            # the other pool healthy — flush for the same reason
            self.scheduler.flush_no_capacity()

    def _on_replica_dead(self, replica_id: str, _meta: str) -> None:
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None or replica.hb_dead:
                return
            replica.hb_dead = True
            self._recount_locked()
        _M_EJECTIONS.labels(replica=replica_id, reason="heartbeat").inc()
        log.warning("fleet: no heartbeat from replica %s for more than "
                    "%.1fs; ejecting it from routing", replica_id,
                    self.monitor.timeout)
        self._kick_scheduler()

    def _on_replica_alive(self, replica_id: str) -> None:
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None or not replica.hb_dead:
                return
            replica.hb_dead = False
            # recovery also wipes the passive signal: the next request's
            # failure re-opens the circuit if the recovery was illusory
            replica.circuit_open = False
            replica.failure_streak = 0
            self._recount_locked()
        log.info("fleet: heartbeats from replica %s resumed; re-admitted",
                 replica_id)
        self.scheduler.kick()

    def _note_failure(self, replica_id: str) -> None:
        opened = False
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None:
                return
            replica.failure_streak += 1
            if (replica.failure_streak >= self._circuit_threshold
                    and not replica.circuit_open):
                replica.circuit_open = True
                replica.probe_attempt = 1
                replica.next_probe_at = time.monotonic() + \
                    self._probe_policy.backoff(1)
                self._recount_locked()
                opened = True
        if opened:
            _M_EJECTIONS.labels(replica=replica_id, reason="circuit").inc()
            log.warning("fleet: replica %s failed %d consecutive requests; "
                        "circuit opened (half-open probes scheduled)",
                        replica_id, self._circuit_threshold)
            self._kick_scheduler()

    def _note_success(self, replica_id: str) -> None:
        closed = False
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None:
                return
            replica.failure_streak = 0
            if replica.circuit_open:
                replica.circuit_open = False
                replica.probe_attempt = 0
                self._recount_locked()
                closed = True
        if closed:
            log.info("fleet: replica %s recovered; circuit closed",
                     replica_id)
            self.scheduler.kick()

    def _probe_loop(self) -> None:
        while not self._stop_probe.is_set():
            self._stop_probe.wait(0.05)
            if self._stop_probe.is_set():
                return
            self.probe_now()

    def probe_now(self) -> None:
        """One half-open sweep: GET /healthz on every circuit-opened
        replica whose backoff elapsed (callable directly from tests)."""
        now = time.monotonic()
        with self._lock:
            due = [(r.id, r.base_url, r.probe_attempt)
                   for r in self._replicas.values()
                   if r.circuit_open and not r.hb_dead
                   and r.next_probe_at <= now]
        for replica_id, base_url, attempt in due:
            try:
                with urllib.request.urlopen(base_url + "/healthz",
                                            timeout=self._request_timeout):
                    pass
            except Exception:  # noqa: BLE001 — probe failure is the signal
                with self._lock:
                    replica = self._replicas.get(replica_id)
                    if replica is not None and replica.circuit_open:
                        replica.probe_attempt = attempt + 1
                        replica.next_probe_at = time.monotonic() + \
                            self._probe_policy.backoff(attempt + 1)
                continue
            self._note_success(replica_id)

    # -- request path --------------------------------------------------------
    def _pick(self, exclude, pool: Optional[str] = None,
              prefer: Optional[str] = None,
              strict: bool = False) -> Optional[_Replica]:
        """Least-outstanding routable replica (claims one outstanding
        slot); ``exclude`` holds replica ids already failed this
        request. ``pool`` restricts candidates to one disagg pool
        (colocated replicas belong to both, unless ``strict``);
        ``prefer`` names the replica to take when it is still eligible
        — the decode replica already holding this request's transferred
        KV blocks beats the load-balance pick."""
        with self._lock:
            candidates = [r for r in self._replicas.values()
                          if r.routable and r.id not in exclude
                          and (r.pool == pool if strict
                               else r.in_pool(pool))]
            if not candidates:
                return None
            preferred = [r for r in candidates if r.id == prefer]
            replica = preferred[0] if preferred else min(
                candidates, key=lambda r: (r.outstanding, r.id))
            replica.outstanding += 1
            outstanding = replica.outstanding
        _M_OUTSTANDING.labels(replica=replica.id).set(outstanding)
        return replica

    def _peek(self, pool: Optional[str] = None) -> Optional[str]:
        """Least-outstanding routable replica id in ``pool`` WITHOUT
        claiming a slot — the prestage hop's way of choosing the decode
        replica it will transfer KV to, before the generate forward
        claims it for real (via ``prefer=``)."""
        with self._lock:
            candidates = [r for r in self._replicas.values()
                          if r.routable and r.in_pool(pool)]
            if not candidates:
                return None
            return min(candidates,
                       key=lambda r: (r.outstanding, r.id)).id

    def _done(self, replica: _Replica) -> None:
        with self._lock:
            replica.outstanding = max(0, replica.outstanding - 1)
            outstanding = replica.outstanding
        _M_OUTSTANDING.labels(replica=replica.id).set(outstanding)

    def _proxy(self, handler: _RouterHandler, path: str) -> None:
        request_id = handler.headers.get(REQUEST_ID_HEADER) \
            or _tracing.new_request_id()
        try:
            length = int(handler.headers.get("Content-Length", 0))
            body = handler.rfile.read(length)
        except (ValueError, OSError):
            handler._send(400, {"error": "bad request body"}, request_id)
            return
        tenant = self.tenants.resolve(handler.headers)
        # every primary request earns its tenant retry-budget tokens —
        # the denominator of the "retries <= ratio * traffic" contract
        self.retry_budget.note_request(tenant.name)
        # the root span of a traced request's cross-host timeline: every
        # downstream hop (admission, replica server, batcher, collective)
        # nests under it via the propagated context
        with _tracing.request_span("router.route", request_id,
                                   args={"path": path,
                                         "tenant": tenant.name}):
            if self._routable_count == 0:
                # a fully-unroutable fleet fails fast: queueing at zero
                # capacity would burn the client's deadline to say less
                log.warning("fleet: request %s (tenant %s): no routable "
                            "replica", request_id, tenant.name)
                handler._send(503, {"error": "no routable replicas"},
                              request_id)
                return
            # end-to-end budget: the client's X-HVD-TPU-Deadline-Ms
            # header wins, else the fleet default knob mints one; with
            # neither, the legacy SERVING_DEADLINE_MS still bounds the
            # queue wait but nothing is propagated downstream
            budget_ts = None
            raw_ms = handler.headers.get(DEADLINE_HEADER)
            if raw_ms is None and self._default_deadline_ms > 0:
                raw_ms = self._default_deadline_ms
            if raw_ms is not None:
                try:
                    budget_ms = float(raw_ms)
                except (TypeError, ValueError):
                    handler._send(400, {"error": f"bad {DEADLINE_HEADER} "
                                        f"header: {raw_ms!r}"}, request_id)
                    return
                if budget_ms <= 0:
                    handler._send(
                        429, {"error": "end-to-end deadline already "
                              "spent at the router", "stage": "route"},
                        request_id,
                        headers={DEADLINE_STAGE_HEADER: "route"})
                    return
                budget_ts = time.monotonic() + budget_ms / 1e3
            deadline_ts = budget_ts
            if deadline_ts is None:
                legacy_ms = float(_config.live_config().get(
                    _config.SERVING_DEADLINE_MS) or 0)
                if legacy_ms > 0:
                    deadline_ts = time.monotonic() + legacy_ms / 1e3
            try:
                with _tracing.span("router.admission",
                                   args={"tenant": tenant.name}):
                    self.scheduler.acquire(tenant, deadline_ts=deadline_ts)
            except TenantQuotaError as e:
                handler._send(429, {"error": str(e), "tenant": tenant.name},
                              request_id)
                return
            except NoCapacityError as e:
                handler._send(503, {"error": str(e), "tenant": tenant.name},
                              request_id)
                return
            except DeadlineExceededError as e:
                handler._send(429, {"error": str(e), "tenant": tenant.name},
                              request_id,
                              headers={DEADLINE_STAGE_HEADER:
                                       getattr(e, "stage", None)})
                return
            try:
                pool = prefer = None
                if self._disagg and path in ("/v1/generate",
                                             "/v1/generate/stream"):
                    # disaggregated generate: run prefill on the
                    # prefill pool and ship the KV blocks to the decode
                    # replica we are about to hand the stream to; any
                    # prestage failure degrades to a cold decode-pool
                    # forward (the replica re-prefills locally)
                    pool = "decode"
                    status, prefer = self._disagg_prestage(
                        body, request_id, tenant.name, budget_ts)
                    if status == "shed":
                        # budget died inside the KV hop: the shed is
                        # the TRANSFER stage's (constructing the error
                        # attributes it on the stage counter)
                        e = DeadlineExceededError(
                            "end-to-end deadline spent in the disagg "
                            "KV transfer", stage="transfer")
                        handler._send(
                            429, {"error": str(e), "stage": "transfer"},
                            request_id,
                            headers={DEADLINE_STAGE_HEADER: "transfer"})
                        return
                if path == "/v1/generate/stream":
                    self._forward_stream(handler, path, body, request_id,
                                         tenant.name, budget_ts,
                                         pool=pool, prefer=prefer)
                else:
                    self._forward(handler, path, body, request_id,
                                  tenant.name, budget_ts,
                                  pool=pool, prefer=prefer)
            finally:
                self.scheduler.release(tenant)

    # -- disaggregated prestage (prefill pool -> decode pool KV hop) ---------
    def _disagg_prestage(self, body: bytes, request_id: str,
                         tenant_name: str,
                         budget_ts: Optional[float]
                         ) -> Tuple[str, Optional[str]]:
        """Run the KV hop for one generate request: prefill the prompt
        on the prefill pool, then offer the resulting content-addressed
        manifest to the decode replica the generate forward should pin
        (``prefer=``). Returns ``(status, decode_replica_id)``:

        * ``("ok", id)`` — blocks offered (or nothing worth shipping);
          forward to ``id`` for zero-debt admission;
        * ``("cold", id_or_None)`` — the hop failed somewhere
          non-fatal (prefill pool empty/unreachable, offer refused);
          forward normally, the decode replica re-prefills locally.
          NEVER client-visible: degradation is the disagg contract;
        * ``("shed", None)`` — the end-to-end budget died inside the
          hop; the request is over, attributed to the ``transfer``
          stage.
        """
        decode_id = self._peek(pool="decode")
        # strictly-prefill replicas only: a colocated replica answering
        # /v1/generate would run the FULL generation, not a prefill
        prefill = self._pick(set(), pool="prefill", strict=True)
        if decode_id is None or prefill is None:
            if prefill is not None:
                self._done(prefill)
            return ("cold", decode_id)
        try:
            req = urllib.request.Request(
                prefill.base_url + "/v1/generate", data=body,
                method="POST",
                headers=self._headers_for(request_id, 0, budget_ts))
            with urllib.request.urlopen(
                    req, timeout=self._request_timeout) as resp:
                doc = json.loads(resp.read())
            self._note_success(prefill.id)
        except urllib.error.HTTPError as e:
            if e.code >= 500:
                self._note_failure(prefill.id)
            else:
                self._note_success(prefill.id)
            log.warning("fleet: request %s (tenant %s): prefill-pool "
                        "prestage rejected by %s (%d); decoding cold",
                        request_id, tenant_name, prefill.id, e.code)
            return ("cold", decode_id)
        except Exception as e:  # noqa: BLE001 — connect/read failure
            self._note_failure(prefill.id)
            log.warning("fleet: request %s (tenant %s): prefill replica "
                        "%s unreachable (%s); decoding cold",
                        request_id, tenant_name, prefill.id, e)
            return ("cold", decode_id)
        finally:
            self._done(prefill)
        manifest = doc.get("manifest") or {}
        hashes = [str(h) for h in manifest.get("hashes") or []]
        source = manifest.get("source")
        if not hashes:
            # short prompt: nothing block-aligned to ship — the decode
            # replica's sub-block prefill IS the cheapest path
            return ("ok", decode_id)
        left = self._budget_left_ms(budget_ts)
        if left is not None and left <= 0:
            # constructing the error attributes the shed on the
            # transfer stage's counter (batcher.py idiom)
            DeadlineExceededError(
                "end-to-end deadline spent before the KV offer",
                stage="transfer")
            return ("shed", None)
        try:
            with _tracing.span("disagg.offer",
                               args={"prefill": prefill.id,
                                     "decode": decode_id,
                                     "blocks": len(hashes)}):
                req = urllib.request.Request(
                    self.replica_url(decode_id) + "/v1/kv/offer",
                    data=json.dumps({"hashes": hashes,
                                     "source": source}).encode("utf-8"),
                    method="POST",
                    headers=self._headers_for(request_id, 0, budget_ts))
                with urllib.request.urlopen(
                        req, timeout=self._request_timeout) as resp:
                    json.loads(resp.read())
        except urllib.error.HTTPError as e:
            if e.code == 429 and e.headers.get(
                    DEADLINE_STAGE_HEADER) == "transfer":
                # the decode replica shed the offer on budget (and
                # already attributed it): the request is over
                return ("shed", None)
            log.warning("fleet: request %s: KV offer to %s rejected "
                        "(%d); decoding cold", request_id, decode_id,
                        e.code)
            return ("cold", decode_id)
        except Exception as e:  # noqa: BLE001 — offer failure degrades
            log.warning("fleet: request %s: KV offer to %s failed (%s); "
                        "decoding cold", request_id, decode_id, e)
            return ("cold", decode_id)
        return ("ok", decode_id)

    # -- forwarding helpers --------------------------------------------------
    def _budget_left_ms(self, budget_ts: Optional[float]) -> Optional[float]:
        return None if budget_ts is None \
            else (budget_ts - time.monotonic()) * 1e3

    def _headers_for(self, request_id: str, attempt: int,
                     budget_ts: Optional[float]) -> dict:
        """Per-attempt forward headers: the request id and trace parent
        are IDENTICAL across attempts (one trace, not N); the attempt
        ordinal and the re-stamped remaining budget differ."""
        headers = {"Content-Type": "application/json",
                   REQUEST_ID_HEADER: request_id,
                   _tracing.ATTEMPT_HEADER: str(attempt)}
        ctx = _tracing.current()
        if ctx is not None:
            # sampled request: hand the replica our span as parent so
            # its server span nests under this proxy hop
            headers[_tracing.TRACE_PARENT_HEADER] = ctx.encode()
        left = self._budget_left_ms(budget_ts)
        if left is not None:
            headers[DEADLINE_HEADER] = f"{max(left, 0.0):.3f}"
        return headers

    def _budget_died(self, handler: _RouterHandler,
                     request_id: str) -> None:
        handler._send(429, {"error": "end-to-end deadline spent at the "
                            "router", "stage": "route"}, request_id,
                      headers={DEADLINE_STAGE_HEADER: "route"})

    def _hedge_delay(self) -> Optional[float]:
        """Seconds to wait on the primary before hedging; None while
        hedging is disabled (knob 0) or the latency sample is thin."""
        if self._hedge_quantile <= 0:
            return None
        with self._lock:
            if len(self._latencies) < _MIN_HEDGE_SAMPLES:
                return None
            lat = sorted(self._latencies)
        idx = min(len(lat) - 1, int(self._hedge_quantile * len(lat)))
        return max(1e-3, lat[idx])

    def _note_latency(self, seconds: float) -> None:
        with self._lock:
            self._latencies.append(seconds)

    def _cancel_on(self, replica: _Replica, request_id: str) -> None:
        """Fire-and-forget loser cancel: tell ``replica`` to stop
        generating for ``request_id`` (asynchronous and idempotent on
        the serving side; a dead replica just drops it)."""
        def post():
            try:
                req = urllib.request.Request(
                    replica.base_url + "/v1/cancel",
                    data=json.dumps({"request_id": request_id}).encode(),
                    method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=2.0):
                    pass
            except Exception:  # noqa: BLE001 — best-effort by design
                pass
        threading.Thread(target=post, name="hvd-fleet-cancel",
                         daemon=True).start()

    def _attempt(self, replica: _Replica, path: str, body: bytes,
                 headers: dict, attempt: int, results: "queue.Queue",
                 trace_ctx) -> None:
        """One forwarded attempt, run on its own thread so hedges can
        race; the outcome tuple is
        ``(attempt, replica, code, payload, stage, exc)``."""
        t0 = time.monotonic()
        req = urllib.request.Request(replica.base_url + path, data=body,
                                     method="POST", headers=headers)
        try:
            with urllib.request.urlopen(
                    req, timeout=self._request_timeout) as resp:
                payload, code, stage = resp.read(), resp.status, None
            self._note_success(replica.id)
        except urllib.error.HTTPError as e:
            # the replica answered: relay its verdict. 5xx also feeds
            # the circuit (server sickness); 4xx is the client's own.
            payload, code = e.read(), e.code
            stage = e.headers.get(DEADLINE_STAGE_HEADER)
            if code >= 500:
                self._note_failure(replica.id)
            else:
                self._note_success(replica.id)
        except Exception as e:  # noqa: BLE001 — connect/read failure
            self._note_failure(replica.id)
            self._done(replica)
            results.put((attempt, replica, None, None, None, e))
            return
        finally:
            if trace_ctx is not None:
                # attempt-numbered span in the REQUEST's trace: retries
                # and hedges are visible as siblings, not new requests
                _tracing.emit_span(trace_ctx, "router.attempt", t0,
                                   time.monotonic(),
                                   args={"attempt": attempt,
                                         "replica": replica.id})
        self._done(replica)
        results.put((attempt, replica, code, payload, stage, None))

    def _forward(self, handler: _RouterHandler, path: str, body: bytes,
                 request_id: str, tenant_name: str,
                 budget_ts: Optional[float],
                 pool: Optional[str] = None,
                 prefer: Optional[str] = None) -> None:
        try:
            _FP_ROUTE.fire()
        except _faults.InjectedFault as e:
            log.warning("fleet: request %s (tenant %s) failed at the "
                        "router: %s", request_id, tenant_name, e)
            handler._send(503, {"error": f"router fault: {e}"}, request_id)
            return
        exclude = set()
        attempt = 0
        t_start = time.monotonic()
        ctx = _tracing.current()
        while True:
            left = self._budget_left_ms(budget_ts)
            if left is not None and left <= 0:
                self._budget_died(handler, request_id)
                return
            replica = self._pick(exclude, pool=pool, prefer=prefer)
            prefer = None    # only the first attempt gets the KV pin
            if replica is None:
                log.warning("fleet: request %s (tenant %s): no routable "
                            "replica", request_id, tenant_name)
                handler._send(503, {"error": "no routable replicas"},
                              request_id)
                return
            results: "queue.Queue" = queue.Queue()
            arms = {attempt: replica}
            primary_attempt = attempt
            threading.Thread(
                target=self._attempt,
                args=(replica, path, body,
                      self._headers_for(request_id, attempt, budget_ts),
                      attempt, results, ctx),
                name="hvd-fleet-attempt", daemon=True).start()
            first = None
            delay = self._hedge_delay()
            if delay is not None:
                try:
                    first = results.get(timeout=delay)
                except queue.Empty:
                    # slow primary: race a second replica — if the
                    # tenant still has retry budget and the fleet has a
                    # second replica to spare
                    if self.retry_budget.try_spend(tenant_name):
                        hedge = self._pick(exclude | {replica.id},
                                           pool=pool)
                        if hedge is not None:
                            attempt += 1
                            _M_HEDGES.labels(outcome="launched").inc()
                            threading.Thread(
                                target=self._attempt,
                                args=(hedge, path, body,
                                      self._headers_for(request_id,
                                                        attempt,
                                                        budget_ts),
                                      attempt, results, ctx),
                                name="hvd-fleet-hedge",
                                daemon=True).start()
                            arms[attempt] = hedge
            winner = None
            pending = len(arms)
            while pending:
                res = first if first is not None else results.get()
                first = None
                pending -= 1
                arm, used, code, payload, stage, exc = res
                if exc is None:
                    winner = res
                    break
                exclude.add(used.id)
                log.warning("fleet: request %s: replica %s unreachable "
                            "(%s); failing over", request_id, used.id, exc)
            if winner is not None:
                arm, used, code, payload, stage, _ = winner
                for other_arm, other in arms.items():
                    if other_arm != arm:
                        # first response wins; the loser (in flight or
                        # already done — cancel is idempotent) stops
                        # burning decode on an answer nobody will read
                        self._cancel_on(other, request_id)
                if len(arms) > 1 and arm != primary_attempt:
                    _M_HEDGES.labels(outcome="won").inc()
                if code < 500:
                    self._note_latency(time.monotonic() - t_start)
                self._relay(handler, code, payload, request_id,
                            headers={DEADLINE_STAGE_HEADER: stage})
                return
            # every arm died on connect: the next attempt is a RETRY
            # and must buy its way in — an exhausted budget degrades to
            # pass-through (relay the failure) instead of storming
            if not self.retry_budget.try_spend(tenant_name):
                log.warning("fleet: request %s (tenant %s): retry budget "
                            "exhausted; passing the failure through",
                            request_id, tenant_name)
                handler._send(503, {"error": "replica unreachable and "
                                    "tenant retry budget exhausted"},
                              request_id)
                return
            attempt += 1

    # -- streaming proxy (journal + mid-stream failover) ---------------------
    def _forward_stream(self, handler: _RouterHandler, path: str,
                        body: bytes, request_id: str, tenant_name: str,
                        budget_ts: Optional[float],
                        pool: Optional[str] = None,
                        prefer: Optional[str] = None) -> None:
        try:
            _FP_ROUTE.fire()
        except _faults.InjectedFault as e:
            log.warning("fleet: request %s (tenant %s) failed at the "
                        "router: %s", request_id, tenant_name, e)
            handler._send(503, {"error": f"router fault: {e}"}, request_id)
            return
        try:
            doc = json.loads(body) if body.strip() else {}
            orig_max = int(doc.get("max_tokens", 16))
            base_offset = int(doc.get("sample_offset", 0))
        except (ValueError, TypeError):
            handler._send(400, {"error": "bad request body"}, request_id)
            return
        journal = _StreamJournal(doc, orig_max, base_offset)
        exclude = set()
        attempt = 0
        started = False    # client headers (and meta record) sent
        while True:
            left = self._budget_left_ms(budget_ts)
            if left is not None and left <= 0:
                if started:
                    self._stream_fail(handler, 429, "end-to-end deadline "
                                      "spent at the router", request_id,
                                      stage="route")
                else:
                    self._budget_died(handler, request_id)
                return
            replica = self._pick(exclude, pool=pool, prefer=prefer)
            prefer = None    # only the first attempt gets the KV pin
            if replica is None:
                self._takeover_failed(handler, started, request_id,
                                      "no surviving replica to resume on"
                                      if started else
                                      "no routable replicas",
                                      count=started)
                return
            outcome = None
            self._stream_enter(replica.id, request_id, budget_ts)
            try:
                outcome = self._stream_attempt(
                    handler, replica, path, journal,
                    self._headers_for(request_id, attempt, budget_ts),
                    attempt, request_id, started)
            finally:
                self._stream_exit(replica.id, request_id)
                self._done(replica)
            kind = outcome[0]
            if kind == "done":
                self._note_success(replica.id)
                return
            if kind == "client_gone":
                # the CLIENT went away: stop the replica's decode, keep
                # the replica (it did nothing wrong)
                self._note_success(replica.id)
                self._cancel_on(replica, request_id)
                return
            if kind == "rejected":
                # the replica ANSWERED with a verdict pre-stream
                code, payload, stage = outcome[1]
                if code >= 500:
                    self._note_failure(replica.id)
                else:
                    self._note_success(replica.id)
                if not started:
                    if code < 500:
                        self._relay(handler, code, payload, request_id,
                                    headers={DEADLINE_STAGE_HEADER: stage})
                        return
                    # a 5xx before any stream: ordinary failover
                elif code < 500:
                    # mid-failover resume rejected with a client-class
                    # verdict (429 deadline, 400): the takeover failed
                    self._takeover_failed(
                        handler, started, request_id,
                        f"resume rejected by replica {replica.id} "
                        f"({code})", count=True)
                    return
            else:   # "severed" — connect error, mid-stream EOF, fault
                started = started or outcome[1]
                self._note_failure(replica.id)
                log.warning("fleet: request %s: stream severed on "
                            "replica %s (%s); attempting takeover",
                            request_id, replica.id, outcome[2])
            exclude.add(replica.id)
            # a takeover attempt is a RETRY: it buys its way in or the
            # failure passes through
            if not self.retry_budget.try_spend(tenant_name):
                self._takeover_failed(handler, started, request_id,
                                      "tenant retry budget exhausted",
                                      count=started)
                return
            attempt += 1

    def _stream_attempt(self, handler: _RouterHandler, replica: _Replica,
                        path: str, journal: "_StreamJournal",
                        headers: dict, attempt: int, request_id: str,
                        started: bool):
        """One streaming attempt against ``replica``; returns
        ``("done",)``, ``("client_gone",)``,
        ``("rejected", (code, payload, stage))`` or
        ``("severed", started, reason)``. Forwards records to the
        client as they arrive; on a resumed attempt (``attempt > 0``)
        the replica's meta record is swallowed — the client already
        has the original."""
        req = urllib.request.Request(
            replica.base_url + path, data=journal.request_body(attempt),
            method="POST", headers=headers)
        t0 = time.monotonic()
        try:
            resp = urllib.request.urlopen(req,
                                          timeout=self._request_timeout)
        except urllib.error.HTTPError as e:
            return ("rejected", (e.code, e.read(),
                                 e.headers.get(DEADLINE_STAGE_HEADER)))
        except Exception as e:  # noqa: BLE001 — connect failure
            return ("severed", started, f"connect: {e}")
        resumed_unmarked = attempt > 0
        try:
            with resp:
                while True:
                    try:
                        line = resp.readline()
                        if line:
                            # the mid-stream kill drill: an injected
                            # error here severs the stream at exactly
                            # this record, like the replica dying
                            _FP_STREAM.fire()
                    except Exception as e:  # noqa: BLE001 — read failure
                        return ("severed", started, f"read: {e}")
                    if not line:
                        # EOF without a terminal record: the replica
                        # died with the stream open
                        return ("severed", started,
                                "EOF before terminal record")
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        return ("severed", started, "corrupt record")
                    if "meta" in rec:
                        journal.note_meta(rec["meta"])
                        if attempt == 0:
                            if not self._stream_start(handler,
                                                      request_id, line):
                                return ("client_gone",)
                            started = True
                        continue
                    if "t" in rec:
                        journal.note_token(rec["t"])
                        if resumed_unmarked:
                            # the takeover is real the moment the
                            # surviving replica speaks
                            _M_FAILOVERS.labels(outcome="resumed").inc()
                            resumed_unmarked = False
                        if not self._stream_write(handler, line):
                            return ("client_gone",)
                        continue
                    if "error" in rec \
                            and int(rec.get("code") or 500) >= 500:
                        # the replica reported its own death in-band (a
                        # dying server flushes a 500 record before the
                        # socket drops): that is a severed stream, not
                        # a verdict — the takeover can still save the
                        # request. 4xx records (deadline, cancel) are
                        # the request's own and genuinely terminal.
                        return ("severed", started,
                                f"replica error record "
                                f"({rec.get('code')}): {rec.get('error')}")
                    # terminal record ("done" or a 4xx in-stream
                    # "error"): the stream ended cleanly — relay, finish
                    self._stream_write(handler, line)
                    if attempt == 0 and not started:
                        # error before meta should not happen, but
                        # never leave the client headerless
                        pass
                    self._note_latency(time.monotonic() - t0)
                    return ("done",)
        finally:
            try:
                resp.close()
            except Exception:  # noqa: BLE001
                pass

    def _stream_start(self, handler: _RouterHandler, request_id: str,
                      meta_line: bytes) -> bool:
        """Commit the client response as a stream (200 + NDJSON) and
        forward the meta record; False = client already gone."""
        _M_REQUESTS.labels(code="200").inc()
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/x-ndjson")
            handler.send_header(REQUEST_ID_HEADER, request_id)
            handler.send_header("Connection", "close")
            handler.close_connection = True
            handler.end_headers()
        except OSError:
            return False
        return self._stream_write(handler, meta_line)

    @staticmethod
    def _stream_write(handler: _RouterHandler, line: bytes) -> bool:
        try:
            handler.wfile.write(line if line.endswith(b"\n")
                                else line + b"\n")
            handler.wfile.flush()
            return True
        except OSError:
            return False

    def _stream_fail(self, handler: _RouterHandler, code: int,
                     message: str, request_id: str,
                     stage: Optional[str] = None) -> None:
        """Terminal failure for a stream that already committed its 200:
        an in-band error record (the client distinguishes it from a
        severed stream by its presence)."""
        self._stream_write(handler, json.dumps(
            {"error": message, "code": code, "stage": stage,
             "request_id": request_id}).encode("utf-8"))

    def _takeover_failed(self, handler: _RouterHandler, started: bool,
                         request_id: str, reason: str,
                         count: bool) -> None:
        if count:
            _M_FAILOVERS.labels(outcome="failed").inc()
        log.warning("fleet: request %s: stream takeover failed: %s",
                    request_id, reason)
        if started:
            self._stream_fail(handler, 503, reason, request_id)
        else:
            handler._send(503, {"error": reason}, request_id)

    @staticmethod
    def _relay(handler: _RouterHandler, code: int, payload: bytes,
               request_id: str, headers: Optional[dict] = None) -> None:
        _M_REQUESTS.labels(code=str(code)).inc()
        try:
            handler.send_response(code)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(payload)))
            handler.send_header(REQUEST_ID_HEADER, request_id)
            for k, v in (headers or {}).items():
                if v is not None:
                    handler.send_header(k, str(v))
            handler.end_headers()
            handler.wfile.write(payload)
        except OSError:
            handler.close_connection = True


class _StreamJournal:
    """Router-side journal of one streaming generation: the original
    request document plus everything the replica has emitted, enough to
    re-submit ``prompt + emitted`` elsewhere and continue bit-identically.

    The meta record supplies the one fact the router cannot know ahead
    of time — the EFFECTIVE seed (a seedless submit defaults to the
    replica-local sequence id) — and the resume document pins it, sets
    ``sample_offset`` to the absolute emission ordinal (the sampler's
    ``fold_in(key, emitted)`` continues the original sampled stream),
    and shrinks ``max_tokens`` by what was already delivered."""

    def __init__(self, doc: dict, orig_max: int, base_offset: int):
        self._doc = doc
        self._orig_max = orig_max
        self._base_offset = base_offset
        self._seed: Optional[int] = None
        self.tokens: List[int] = []

    def note_meta(self, meta: dict) -> None:
        if self._seed is None and isinstance(meta, dict):
            seed = meta.get("seed")
            self._seed = None if seed is None else int(seed)

    def note_token(self, token: int) -> None:
        self.tokens.append(int(token))

    def request_body(self, attempt: int) -> bytes:
        if attempt == 0:
            return json.dumps(self._doc).encode("utf-8")
        doc = dict(self._doc)
        doc["prompt"] = list(self._doc.get("prompt", [])) + self.tokens
        doc["max_tokens"] = max(1, self._orig_max - len(self.tokens))
        doc["sample_offset"] = self._base_offset + len(self.tokens)
        if self._seed is not None:
            doc["seed"] = self._seed
        return json.dumps(doc).encode("utf-8")


class _RouterBeatClient:
    """KV-client-shaped adapter: a replica's beats become POSTs to the
    router's heartbeat endpoint. Chaos site ``fleet.health``: an injected
    error here drops the beat on the floor (the silent-replica
    simulation) — the sender treats it like any delivery failure."""

    def __init__(self, router_url: str, timeout: float = 2.0,
                 payload: Optional[bytes] = None):
        self._url = router_url.rstrip("/")
        self._timeout = timeout
        # optional JSON capability document carried on every beat
        # (spec/beam enablement): the router stores it per replica and
        # republishes it on /fleet/health
        self._payload = payload

    def put(self, scope: str, key: str, value: bytes) -> None:
        _FP_HEALTH.fire()
        req = urllib.request.Request(
            self._url + HEARTBEAT_PATH + key,
            data=self._payload or value or b"-", method="POST")
        with urllib.request.urlopen(req, timeout=self._timeout):
            pass


class ReplicaHeartbeat:
    """Replica-side beat loop: tells the router this replica is alive
    every ``HVD_TPU_FLEET_HEARTBEAT_INTERVAL`` seconds (the
    :class:`~horovod_tpu_torch.elastic.heartbeat.HeartbeatSender` loop pointed
    at the router instead of the rendezvous store)."""

    def __init__(self, router_url: str, replica_id: str,
                 interval: Optional[float] = None,
                 capabilities: Optional[dict] = None):
        if interval is None:
            interval = float(_config.live_config().get(
                _config.FLEET_HEARTBEAT_INTERVAL))
        payload = (json.dumps(capabilities).encode("utf-8")
                   if capabilities else None)
        self._sender = HeartbeatSender(
            _RouterBeatClient(router_url, payload=payload),
            hostname=replica_id, local_rank=0, rank=replica_id,
            interval=interval, key=replica_id)

    def beat_once(self) -> bool:
        return self._sender.beat_once()

    def start(self) -> None:
        self._sender.start()

    def stop(self) -> None:
        self._sender.stop()
