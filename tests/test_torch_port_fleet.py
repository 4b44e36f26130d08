"""The port's serving fleet (horovod_tpu_torch.serving.fleet: the router,
tenancy and rolling reload) against the JAX package's, on the CPU.

* Host logic exactly: tenant resolution, the retry budget's accrual and
  spend, and the fair scheduler's grant order and virtual times, each
  scripted step by step on one thread through both packages (the
  scheduler's waiters are parked without a waiting thread: its
  condition's ``wait`` raises, which leaves the waiter queued, and the
  grants are read off the waiters' ``granted`` flag in the order they
  are set). The 16 ``FLEET_*`` knobs and their ``describe()`` lines.
* The router end to end over the port's ``InferenceServer`` replicas
  serving the row-wise linear model of tests/test_fleet.py: ejection on
  silence, the circuit and its half-open probe, request ids, least
  outstanding, a flooding tenant, rolling reload under traffic, the
  drain wedge, attempt headers, the zero-capacity flush and the retry
  budget, each as tests/test_fleet.py and tests/test_failover.py drive
  the JAX fleet.
* Under one ``faults.configure`` seed, a serial run of requests through
  the port's fleet answers the same sequence of status codes as the JAX
  fleet.

Timing: no test here bounds how long an ``acquire`` takes to be handed
the scheduler's lock (its waiters poll one condition every 50 ms and
lock hand-off is not fair, so under a loaded test host a sub-second bound
there is noise); the ejection bounds are the heartbeat contract's own.
"""

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

from horovod_tpu import config as jconfig
from horovod_tpu import faults as jfaults
from horovod_tpu import serving as jserving
from horovod_tpu.serving import fleet as jfleet
from horovod_tpu.serving.fleet import tenancy as jtenancy
from horovod_tpu_torch import checkpointing as tckpt
from horovod_tpu_torch import config as tconfig
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import serving as tserving
from horovod_tpu_torch import tracing as ttracing
from horovod_tpu_torch.serving import fleet as tfleet
from horovod_tpu_torch.serving.batcher import DEADLINE_HEADER
from horovod_tpu_torch.serving.fleet import rollout as trollout
from horovod_tpu_torch.serving.fleet import tenancy as ttenancy

SEED = 1234
IN_DIM, OUT_DIM = 4, 2
HB_TIMEOUT, HB_INTERVAL = 0.5, 0.1


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    jfaults.configure("", seed=0)
    tfaults.configure("", seed=0)


def _params(scale: float):
    """ones(IN_DIM) @ w -> 4 * scale per output: the serving checkpoint
    is readable off any output."""
    return {"w": np.full((IN_DIM, OUT_DIM), scale, np.float32),
            "b": np.zeros(OUT_DIM, np.float32)}


def _port_apply(params, x):
    return x.float() @ params["w"] + params["b"]


def _jax_apply(params, x):
    return x @ params["w"] + params["b"]


def _engine_kw(**kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("batch_timeout_ms", 2.0)
    kw.setdefault("deadline_ms", 0)
    kw.setdefault("reload_poll_seconds", 0)
    kw.setdefault("warmup", False)
    return kw


def _replica(ckpt=None, params=None, apply_fn=_port_apply, port=0, **kw):
    """A port replica on the CPU."""
    eng = tserving.InferenceEngine(
        apply_fn, checkpoint_dir=str(ckpt) if ckpt else None,
        params=params, device="cpu", **_engine_kw(**kw))
    srv = tserving.InferenceServer(eng, port=port, addr="127.0.0.1")
    srv.start()
    return srv


def _jax_replica(params=None, **kw):
    eng = jserving.InferenceEngine(_jax_apply, params=params,
                                   **_engine_kw(**kw))
    srv = jserving.InferenceServer(eng, port=0, addr="127.0.0.1")
    srv.start()
    return srv


def _router(pkg, replicas, **kw):
    kw.setdefault("addr", "127.0.0.1")
    kw.setdefault("heartbeat_timeout", HB_TIMEOUT)
    kw.setdefault("heartbeat_interval", HB_INTERVAL)
    r = pkg.FleetRouter(replicas, port=0, **kw)
    r.start()
    return r


def _url(srv):
    return f"http://127.0.0.1:{srv.port}"


def _post(url, doc=None, headers=None, timeout=30):
    body = json.dumps(doc if doc is not None
                      else {"inputs": [[1.0] * IN_DIM]}).encode()
    req = Request(url, data=body, method="POST",
                  headers={"Content-Type": "application/json",
                           **(headers or {})})
    try:
        with urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _delta(before, key):
    return tmetrics.snapshot().get(key, 0) - before.get(key, 0)


def _series(snap, name, **labels):
    hits = [v for k, v in snap.items() if k.startswith(name)
            and all(f'{n}="{v_}"' in k for n, v_ in labels.items())]
    assert len(hits) <= 1, hits
    return hits[0] if hits else None


def _dead_port():
    """A 127.0.0.1 port that refuses connections."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _wait(pred, timeout, msg=""):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, msg
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

FLEET_KNOBS = sorted(k for k in jconfig.knobs() if k.startswith("FLEET_"))


def test_all_fleet_knobs_registered_as_jax():
    assert len(FLEET_KNOBS) == 16
    jk, tk = jconfig.knobs(), tconfig.knobs()
    for name in FLEET_KNOBS:
        a, b = tk[name], jk[name]
        assert (a.default, a.alias, a.help) == (b.default, b.alias, b.help)
        assert a.parser("7") == b.parser("7")


def test_fleet_knobs_describe_as_jax(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLEET_HEDGE_QUANTILE", "0.75")
    monkeypatch.setenv("HVD_TPU_FLEET_TENANTS", '{"a": {"weight": 2}}')
    monkeypatch.setenv("HVD_TPU_FLEET_PORT", "not-a-number")

    def lines(mod):
        return {ln.split()[0]: ln for ln in mod.describe(mod.Config())
                .splitlines() if ln.startswith("HVD_TPU_FLEET_")}
    assert lines(tconfig) == lines(jconfig)
    assert len(lines(tconfig)) == 16
    for name in FLEET_KNOBS:
        assert tconfig.Config().resolve(name) == \
            jconfig.Config().resolve(name)


# ---------------------------------------------------------------------------
# tenancy: registry, retry budget, fair scheduler
# ---------------------------------------------------------------------------

SPEC = json.dumps({
    "gold": {"keys": ["k-gold"], "max_concurrent": 8, "weight": 4,
             "priority": 1},
    "free": {"keys": ["k-free1", "k-free2"], "max_queued": 2},
    "bronze": {"weight": 0.0}})


@pytest.mark.parametrize("headers", [
    {"X-HVD-TPU-API-Key": "k-gold"}, {"X-HVD-TPU-API-Key": "k-free2"},
    {"X-HVD-TPU-Tenant": "gold"}, {"X-HVD-TPU-Tenant": "nope"},
    {"X-HVD-TPU-API-Key": "bogus"}, {},
    {"X-HVD-TPU-API-Key": "bogus", "X-HVD-TPU-Tenant": "free"},
    {"X-HVD-TPU-API-Key": "k-free1", "X-HVD-TPU-Tenant": "gold"}])
def test_tenant_resolution_matches_jax(headers):
    t = ttenancy.TenantRegistry(spec=SPEC).resolve(headers)
    j = jtenancy.TenantRegistry(spec=SPEC).resolve(headers)
    assert (t.name, t.keys, t.max_concurrent, t.max_queued, t.weight,
            t.priority) == (j.name, j.keys, j.max_concurrent, j.max_queued,
                            j.weight, j.priority)


@pytest.mark.parametrize("spec", [SPEC, "", "{}"])
def test_tenant_table_and_defaults_match_jax(spec, monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLEET_TENANT_CONCURRENT", "3")
    monkeypatch.setenv("HVD_TPU_FLEET_TENANT_QUEUE_DEPTH", "5")
    monkeypatch.setenv("HVD_TPU_FLEET_TENANT_WEIGHT", "1.5")

    def table(mod):
        return {n: (t.keys, t.max_concurrent, t.max_queued, t.weight,
                    t.priority)
                for n, t in mod.TenantRegistry(spec=spec).tenants().items()}
    assert table(ttenancy) == table(jtenancy)
    monkeypatch.setenv("HVD_TPU_FLEET_TENANTS", spec)
    assert table(ttenancy) == table(jtenancy)


@pytest.mark.parametrize("ratio,burst", [(0.5, 2), (0.1, 16), (0.0, 1),
                                         (1.5, 3)])
def test_retry_budget_accrual_and_spend_match_jax(ratio, burst):
    rng = np.random.RandomState(int(ratio * 10) + burst)
    t, j = ttenancy.RetryBudget(ratio, burst), jtenancy.RetryBudget(ratio,
                                                                    burst)
    for _ in range(200):
        tenant = f"t{rng.randint(3)}"
        if rng.rand() < 0.5:
            t.note_request(tenant)
            j.note_request(tenant)
            got = want = None
        else:
            got, want = t.try_spend(tenant), j.try_spend(tenant)
        assert got == want
        assert t.tokens(tenant) == j.tokens(tenant)


def test_retry_budget_reads_its_knobs_as_jax(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLEET_RETRY_BUDGET_RATIO", "0.5")
    monkeypatch.setenv("HVD_TPU_FLEET_RETRY_BUDGET_BURST", "2")
    for mod in (ttenancy, jtenancy):
        b = mod.RetryBudget()
        assert b.try_spend("t") and b.try_spend("t")
        assert not b.try_spend("t")
        b.note_request("t")
        assert not b.try_spend("t")
        b.note_request("t")
        assert b.try_spend("t")


class _Parked(Exception):
    """Raised by a scripted scheduler's condition wait: the acquire
    returns to the script with its waiter still queued."""


def _run_script(mod, script, tenants):
    """``script`` through a FairScheduler of ``mod`` on this thread: per
    step, (step, outcome, every grant so far in order, stats())."""
    cap, log, cell = {"v": 0}, [], {}

    class Waiter(mod._Waiter):
        __slots__ = ("_granted", "tag")

        def __init__(self, *a, **kw):
            self.tag = cell["tag"]
            super().__init__(*a, **kw)

        @property
        def granted(self):
            return self._granted

        @granted.setter
        def granted(self, value):
            if value and not getattr(self, "_granted", False):
                log.append(self.tag)
            self._granted = value

    def park(timeout=None):
        raise _Parked()
    sched = mod.FairScheduler(capacity_fn=lambda: cap["v"])
    sched._cond.wait = park
    real, mod._Waiter = mod._Waiter, Waiter
    events = []
    try:
        for n, op in enumerate(script):
            outcome = None
            if op[0] == "arrive":
                cell["tag"] = f"{op[1]}#{n}"
                try:
                    sched.acquire(tenants[op[1]], deadline_ts=op[2])
                    outcome = "granted"
                except _Parked:
                    outcome = "queued"
                except mod.TenantQuotaError:
                    outcome = "quota"
            elif op[0] == "release":
                sched.release(tenants[op[1]])
            elif op[0] == "cap":
                cap["v"] = op[1]
                sched.kick()
            else:
                sched.flush_no_capacity()
            events.append((op, outcome, list(log), sched.stats()))
    finally:
        mod._Waiter = real
    return events


def _random_script(seed):
    rng = np.random.RandomState(seed)
    names = ["a", "b", "c", "d"]
    specs = {
        "a": dict(weight=1.0, max_concurrent=2, max_queued=4, priority=0),
        "b": dict(weight=2.0, max_concurrent=3, max_queued=6, priority=0),
        "c": dict(weight=0.5, max_concurrent=1, max_queued=3, priority=0),
        "d": dict(weight=1.0, max_concurrent=2, max_queued=2,
                  priority=int(seed % 2))}
    active = {n: 0 for n in names}
    script, cap = [], 0
    for _ in range(80):
        r = rng.rand()
        if r < 0.5:
            name = names[rng.randint(4)]
            # far-future deadlines: EDF order without ever expiring
            deadline = None if rng.rand() < 0.3 else \
                time.monotonic() + 1e6 + float(rng.randint(100))
            script.append(("arrive", name, deadline))
        elif r < 0.75:
            busy = [n for n in names if active[n] > 0]
            if busy:
                script.append(("release", busy[rng.randint(len(busy))]))
        elif r < 0.97:
            cap = max(0, min(6, cap + rng.choice([-1, 1, 1])))
            script.append(("cap", cap))
        else:
            script.append(("flush",))
        # the script needs the active counts only to pick releases; the
        # exact counts come from the run itself
        if script and script[-1][0] == "arrive":
            active[script[-1][1]] += 1
        elif script and script[-1][0] == "release":
            active[script[-1][1]] -= 1
    return script, specs


@pytest.mark.parametrize("seed", range(6))
def test_fair_scheduler_grants_and_virtual_times_match_jax(seed):
    """Priority classes, stride order over weights, EDF within a tenant,
    quota rejections, re-entry at the busy tenants' frontier, capacity
    changes and the zero-capacity flush: the same script through both
    packages grants the same waiters in the same order and leaves the
    same virtual times after every step."""
    script, specs = _random_script(seed)
    tenants_j = {n: jtenancy.Tenant(n, **s) for n, s in specs.items()}
    tenants_t = {n: ttenancy.Tenant(n, **s) for n, s in specs.items()}
    got = _run_script(ttenancy, script, tenants_t)
    want = _run_script(jtenancy, script, tenants_j)
    assert got == want
    outcomes = {e[1] for e in want}
    assert want[-1][2] and "queued" in outcomes, \
        "the script must queue and grant"


def test_edf_within_tenant_matches_jax():
    now = time.monotonic()
    script = [("arrive", "t", now + 1e6 + 30), ("arrive", "t", now + 1e6 + 8),
              ("arrive", "t", now + 1e6 + 15), ("arrive", "t", None),
              ("cap", 1), ("release", "t"), ("release", "t"),
              ("release", "t")]
    spec = dict(max_concurrent=16, max_queued=16)
    got = _run_script(ttenancy, script, {"t": ttenancy.Tenant("t", **spec)})
    want = _run_script(jtenancy, script, {"t": jtenancy.Tenant("t", **spec)})
    assert got == want
    assert got[-1][2] == ["t#1", "t#2", "t#0", "t#3"]


# ---------------------------------------------------------------------------
# the router end to end over port replicas
# ---------------------------------------------------------------------------

def test_kill_replica_ejected_within_2x_timeout_survivor_serves():
    r0, r1 = _replica(params=_params(1.0)), _replica(params=_params(1.0))
    router = _router(tfleet, {"r0": _url(r0), "r1": _url(r1)})
    hb0 = tfleet.ReplicaHeartbeat(router.url, "r0", interval=HB_INTERVAL)
    hb1 = tfleet.ReplicaHeartbeat(router.url, "r1", interval=HB_INTERVAL)
    failures, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            code, doc, _ = _post(router.url + "/v1/infer")
            if code != 200:
                failures.append((code, doc))
            time.sleep(0.01)

    try:
        hb0.start(), hb1.start()
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.4)
        hb1.stop()
        r1.stop()
        t_kill = time.monotonic()
        while router.health_doc()["replicas"]["r1"]["state"] != "dead":
            assert time.monotonic() - t_kill < 2 * HB_TIMEOUT, \
                router.health_doc()
            time.sleep(0.02)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert failures == [], failures[:5]
        assert router.routable_count() == 1
        assert _post(router.url + "/v1/infer")[0] == 200
    finally:
        stop.set()
        hb0.stop(), hb1.stop()
        router.stop()
        r0.close(), r1.close()


def test_circuit_opens_on_connect_errors_and_probes_reclose():
    good = _replica(params=_params(1.0))
    dead_port = _dead_port()
    router = _router(tfleet, {"good": _url(good),
                              "bad": f"http://127.0.0.1:{dead_port}"})
    try:
        for _ in range(6):
            assert _post(router.url + "/v1/infer")[0] == 200
        deadline = time.monotonic() + 5
        while router.health_doc()["replicas"]["bad"]["state"] \
                != "circuit_open":
            assert time.monotonic() < deadline, router.health_doc()
            _post(router.url + "/v1/infer")
            time.sleep(0.02)
        revived = _replica(params=_params(1.0), port=dead_port)
        try:
            _wait(lambda: router.health_doc()["replicas"]["bad"]["state"]
                  == "up", 10, router.health_doc())
        finally:
            revived.close()
    finally:
        router.stop()
        good.close()


def test_request_id_stamped_and_propagated():
    srv = _replica(params=_params(1.0))
    router = _router(tfleet, {"r0": _url(srv)})
    try:
        code, _, headers = _post(
            router.url + "/v1/infer",
            headers={tfleet.REQUEST_ID_HEADER: "req-abc123"})
        assert code == 200
        assert headers.get(tfleet.REQUEST_ID_HEADER) == "req-abc123"
        code, _, headers = _post(router.url + "/v1/infer")
        assert code == 200 and headers.get(tfleet.REQUEST_ID_HEADER)
        code, _, headers = _post(
            _url(srv) + "/v1/infer",
            headers={tfleet.REQUEST_ID_HEADER: "req-direct"})
        assert code == 200
        assert headers.get(tfleet.REQUEST_ID_HEADER) == "req-direct"
    finally:
        router.stop()
        srv.close()


def test_least_outstanding_prefers_idle_replica():
    r0, r1 = _replica(params=_params(1.0)), _replica(params=_params(1.0))
    router = _router(tfleet, {"r0": _url(r0), "r1": _url(r1)})
    seen = []
    real = router._pick

    def pick(*a, **kw):
        r = real(*a, **kw)
        seen.append(r.id)
        return r
    router._pick = pick
    try:
        before = tmetrics.snapshot()
        for _ in range(10):
            assert _post(router.url + "/v1/infer")[0] == 200
        # sequential requests see both replicas idle: the id tie-break
        # pins them to r0, so the count (not round-robin) decides
        assert seen == ["r0"] * 10
        assert _delta(before,
                      'hvd_tpu_fleet_requests_total{code="200"}') >= 10
        snap = tmetrics.snapshot()
        for rid in ("r0", "r1"):
            assert _series(snap, "hvd_tpu_fleet_outstanding",
                           replica=rid) == 0
    finally:
        router.stop()
        r0.close(), r1.close()


TENANTS = json.dumps({
    "good": {"keys": ["key-good"], "max_concurrent": 2, "max_queued": 8},
    "flood": {"keys": ["key-flood"], "max_concurrent": 2, "max_queued": 4}})


def test_flooding_tenant_gets_only_its_own_429s(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLEET_REPLICA_CONCURRENCY", "2")
    srv = _replica(params=_params(1.0))
    router = _router(tfleet, {"r0": _url(srv)},
                     tenants=tfleet.TenantRegistry(spec=TENANTS))
    before = tmetrics.snapshot()
    flood_codes, good_codes = [], []
    lock, stop = threading.Lock(), threading.Event()
    hdr = {DEADLINE_HEADER: "30000"}

    def flood():
        while not stop.is_set():
            code = _post(router.url + "/v1/infer", headers={
                tfleet.API_KEY_HEADER: "key-flood", **hdr})[0]
            with lock:
                flood_codes.append(code)

    def good():
        for _ in range(25):
            code = _post(router.url + "/v1/infer", headers={
                tfleet.API_KEY_HEADER: "key-good", **hdr})[0]
            with lock:
                good_codes.append(code)
            time.sleep(0.005)

    try:
        flooders = [threading.Thread(target=flood, daemon=True)
                    for _ in range(40)]
        for t in flooders:
            t.start()
        good_t = threading.Thread(target=good, daemon=True)
        good_t.start()
        good_t.join(timeout=120)
        assert not good_t.is_alive()
        stop.set()
        for t in flooders:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        stop.set()
        router.stop()
        srv.close()
    assert flood_codes.count(429) > 0
    assert set(flood_codes) <= {200, 429}
    assert good_codes == [200] * 25, good_codes
    snap = tmetrics.snapshot()
    flood_rej = (_series(snap, "hvd_tpu_fleet_tenant_rejected_total",
                         tenant="flood", reason="quota") or 0) - \
        (_series(before, "hvd_tpu_fleet_tenant_rejected_total",
                 tenant="flood", reason="quota") or 0)
    good_rej = sum(v for k, v in snap.items()
                   if k.startswith("hvd_tpu_fleet_tenant_rejected_total")
                   and 'tenant="good"' in k) - sum(
        v for k, v in before.items()
        if k.startswith("hvd_tpu_fleet_tenant_rejected_total")
        and 'tenant="good"' in k)
    assert flood_rej == flood_codes.count(429) and good_rej == 0
    hist = _series(snap, "hvd_tpu_fleet_tenant_queue_wait_seconds",
                   tenant="good")
    assert hist is not None and hist["count"] >= 25


def _fleet_of_checkpoints(tmp_path, n=2):
    replicas, urls = [], {}
    for i in range(n):
        ckpt = tmp_path / f"replica{i}"
        ckpt.mkdir()
        tckpt.save(str(ckpt), 1, _params(1.0))
        srv = _replica(ckpt)
        replicas.append(srv)
        urls[f"r{i}"] = _url(srv)
        tckpt.save(str(ckpt), 2, _params(2.0))
    return replicas, urls


def test_rolling_reload_mid_traffic_zero_failures(tmp_path, monkeypatch):
    replicas, urls = _fleet_of_checkpoints(tmp_path)
    router = _router(tfleet, urls)
    failures, seen, gauge_at_swap = [], [], []
    stop = threading.Event()
    real_post_reload = trollout._post_reload

    def checked_post_reload(base_url, step, timeout):
        rid = [i for i, u in urls.items() if u == base_url][0]
        gauge_at_swap.append(
            (rid, router.outstanding(rid),
             _series(tmetrics.snapshot(), "hvd_tpu_fleet_outstanding",
                     replica=rid)))
        return real_post_reload(base_url, step, timeout)

    monkeypatch.setattr(trollout, "_post_reload", checked_post_reload)

    def client():
        while not stop.is_set():
            code, doc, _ = _post(router.url + "/v1/infer")
            if code != 200:
                failures.append((code, doc))
            else:
                seen.append((doc["step"],
                             float(np.asarray(doc["outputs"])[0, 0])))
            time.sleep(0.002)

    try:
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        summary = tfleet.rolling_reload(router, step=2, drain_deadline=10.0)
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        for url in urls.values():
            with urlopen(url + "/healthz", timeout=10) as resp:
                assert json.loads(resp.read())["step"] == 2
    finally:
        stop.set()
        router.stop()
        for srv in replicas:
            srv.close()
    assert failures == [], failures[:5]
    assert summary == {"result": "ok", "replicas": ["r0", "r1"], "step": 2}
    assert [g[0] for g in gauge_at_swap] == ["r0", "r1"]
    assert all(out == 0 and gauge == 0 for _, out, gauge in gauge_at_swap)
    assert all(val == (4.0 if step == 1 else 8.0) for step, val in seen)
    assert seen[-1][0] == 2


def test_drill_route_fault_answers_503_then_recovers():
    srv = _replica(params=_params(1.0))
    router = _router(tfleet, {"r0": _url(srv)})
    before = tmetrics.snapshot()
    try:
        tfaults.configure("fleet.route:error:once", seed=SEED)
        code, doc, _ = _post(router.url + "/v1/infer")
        assert code == 503 and "router fault" in doc["error"]
        assert _post(router.url + "/v1/infer")[0] == 200
    finally:
        router.stop()
        srv.close()
    assert _delta(before, 'hvd_tpu_fleet_requests_total{code="503"}') == 1


def test_drill_drain_wedge_aborts_rollout_and_readmits(tmp_path):
    ckpt = tmp_path / "replica0"
    ckpt.mkdir()
    tckpt.save(str(ckpt), 1, _params(1.0))
    srv = _replica(ckpt)
    tckpt.save(str(ckpt), 2, _params(2.0))
    router = _router(tfleet, {"r0": _url(srv)})
    before = tmetrics.snapshot()
    try:
        tfaults.configure("fleet.drain:error", seed=SEED)
        with pytest.raises(tfleet.RolloutAborted):
            tfleet.rolling_reload(router, step=2, drain_deadline=0.3)
        tfaults.configure("", seed=0)
        assert router.health_doc()["replicas"]["r0"]["state"] == "up"
        code, served, _ = _post(router.url + "/v1/infer")
        assert code == 200 and served["step"] == 1
    finally:
        router.stop()
        srv.close()
    assert _delta(before,
                  'hvd_tpu_fleet_rollouts_total{result="aborted"}') == 1


def test_drill_dropped_beats_eject_then_readmit():
    srv = _replica(params=_params(1.0))
    router = _router(tfleet, {"r0": _url(srv)})
    hb = tfleet.ReplicaHeartbeat(router.url, "r0", interval=HB_INTERVAL)
    before = tmetrics.snapshot()
    try:
        tfaults.configure("fleet.health:error:after=2", seed=SEED)
        assert hb.beat_once() and hb.beat_once()
        assert not hb.beat_once()
        t0 = time.monotonic()
        while router.health_doc()["replicas"]["r0"]["state"] != "dead":
            assert time.monotonic() - t0 < 2 * HB_TIMEOUT, \
                router.health_doc()
            hb.beat_once()
            time.sleep(0.02)
        code, doc, _ = _post(router.url + "/v1/infer")
        assert code == 503 and "no routable" in doc["error"]
        tfaults.configure("", seed=0)
        assert hb.beat_once()
        _wait(lambda: router.health_doc()["replicas"]["r0"]["state"]
              == "up", 5, router.health_doc())
        assert _post(router.url + "/v1/infer")[0] == 200
    finally:
        router.stop()
        srv.close()
    assert _delta(before, 'hvd_tpu_fleet_ejections_total{replica="r0",'
                          'reason="heartbeat"}') == 1


class _CaptureReplica(BaseHTTPRequestHandler):
    captured = []

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        type(self).captured.append(
            {k.lower(): v for k, v in self.headers.items()})
        body = json.dumps({"tokens": [5], "logprobs": [0.0],
                           "step": 0}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_failover_keeps_identity_and_numbers_the_attempt(monkeypatch):
    monkeypatch.setenv("HVD_TPU_TRACE_SAMPLE", "1.0")
    ttracing.reset()
    _CaptureReplica.captured = []
    live = ThreadingHTTPServer(("127.0.0.1", 0), _CaptureReplica)
    threading.Thread(target=live.serve_forever, daemon=True).start()
    router = _router(tfleet, {
        "a-dead": f"http://127.0.0.1:{_dead_port()}",
        "b-live": f"http://127.0.0.1:{live.server_address[1]}"})
    try:
        code, _, headers = _post(
            router.url + "/v1/generate", {"prompt": [1, 2], "max_tokens": 1},
            headers={tfleet.REQUEST_ID_HEADER: "req-survive",
                     DEADLINE_HEADER: "20000"})
        assert code == 200
        assert headers.get(tfleet.REQUEST_ID_HEADER) == "req-survive"
        assert len(_CaptureReplica.captured) == 1
        seen = _CaptureReplica.captured[0]
        assert seen.get(ttracing.ATTEMPT_HEADER.lower()) == "1"
        assert seen.get(tfleet.REQUEST_ID_HEADER.lower()) == "req-survive"
        parent = seen.get(ttracing.TRACE_PARENT_HEADER.lower())
        assert ttracing.TraceContext.decode(parent).trace_id == "req-survive"
        assert 0 < float(seen.get(DEADLINE_HEADER.lower())) < 20000
    finally:
        router.stop()
        live.shutdown()
        live.server_close()
        ttracing.reset()


def test_zero_capacity_flush_fails_queued_waiters_fast():
    sched = ttenancy.FairScheduler(capacity_fn=lambda: 0)
    t = ttenancy.Tenant("t", max_queued=8)
    errors = []

    def one():
        try:
            sched.acquire(t, deadline_ts=time.monotonic() + 30)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=one, daemon=True) for _ in range(3)]
    for th in threads:
        th.start()
    _wait(lambda: sched.stats().get("t", {}).get("queued", 0) == 3, 10)
    sched.flush_no_capacity()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    assert len(errors) == 3
    assert all(isinstance(e, ttenancy.NoCapacityError) for e in errors)
    sched.close()


def test_last_replica_ejected_flushes_router_queue(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLEET_REPLICA_CONCURRENCY", "1")

    def slow_apply(params, x):
        time.sleep(3.0)
        return _port_apply(params, x)

    srv = _replica(params=_params(1.0), apply_fn=slow_apply)
    router = _router(tfleet, {"r0": _url(srv)})
    hb = tfleet.ReplicaHeartbeat(router.url, "r0", interval=HB_INTERVAL)
    results = {}

    def hog():
        results["hog"] = _post(router.url + "/v1/infer")

    def queued():
        t0 = time.monotonic()
        code, doc, _ = _post(router.url + "/v1/infer",
                             headers={DEADLINE_HEADER: "30000"})
        results["queued"] = (code, doc, time.monotonic() - t0)

    try:
        hb.start()
        time.sleep(0.3)
        th_hog = threading.Thread(target=hog, daemon=True)
        th_hog.start()
        time.sleep(0.3)
        th_q = threading.Thread(target=queued, daemon=True)
        th_q.start()
        time.sleep(0.3)
        hb.stop()
        srv.stop()
        th_q.join(timeout=15)
        assert not th_q.is_alive(), "the queued request must be flushed"
        code, doc, elapsed = results["queued"]
        assert code == 503, results["queued"]
        # flushed at the ejection, well before its own 30 s deadline
        assert elapsed < 15.0
        th_hog.join(timeout=10)
    finally:
        hb.stop()
        router.stop()
        srv.close()


def test_retry_budget_flood_collapses_to_pass_through(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLEET_RETRY_BUDGET_RATIO", "0")
    monkeypatch.setenv("HVD_TPU_FLEET_RETRY_BUDGET_BURST", "2")
    router = _router(tfleet, {"r0": f"http://127.0.0.1:{_dead_port()}",
                              "r1": f"http://127.0.0.1:{_dead_port()}"})
    try:
        before = tmetrics.snapshot()
        codes = [_post(router.url + "/v1/infer", timeout=10)[0]
                 for _ in range(6)]
        assert codes == [503] * 6, codes
        key = 'hvd_tpu_fleet_retry_budget_total{tenant="default",outcome='
        assert _delta(before, key + '"granted"}') <= 2
        assert _delta(before, key + '"denied"}') >= 1
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# one fault seed, both fleets: the same status codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "fleet.route:error:rate=0.3",
    "fleet.route:error:after=3:times=4",
    "serving.admit:error:rate=0.25"])
def test_serial_status_codes_under_one_fault_seed_match_jax(spec):
    """20 serial requests through each package's fleet (its router over
    two of its replicas) under the same spec and seed: the same codes,
    request by request, and the same outputs where they answer."""
    def run(pkg, faults, replica):
        r0, r1 = replica(params=_params(1.0)), replica(params=_params(1.0))
        router = _router(pkg, {"r0": _url(r0), "r1": _url(r1)})
        try:
            faults.configure(spec, seed=SEED)
            out = []
            for _ in range(20):
                code, doc, _ = _post(router.url + "/v1/infer")
                out.append((code, doc.get("outputs")))
            faults.configure("", seed=0)
            return out
        finally:
            router.stop()
            r0.close(), r1.close()
    want = run(jfleet, jfaults, _jax_replica)
    got = run(tfleet, tfaults, _replica)
    assert [c for c, _ in got] == [c for c, _ in want]
    assert len({c for c, _ in want}) > 1, "the spec must fire"
    for (c, a), (_, b) in zip(got, want):
        if c == 200:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=1e-6)
