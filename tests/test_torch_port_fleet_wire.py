"""The fleet across packages, on the CPU: one router fronting replicas of
the other package, generation through the port's fleet against the JAX
fleet, the mid-stream takeover, hedging and the pooled prefill/decode
fleet.

* Mixed fleets: the JAX ``FleetRouter`` over port replicas and the port's
  router over JAX replicas (the row-wise linear model of
  tests/test_fleet.py) answer what the same-package fleets answer: the
  codes, the outputs, the request id echoed to the client, and the
  request id and attempt number each replica is sent (a failover from a
  dead replica numbers its second attempt 1).
* Generation through the port's fleet on the tiny transformer built by
  the JAX package and carried across by ``models/convert.py``
  (tests/torch_port_gen_common.py, float32 on both sides): tokens equal
  the JAX fleet's, logprobs within 1e-5. A stream severed mid-generation
  (the seeded ``fleet.stream`` fault, and a replica closed for real) is
  resumed on the survivor bit-identical to the uninterrupted stream,
  greedy and seeded-sampled.
* Hedging beats a slow stub replica; a pooled prefill/decode fleet
  answers what a colocated one answers, and a warm repeat moves no
  transfer bytes.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

from horovod_tpu import faults as jfaults
from horovod_tpu import serving as jserving
from horovod_tpu.serving import fleet as jfleet
from horovod_tpu.serving import server as jserver
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import serving as tserving
from horovod_tpu_torch import tracing as ttracing
from horovod_tpu_torch.serving import fleet as tfleet
from horovod_tpu_torch.serving import server as tserver

from torch_port_gen_common import jax_engine, port_engine

SEED = 1234
IN_DIM, OUT_DIM = 4, 2
TOL_LOGPROB = 1e-5
PROMPT = [3, 11, 42, 7, 19, 5]
SAMPLED = dict(temperature=0.9, top_k=12, top_p=0.85)


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    jfaults.configure("", seed=0)
    tfaults.configure("", seed=0)


def _params():
    return {"w": np.full((IN_DIM, OUT_DIM), 1.0, np.float32),
            "b": np.zeros(OUT_DIM, np.float32)}


def _infer_replica(pkg):
    kw = dict(max_batch=8, batch_timeout_ms=2.0, deadline_ms=0,
              reload_poll_seconds=0, warmup=False)
    if pkg == "jax":
        eng = jserving.InferenceEngine(
            lambda p, x: x @ p["w"] + p["b"], params=_params(), **kw)
        srv = jserving.InferenceServer(eng, port=0, addr="127.0.0.1")
    else:
        eng = tserving.InferenceEngine(
            lambda p, x: x.float() @ p["w"] + p["b"], params=_params(),
            device="cpu", **kw)
        srv = tserving.InferenceServer(eng, port=0, addr="127.0.0.1")
    srv.start()
    return srv


def _gen_replica(pkg, **kw):
    if pkg == "jax":
        return_srv = jserving.InferenceServer(
            None, port=0, addr="127.0.0.1", gen_engine=jax_engine(**kw))
    else:
        return_srv = tserving.InferenceServer(
            None, port=0, addr="127.0.0.1", gen_engine=port_engine(**kw))
    return_srv.start()
    return return_srv


def _router(pkg, replicas, **kw):
    mod = jfleet if pkg == "jax" else tfleet
    r = mod.FleetRouter(replicas, port=0, addr="127.0.0.1",
                        heartbeat_timeout=0.5, heartbeat_interval=0.1, **kw)
    r.start()
    return r


def _url(srv):
    return f"http://127.0.0.1:{srv.port}"


def _post(url, doc, headers=None, timeout=60):
    req = Request(url, data=json.dumps(doc).encode(), method="POST",
                  headers={"Content-Type": "application/json",
                           **(headers or {})})
    try:
        with urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _stream(url, doc, timeout=120):
    req = Request(url, data=json.dumps(doc).encode(), method="POST",
                  headers={"Content-Type": "application/json"})
    with urlopen(req, timeout=timeout) as resp:
        return [json.loads(line) for line in resp if line.strip()]


def _tokens(records):
    return [r["t"] for r in records if "t" in r]


def _dead_port():
    import socket
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


# ---------------------------------------------------------------------------
# mixed fleets
# ---------------------------------------------------------------------------

@pytest.fixture
def replica_headers(monkeypatch):
    """(request id, attempt) of every POST each package's server sees."""
    seen = []
    for mod in (jserver, tserver):
        real = mod._ServingHandler.do_POST

        def record(self, _real=real):
            seen.append((self.headers.get("X-HVD-TPU-Request-Id"),
                         self.headers.get(ttracing.ATTEMPT_HEADER)))
            return _real(self)
        monkeypatch.setattr(mod._ServingHandler, "do_POST", record)
    return seen


def _drive(router_pkg, replica_pkg, seen):
    """The scenario every fleet combination answers: a request with an
    id, one without, a failover off a dead replica, a malformed body and
    an unknown route. Returns what the client and the replicas saw."""
    live = _infer_replica(replica_pkg)
    out = []
    try:
        router = _router(router_pkg, {"r0": _url(live)})
        try:
            code, doc, hdr = _post(router.url + "/v1/infer",
                                   {"inputs": [[1.0] * IN_DIM]},
                                   headers={"X-HVD-TPU-Request-Id": "rid-1"})
            out.append((code, doc.get("outputs"),
                        hdr.get("X-HVD-TPU-Request-Id")))
            code, doc, hdr = _post(router.url + "/v1/infer",
                                   {"inputs": [[2.0] * IN_DIM] * 3})
            out.append((code, doc.get("outputs"),
                        bool(hdr.get("X-HVD-TPU-Request-Id"))))
            code, doc, hdr = _post(router.url + "/v1/infer",
                                   {"inputs": "nope"},
                                   headers={"X-HVD-TPU-Request-Id": "rid-3"})
            out.append((code, hdr.get("X-HVD-TPU-Request-Id")))
            code, _, _ = _post(router.url + "/v1/nope", {})
            out.append(code)
        finally:
            router.stop()
        router = _router(router_pkg, {
            "a-dead": f"http://127.0.0.1:{_dead_port()}",
            "b-live": _url(live)})
        try:
            del seen[:]
            code, doc, hdr = _post(router.url + "/v1/infer",
                                   {"inputs": [[1.0] * IN_DIM]},
                                   headers={"X-HVD-TPU-Request-Id": "rid-4"})
            out.append((code, doc.get("outputs"),
                        hdr.get("X-HVD-TPU-Request-Id"), list(seen)))
        finally:
            router.stop()
    finally:
        live.close()
    return out


def test_mixed_fleets_answer_as_same_package_fleets(replica_headers):
    got = {(r, p): _drive(r, p, replica_headers)
           for r in ("jax", "port") for p in ("jax", "port")}
    want = got[("jax", "jax")]
    assert want[0][0] == 200 and want[4][3] == [("rid-4", "1")]
    for combo, answers in got.items():
        assert answers == want, combo


# ---------------------------------------------------------------------------
# generation through the fleet
# ---------------------------------------------------------------------------

def _gen_fleet(pkg, n=2, **kw):
    srvs = [_gen_replica(pkg, **kw) for _ in range(n)]
    router = _router(pkg, {f"r{i}": _url(s) for i, s in enumerate(srvs)})
    return router, srvs


def _close(router, srvs):
    router.stop()
    for s in srvs:
        s.close()


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX fleet's answers to the generation scenarios (its programs
    compile once per shape, so they are computed once)."""
    router, srvs = _gen_fleet("jax")
    try:
        url = router.url
        docs = [_post(url + "/v1/generate",
                      {"prompt": PROMPT[:n], "max_tokens": 12, **kw})
                for n, kw in ((6, {}), (4, {"seed": 5, **SAMPLED}),
                              (3, {"seed": 9}))]
        streams = {}
        for name, kw in (("greedy", {}), ("sampled", SAMPLED)):
            doc = {"prompt": PROMPT, "max_tokens": 24, "seed": 7, **kw}
            streams[name] = _tokens(_stream(url + "/v1/generate/stream",
                                            doc))
            jfaults.configure("fleet.stream:error:after=8:times=1",
                              seed=SEED)
            drilled = _stream(url + "/v1/generate/stream", doc)
            jfaults.configure("", seed=0)
            streams[name + "_drill"] = _tokens(drilled)
        return {"docs": docs, "streams": streams}
    finally:
        _close(router, srvs)


def test_generate_through_port_fleet_equals_jax_fleet(jax_answers):
    router, srvs = _gen_fleet("port")
    try:
        for (code, doc, _), req in zip(
                jax_answers["docs"],
                ((6, {}), (4, {"seed": 5, **SAMPLED}), (3, {"seed": 9}))):
            n, kw = req
            tcode, tdoc, _ = _post(router.url + "/v1/generate",
                                   {"prompt": PROMPT[:n], "max_tokens": 12,
                                    **kw})
            assert (tcode, code) == (200, 200)
            assert tdoc["tokens"] == doc["tokens"]
            np.testing.assert_allclose(tdoc["logprobs"], doc["logprobs"],
                                       rtol=0, atol=TOL_LOGPROB)
    finally:
        _close(router, srvs)


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_injected_stream_kill_resumes_bit_identical(jax_answers, sampling):
    """The seeded ``fleet.stream`` kill at the 8th record, through the
    port's fleet: the client gets the full stream, equal to the
    uninterrupted one and to the JAX fleet's, with one resumed
    failover."""
    router, srvs = _gen_fleet("port")
    kw = SAMPLED if sampling == "sampled" else {}
    doc = {"prompt": PROMPT, "max_tokens": 24, "seed": 7, **kw}
    try:
        url = router.url + "/v1/generate/stream"
        base = _tokens(_stream(url, doc))
        before = tmetrics.snapshot()
        tfaults.configure("fleet.stream:error:after=8:times=1", seed=SEED)
        drill = _stream(url, doc)
        tfaults.configure("", seed=0)
        resumed = tmetrics.snapshot().get(
            'hvd_tpu_fleet_failovers_total{outcome="resumed"}', 0) - \
            before.get('hvd_tpu_fleet_failovers_total{outcome="resumed"}', 0)
    finally:
        _close(router, srvs)
    assert len(base) == 24
    assert _tokens(drill) == base
    assert [r for r in drill if "error" in r] == []
    assert drill[0]["meta"]["seed"] == 7 and drill[-1].get("done") is True
    assert resumed == 1
    assert base == jax_answers["streams"][sampling]
    assert _tokens(drill) == jax_answers["streams"][sampling + "_drill"]


def test_real_replica_death_mid_stream_resumes():
    """The serving replica is closed for real mid-stream (server and
    engine): the client still gets the uninterrupted stream."""
    doc = {"prompt": PROMPT, "max_tokens": 24, "seed": 11, **SAMPLED}
    survivor = _gen_replica("port")
    base = _tokens(_stream(_url(survivor) + "/v1/generate/stream", doc))
    slow = _gen_replica("port", on_step=lambda ph, ids: time.sleep(
        0.03 if ph == "decode" else 0))
    router = _router("port", {"r0": _url(slow), "r1": _url(survivor)})
    try:
        req = Request(router.url + "/v1/generate/stream",
                      data=json.dumps(doc).encode(), method="POST",
                      headers={"Content-Type": "application/json"})
        records = []
        with urlopen(req, timeout=120) as resp:
            while len(_tokens(records)) < 3:
                records.append(json.loads(resp.readline()))
            slow.close()
            for line in resp:
                if line.strip():
                    records.append(json.loads(line))
    finally:
        _close(router, [survivor])
    assert _tokens(records) == base
    assert [r for r in records if "error" in r] == []
    assert records[-1].get("done") is True


# ---------------------------------------------------------------------------
# hedging and the pooled fleet
# ---------------------------------------------------------------------------

def _stub(delay_s):
    class _Stub(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            self._answer()

        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if self.path != "/v1/cancel":
                time.sleep(delay_s)
            self._answer()

        def _answer(self):
            body = json.dumps({"tokens": [1], "logprobs": [0.0],
                               "step": 0}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_hedge_beats_slow_stub_replica(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLEET_HEDGE_QUANTILE", "0.9")
    # the fast replica's answer time is the hedge delay (the latency
    # quantile of the warm-up), and the window in which the second
    # request must be routed while the first is still outstanding there
    fast, slow = _stub(0.5), _stub(4.0)
    router = _router("port", {
        "f-fast": f"http://127.0.0.1:{fast.server_address[1]}",
        "s-slow": f"http://127.0.0.1:{slow.server_address[1]}"})
    doc = {"prompt": PROMPT, "max_tokens": 4}
    try:
        for _ in range(9):      # the hedge delay's latency sample
            assert _post(router.url + "/v1/generate", doc)[0] == 200
        before = tmetrics.snapshot()
        results = {}

        def client(tag):
            t0 = time.monotonic()
            code = _post(router.url + "/v1/generate", doc)[0]
            results[tag] = (code, time.monotonic() - t0)
        def wait_outstanding(replica, count):
            deadline = time.monotonic() + 30
            while router.outstanding(replica) != count:
                assert time.monotonic() < deadline, (replica, count)
                time.sleep(0.001)
        # a warm-up request answered later than the hedge delay was hedged
        # onto the slow replica, which holds that slot until its answer:
        # both replicas idle first, so the first request goes to the fast
        # one and the second finds it the busier
        wait_outstanding("s-slow", 0)
        a = threading.Thread(target=client, args=("a",))
        a.start()
        # the second request starts once the first is outstanding at the
        # fast replica, however late the first thread was scheduled
        wait_outstanding("f-fast", 1)
        b = threading.Thread(target=client, args=("b",))
        b.start()
        a.join(30), b.join(30)
        assert results["a"][0] == 200 and results["b"][0] == 200
        # the second request landed on the slow replica (the fast one
        # had the first outstanding) and was answered by the hedge
        assert max(results["a"][1], results["b"][1]) < 3.0, results
        snap = tmetrics.snapshot()
        for outcome in ("launched", "won"):
            key = f'hvd_tpu_fleet_hedges_total{{outcome="{outcome}"}}'
            assert snap.get(key, 0) - before.get(key, 0) >= 1
    finally:
        router.stop()
        for s in (fast, slow):
            s.shutdown()
            s.server_close()


def test_pooled_fleet_equals_colocated_and_warm_repeat_moves_nothing():
    rng = np.random.RandomState(3)
    system = rng.randint(0, 97, (16,)).tolist()
    asks = [system + rng.randint(0, 97, (3 + i,)).tolist() for i in range(4)]
    TB = "hvd_tpu_disagg_transfer_bytes_total"

    def run(pools):
        if pools:
            srvs = [_gen_replica("port", role="prefill"),
                    _gen_replica("port", role="decode")]
        else:
            srvs = [_gen_replica("port"), _gen_replica("port")]
        router = _router("port", {f"r{i}": _url(s)
                                  for i, s in enumerate(srvs)},
                         pools={"r0": "prefill", "r1": "decode"}
                         if pools else None)
        try:
            snap0 = tmetrics.snapshot()
            out = [_post(router.url + "/v1/generate",
                         {"prompt": p, "max_tokens": 8})[1]["tokens"]
                   for p in asks]
            snap1 = tmetrics.snapshot()
            again = _post(router.url + "/v1/generate",
                          {"prompt": asks[0], "max_tokens": 8})[1]["tokens"]
            warm = tmetrics.snapshot().get(TB, 0) - snap1.get(TB, 0)
            moved = snap1.get(TB, 0) - snap0.get(TB, 0)
            return out, again, moved, warm
        finally:
            _close(router, srvs)
    colo, _, colo_moved, _ = run(False)
    pooled, again, moved, warm = run(True)
    assert pooled == colo
    assert colo_moved == 0 and moved > 0
    assert again == pooled[0] and warm == 0


def test_resumed_tail_is_prefilled_at_the_decode_steps_shapes():
    """A takeover resubmits ``prompt + emitted`` with ``sample_offset``:
    the replica prefills the original prompt in its usual chunk (none
    straddles the emitted tail), then the emitted tail at the decode
    step's shapes: ``(max_seqs, 2)`` tokens a call, token i in lane
    i // 2, every lane at its own positions. The continuation equals the
    uninterrupted run's. (The prefix cache is off: with it on, the
    blocks the first run filled would be attached instead.)"""
    calls = []
    with port_engine(prefix_cache=False) as eng:
        full = eng.result(eng.submit(PROMPT, max_tokens=20, seed=3,
                                     **SAMPLED), timeout=60)
        b = eng.batcher
        prefill = b._prefill_prog

        def spy(params, cache, tokens, sample):
            calls.append((tuple(tokens.shape), cache.lengths.tolist(),
                          cache.live.tolist()))
            return prefill(params, cache, tokens, sample)
        b._prefill_prog = spy
        k = 13
        rest = eng.result(eng.submit(PROMPT + full[:k], max_tokens=20 - k,
                                     seed=3, sample_offset=k, **SAMPLED),
                          timeout=60)
        lanes, chunk = b.max_seqs, b.prefill_chunk
    assert full[:k] + rest == full
    assert calls[0] == ((1, chunk), [0], [len(PROMPT)])
    tails = calls[1:]
    assert all(c[0] == (lanes, 2) for c in tails)
    assert sum(sum(c[2]) for c in tails) == k
    pos = len(PROMPT)
    for _, lengths, lives in tails:
        for lane, n in enumerate(lives):
            if n:
                assert lengths[lane] == pos
                pos += n
    assert pos == len(PROMPT) + k


def test_preemption_recompute_keeps_prompt_shaped_chunks():
    """A sequence preempted in decode rebuilds ``prompt + generated`` in
    the prompt's ``(1, prefill_chunk)`` chunks: only a takeover's
    resubmission (``sample_offset > 0``) takes the decode-shaped tail.
    The wave is the generation tests' preemption wave (14 blocks of 4
    tokens, four sequences), and its tokens equal the JAX engine's."""
    from torch_port_gen_common import prompts, run_all
    reqs = [dict(prompt=p, max_tokens=14)
            for p in prompts(2, [9, 10, 11, 8])]
    knobs = dict(num_blocks=14, max_seqs=4)
    with jax_engine(**knobs) as eng:
        want = [t for t, _ in run_all(eng, reqs)]
    key = "hvd_tpu_gen_preemptions_total"
    shapes = []
    before = tmetrics.snapshot().get(key, 0)
    with port_engine(**knobs) as eng:
        b = eng.batcher
        prefill = b._prefill_prog

        def spy(params, cache, tokens, sample):
            shapes.append(tuple(tokens.shape))
            return prefill(params, cache, tokens, sample)
        b._prefill_prog = spy
        got = [t for t, _ in run_all(eng, reqs)]
        chunk = b.prefill_chunk
    assert tmetrics.snapshot().get(key, 0) > before
    assert got == want
    assert len(shapes) > len(reqs)
    assert set(shapes) == {(1, chunk)}
