"""The KV wire, disaggregated prefill/decode and the generation routes of
the port's server, held to the JAX package (2 layers, d_model 32,
2 x 16 heads, vocab 97, blocks of 4, float32 on both sides):

* ``prompt_manifest`` equals the JAX package's and the engines' hashes;
* a KV payload packed by either package unpacks in the other bit for
  bit (fp32 and bf16 pools, native and bf16 wire), and both packages
  write the same document for the same blocks;
* a prefill-role server and a decode-role server: ``/v1/kv/offer``
  pulls the prompt's blocks over ``/v1/kv/fetch`` and the continuation
  equals the colocated one, also with a JAX prefill replica feeding a
  port decode replica (mixed replicas exchange KV); a dead source and
  an injected ``disagg.transfer`` fault degrade to a re-prefill;
* the HTTP routes answer the JAX server's codes and bodies (200, 400,
  404, 429, 499, 503), the stream equals the blocking answer, and
  ``/healthz`` reports the same generation fields. Logprobs in bodies
  (rounded to 6 decimals by both servers) agree within 1e-5.
"""

import json
import threading
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.serving import InferenceServer as JServer
from horovod_tpu.serving.disagg import wire as jwire
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch.serving import InferenceServer as TServer
from horovod_tpu_torch.serving.disagg import pull_and_import
from horovod_tpu_torch.serving.disagg import wire as twire

from torch_port_gen_common import (BLOCK, jax_engine, port_engine, prompts)

TOL = 1e-5


def _post(url, doc, headers=None, timeout=60):
    req = Request(url, data=json.dumps(doc).encode(), method="POST",
                  headers={"Content-Type": "application/json",
                           **(headers or {})})
    try:
        with urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get(url, timeout=10):
    with urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _stream(url, doc, timeout=60):
    req = Request(url, data=json.dumps(doc).encode(), method="POST",
                  headers={"Content-Type": "application/json"})
    with urlopen(req, timeout=timeout) as resp:
        return [json.loads(ln) for ln in resp.read().decode().splitlines()
                if ln.strip()]


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4, 5, 9])
def test_prompt_manifest_matches_jax(n):
    toks = prompts(n, [n * BLOCK + 1])[0]
    want = jwire.prompt_manifest(toks, BLOCK)
    assert twire.prompt_manifest(toks, BLOCK) == want
    assert len(want) == n
    with port_engine() as eng:
        assert eng.kv_manifest(toks) == want


def _blocks(dtype, seed=0):
    a = np.random.RandomState(seed).randn(2, 3, 4, 2, 16).astype(np.float32)
    if dtype == "bfloat16":
        return a.astype(ml_dtypes.bfloat16), \
            torch.from_numpy(a).to(torch.bfloat16)
    return a, torch.from_numpy(a)


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire_dtype", ["native", "bf16"])
def test_payload_crosses_packages_bit_for_bit(pool, wire_dtype):
    hashes = ["a", "b", "c"]
    jk, tk = _blocks(pool, 0)
    jv, tv = _blocks(pool, 1)
    jdoc = jwire.pack_blocks(hashes, jk, jv, wire_dtype)
    tdoc = twire.pack_blocks(hashes, tk, tv, wire_dtype)
    assert tdoc == jdoc                       # the same document
    # JAX-packed -> port, port-packed -> JAX
    h, k, v, nbytes = twire.unpack_blocks(json.loads(json.dumps(jdoc)))
    jh, jk2, jv2, jbytes = jwire.unpack_blocks(json.loads(json.dumps(tdoc)))
    assert h == jh == hashes and nbytes == jbytes
    for t, a in ((k, jk2), (v, jv2)):
        raw_t = (t.view(torch.int16) if t.dtype == torch.bfloat16
                 else t).numpy().tobytes()
        assert raw_t == np.ascontiguousarray(a).tobytes()
    if wire_dtype == "bf16" or pool == "bfloat16":
        assert k.dtype == torch.bfloat16
        assert nbytes == 2 * jk.size * 2


def test_empty_payload_and_bad_wire_dtype_as_jax():
    assert twire.pack_blocks([], None, None) == jwire.pack_blocks(
        [], None, None) == {"hashes": []}
    assert twire.unpack_blocks({"hashes": []}) == ([], None, None, 0)
    with pytest.raises(ValueError) as je:
        jwire.pack_blocks(["a"], np.zeros(1), np.zeros(1), "fp8")
    with pytest.raises(ValueError) as te:
        twire.pack_blocks(["a"], torch.zeros(1), torch.zeros(1), "fp8")
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# disaggregated prefill -> decode over HTTP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replicas():
    """A port prefill replica, a JAX prefill replica, a port decode
    replica, and a colocated port engine for the reference answers."""
    pre = TServer(None, port=0, addr="127.0.0.1",
                  gen_engine=port_engine(role="prefill"))
    jpre = JServer(None, port=0, addr="127.0.0.1",
                   gen_engine=jax_engine(role="prefill"))
    dec = TServer(None, port=0, addr="127.0.0.1",
                  gen_engine=port_engine(role="decode"))
    colo = port_engine()
    for s in (pre, jpre, dec):
        s.start()
    yield pre, jpre, dec, colo
    for s in (pre, jpre, dec):
        s.close()
    colo.close()


def _url(srv):
    return f"http://127.0.0.1:{srv.port}"


@pytest.mark.parametrize("source", ["port", "jax"])
@pytest.mark.parametrize("seeded", [False, True])
def test_disagg_continuation_equals_colocated(replicas, source, seeded):
    pre, jpre, dec, colo = replicas
    src = pre if source == "port" else jpre
    prompt = prompts(70 + seeded + 2 * (source == "jax"), [23])[0]
    extra = dict(temperature=0.8, seed=5) if seeded else {}
    code, body, _ = _post(_url(src) + "/v1/generate",
                          dict(prompt=prompt, max_tokens=6, **extra))
    assert code == 200 and body["tokens"] == []
    man = body["manifest"]
    assert len(man["hashes"]) == 5 and man["source"] == _url(src)
    code, res, _ = _post(_url(dec) + "/v1/kv/offer", man)
    assert code == 200 and res["error"] is None
    assert res["imported"] == 5 and res["bytes"] > 0
    code, got, _ = _post(_url(dec) + "/v1/generate",
                         dict(prompt=prompt, max_tokens=6, **extra))
    want = colo.generate(prompt, max_tokens=6, timeout=30, **extra)
    assert code == 200 and got["tokens"] == want
    # a warm prefix moves zero bytes
    code, again, _ = _post(_url(dec) + "/v1/kv/offer", man)
    assert again["bytes"] == 0 and again["held"] == 5


def test_dead_source_and_transfer_fault_degrade(replicas):
    pre, _, dec, colo = replicas
    prompt = prompts(80, [17])[0]
    hashes = twire.prompt_manifest(prompt, BLOCK)
    res = pull_and_import(dec.gen_engine, hashes,
                          source="http://127.0.0.1:9", timeout=1.0)
    assert res["imported"] == 0 and res["error"]
    _post(_url(pre) + "/v1/generate", dict(prompt=prompt, max_tokens=2))
    tfaults.configure("disagg.transfer:error:once", seed=0)
    try:
        res = pull_and_import(dec.gen_engine, hashes, source=_url(pre))
    finally:
        tfaults.configure("", seed=0)
    assert res["imported"] == 0 and res["error"]
    code, got, _ = _post(_url(dec) + "/v1/generate",
                         dict(prompt=prompt, max_tokens=5))
    assert got["tokens"] == colo.generate(prompt, max_tokens=5, timeout=30)


def test_kv_fetch_serves_a_prefix_and_rejects_bad_dtype(replicas):
    pre, jpre, _, _ = replicas
    prompt = prompts(81, [13])[0]
    hashes = twire.prompt_manifest(prompt, BLOCK)
    for srv in (pre, jpre):
        _post(_url(srv) + "/v1/generate", dict(prompt=prompt, max_tokens=1))
    outs = []
    for srv in (pre, jpre):
        code, doc, _ = _post(_url(srv) + "/v1/kv/fetch",
                             dict(hashes=hashes + ["missing"]))
        assert code == 200 and doc["hashes"] == hashes
        outs.append(doc)
        code, body, _ = _post(_url(srv) + "/v1/kv/fetch",
                              dict(hashes=hashes, wire_dtype="fp8"))
        assert code == 400
    # the prefill replicas of both packages hold the same bytes, within
    # float32 rounding of their forwards
    tk = twire.unpack_blocks(outs[0])[1].numpy()
    jk = np.asarray(jwire.unpack_blocks(outs[1])[1])
    np.testing.assert_allclose(tk, jk, atol=TOL)


# ---------------------------------------------------------------------------
# the routes, against the JAX server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    j = JServer(None, port=0, addr="127.0.0.1",
                gen_engine=jax_engine(max_beams=2))
    t = TServer(None, port=0, addr="127.0.0.1",
                gen_engine=port_engine(max_beams=2))
    j.start()
    t.start()
    yield j, t
    j.close()
    t.close()


def _strip(body):
    return {k: v for k, v in body.items()
            if k not in ("request_id", "logprobs", "step")}


ROUTE_CASES = {
    "generate": ("/v1/generate", dict(prompt=prompts(90, [9])[0],
                                      max_tokens=7)),
    "generate_eos": ("/v1/generate", dict(prompt=prompts(91, [5])[0],
                                          max_tokens=9, eos_id=3)),
    "generate_beam": ("/v1/generate", dict(prompt=prompts(92, [6])[0],
                                           max_tokens=5, num_beams=2)),
    "generate_seeded": ("/v1/generate", dict(prompt=prompts(93, [6])[0],
                                             max_tokens=5, temperature=0.7,
                                             top_k=20, seed=11)),
    "not_json": ("/v1/generate", None),
    "no_prompt": ("/v1/generate", dict(max_tokens=3)),
    "never_fits": ("/v1/generate", dict(prompt=[1] * 60, max_tokens=10)),
    "bad_top_p": ("/v1/generate", dict(prompt=[1, 2], top_p=2.0)),
    "spent_deadline": ("/v1/generate", dict(prompt=[1, 2],
                                            deadline_ms=-1)),
    "unknown_route": ("/v1/nothing", dict(prompt=[1])),
    "infer_without_engine": ("/v1/infer", dict(inputs=[[1.0]])),
    "cancel_unknown": ("/v1/cancel", dict(request_id="nobody")),
    "cancel_bad": ("/v1/cancel", dict()),
    "offer_bad": ("/v1/kv/offer", dict()),
    "offer_spent_budget": ("/v1/kv/offer", dict(hashes=["x"])),
    "fetch_unknown": ("/v1/kv/fetch", dict(hashes=["nope"])),
}


def _raw_post(url, raw):
    req = Request(url, data=raw, method="POST",
                  headers={"Content-Type": "application/json"})
    try:
        with urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_answers_as_jax(servers, case):
    path, doc = ROUTE_CASES[case]
    headers = {"X-HVD-TPU-Deadline-Ms": "0"} \
        if case == "offer_spent_budget" else None
    answers = []
    for srv in servers:
        if doc is None:
            answers.append(_raw_post(_url(srv) + path, b"{not json"))
        else:
            answers.append(_post(_url(srv) + path, doc, headers=headers))
    (jc, jb, jh), (tc, tb, th) = answers
    assert tc == jc
    if "error" in jb:
        assert set(tb) == set(jb)
        if case not in ("not_json",):   # json's own messages may differ
            assert tb["error"] == jb["error"]
        assert th.get("X-HVD-TPU-Deadline-Exceeded") == \
            jh.get("X-HVD-TPU-Deadline-Exceeded")
    else:
        assert _strip(tb) == _strip(jb)
        if "logprobs" in jb:
            np.testing.assert_allclose(tb["logprobs"], jb["logprobs"],
                                       atol=TOL)


def test_route_codes_cover_the_contract(servers):
    codes = set()
    for case, (path, doc) in ROUTE_CASES.items():
        if doc is not None:
            headers = {"X-HVD-TPU-Deadline-Ms": "0"} \
                if case == "offer_spent_budget" else None
            codes.add(_post(_url(servers[1]) + path, doc,
                            headers=headers)[0])
    assert {200, 400, 404, 429} <= codes


def test_queue_full_is_503_in_both():
    """A queue of one, held full by a request no scheduler thread takes
    (the thread is never started)."""
    codes = []
    for make, server in ((jax_engine, JServer), (port_engine, TServer)):
        eng = make(queue_depth=1)
        eng.batcher._ensure_thread = lambda: None
        eng.submit([1, 2], max_tokens=2)
        srv = server(None, port=0, addr="127.0.0.1", gen_engine=eng)
        srv.start()
        try:
            code, body, _ = _post(_url(srv) + "/v1/generate",
                                  dict(prompt=[1, 2], max_tokens=2))
            codes.append((code, body["error"]))
        finally:
            srv.close()
    assert codes[0] == codes[1] and codes[0][0] == 503


def test_cancel_mid_generation_is_499(servers):
    _, t = servers
    out = {}

    def run():
        out["r"] = _post(_url(t) + "/v1/generate",
                         dict(prompt=[1, 2, 3], max_tokens=60),
                         headers={"X-HVD-TPU-Request-Id": "rid-499"})
    th = threading.Thread(target=run)
    eng = t.gen_engine
    steps = []
    eng.batcher.on_step = lambda phase, ids: (steps.append(phase),
                                               time.sleep(0.02))
    try:
        th.start()
        deadline = time.monotonic() + 20
        while "decode" not in steps and time.monotonic() < deadline:
            time.sleep(0.005)
        code, body, _ = _post(_url(t) + "/v1/cancel",
                              dict(request_id="rid-499"))
        assert code == 200 and body == {"cancelled": "rid-499"}
        th.join(30)
    finally:
        eng.batcher.on_step = None
    code, body, hdrs = out["r"]
    assert code == 499 and "cancelled" in body["error"]
    assert hdrs["X-HVD-TPU-Request-Id"] == "rid-499"


def test_stream_equals_blocking_answer_in_both(servers):
    doc = dict(prompt=prompts(95, [8])[0], max_tokens=6)
    for srv in servers:
        _, blocking, _ = _post(_url(srv) + "/v1/generate", doc)
        recs = _stream(_url(srv) + "/v1/generate/stream", doc)
        assert "meta" in recs[0] and recs[-1]["done"] is True
        toks = [r["t"] for r in recs[1:-1]]
        assert toks == blocking["tokens"]
        assert [r["lp"] for r in recs[1:-1]] == blocking["logprobs"]


def test_healthz_generation_fields_as_jax(servers):
    j, t = servers
    jd, td = _get(_url(j) + "/healthz"), _get(_url(t) + "/healthz")
    assert set(td) == set(jd)
    for key in ("status", "prefix_cache", "disagg_role", "spec_mode",
                "spec_tokens", "max_beams", "step"):
        assert td[key] == jd[key]
    assert sum(td["kv_blocks"].values()) == sum(jd["kv_blocks"].values())


def test_server_needs_an_engine():
    with pytest.raises(ValueError, match="at least one"):
        TServer(None)
