"""The port's inference serving plane (horovod_tpu_torch.serving: the
micro-batcher, the engine with hot reload, the HTTP server) against the
JAX package's, which is the oracle, on the CPU.

* Host logic bit for bit: bucket choice, coalescing (the padded shapes
  and live-row counts each forward sees), the 429/503 rejections and the
  deadline stage, each scenario run through both packages' batchers.
* Both HTTP servers answer the same requests with the same codes and
  bodies; outputs of the row-wise linear model within 1e-6 (the same fp32
  products, XLA against PyTorch). That includes 404 on every generation
  route, which the JAX server answers so without a generation engine.
* A 2-layer transformer served by both engines from one checkpoint
  written by the JAX package: the last position's greedy token equal and
  its fp32 log-probability within 1e-5, the atol of
  test_torch_port_transformer.py's fp32 logits (the same arithmetic,
  reductions ordered differently; the JAX side runs its flash kernel in
  interpret mode at 8 x 8 tiles, the port its plain flash recurrence).
* Hot reload under traffic, with the ``serving.reload:crash`` drill, and
  the spans of traced requests (``server.infer`` -> ``batch.queue`` ->
  ``batch.forward``), merged through ``tools/trace.merge``.
"""

import importlib
import json
import threading
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from horovod_tpu import checkpointing as jckpt
from horovod_tpu import faults as jfaults
from horovod_tpu import serving as jserving
from horovod_tpu import tracing as jtr
from horovod_tpu.models import transformer as jtrm
from horovod_tpu.serving import batcher as jbatcher
from horovod_tpu_torch import checkpointing as tckpt
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import serving as tserving
from horovod_tpu_torch import tracing as ttr
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import flash_attention_fn
from horovod_tpu_torch.serving import batcher as tbatcher
from tools import trace as trace_tool

jfa = importlib.import_module("horovod_tpu.ops.flash_attention")

TOL_LINEAR = 1e-6
TOL_LOGPROB = 1e-5
IN_DIM, OUT_DIM = 4, 2
TINY = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
            head_dim=8, max_seq_len=16)


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    jfaults.configure("", seed=0)
    tfaults.configure("", seed=0)


def _params(scale: float):
    """Row-wise linear model: ones(IN_DIM) @ w -> 4 * scale per output, so
    the serving checkpoint is readable off any output."""
    return {"w": np.full((IN_DIM, OUT_DIM), scale, np.float32),
            "b": np.zeros(OUT_DIM, np.float32)}


def _jax_apply(params, x):
    return x @ params["w"] + params["b"]


def _port_apply(params, x):
    return x.float() @ params["w"] + params["b"]


def _rows(n: int, value: float = 1.0):
    return np.full((n, IN_DIM), value, np.float32)


def _delta(before, key):
    return tmetrics.snapshot().get(key, 0) - before.get(key, 0)


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,max_batch", [
    ("", 8), ("", 5), ("", 1), ("1,2,4,8", 8), ("3,1", 8), (" 2 , 6 ", 6),
    ("4", 16)])
def test_parse_buckets_and_bucket_for_match_jax(spec, max_batch):
    got = tbatcher.parse_buckets(spec, max_batch)
    assert got == jbatcher.parse_buckets(spec, max_batch)
    for n in range(1, max_batch + 1):
        assert tbatcher.bucket_for(n, got) == jbatcher.bucket_for(n, got)
    for n in range(1, 40):
        assert tbatcher.next_pow2(n) == jbatcher.next_pow2(n)


@pytest.mark.parametrize("spec,max_batch", [
    ("0,2", 8), ("a,b", 8), ("1,16", 8), (",", 8)])
def test_bad_bucket_specs_raise_as_jax(spec, max_batch):
    with pytest.raises(ValueError) as want:
        jbatcher.parse_buckets(spec, max_batch)
    with pytest.raises(ValueError) as got:
        tbatcher.parse_buckets(spec, max_batch)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the micro-batcher, one scenario through both packages
# ---------------------------------------------------------------------------

def _coalesce(mod, max_batch, timeout_ms, requests):
    """Submit ``requests`` (row counts) at once; the (padded rows, live
    rows) each forward saw, and every request's output."""
    sizes = []
    p = _params(1.0)

    def forward(x, n):
        sizes.append((int(x.shape[0]), n))
        return _jax_apply(p, x)
    b = mod.MicroBatcher(forward, max_batch=max_batch, timeout_ms=timeout_ms,
                         queue_depth=16, default_deadline_ms=0)
    try:
        reqs = [b.submit(_rows(n, value=i)) for i, n in enumerate(requests)]
        outs = [np.asarray(b.result(r, timeout=10)).tolist() for r in reqs]
    finally:
        b.stop()
    return sizes, outs


@pytest.mark.parametrize("max_batch,timeout_ms,requests", [
    (4, 2000.0, [1, 1, 1, 1]),      # a full bucket dispatches at once
    (8, 100.0, [1, 2]),             # 3 live rows padded to bucket 4
    (4, 2000.0, [3, 2]),            # the second opens the next batch
    (8, 2000.0, [8]),
])
def test_coalescing_matches_jax(max_batch, timeout_ms, requests):
    got = _coalesce(tbatcher, max_batch, timeout_ms, requests)
    assert got == _coalesce(jbatcher, max_batch, timeout_ms, requests)


def _queue_full(mod):
    gate = threading.Event()
    p = _params(1.0)

    def slow(x, n):
        gate.wait(10)
        return _jax_apply(p, x)
    b = mod.MicroBatcher(slow, max_batch=1, timeout_ms=500, queue_depth=2,
                         default_deadline_ms=0)
    try:
        first = b.submit(_rows(1))
        admitted, rejected = [], []
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not rejected:
            try:
                admitted.append(b.submit(_rows(1)))
            except mod.QueueFullError as e:
                rejected.append(str(e))
        gate.set()
        b.result(first, timeout=10)
        for r in admitted:
            b.result(r, timeout=10)
    finally:
        gate.set()
        b.stop()
    return rejected


def _deadline(mod):
    gate = threading.Event()
    p = _params(1.0)
    forwarded = []

    def slow(x, n):
        forwarded.append(n)
        gate.wait(10)
        return _jax_apply(p, x)
    b = mod.MicroBatcher(slow, max_batch=1, timeout_ms=500, queue_depth=8,
                         default_deadline_ms=0)
    try:
        first = b.submit(_rows(1))
        while not forwarded:
            time.sleep(0.005)
        late = b.submit(_rows(1), deadline_ms=50)
        time.sleep(0.1)
        gate.set()
        b.result(first, timeout=10)
        with pytest.raises(mod.DeadlineExceededError) as e:
            b.result(late, timeout=10)
        with pytest.raises(mod.DeadlineExceededError) as neg:
            b.submit(_rows(1), deadline_ms=-5)
    finally:
        gate.set()
        b.stop()
    return forwarded, e.value.stage, neg.value.stage, str(neg.value)


def test_queue_full_rejection_matches_jax():
    before = tmetrics.snapshot()
    got = _queue_full(tbatcher)
    assert got == _queue_full(jbatcher) and len(got) == 1
    assert _delta(before,
                  'hvd_tpu_serving_rejected_total{reason="queue_full"}') == 1


def test_deadline_rejection_and_stage_match_jax():
    before = tmetrics.snapshot()
    got = _deadline(tbatcher)
    assert got == _deadline(jbatcher)
    assert got[:3] == ([1], "queue", "queue")
    assert _delta(before,
                  'hvd_tpu_serving_rejected_total{reason="deadline"}') == 2
    assert _delta(before,
                  'hvd_tpu_serving_deadline_stage_total{stage="queue"}') == 2


@pytest.mark.parametrize("x,err", [
    (np.zeros((9, IN_DIM), np.float32), "more than"),
    (np.zeros((0, IN_DIM), np.float32), "at least one row"),
    (np.zeros((1, IN_DIM + 1), np.float32), "does not match"),
])
def test_admission_errors_match_jax(x, err):
    msgs = []
    for mod in (jbatcher, tbatcher):
        b = mod.MicroBatcher(lambda x, n: x, max_batch=8, timeout_ms=1,
                             default_deadline_ms=0, row_shape=(IN_DIM,))
        try:
            with pytest.raises(ValueError, match=err) as e:
                b.submit(x)
            msgs.append(str(e.value))
        finally:
            b.stop()
    assert msgs[0] == msgs[1]


def test_admit_and_batch_fault_sites():
    b = tbatcher.MicroBatcher(lambda x, n: torch.as_tensor(x) * 2,
                              max_batch=4, timeout_ms=1,
                              default_deadline_ms=0)
    try:
        tfaults.configure("serving.admit:error:once", seed=0)
        with pytest.raises(tbatcher.QueueFullError):
            b.submit(_rows(1))
        tfaults.configure("serving.batch:error:once", seed=0)
        with pytest.raises(tfaults.InjectedFault):
            b.infer(_rows(1), timeout=10)
        out = b.infer(_rows(2, 3.0), timeout=10)   # 'once' consumed
        np.testing.assert_array_equal(out, _rows(2, 6.0))
    finally:
        b.stop()


def test_live_rows_only_reach_the_host():
    """The forward's output stays where the forward put it; only the live
    rows are copied back and sliced per request."""
    seen = []

    def forward(x, n):
        out = torch.as_tensor(x) + 1
        seen.append((tuple(out.shape), n))
        return out
    b = tbatcher.MicroBatcher(forward, max_batch=8, timeout_ms=200,
                              default_deadline_ms=0)
    try:
        r = [b.submit(_rows(1, i)) for i in range(3)]
        outs = [b.result(x, timeout=10) for x in r]
    finally:
        b.stop()
    assert seen == [((4, IN_DIM), 3)]
    assert all(isinstance(o, np.ndarray) for o in outs)
    assert [o.tolist() for o in outs] == [
        _rows(1, i + 1).tolist() for i in range(3)]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _port_engine(tmp_path=None, params=None, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("batch_timeout_ms", 5.0)
    kw.setdefault("deadline_ms", 0)
    kw.setdefault("reload_poll_seconds", 0)
    kw.setdefault("warmup", False)
    return tserving.InferenceEngine(
        _port_apply, checkpoint_dir=str(tmp_path) if tmp_path else None,
        params=params, device="cpu", **kw)


def _jax_engine(params, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("batch_timeout_ms", 5.0)
    kw.setdefault("deadline_ms", 0)
    kw.setdefault("reload_poll_seconds", 0)
    kw.setdefault("warmup", False)
    return jserving.InferenceEngine(_jax_apply, params=params, **kw)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.InferenceEngine(_port_apply, params=_params(1.0))


def test_engine_arguments_as_jax():
    with pytest.raises(ValueError):
        tserving.InferenceEngine(_port_apply, device="cpu")
    with pytest.raises(ValueError):
        tserving.InferenceEngine(_port_apply, checkpoint_dir="/x",
                                 params=_params(1.0), device="cpu")
    with pytest.raises(ValueError, match="sharding"):
        tserving.InferenceEngine(_port_apply, params=_params(1.0),
                                 sharding=object(), device="cpu")


def test_engine_restores_warms_and_reloads(tmp_path):
    tckpt.save(str(tmp_path), 1, _params(1.0))
    tckpt.save(str(tmp_path), 2, _params(2.0))
    before = tmetrics.snapshot()
    eng = _port_engine(tmp_path, warmup=True, buckets=(1, 2, 4), max_batch=4,
                       example=np.zeros(IN_DIM, np.float32))
    try:
        assert eng.step == 2
        assert eng._bucketed.compiled_buckets == {1, 2, 4}
        assert set(eng.params) == {"w", "b"}
        out, step = eng.infer_with_step(_rows(1), timeout=10)
        np.testing.assert_allclose(out, np.full((1, OUT_DIM), 8.0))
        assert step == 2 and eng.reload() is False
        tckpt.save(str(tmp_path), 5, _params(3.0))
        assert eng.reload() is True and eng.step == 5
        np.testing.assert_allclose(eng.infer(_rows(1), timeout=10),
                                   np.full((1, OUT_DIM), 12.0))
    finally:
        eng.close()
    assert _delta(before,
                  'hvd_tpu_serving_hot_swaps_total{plane="inference"}') == 1
    assert tmetrics.snapshot()[
        'hvd_tpu_serving_checkpoint_step{plane="inference"}'] == 5


def test_hot_reload_under_traffic_and_crash_drill(tmp_path):
    """Clients hammering the engine across a hot reload see only clean
    answers, each wholly from the step it is labelled with; then the
    ``serving.reload:crash`` drill leaves the old step serving and the
    poller completes the swap on its next poll."""
    tckpt.save(str(tmp_path), 1, _params(1.0))
    answers, errors = [], []
    stop = threading.Event()
    eng = _port_engine(tmp_path, reload_poll_seconds=0.05)

    def client(i):
        while not stop.is_set():
            try:
                out, step = eng.infer_with_step(_rows(2, i + 1), timeout=10)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return
            answers.append((i, step, out))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.1)
        tckpt.save(str(tmp_path), 2, _params(2.0))
        deadline = time.monotonic() + 10
        while eng.step != 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert eng.step == 2, "hot reload never happened"
        time.sleep(0.1)
        tfaults.configure("serving.reload:crash:once", seed=0)
        tckpt.save(str(tmp_path), 3, _params(3.0))
        with pytest.raises(tserving.ReloadCrashed):
            eng.reload()
        assert eng.step == 2
        deadline = time.monotonic() + 10
        while eng.step != 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert eng.step == 3, "the poller did not recover from the crash"
        time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        eng.close()
    assert not errors, errors
    assert {s for _, s, _ in answers} == {1, 2, 3}
    for i, step, out in answers:
        np.testing.assert_array_equal(
            out, np.full((2, OUT_DIM), 4.0 * step * (i + 1), np.float32))


def test_wait_for_step(tmp_path):
    with pytest.raises(TimeoutError):
        tserving.wait_for_step(str(tmp_path), timeout=0.3)
    tckpt.save(str(tmp_path), 3, _params(1.0))
    assert tserving.wait_for_step(str(tmp_path), timeout=5) == 3


# ---------------------------------------------------------------------------
# both HTTP servers, the same requests
# ---------------------------------------------------------------------------

def _call(port, method, path, body=None, headers=None):
    req = Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                  headers=dict(headers or {}))
    try:
        with urlopen(req, timeout=15) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _doc(d):
    return json.dumps(d).encode()


RID = {"X-HVD-TPU-Request-Id": "0123456789abcdef"}
REQUESTS = [
    ("POST", "/v1/infer", _doc({"inputs": _rows(3).tolist()}), RID),
    ("POST", "/v1/infer", _doc({"inputs": _rows(1, 2.5).tolist(),
                                "deadline_ms": 1000}), RID),
    ("POST", "/v1/infer", b"not json", RID),
    ("POST", "/v1/infer", _doc({"rows": [1]}), RID),
    ("POST", "/v1/infer", _doc({"inputs": _rows(9).tolist()}), RID),
    ("POST", "/v1/infer", _doc({"inputs": [[1.0, 2.0]]}), RID),
    ("POST", "/v1/infer", _doc({"inputs": _rows(1).tolist()}),
     dict(RID, **{"X-HVD-TPU-Deadline-Ms": "-1"})),
    ("POST", "/v1/infer", _doc({"inputs": _rows(1).tolist()}),
     dict(RID, **{"X-HVD-TPU-Deadline-Ms": "soon"})),
    ("POST", "/v1/generate", _doc({"prompt": [1, 2]}), RID),
    ("POST", "/v1/generate/stream", _doc({"prompt": [1]}), RID),
    ("POST", "/v1/cancel", _doc({"request_id": "x"}), RID),
    ("POST", "/v1/kv/offer", _doc({"hashes": []}), RID),
    ("POST", "/v1/kv/fetch", _doc({"hashes": []}), RID),
    ("POST", "/v1/reload", _doc({}), RID),
    ("POST", "/v1/reload", _doc({"step": "x"}), RID),
    ("POST", "/nope", _doc({}), RID),
    ("GET", "/healthz", None, RID),
    ("GET", "/nope", None, RID),
]


def test_http_servers_answer_alike():
    answers = {}
    for name, engine, server_mod in (
            ("jax", _jax_engine(_params(1.0)), jserving),
            ("port", _port_engine(params=_params(1.0)), tserving)):
        srv = server_mod.InferenceServer(engine, port=0, addr="127.0.0.1")
        srv.start()
        try:
            answers[name] = [_call(srv.port, *r) for r in REQUESTS]
        finally:
            srv.close()
    for req, (jc, jh, jd), (tc, th, td) in zip(REQUESTS, answers["jax"],
                                               answers["port"]):
        assert tc == jc, (req, jd, td)
        assert th.get("X-HVD-TPU-Request-Id") == RID["X-HVD-TPU-Request-Id"]
        assert th.get("X-HVD-TPU-Deadline-Exceeded") \
            == jh.get("X-HVD-TPU-Deadline-Exceeded")
        if "outputs" in jd:
            np.testing.assert_allclose(td["outputs"], jd["outputs"],
                                       atol=TOL_LINEAR, rtol=0)
            assert td["step"] == jd["step"]
            assert set(td) == set(jd)
        else:
            assert td == jd, req
    codes = [c for c, _, _ in answers["port"]]
    assert codes == [200, 200, 400, 400, 400, 400, 429, 400, 404, 404, 404,
                     404, 404, 500, 400, 404, 200, 404]


# ---------------------------------------------------------------------------
# a 2-layer transformer served by both engines from one JAX checkpoint
# ---------------------------------------------------------------------------

def _jax_flash(q, k, v, mask, dtype):
    del mask
    return jfa.flash_attention(q, k, v, causal=True, out_dtype=dtype,
                               block_q=8, block_k=8, interpret=True)


def _jax_served(model):
    def apply(params, x):
        logits = model.apply({"params": params}, x.astype(jnp.int32))
        last = jax.nn.log_softmax(logits[:, -1], axis=-1)
        tok = jnp.argmax(last, axis=-1)
        lp = jnp.take_along_axis(last, tok[:, None], axis=-1)[:, 0]
        return jnp.stack([tok.astype(jnp.float32), lp], axis=-1)
    return apply


def _port_served(model):
    def apply(params, x):
        logits = torch.func.functional_call(model, params, (x.long(),))
        last = torch.log_softmax(logits[:, -1], dim=-1)
        lp, tok = last.max(dim=-1)
        return torch.stack([tok.float(), lp], dim=-1)
    return apply


def test_served_transformer_matches_jax(tmp_path):
    cfg = jtrm.TransformerConfig(**TINY, dtype=jnp.float32,
                                 attention_fn=_jax_flash)
    jmodel = jtrm.Transformer(cfg)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, TINY["max_seq_len"]), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray,
                                    meta.unbox(variables["params"]))
    jckpt.save(str(tmp_path), 1, params)
    tmodel = Transformer(TransformerConfig(
        **TINY, dtype=torch.float32, attention_fn=flash_attention_fn),
        device="meta")
    rows = np.random.RandomState(0).randint(
        0, TINY["vocab_size"], (7, TINY["max_seq_len"])).astype(np.float32)
    common = dict(max_batch=4, buckets=(1, 2, 4), batch_timeout_ms=50.0,
                  deadline_ms=0, reload_poll_seconds=0, warmup=True,
                  example=np.zeros(TINY["max_seq_len"], np.float32))
    jeng = jserving.InferenceEngine(_jax_served(jmodel),
                                    checkpoint_dir=str(tmp_path), **common)
    teng = tserving.InferenceEngine(_port_served(tmodel),
                                    checkpoint_dir=str(tmp_path),
                                    device="cpu", **common)
    try:
        assert teng.step == jeng.step == 1
        assert set(teng.params) == set(tmodel.state_dict())
        outs = {}
        for name, eng in (("jax", jeng), ("port", teng)):
            # one request at a time: bucket 1, then coalesced: 4 + 2 rows
            single = [np.asarray(eng.infer(rows[i:i + 1], timeout=60))
                      for i in range(2)]
            reqs = [eng.batcher.submit(rows[i:i + 1]) for i in range(1, 7)]
            batched = [np.asarray(eng.batcher.result(r, timeout=60))
                       for r in reqs]
            outs[name] = np.concatenate(single + batched)
    finally:
        jeng.close()
        teng.close()
    j, t = outs["jax"], outs["port"]
    np.testing.assert_array_equal(t[:, 0], j[:, 0])
    np.testing.assert_allclose(t[:, 1], j[:, 1], atol=TOL_LOGPROB, rtol=0)
    assert np.all(t[:, 1] < 0)


# ---------------------------------------------------------------------------
# traced requests
# ---------------------------------------------------------------------------

def test_traced_requests_spans_nest_and_merge(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_TRACE_SAMPLE", "1")
    monkeypatch.setenv("HVD_TPU_TRACE_DIR", str(tmp_path))
    ttr.reset()
    srv = tserving.InferenceServer(
        _port_engine(params=_params(1.0), batch_timeout_ms=100.0), port=0,
        addr="127.0.0.1")
    srv.start()
    rids = [f"{i:016x}" for i in range(1, 5)]
    try:
        threads = [threading.Thread(target=_call, args=(
            srv.port, "POST", "/v1/infer", _doc({"inputs": _rows(1).tolist()}),
            {"X-HVD-TPU-Request-Id": rid})) for rid in rids]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        path = ttr.tracer().span_path
    finally:
        srv.close()
        ttr.reset()
    spans = trace_tool.load_span_file(path)
    for rid in rids:
        mine = {s["name"]: s for s in spans if s["trace"] == rid}
        assert set(mine) == {"server.infer", "batch.queue", "batch.forward"}
        root = mine["server.infer"]
        assert root["parent"] is None
        assert mine["batch.queue"]["parent"] == root["span"]
        assert mine["batch.forward"]["parent"] == root["span"]
        doc = trace_tool.merge(rid, spans)
        assert sorted(trace_tool.span_names(doc)) == [
            "batch.forward", "batch.queue", "server.infer"]
    assert max(s["args"]["batched_requests"] for s in spans
               if s["name"] == "batch.forward") > 1
    jtr.reset()


@pytest.mark.parametrize("batch", [1, 2])
def test_flash_gets_contiguous_heads_at_every_bucket(monkeypatch, batch):
    """Bucket 1 gives the flash Function a batch of one, where the (B, S,
    H, D) -> (B*H, S, D) reshape alone is a strided view; the kernel on
    the card takes contiguous tensors only, so the wrapper must hand it
    contiguous ones (the plain path here would not notice)."""
    from horovod_tpu_torch.ops import flash_attention as tfa
    seen = []
    plain = tfa._flash_fwd

    def spy(q, k, v, *args):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return plain(q, k, v, *args)
    monkeypatch.setattr(tfa, "_flash_fwd", spy)
    q, k, v = (torch.randn(batch, 16, 4, 8) for _ in range(3))
    with torch.inference_mode():
        out, _ = tfa.flash_attention_with_lse(q, k, v, causal=True)
    assert seen == [True]
    want = tfa.mha_reference(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
