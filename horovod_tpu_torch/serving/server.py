"""The serving HTTP front-end: ``/v1/infer``, ``/v1/reload``,
``/healthz`` (counterpart of ``horovod_tpu/serving/server.py``, its
inference plane).

Same stdlib idiom as the rendezvous KV server and the metrics endpoint,
through the shared :mod:`horovod_tpu_torch._http` front-end: idle
keep-alive connections wait in a selector, and each active request runs
on a worker thread, which blocks inside ``engine.infer_with_step()``
until its micro-batch completes, so N concurrent requests coalesce into
one forward.

Admission control shows at the wire as status codes:

* ``200``: served;
* ``429``: the deadline expired before the micro-batch dispatched; the
  ``X-HVD-TPU-Deadline-Exceeded`` response header (and the body's
  ``stage``) names the stage that shed the request;
* ``503``: the bounded queue is full (back off and retry);
* ``400``: malformed request (not JSON, bad shapes, too many rows);
* ``500``: the forward failed (includes injected ``serving.*`` faults).

Every response increments ``hvd_tpu_serving_requests_total{code}``,
echoes the ``X-HVD-TPU-Request-Id`` header (minted when the client sent
none) and quotes it in error bodies. ``/v1/infer`` takes ``{"inputs":
[[...], ...]}`` (rows of the model's input; optional ``"deadline_ms"``,
tightened by the end-to-end budget header ``X-HVD-TPU-Deadline-Ms``) and
answers ``{"outputs": [...], "step": N}``, ``step`` naming the checkpoint
that produced the outputs. Each request is the root span
``server.infer`` of its trace (``HVD_TPU_TRACE_SAMPLE``), nested under
the ``X-HVD-TPU-Trace-Parent`` header's span when one is sent.

The generation routes (``/v1/generate``, ``/v1/generate/stream``,
``/v1/cancel``, ``/v1/kv/offer``, ``/v1/kv/fetch``) answer exactly as the
JAX server does without a generation engine: 404 ``{"error": "no
generation engine configured"}``. The server's ``gen_engine=`` waits
for the port of the generation plane (ROADMAP A6).
"""

import json
import logging
from typing import Optional

import numpy as np

from .. import _http
from .. import config as _config
from .. import metrics as _metrics
from .. import tracing as _tracing
from .batcher import (DEADLINE_HEADER, DEADLINE_STAGE_HEADER,
                      DeadlineExceededError, QueueFullError)
from .engine import InferenceEngine

log = logging.getLogger("horovod_tpu_torch.serving")

_M_REQUESTS = _metrics.counter(
    "hvd_tpu_serving_requests_total",
    "Serving HTTP requests (/v1/infer and /v1/generate) by response "
    "code: 200 served, 429 deadline expired, 503 queue full (admission "
    "control), 400 malformed, 500 forward/decode failure.",
    labels=("code",))


#: cross-tier trace header: a router stamps it (generating one when the
#: client didn't) and this side echoes it and tags failure logs with it,
#: so one bad request is greppable router -> replica
REQUEST_ID_HEADER = "X-HVD-TPU-Request-Id"

#: the generation plane's routes, answered 404 until it is ported
_GENERATION_ROUTES = ("/v1/generate", "/v1/generate/stream", "/v1/cancel",
                      "/v1/kv/offer", "/v1/kv/fetch")


class _ServingHandler(_http.QuietHandler):
    def _request_id(self):
        # generate an id server-side when the client sent none, so every
        # response — including 4xx/5xx — carries a quotable id; cached
        # per request (do_GET/do_POST clear it: keep-alive reuses the
        # handler instance across requests)
        rid = getattr(self, "_rid", None)
        if rid is None:
            rid = self.headers.get(REQUEST_ID_HEADER) or \
                _tracing.new_request_id()
            self._rid = rid
        return rid

    def _respond(self, code: int, doc: dict,
                 headers: Optional[dict] = None) -> None:
        rid = self._request_id()
        if code >= 400 and "request_id" not in doc:
            # error bodies quote the id too: a client that dropped the
            # response headers can still report a traceable failure
            doc = dict(doc, request_id=rid)
        body = json.dumps(doc).encode("utf-8")
        _M_REQUESTS.labels(code=str(code)).inc()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header(REQUEST_ID_HEADER, rid)
            for k, v in (headers or {}).items():
                if v is not None:
                    self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            # client gave up while we were batching; nothing to serve
            self.close_connection = True

    def _deadline_exceeded(self, e: DeadlineExceededError) -> None:
        """429 with the stage that shed the request named in the
        ``X-HVD-TPU-Deadline-Exceeded`` header (and body)."""
        stage = getattr(e, "stage", None)
        self._respond(429, {"error": str(e), "stage": stage},
                      headers={DEADLINE_STAGE_HEADER: stage})

    def _budget_ms(self) -> Optional[float]:
        """Remaining end-to-end budget from ``X-HVD-TPU-Deadline-Ms``
        (None when absent; a malformed value raises ``ValueError`` into
        the caller's 400 path)."""
        raw = self.headers.get(DEADLINE_HEADER)
        return None if raw is None else float(raw)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        self._rid = None
        if self.path.split("?", 1)[0] != "/healthz":
            self._respond(404, {"error": "not found"})
            return
        engine = self.server.engine
        self._respond(200, {"status": "serving", "step": engine.step,
                            "queue_depth": engine.queue_depth})

    def do_POST(self):  # noqa: N802
        self._rid = None
        path = self.path.split("?", 1)[0]
        if path == "/v1/infer":
            self._infer()
        elif path in _GENERATION_ROUTES:
            # the JAX server's answer on these routes without a
            # generation engine, before it reads the body
            self._respond(404, {"error": "no generation engine configured"})
        elif path == "/v1/reload":
            self._reload()
        else:
            self._respond(404, {"error": "not found"})

    def _read_doc(self):
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length)
        return json.loads(raw) if raw.strip() else {}

    def _reload(self) -> None:
        """Admin endpoint for a rolling rollout: swap to the newest
        committed checkpoint (or an explicit ``{"step": N}``); the
        response names the serving step afterwards. A failed restore is a 500 with the old params
        still serving (reload is atomic-or-nothing)."""
        try:
            doc = self._read_doc()
            step = doc.get("step")
            step = None if step is None else int(step)
        except (ValueError, TypeError) as e:
            self._respond(400, {"error": f"bad request: {e}"})
            return
        engine = self.server.engine
        try:
            reloaded = bool(engine.reload(step=step))
        except Exception as e:  # noqa: BLE001 — restore failure -> 500
            log.warning("serving: reload failed (request %s): %s",
                        self._request_id(), e)
            self._respond(500, {"error": str(e)})
            return
        self._respond(200, {"reloaded": reloaded, "step": engine.step})

    def _infer(self) -> None:
        engine: InferenceEngine = self.server.engine
        try:
            doc = self._read_doc()
            x = np.asarray(doc["inputs"], dtype=np.float32)
            # the end-to-end budget header tightens (never loosens) the
            # request's own deadline: the inference plane has a single
            # dispatch stage, so min() is the whole decrement story here
            deadline_ms = doc.get("deadline_ms")
            budget = self._budget_ms()
            if budget is not None:
                deadline_ms = (budget if deadline_ms is None
                               else min(float(deadline_ms), budget))
        except (ValueError, KeyError, TypeError) as e:
            self._respond(400, {"error": f"bad request: {e}"})
            return
        with _tracing.request_span(
                "server.infer", self._request_id(),
                parent=self.headers.get(_tracing.TRACE_PARENT_HEADER),
                args={"rows": len(x)}):
            try:
                out, step = engine.infer_with_step(
                    x, deadline_ms=deadline_ms)
            except QueueFullError as e:
                self._respond(503, {"error": str(e)})
                return
            except DeadlineExceededError as e:
                self._deadline_exceeded(e)
                return
            except ValueError as e:         # oversized request, bad rank
                self._respond(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — forward failure -> 500
                log.warning("serving: forward failed for one batch "
                            "(request %s): %s", self._request_id(), e)
                self._respond(500, {"error": str(e)})
                return
            # step comes back with the batch result: it names the
            # checkpoint that PRODUCED these outputs, even if a hot-swap
            # landed since
            self._respond(200, {"outputs": np.asarray(out).tolist(),
                                "step": step})


class InferenceServer:
    """HTTP front-end over an :class:`InferenceEngine`.

    ``port`` defaults to ``HVD_TPU_SERVING_PORT`` (0 = ephemeral; read the
    bound port back from :attr:`port`). ``start()``/``stop()`` are
    idempotent; stopping the server does not close the engine (it may
    serve in-process callers too); :meth:`close` closes both.
    """

    def __init__(self, engine: InferenceEngine, port: Optional[int] = None,
                 addr: str = "0.0.0.0", verbose: bool = False):
        if engine is None:
            raise ValueError("an inference engine is required")
        self.engine = engine
        self._requested_port = int(
            _config.live_config().get(_config.SERVING_PORT)
            if port is None else port)
        self._addr = addr
        self._verbose = verbose
        self._httpd = None

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("InferenceServer not started")
        return self._httpd.server_address[1]

    def start(self) -> int:
        if self._httpd is None:
            self._httpd = _http.start_server(
                _ServingHandler, port=self._requested_port,
                addr=self._addr, name="hvd-tpu-serving-http",
                verbose=self._verbose)
            self._httpd.engine = self.engine
            log.info("serving: HTTP front-end on %s:%d (step %d)",
                     self._addr, self.port, self.engine.step)
        return self.port

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        _http.stop_server(httpd)

    def close(self) -> None:
        self.stop()
        self.engine.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
