"""The serving HTTP front-end: ``/v1/infer``, ``/v1/generate``,
``/v1/generate/stream``, ``/v1/cancel``, ``/v1/kv/offer``,
``/v1/kv/fetch``, ``/v1/reload``, ``/healthz`` (counterpart of
``horovod_tpu/serving/server.py``).

Same stdlib idiom as the rendezvous KV server and the metrics endpoint,
through the shared :mod:`horovod_tpu_torch._http` front-end: idle
keep-alive connections wait in a selector and each active request runs
on a worker thread, which blocks inside ``engine.infer_with_step()`` /
``gen_engine.result()`` until its work completes — so N concurrent
requests still coalesce into one forward (inference) or share the
running decode batch (generation).

Admission control shows up at the wire as status codes, identically on
both POST routes:

* ``200`` — served;
* ``429`` — the deadline expired: before the micro-batch dispatched
  (``/v1/infer``) or before the next token was produced
  (``/v1/generate``'s per-token extension);
* ``503`` — the bounded queue is full (back off and retry);
* ``400`` — malformed request (not JSON, bad shapes, a generation
  request that could never fit);
* ``499`` — the generation was cancelled (``/v1/cancel``);
* ``500`` — the forward / a decode or prefill step failed (includes
  injected ``serving.*`` faults; the next request gets fresh state).

Every response increments ``hvd_tpu_serving_requests_total{code}``.

Wire formats (JSON):

* ``/v1/infer`` request ``{"inputs": [[...], ...]}`` (rows of the
  model's input; optional ``"deadline_ms"``), response
  ``{"outputs": [...], "step": N}``;
* ``/v1/generate`` request ``{"prompt": [int, ...]}`` (optional
  ``"max_tokens"``, ``"eos_id"``, ``"deadline_ms"``, and the on-device
  sampling controls ``"temperature"``/``"top_k"``/``"top_p"``/
  ``"seed"`` — invalid values are a 400), response
  ``{"tokens": [int, ...], "logprobs": [float, ...], "step": N}`` —
  ``logprobs`` is index-aligned with ``tokens`` (the sampled token's
  log-probability under the *unmodified* softmax), ``step`` is the
  serving checkpoint at completion (a hot-reload may land mid-sequence;
  decode continues under the new params).

Request survivability:

* the end-to-end budget arrives as ``X-HVD-TPU-Deadline-Ms`` (the
  fleet router mints and decrements it; direct clients may set it
  too) and bounds the request across EVERY stage — unlike
  ``deadline_ms``, which re-arms per token. A 429 names the stage
  that shed the request in the ``X-HVD-TPU-Deadline-Exceeded``
  response header (``queue`` / ``prefill`` / ``decode``);
* ``POST /v1/generate/stream`` is the journaling transport for
  mid-stream failover: an NDJSON stream opening with
  ``{"meta": {"seed", "request_id", "step"}}`` (the *effective* seed,
  so a resume can pin it), then ``{"t": token, "lp": logprob}`` per
  token, closing with ``{"done": true, "finish", "step"}`` — or
  ``{"error", "code", "stage"}`` on an in-stream failure. An EOF
  without a terminal record means the replica died mid-stream; a
  router resubmits ``prompt + emitted`` with ``"sample_offset"`` set
  so the continuation is bit-identical;
* ``POST /v1/cancel`` ``{"request_id": "..."}`` flags that request's
  sequences for cancellation (hedging's loser-cancel; resumed-stream
  cleanup). Cancellation is asynchronous; a cancelled blocking
  generation answers 499.

A route whose engine is not configured answers 404 (``{"error": "no
generation engine configured"}`` on the generation routes). Every
response echoes the ``X-HVD-TPU-Request-Id`` header (minted when the
client sent none) and quotes it in error bodies; each POST is the root
span of its trace (``server.infer``, ``server.generate``, ...), nested
under the ``X-HVD-TPU-Trace-Parent`` header's span when one is sent.
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
from .disagg.transfer import pull_and_import
from .disagg.wire import pack_blocks
from .engine import InferenceEngine
from .generation.scheduler import RequestCancelledError

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
        engine = self.server.engine or self.server.gen_engine
        doc = {"status": "serving", "step": engine.step}
        if self.server.engine is not None:
            doc["queue_depth"] = self.server.engine.queue_depth
        if self.server.gen_engine is not None:
            # the generation plane's capacity story: prefix-cache mode
            # plus the block pool split (free/cached/private/shared sums
            # to the pool capacity) — the same numbers the
            # hvd_tpu_gen_kv_blocks{state} gauge publishes
            alloc = self.server.gen_engine.allocator
            doc["prefix_cache"] = bool(alloc.prefix_cache)
            doc["kv_blocks"] = alloc.stats()
            # pool membership for the disagg fleet: the router's
            # /fleet/health aggregates this per pool
            doc["disagg_role"] = self.server.gen_engine.role
            # decode-feature homogeneity: routers assert a decode pool
            # agrees on these before prestaging spec/beam traffic
            doc["spec_mode"] = self.server.gen_engine.spec_mode
            doc["spec_tokens"] = self.server.gen_engine.spec_tokens
            doc["max_beams"] = self.server.gen_engine.max_beams
        self._respond(200, doc)

    def do_POST(self):  # noqa: N802
        self._rid = None
        path = self.path.split("?", 1)[0]
        if path == "/v1/infer":
            self._infer()
        elif path == "/v1/generate":
            self._generate()
        elif path == "/v1/generate/stream":
            self._generate_stream()
        elif path == "/v1/cancel":
            self._cancel()
        elif path == "/v1/kv/offer":
            self._kv_offer()
        elif path == "/v1/kv/fetch":
            self._kv_fetch()
        elif path == "/v1/reload":
            self._reload()
        else:
            self._respond(404, {"error": "not found"})

    def _read_doc(self):
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length)
        return json.loads(raw) if raw.strip() else {}

    def _reload(self) -> None:
        """Admin endpoint for a rolling rollout: swap to the
        newest committed checkpoint (or an explicit ``{"step": N}``) on
        whichever engines are configured; response names the serving
        step afterwards. A failed restore is a 500 with the old params
        still serving (reload is atomic-or-nothing)."""
        try:
            doc = self._read_doc()
            step = doc.get("step")
            step = None if step is None else int(step)
        except (ValueError, TypeError) as e:
            self._respond(400, {"error": f"bad request: {e}"})
            return
        engines = [e for e in (self.server.engine, self.server.gen_engine)
                   if e is not None]
        try:
            reloaded = [bool(e.reload(step=step)) for e in engines]
        except Exception as e:  # noqa: BLE001 — restore failure -> 500
            log.warning("serving: reload failed (request %s): %s",
                        self._request_id(), e)
            self._respond(500, {"error": str(e)})
            return
        self._respond(200, {"reloaded": any(reloaded),
                            "step": engines[0].step})

    def _infer(self) -> None:
        engine: InferenceEngine = self.server.engine
        if engine is None:
            self._respond(404, {"error": "no inference engine configured"})
            return
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

    def _parse_generate(self, doc: dict) -> dict:
        """Shared request parsing for ``/v1/generate`` and
        ``/v1/generate/stream``; ``ValueError``/``KeyError``/
        ``TypeError`` out of here is the caller's 400."""
        budget_ms = self._budget_ms()
        if budget_ms is None and doc.get("budget_ms") is not None:
            budget_ms = float(doc["budget_ms"])

        def opt(name, conv):
            v = doc.get(name)
            return None if v is None else conv(v)

        return dict(
            prompt=[int(t) for t in doc["prompt"]],
            max_tokens=int(doc.get("max_tokens", 16)),
            eos_id=opt("eos_id", int),
            deadline_ms=doc.get("deadline_ms"),
            temperature=opt("temperature", float),
            top_k=opt("top_k", int),
            top_p=opt("top_p", float),
            seed=opt("seed", int),
            budget_ms=budget_ms,
            sample_offset=int(doc.get("sample_offset", 0)),
            num_beams=opt("num_beams", int),
            request_id=self._request_id())

    def _generate(self) -> None:
        gen = self.server.gen_engine
        if gen is None:
            self._respond(404, {"error": "no generation engine configured"})
            return
        try:
            kwargs = self._parse_generate(self._read_doc())
        except (ValueError, KeyError, TypeError) as e:
            self._respond(400, {"error": f"bad request: {e}"})
            return
        # admission errors are the CLIENT's (400/429/503); anything the
        # scheduler delivers after admission — even a ValueError out of
        # the device program — is a server-side 500, so the two phases
        # are caught separately
        with _tracing.request_span(
                "server.generate", self._request_id(),
                parent=self.headers.get(_tracing.TRACE_PARENT_HEADER),
                args={"prompt_tokens": len(kwargs["prompt"]),
                      "max_tokens": kwargs["max_tokens"]}):
            try:
                seq = gen.submit(**kwargs)
            except QueueFullError as e:
                self._respond(503, {"error": str(e)})
                return
            except DeadlineExceededError as e:
                self._deadline_exceeded(e)
                return
            except ValueError as e:  # could-never-fit, bad sampling params
                self._respond(400, {"error": str(e)})
                return
            try:
                tokens = gen.result(seq)
            except DeadlineExceededError as e:
                self._deadline_exceeded(e)
                return
            except RequestCancelledError as e:
                self._respond(499, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — decode failure -> 500
                log.warning("serving: generation failed for one sequence "
                            "(request %s): %s", self._request_id(), e)
                self._respond(500, {"error": str(e)})
                return
            out = {"tokens": tokens,
                   "logprobs": [round(x, 6) for x in seq.logprobs],
                   "step": gen.step}
            if gen.role == "prefill":
                # prefill-only replica: no tokens come back — the
                # deliverable is the content-addressed manifest a
                # router offers to the decode pool, plus where to
                # fetch the payloads from
                out["manifest"] = {
                    "hashes": gen.kv_manifest(kwargs["prompt"]),
                    "source": getattr(self.server, "advertised_url",
                                      None)}
            self._respond(200, out)

    def _generate_stream(self) -> None:
        """NDJSON streaming generation (module docstring: wire format).
        Admission errors answer as plain JSON statuses; once the meta
        record is on the wire the stream can only end with a ``done``
        or ``error`` record — or be severed by this replica dying,
        which is exactly the EOF the fleet router's failover detects."""
        gen = self.server.gen_engine
        if gen is None:
            self._respond(404, {"error": "no generation engine configured"})
            return
        try:
            kwargs = self._parse_generate(self._read_doc())
        except (ValueError, KeyError, TypeError) as e:
            self._respond(400, {"error": f"bad request: {e}"})
            return
        rid = self._request_id()
        with _tracing.request_span(
                "server.generate_stream", rid,
                parent=self.headers.get(_tracing.TRACE_PARENT_HEADER),
                args={"prompt_tokens": len(kwargs["prompt"]),
                      "max_tokens": kwargs["max_tokens"]}):
            try:
                seq = gen.submit(**kwargs)
            except QueueFullError as e:
                self._respond(503, {"error": str(e)})
                return
            except DeadlineExceededError as e:
                self._deadline_exceeded(e)
                return
            except ValueError as e:
                self._respond(400, {"error": str(e)})
                return
            _M_REQUESTS.labels(code="200").inc()
            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header(REQUEST_ID_HEADER, rid)
                # no Content-Length: the stream's length is unknown;
                # EOF semantics carry the severed-stream signal
                self.send_header("Connection", "close")
                self.close_connection = True
                self.end_headers()
                # the meta record publishes the EFFECTIVE seed (a
                # seedless submit defaults to the sequence id) — the
                # one fact a resume cannot reconstruct client-side
                self._stream_line({"meta": {"seed": seq.seed,
                                            "request_id": rid,
                                            "step": gen.step}})
                n = 0
                for tok in gen.batcher.stream(seq):
                    self._stream_line({"t": int(tok),
                                       "lp": round(seq.logprobs[n], 6)})
                    n += 1
                finish = ("eos" if seq.eos_id is not None and seq.generated
                          and seq.generated[-1] == seq.eos_id else "length")
                self._stream_line({"done": True, "finish": finish,
                                   "step": gen.step})
            except OSError:
                # the CLIENT went away mid-stream: stop burning decode
                # capacity on tokens nobody will read
                gen.cancel(rid)
            except DeadlineExceededError as e:
                self._stream_error(e, 429, getattr(e, "stage", None))
            except RequestCancelledError as e:
                self._stream_error(e, 499, None)
            except Exception as e:  # noqa: BLE001 — decode failure
                log.warning("serving: streamed generation failed "
                            "(request %s): %s", rid, e)
                self._stream_error(e, 500, None)

    def _stream_line(self, doc: dict) -> None:
        self.wfile.write((json.dumps(doc) + "\n").encode("utf-8"))
        self.wfile.flush()

    def _stream_error(self, err: BaseException, code: int,
                      stage: Optional[str]) -> None:
        """Terminal error record for an already-streaming response (the
        status line is long gone; the record carries the would-be
        code). Best-effort: the client may already be gone."""
        try:
            self._stream_line({"error": str(err), "code": code,
                               "stage": stage,
                               "request_id": self._request_id()})
        except OSError:
            pass

    def _cancel(self) -> None:
        """Flag a request id for cancellation on the generation engine
        (hedging's loser-cancel; resumed-stream cleanup). Always 200:
        cancellation is asynchronous and idempotent, and an id that
        matches nothing (already retired, never submitted here) is not
        an error the caller can act on."""
        gen = self.server.gen_engine
        if gen is None:
            self._respond(404, {"error": "no generation engine configured"})
            return
        try:
            doc = self._read_doc()
            rid = str(doc["request_id"])
        except (ValueError, KeyError, TypeError) as e:
            self._respond(400, {"error": f"bad request: {e}"})
            return
        gen.cancel(rid)
        self._respond(200, {"cancelled": rid})

    # -- disaggregated KV hop -----------------------------------------------

    def _kv_offer(self) -> None:
        """Decode side of the KV hop: the router offers a prompt's
        content-addressed manifest; this replica pulls only the blocks
        it doesn't already hold from the named prefill source and
        registers them for zero-debt admission. Transfer failures
        degrade (``error`` in the 200 body) — the only client error
        here is an already-exhausted end-to-end budget, shed as a 429
        attributed to the ``transfer`` stage."""
        gen = self.server.gen_engine
        if gen is None:
            self._respond(404, {"error": "no generation engine configured"})
            return
        try:
            doc = self._read_doc()
            hashes = [str(h) for h in doc["hashes"]]
            source = doc.get("source")
            budget_ms = self._budget_ms()
        except (ValueError, KeyError, TypeError) as e:
            self._respond(400, {"error": f"bad request: {e}"})
            return
        if budget_ms is not None and budget_ms <= 0:
            self._deadline_exceeded(DeadlineExceededError(
                "end-to-end budget exhausted before KV transfer",
                stage="transfer"))
            return
        with _tracing.request_span(
                "server.kv_offer", self._request_id(),
                parent=self.headers.get(_tracing.TRACE_PARENT_HEADER),
                args={"blocks": len(hashes)}):
            res = pull_and_import(gen, hashes, source=source,
                                  request_id=self._request_id())
        self._respond(200, res)

    def _kv_fetch(self) -> None:
        """Prefill side of the KV hop: read the requested blocks'
        contents off the paged pools (scheduler-thread control op) and
        ship them packed. Blocks evicted since the offer simply
        truncate the served prefix — the decode side re-prefills the
        difference."""
        gen = self.server.gen_engine
        if gen is None:
            self._respond(404, {"error": "no generation engine configured"})
            return
        try:
            doc = self._read_doc()
            hashes = [str(h) for h in doc["hashes"]]
            wire_dtype = str(
                doc.get("wire_dtype")
                or _config.live_config().get(
                    _config.DISAGG_WIRE_DTYPE)).strip().lower()
        except (ValueError, KeyError, TypeError) as e:
            self._respond(400, {"error": f"bad request: {e}"})
            return
        with _tracing.request_span(
                "server.kv_fetch", self._request_id(),
                parent=self.headers.get(_tracing.TRACE_PARENT_HEADER),
                args={"blocks": len(hashes)}):
            try:
                served, k_np, v_np = gen.kv_export(hashes)
                payload = pack_blocks(served, k_np, v_np, wire_dtype)
            except ValueError as e:        # unknown wire dtype
                self._respond(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — export failure -> 500
                log.warning("serving: KV export failed (request %s): %s",
                            self._request_id(), e)
                self._respond(500, {"error": str(e)})
                return
            self._respond(200, payload)


class InferenceServer:
    """HTTP front-end over an :class:`InferenceEngine` and/or
    a :class:`~horovod_tpu_torch.serving.generation.GenerationEngine`.

    ``engine`` serves ``POST /v1/infer``; ``gen_engine`` serves
    ``POST /v1/generate``; at least one is required (a route without an
    engine answers 404). ``port`` defaults to ``HVD_TPU_SERVING_PORT``
    (0 = ephemeral; read the bound port back from :attr:`port`).
    ``start()``/``stop()`` are idempotent; stopping the server does not
    close the engines (they may serve in-process callers too) — use
    :meth:`close` for both.
    """

    def __init__(self, engine: Optional[InferenceEngine],
                 port: Optional[int] = None,
                 addr: str = "0.0.0.0", verbose: bool = False,
                 gen_engine=None, advertised_url: Optional[str] = None):
        if engine is None and gen_engine is None:
            raise ValueError(
                "provide at least one of engine= / gen_engine=")
        self.engine = engine
        self.gen_engine = gen_engine
        self._requested_port = int(
            _config.live_config().get(_config.SERVING_PORT)
            if port is None else port)
        self._addr = addr
        self._verbose = verbose
        self._httpd = None
        # the URL OTHER replicas reach this server at — a prefill
        # replica hands it out as the manifest's fetch source (defaults
        # to loopback + the bound port, right for single-host fleets)
        self._advertised_url = advertised_url

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
            self._httpd.gen_engine = self.gen_engine
            self._httpd.advertised_url = (
                self._advertised_url
                or f"http://127.0.0.1:{self.port}")
            log.info("serving: HTTP front-end on %s:%d (step %d)",
                     self._addr, self.port,
                     (self.engine or self.gen_engine).step)
        return self.port

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        _http.stop_server(httpd)

    def close(self) -> None:
        self.stop()
        if self.engine is not None:
            self.engine.close()
        if self.gen_engine is not None:
            self.gen_engine.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
