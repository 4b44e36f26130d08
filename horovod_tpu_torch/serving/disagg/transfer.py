"""Decode-side KV-block transfer: answer an offer by pulling only the
missing blocks and registering them remotely (counterpart of
``horovod_tpu/serving/disagg/transfer.py``).

:func:`pull_and_import` is the whole ``POST /v1/kv/offer`` story after
parsing: probe the local prefix-cache index for the offered chain
(``disagg.offer`` math — a warm shared prefix matches everything and
moves **zero bytes**), pull the missing tail's payloads from the
prefill replica's ``/v1/kv/fetch`` (the ``disagg.transfer`` span and
fault site; bytes/seconds land in the transfer counters), then write
and register them through the scheduler thread (the ``disagg.admit``
span). Every failure mode degrades, never errors: a dead prefill
replica, an injected ``disagg.transfer`` fault, or an exhausted block
pool all collapse to "fewer blocks held", and the sequence that
follows simply re-prefills the difference locally — bit-identical
output either way, which is what the seeded mid-transfer kill drill
pins.
"""

import json
import logging
import time
import urllib.request
from typing import Dict, Optional, Sequence

from ... import config as _config
from ... import faults as _faults
from ... import metrics as _metrics
from ... import tracing as _tracing
from ..fleet.router import REQUEST_ID_HEADER
from .wire import unpack_blocks

log = logging.getLogger("horovod_tpu_torch.disagg")

# mid-transfer kill drill: fired as the decode replica pulls block
# payloads off the prefill replica; an injected error abandons the
# transfer at exactly that point — zero-debt admission degrades to
# local re-prefill with no client-visible failure
_FP_TRANSFER = _faults.FaultPoint("disagg.transfer",
                                  exc=_faults.InjectedTransientFault)

_M_TRANSFER_BYTES = _metrics.counter(
    "hvd_tpu_disagg_transfer_bytes_total",
    "KV-block payload bytes pulled across the prefill->decode hop "
    "(wire size after HVD_TPU_DISAGG_WIRE_DTYPE packing; excludes "
    "JSON/base64 framing). A warm shared prefix adds ZERO here — "
    "content-addressed offers dedup against the decode replica's "
    "prefix-cache index before any payload moves.")
_M_TRANSFER_SECONDS = _metrics.counter(
    "hvd_tpu_disagg_transfer_seconds",
    "Wall seconds spent pulling KV payloads from prefill replicas "
    "(the disagg.transfer span), including failed pulls. Pair with "
    "hvd_tpu_disagg_transfer_bytes_total for effective hop bandwidth.")


def fetch_blocks(source: str, hashes: Sequence[str],
                 wire_dtype: str = "native",
                 timeout: Optional[float] = None,
                 request_id: Optional[str] = None):
    """Pull ``hashes``' packed payloads from ``source``'s
    ``POST /v1/kv/fetch``; returns :func:`~.wire.unpack_blocks`'s
    ``(served_hashes, k, v, wire_bytes)``. The prefill side may
    serve a shorter prefix than asked (blocks evicted since the offer
    was computed) — the importer tolerates that."""
    headers = {"Content-Type": "application/json"}
    if request_id:
        headers[REQUEST_ID_HEADER] = str(request_id)
    ctx = _tracing.current()
    if ctx is not None:
        # the prefill replica's server.kv_fetch span nests under this
        # hop's disagg.transfer span
        headers[_tracing.TRACE_PARENT_HEADER] = ctx.encode()
    body = json.dumps({"hashes": [str(h) for h in hashes],
                       "wire_dtype": wire_dtype}).encode("utf-8")
    req = urllib.request.Request(
        source.rstrip("/") + "/v1/kv/fetch", data=body,
        headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        doc = json.loads(resp.read().decode("utf-8"))
    return unpack_blocks(doc)


def pull_and_import(engine, hashes: Sequence[str],
                    source: Optional[str] = None,
                    request_id: Optional[str] = None,
                    timeout: Optional[float] = None,
                    wire_dtype: Optional[str] = None) -> Dict:
    """Answer one KV offer on the decode side (see module docstring).

    Returns ``{"held", "imported", "bytes", "error"}``: ``held`` blocks
    of the offered chain were already indexed locally (zero-byte
    prefix-cache hits), ``imported`` were pulled from ``source`` and
    registered remote, ``bytes`` moved on the wire, ``error`` names a
    degraded transfer (None when clean). Never raises for transfer or
    admit failures — degradation IS the contract."""
    cfg = _config.live_config()
    if timeout is None:
        timeout = float(cfg.get(_config.DISAGG_FETCH_TIMEOUT_S))
    if wire_dtype is None:
        wire_dtype = str(cfg.get(_config.DISAGG_WIRE_DTYPE)).strip().lower()
    hashes = [str(h) for h in hashes]
    if not hashes or not getattr(engine, "prefix_cache", False):
        return {"held": 0, "imported": 0, "bytes": 0,
                "error": None if hashes else "empty offer"}
    held = engine.kv_probe(hashes)
    missing = hashes[held:]
    payload_hashes, k_np, v_np, nbytes = [], None, None, 0
    error = None
    if missing and source:
        t0 = time.perf_counter()
        try:
            with _tracing.span("disagg.transfer",
                               args={"blocks": len(missing),
                                     "source": source}):
                _FP_TRANSFER.fire()
                payload_hashes, k_np, v_np, nbytes = fetch_blocks(
                    source, missing, wire_dtype=wire_dtype,
                    timeout=timeout, request_id=request_id)
        except Exception as e:  # noqa: BLE001 — degrade, never error
            error = str(e)
            log.warning("disagg: KV pull from %s failed, degrading to "
                        "local re-prefill (request %s): %s",
                        source, request_id, e)
            payload_hashes, k_np, v_np, nbytes = [], None, None, 0
        _M_TRANSFER_SECONDS.inc(time.perf_counter() - t0)
        if nbytes:
            _M_TRANSFER_BYTES.inc(nbytes)
    imported = 0
    if payload_hashes:
        try:
            with _tracing.span("disagg.admit",
                               args={"payload_blocks": len(payload_hashes)}):
                held, imported = engine.kv_import(
                    hashes, payload_hashes, k_np, v_np)
        except Exception as e:  # noqa: BLE001 — degrade, never error
            error = str(e)
            log.warning("disagg: KV admit failed, degrading to local "
                        "re-prefill (request %s): %s", request_id, e)
    return {"held": held, "imported": imported, "bytes": nbytes,
            "error": error}
