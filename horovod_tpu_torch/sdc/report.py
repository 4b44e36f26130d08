"""SDC quarantine report channel shared by drills and production.

Mirrors the preemption notice channel (``elastic/preemption.py``): one
journaled rendezvous KV scope (``scope='sdc'``) keyed by hostname,
carrying a small JSON payload:

    {"kind": "nonfinite"|"loss_spike"|"fingerprint",
     "strikes": <detections inside the policy window when reported>,
     "ts": <unix time the report was sent>}

Producers:

* the worker-side SDC policy — when a host's detections cross
  ``HVD_TPU_SDC_STRIKES`` inside the window, the worker PUTs its own
  report via :meth:`WorkerNotificationManager.send_sdc_report`;
* an external agent — ``curl -X PUT http://<coordinator>/sdc/<host>``
  with the JSON body — since the KV server runs scope PUT handlers for
  HTTP requests and in-process puts alike.

Both converge on ``ElasticDriver.record_sdc_report``, which quarantines
the host (``blacklist_host(reason="sdc")`` — persisted to the journaled
blacklist scope, unlike a graceful drain, so a flaky chip stays out
across coordinator restarts).
"""

import json
import time
from typing import Optional, Tuple

#: rendezvous KV scope carrying SDC quarantine reports (journaled — a
#: coordinator restart must not forget a host already caught corrupting)
SDC_SCOPE = "sdc"


def encode_report(kind: str, strikes: int = 1,
                  ts: Optional[float] = None) -> bytes:
    """Serialize a report payload for the ``sdc`` scope."""
    return json.dumps(
        {"kind": str(kind), "strikes": int(strikes),
         "ts": float(ts) if ts is not None else time.time()}).encode()


def decode_report(value: Optional[bytes]) -> Tuple[str, int, float]:
    """``(kind, strikes, ts)`` from a scope value; tolerant of hand-fed
    payloads (bare string, empty or missing body) so an operator's quick
    ``curl`` still parses."""
    try:
        obj = json.loads((value or b"").decode() or "{}")
    except (ValueError, UnicodeDecodeError):
        return "nonfinite", 1, time.time()
    if isinstance(obj, str):
        return obj or "nonfinite", 1, time.time()
    if not isinstance(obj, dict):
        return "nonfinite", 1, time.time()
    kind = obj.get("kind")
    kind = kind if isinstance(kind, str) and kind else "nonfinite"
    try:
        strikes = int(obj.get("strikes", 1))
    except (TypeError, ValueError):
        strikes = 1
    try:
        ts = float(obj.get("ts", time.time()))
    except (TypeError, ValueError):
        ts = time.time()
    return kind, strikes, ts
