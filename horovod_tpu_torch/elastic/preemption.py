"""Preemption notice channel shared by drills and production.

Real fleets are spot-/reclaim-heavy: the scheduler *announces* a host
reclaim with a grace window rather than SIGKILLing it cold. This module
defines the one notice channel every producer feeds and the driver
consumes — a journaled rendezvous KV scope (``scope='preempt'``) keyed by
hostname, carrying a small JSON payload:

    {"grace": <seconds>, "ts": <unix time the notice was recorded>}

Producers:

* the ``preempt`` fault kind (``worker.step:preempt:step=N:grace=S``) —
  the departing worker PUTs its own notice via
  :meth:`WorkerNotificationManager.send_preemption_notice` (the drill
  path);
* an external agent — ``curl -X PUT http://<coordinator>/preempt/<host>``
  with the JSON body — since the KV server runs scope PUT handlers for
  HTTP requests and in-process puts alike;
* a :class:`HostDiscovery` subclass overriding ``find_preempted_hosts``,
  polled by the driver's discovery thread (the cloud-metadata path).

All three converge on ``ElasticDriver.record_preemption_notice``; the
scope is journaled (not ephemeral) so a coordinator restart re-seeds
in-flight drains from the replayed store.
"""

import json
import time
from typing import Optional, Tuple

#: rendezvous KV scope carrying preemption notices (journaled — a
#: coordinator restart must not forget an in-flight drain)
PREEMPT_SCOPE = "preempt"


def encode_notice(grace: float, ts: Optional[float] = None) -> bytes:
    """Serialize a notice payload for the ``preempt`` scope."""
    return json.dumps(
        {"grace": float(grace),
         "ts": float(ts) if ts is not None else time.time()}).encode()


def decode_notice(value: Optional[bytes]) -> Tuple[float, float]:
    """``(grace_seconds, notice_ts)`` from a scope value; tolerant of
    hand-fed payloads (bare number, empty or missing body) so an
    operator's quick ``curl`` still parses."""
    try:
        obj = json.loads((value or b"").decode() or "{}")
    except (ValueError, UnicodeDecodeError):
        return 0.0, time.time()
    if isinstance(obj, (int, float)):
        return float(obj), time.time()
    if not isinstance(obj, dict):
        return 0.0, time.time()
    try:
        grace = float(obj.get("grace", 0.0))
    except (TypeError, ValueError):
        grace = 0.0
    try:
        ts = float(obj.get("ts", time.time()))
    except (TypeError, ValueError):
        ts = time.time()
    return grace, ts
