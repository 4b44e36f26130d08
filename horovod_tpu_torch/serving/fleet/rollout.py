"""Rolling hot-reload across the fleet: one drained replica at a time
(a copy of ``horovod_tpu/serving/fleet/rollout.py``).

A single replica already hot-reloads without downtime
(:meth:`~horovod_tpu_torch.serving.engine.InferenceEngine.reload` swaps
params atomically under in-flight traffic). Fleet-wide, the dangerous
part is *coordination*: reloading every replica at once turns a
checkpoint push into an outage, and reloading a replica that still has
requests in flight risks answering them off a half-swapped serving
plane. :func:`rolling_reload` makes the swap boring:

1. mark one replica **draining** — the router stops sending it new
   requests (``hvd_tpu_fleet_outstanding{replica}`` is the evidence);
2. wait for its outstanding count to reach **0** (in-flight requests
   complete normally), bounded by
   ``HVD_TPU_FLEET_DRAIN_DEADLINE_SECONDS`` — extended, for a replica
   holding long-lived generation streams, to the streams' own
   end-to-end budgets (``FleetRouter.stream_drain_extension``): the
   budget sheds them server-side, so the drain still terminates;
3. ``POST /v1/reload`` on the replica and verify ``GET /healthz``
   answers (and reports the expected step, when one was requested);
4. re-admit it, then move to the next replica — at most one replica is
   ever out of rotation, so capacity never drops by more than one.

Fail-static: if a drain never completes (chaos site ``fleet.drain``
simulates exactly this wedge) or a swap/health check fails, the rollout
**aborts** — the replica is re-admitted un-swapped and
:class:`RolloutAborted` is raised with the fleet still serving. A
partially-rolled fleet is a retryable state; a fleet that lost capacity
to a stuck rollout is not. Outcomes are counted in
``hvd_tpu_fleet_rollouts_total{result}``.
"""

import json
import logging
import time
import urllib.request
from typing import Optional

from ... import config as _config
from ... import faults as _faults
from ... import metrics as _metrics

log = logging.getLogger("horovod_tpu_torch.fleet")

#: drain wedge simulation: while injected, the rollout never observes
#: the draining replica as idle, so the drain deadline is what saves it
_FP_DRAIN = _faults.FaultPoint("fleet.drain")

#: slack added on top of a draining stream's remaining budget: the
#: server sheds the stream AT the budget, but delivering the shed
#: (finishing the in-flight decode step, flushing the terminal record,
#: the router's bookkeeping) takes a beat more — without it the drain
#: would abort at the exact instant the stream is being released
_SHED_GRACE_S = 1.0

_M_ROLLOUTS = _metrics.counter(
    "hvd_tpu_fleet_rollouts_total",
    "Fleet-wide rolling hot-reloads by outcome: ok (every replica "
    "drained, swapped, verified) or aborted (a drain deadline expired "
    "or a swap/health check failed; the replica was re-admitted "
    "un-swapped and the fleet kept serving).",
    labels=("result",))


class RolloutAborted(RuntimeError):
    """The rolling reload stopped early; the fleet is intact but one or
    more replicas still serve the old checkpoint."""


def _post_reload(base_url: str, step: Optional[int],
                 timeout: float) -> dict:
    body = json.dumps({} if step is None else {"step": int(step)})
    req = urllib.request.Request(
        base_url + "/v1/reload", data=body.encode("utf-8"), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _verify_healthy(base_url: str, step: Optional[int],
                    timeout: float) -> None:
    with urllib.request.urlopen(base_url + "/healthz",
                                timeout=timeout) as resp:
        doc = json.loads(resp.read())
    if step is not None and int(doc.get("step", -1)) != int(step):
        raise RuntimeError(
            f"replica healthy but serving step {doc.get('step')}, "
            f"expected {step}")


def rolling_reload(router, step: Optional[int] = None,
                   drain_deadline: Optional[float] = None,
                   poll: float = 0.01,
                   request_timeout: float = 10.0) -> dict:
    """Reload every replica behind ``router``, one drained replica at a
    time (see module docstring). Returns a summary dict
    ``{"result": "ok", "replicas": [...], "step": ...}``; raises
    :class:`RolloutAborted` (after re-admitting the wedged replica) on
    any drain timeout or swap failure."""
    if drain_deadline is None:
        drain_deadline = float(_config.live_config().get(
            _config.FLEET_DRAIN_DEADLINE_SECONDS))
    swapped = []
    for replica_id in router.replica_ids():
        router.set_draining(replica_id, True)
        log.info("fleet: rollout draining replica %s (outstanding=%d)",
                 replica_id, router.outstanding(replica_id))
        deadline_ts = time.monotonic() + max(0.0, drain_deadline)
        drained = False
        while True:
            now = time.monotonic()
            if now >= deadline_ts:
                # a long-lived generation stream may legitimately hold
                # the replica past the configured drain bound — but only
                # as long as its own end-to-end budget: the budget sheds
                # it server-side, outstanding hits 0, and the rollout
                # proceeds. A budget-less stream gets no extension (it
                # could hold the drain forever).
                extension = getattr(router, "stream_drain_extension",
                                    lambda _rid: 0.0)(replica_id)
                if extension <= 0:
                    break
                deadline_ts = now + extension + _SHED_GRACE_S
            if _FP_DRAIN.check():
                # injected wedge: in-flight work "never" finishes; keep
                # waiting so the deadline (not the fault) decides
                pass
            elif router.outstanding(replica_id) == 0:
                drained = True
                break
            time.sleep(poll)
        if not drained:
            router.set_draining(replica_id, False)
            _M_ROLLOUTS.labels(result="aborted").inc()
            log.warning(
                "fleet: rollout aborted — replica %s did not drain within "
                "%.1fs (outstanding=%d); re-admitted un-swapped",
                replica_id, drain_deadline, router.outstanding(replica_id))
            raise RolloutAborted(
                f"replica {replica_id} did not drain within "
                f"{drain_deadline:.1f}s; rollout aborted "
                f"(already swapped: {swapped or 'none'})")
        try:
            doc = _post_reload(router.replica_url(replica_id), step,
                               request_timeout)
            _verify_healthy(router.replica_url(replica_id), step,
                            request_timeout)
        except Exception as e:  # noqa: BLE001 — any swap failure aborts
            router.set_draining(replica_id, False)
            _M_ROLLOUTS.labels(result="aborted").inc()
            log.warning("fleet: rollout aborted — replica %s swap/verify "
                        "failed (%s); re-admitted un-swapped",
                        replica_id, e)
            raise RolloutAborted(
                f"replica {replica_id} reload failed: {e} "
                f"(already swapped: {swapped or 'none'})") from e
        router.set_draining(replica_id, False)
        swapped.append(replica_id)
        log.info("fleet: rollout swapped replica %s to step %s",
                 replica_id, doc.get("step"))
    _M_ROLLOUTS.labels(result="ok").inc()
    return {"result": "ok", "replicas": swapped, "step": step}
