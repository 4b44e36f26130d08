"""The serving fleet: a router tier over N replica servers (the port's
copy of ``horovod_tpu/serving/fleet``: the same routes, headers, knobs,
metrics and fault sites, so one router fronts replicas of either
package).

One :class:`~horovod_tpu_torch.serving.server.InferenceServer` is a demo; a
service is N of them behind something that knows which ones are alive.
This package is that something:

* :mod:`.router` — :class:`FleetRouter`: least-outstanding balancing
  over routable replicas, replica liveness from heartbeats (the elastic
  layer reused with replica-id keys) plus passive circuit breakers with
  half-open probes, ``X-HVD-TPU-Request-Id`` propagation, and
  :class:`ReplicaHeartbeat` for the replica side;
* :mod:`.tenancy` — per-tenant admission in front of dispatch:
  API-key/header resolution, quota (a flooding tenant gets its own
  429s), priority classes, weighted fair dequeue;
* :mod:`.rollout` — :func:`rolling_reload`: fleet-wide checkpoint
  swaps one drained replica at a time, aborting fail-static on a
  wedged drain.

Quick start (replicas are ordinary ``InferenceServer``\\ s)::

    from horovod_tpu_torch.serving import fleet

    router = fleet.FleetRouter({"r0": f"http://127.0.0.1:{p0}",
                                "r1": f"http://127.0.0.1:{p1}"})
    with router:
        beat = fleet.ReplicaHeartbeat(router.url, "r0")
        beat.start()                    # r0 arms and stays routable
        ...                             # POST router.url + /v1/infer
        fleet.rolling_reload(router)    # zero-downtime checkpoint push

The replicas are the port's servers: ``/v1/infer`` answers from an
:class:`~horovod_tpu_torch.serving.engine.InferenceEngine`, the
generation and KV routes from a
:class:`~horovod_tpu_torch.serving.generation.GenerationEngine`.
"""

from .router import (FleetRouter, ReplicaHeartbeat,       # noqa: F401
                     REQUEST_ID_HEADER)
from .tenancy import (FairScheduler, Tenant,              # noqa: F401
                      TenantQuotaError, TenantRegistry,
                      API_KEY_HEADER, TENANT_HEADER)
from .rollout import RolloutAborted, rolling_reload       # noqa: F401
