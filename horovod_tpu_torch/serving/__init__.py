"""The serving plane of horovod_tpu_torch (counterpart of
``horovod_tpu/serving``), its fixed-shape inference half:

* :mod:`.batcher`: bounded admission queue and dynamic micro-batcher
  that coalesces concurrent requests into static-shape-bucketed forwards
  (also the buckets behind ``Estimator.predict``);
* :mod:`.engine`: :class:`InferenceEngine`, params restored from a
  checkpoint (the port's or the JAX package's) onto the card and
  hot-reloaded from newer committed steps with one reference swap;
* :mod:`.server`: :class:`InferenceServer`, the HTTP front-end (``POST
  /v1/infer``, ``POST /v1/reload``, ``GET /healthz``) where admission
  control degrades overload to fast 429/503 backpressure.

Quick start::

    import horovod_tpu_torch.serving as serving

    engine = serving.InferenceEngine(
        lambda params, x: torch.func.functional_call(model, params, (x,)),
        checkpoint_dir="/ckpts/run1", example=np.zeros((8,), np.float32))
    with serving.InferenceServer(engine, port=8500):
        ...   # POST /v1/infer {"inputs": [[...], ...]}

Its generation half:

* :mod:`.generation`: :class:`GenerationEngine`, continuous batching
  over a paged KV cache with on-device sampling, speculative and beam
  decode, behind the same server (``InferenceServer(engine=None,
  gen_engine=...)``: ``/v1/generate``, ``/v1/generate/stream``,
  ``/v1/cancel``);
* :mod:`.disagg`: the KV-block wire and the decode side's pull
  (``/v1/kv/offer``, ``/v1/kv/fetch``), for prefill and decode
  replicas.

And the tier above the replicas:

* :mod:`.fleet`: :class:`~.fleet.FleetRouter`, health-aware balancing
  over N replica servers with per-tenant admission, hedging, mid-stream
  failover and the pooled prefill/decode hop, and
  :func:`~.fleet.rolling_reload`.
"""

from .batcher import (BucketedForward, DeadlineExceededError,  # noqa: F401
                      MicroBatcher, QueueFullError, RejectedError,
                      bucket_for, parse_buckets)
from .engine import (InferenceEngine, ParamsLifecycle,  # noqa: F401
                     ReloadCrashed, wait_for_step)
from .generation import GenerationEngine                          # noqa: F401
from .server import InferenceServer                               # noqa: F401
from . import fleet                                               # noqa: F401
