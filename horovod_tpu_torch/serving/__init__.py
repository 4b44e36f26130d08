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

The generation plane (paged KV cache, continuous batching, the
generation routes), the fleet router and disaggregated serving are not
ported yet (ROADMAP A6).
"""

from .batcher import (BucketedForward, DeadlineExceededError,  # noqa: F401
                      MicroBatcher, QueueFullError, RejectedError,
                      bucket_for, parse_buckets)
from .engine import (InferenceEngine, ParamsLifecycle,  # noqa: F401
                     ReloadCrashed, wait_for_step)
from .server import InferenceServer                               # noqa: F401
