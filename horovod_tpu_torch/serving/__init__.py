"""The serving plane of horovod_tpu_torch (counterpart of
``horovod_tpu/serving``): only the shape buckets of ``batcher.py`` so far,
which ``Estimator.predict`` runs through. The engine, the micro-batcher,
the HTTP server and the generation plane wait (ROADMAP A6)."""
