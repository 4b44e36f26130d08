"""Static shape buckets for inference (counterpart of the bucket half of
``horovod_tpu/serving/batcher.py``).

A batch of ``n`` rows is zero-padded to the smallest bucket that holds it
(:func:`horovod_tpu_torch.data.pad_to_size`), the forward runs at the
bucket's shape and the live rows are returned, so a handful of shapes
serve every size: the JAX package's compiled-program cache, and here the
shapes a CUDA graph or cuBLAS's per-shape choices are made for.

* :func:`parse_buckets`, :func:`bucket_for` and :func:`next_pow2` are the
  JAX package's, copied;
* :class:`BucketedForward` pads to the bucket, runs the forward under
  ``torch.no_grad()`` and records the buckets it has run
  (``compiled_buckets``); :meth:`~BucketedForward.warmup` runs each
  bucket once. It is the engine behind ``Estimator.predict``.

The micro-batcher (``MicroBatcher``, its admission errors and fault
sites) waits with the rest of the serving plane (ROADMAP A6).
"""

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _locks
from .. import data as _data


def parse_buckets(spec: str, max_batch: int) -> Tuple[int, ...]:
    """Bucket sizes from HVD_TPU_SERVING_BUCKETS (comma-separated rows),
    or powers of two up to ``max_batch`` when empty. ``max_batch`` is
    always a bucket: every admissible batch must have a home."""
    if spec and spec.strip():
        try:
            buckets = sorted({int(b) for b in spec.split(",") if b.strip()})
        except ValueError as e:
            raise ValueError(
                f"HVD_TPU_SERVING_BUCKETS={spec!r}: want comma-separated "
                f"integers") from e
        if not buckets or buckets[0] < 1:
            raise ValueError(
                f"HVD_TPU_SERVING_BUCKETS={spec!r}: buckets must be >= 1")
        if buckets[-1] > max_batch:
            raise ValueError(
                f"HVD_TPU_SERVING_BUCKETS={spec!r}: bucket "
                f"{buckets[-1]} exceeds HVD_TPU_SERVING_MAX_BATCH="
                f"{max_batch}; raise the max or drop the bucket")
    else:
        buckets, b = [], 1
        while b < max_batch:
            buckets.append(b)
            b *= 2
    if max_batch not in buckets:
        buckets.append(max_batch)
    return tuple(sorted(buckets))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding ``n`` rows."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} rows exceed the largest bucket {buckets[-1]}")


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class BucketedForward:
    """A forward ``fn(x)`` run at bucket shapes.

    ``buckets=None`` is open-ended powers of two (the ``Estimator.predict``
    mode). ``device`` is where padded inputs go (the model's device).
    ``compiled_buckets`` records the bucket shapes this instance has run.
    """

    def __init__(self, fn: Callable, buckets: Optional[Sequence[int]] = None,
                 device=None):
        self._fn = fn
        self._buckets = tuple(sorted(buckets)) if buckets else None
        self._device = torch.device(device) if device is not None else None
        self._lock = _locks.lock("serving.BucketedForward._lock")
        self.compiled_buckets: set = set()

    def bucket(self, n: int) -> int:
        if self._buckets is not None:
            return bucket_for(n, self._buckets)
        return next_pow2(n)

    def __call__(self, x) -> torch.Tensor:
        """Apply to an already-padded ``x`` (leading dim = some bucket)."""
        x = torch.as_tensor(x)
        if self._device is not None:
            x = x.to(self._device)
        with self._lock:
            self.compiled_buckets.add(int(x.shape[0]))
        with torch.no_grad():
            return self._fn(x)

    def apply_padded(self, x) -> torch.Tensor:
        """Pad ``x`` to its bucket, apply, return the live rows only."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        n = len(x)
        padded, _mask = _data.pad_to_size(x, self.bucket(n))
        return self(padded)[:n]

    def warmup(self, row_shape: Sequence[int], dtype=np.float32,
               buckets: Optional[Sequence[int]] = None) -> None:
        """Run every bucket once with zero inputs, so no live request
        pays a first call's costs. ``row_shape`` is one row (no batch
        dim)."""
        for b in (buckets or self._buckets or ()):
            self(np.zeros((b, *row_shape), dtype=dtype))
