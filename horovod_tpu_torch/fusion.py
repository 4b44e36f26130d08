"""Gradient bucketing ("tensor fusion"), counterpart of the eager planner
of ``horovod_tpu/fusion.py``.

Buckets are formed greedily from traversal order, so every process builds
identical buckets without negotiation. This is the pure-Python planner;
the JAX package's native planner (``_native/``) computes the same plan.
"""

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def plan_buckets(shapes_dtypes: Sequence[Tuple[tuple, Any]],
                 threshold_bytes: int) -> List[List[int]]:
    """Greedy in-order bucketing: consecutive tensors share a bucket until
    adding the next would exceed ``threshold_bytes`` (mirrors
    FuseResponses' size cap, controller.cc:640-761). ``dtype`` may be a
    torch or a numpy dtype.

    threshold_bytes <= 0 disables fusion (one bucket per tensor), matching
    HOROVOD_FUSION_THRESHOLD=0 semantics."""
    sizes = [int(np.prod(shape, dtype=np.int64)) * _itemsize(dtype)
             for shape, dtype in shapes_dtypes]
    if threshold_bytes <= 0:
        return [[i] for i in range(len(sizes))]
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, nbytes in enumerate(sizes):
        if cur and cur_bytes + nbytes > threshold_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def bucketed_apply(values: List[torch.Tensor], threshold_bytes: int,
                   fused_fn: Callable[[List, List[str]], List],
                   names: Optional[List[str]] = None) -> List:
    """Apply ``fused_fn(bucket_values, bucket_names) -> bucket_results`` per
    bucket and reassemble results in input order."""
    buckets = plan_buckets([(tuple(v.shape), v.dtype) for v in values],
                           threshold_bytes)
    if names is None:
        names = [f"tensor.{i}" for i in range(len(values))]
    out: List = [None] * len(values)
    for b in buckets:
        results = fused_fn([values[i] for i in b], [names[i] for i in b])
        for i, r in zip(b, results):
            out[i] = r
    return out
