"""Gradient bucketing ("tensor fusion"), counterpart of
``horovod_tpu/fusion.py``.

Buckets are formed greedily from traversal order, so every process builds
identical buckets without negotiation. This is the pure-Python planner;
the JAX package's native planner (``_native/``) computes the same plan.

Two consumers share the planner, as in the JAX package: the eager
plane (:func:`bucketed_apply`, dtypes mixed in a bucket) and the
compiled-plane reduction's packed buffers (:func:`packed_plan`, one
dtype per flat buffer), whose plan is memoized on (shapes, dtypes,
threshold) and equals the JAX package's tuple for the same shapes and
dtype names.
"""

from functools import lru_cache
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .tensor_table import dtype_str


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None),
                                             torch.dtype):
        return getattr(torch, dtype).itemsize   # "bfloat16" too
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


@lru_cache(maxsize=512)
def _packed_plan_cached(shapes: tuple, dtypes: tuple,
                        threshold_bytes: int) -> tuple:
    by_dtype = {}
    for i, dt in enumerate(dtypes):
        by_dtype.setdefault(dt, []).append(i)
    plan = []
    for dt in sorted(by_dtype):
        idxs = by_dtype[dt]
        if threshold_bytes <= 0:
            # one unbounded flat buffer per dtype (the knob's semantics,
            # unlike the eager plane's "0 disables fusion")
            plan.append((dt, tuple(idxs)))
            continue
        metas = [(shapes[i], dt) for i in idxs]
        for b in plan_buckets(metas, threshold_bytes):
            plan.append((dt, tuple(idxs[j] for j in b)))
    return tuple(plan)


def packed_plan(shapes: Sequence[tuple], dtypes: Sequence[Any],
                threshold_bytes: int) -> tuple:
    """Bucket plan of the packed buffers: leaves grouped by dtype (a flat
    buffer has one dtype), the groups in sorted order of numpy's dtype
    name, each split by the greedy planner at ``threshold_bytes``
    (``HVD_TPU_INJIT_PACKED_THRESHOLD``; <= 0 packs each dtype into one
    unbounded buffer). ``dtypes`` may be torch dtypes or names.

    Returns ``((dtype_name, (leaf_index, ...)), ...)``, memoized on
    ``(shapes, dtypes, threshold)``."""
    return _packed_plan_cached(
        tuple(tuple(s) for s in shapes),
        tuple(dtype_str(d) for d in dtypes),
        int(threshold_bytes))


def packed_apply(leaves: Sequence[torch.Tensor], threshold_bytes: int,
                 reduce_bucket: Callable,
                 residuals: Optional[Sequence[torch.Tensor]] = None):
    """Group same-dtype ``leaves`` into :func:`packed_plan` buckets and call
    ``reduce_bucket(bucket_leaves, bucket_residuals) -> (out_leaves,
    new_residuals | None)`` once per bucket, in plan order. ``residuals``
    (optional, one per leaf: the int8 compressor's error feedback) ride
    the same buckets. Returns ``(out_leaves, new_residual_leaves)``; the
    residual list is all None when there are no residuals."""
    plan = packed_plan([tuple(l.shape) for l in leaves],
                       [l.dtype for l in leaves], threshold_bytes)
    out: List = [None] * len(leaves)
    new_res: List = [None] * len(leaves)
    for _dt, idxs in plan:
        vals = [leaves[i] for i in idxs]
        rvals = None if residuals is None else [residuals[i] for i in idxs]
        outs, nrs = reduce_bucket(vals, rvals)
        for j, i in enumerate(idxs):
            out[i] = outs[j]
            if nrs is not None:
                new_res[i] = nrs[j]
    return out, new_res


def flatten_bucket(vals: Sequence[torch.Tensor]):
    """One bucket's leaves as one flat 1-D buffer: ``(flat, unflatten)``,
    where ``unflatten(reduced_flat)`` splits it back into views of the
    leaves' shapes. For reducers that need one flat view of the bucket
    (the int8 per-bucket scale)."""
    shapes = [tuple(v.shape) for v in vals]
    if len(vals) == 1:
        return vals[0].reshape(-1), lambda r: [r.reshape(shapes[0])]
    flat = torch.cat([v.reshape(-1) for v in vals])
    sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]

    def unflatten(r):
        return [piece.view(s) for piece, s in
                zip(torch.split(r, sizes), shapes)]
    return flat, unflatten
