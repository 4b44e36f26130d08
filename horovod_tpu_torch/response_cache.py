"""Response cache: skip re-validating steady-state submissions
(counterpart of ``horovod_tpu/response_cache.py``, its pure-Python LRU).

A hit means this (process set, fingerprint) pair was already validated
identically on every process, so the consistency exchange is skipped.
Every process runs the same deterministic LRU with the same capacity and
inserts a key only after a successful cross-process validation, so the
caches never diverge on the hit path. Capacity comes from
``HVD_TPU_CACHE_CAPACITY`` (alias ``HOROVOD_CACHE_CAPACITY``, default
1024; 0 disables caching). Hits, misses and evictions are counted in the
JAX package's metric families.
"""

import collections
import threading
from typing import Optional

from . import metrics as _metrics

# Cache efficiency is the steady-state health signal of the collective
# path: a hit means the consistency exchange (a wire round-trip) was
# skipped; a miss storm on one rank shows in metrics_allgather_summary
# long before it shows as lost throughput.
_M_HITS = _metrics.counter(
    "hvd_tpu_response_cache_hits_total",
    "Response-cache hits (consistency exchange skipped).")
_M_MISSES = _metrics.counter(
    "hvd_tpu_response_cache_misses_total",
    "Response-cache misses (full cross-process exchange performed).")
_M_EVICTIONS = _metrics.counter(
    "hvd_tpu_response_cache_evictions_total",
    "Response-cache LRU evictions (capacity pressure; evicted "
    "fingerprints re-validate on next submission).")


class ResponseCache:
    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()

    def lookup(self, key: int) -> bool:
        """True when ``key`` was validated before (refreshes LRU order)."""
        if self.capacity <= 0:
            _M_MISSES.inc()  # disabled cache: every check re-exchanges
            return False
        with self._lock:
            hit = key in self._lru
            if hit:
                self._lru.move_to_end(key)
        (_M_HITS if hit else _M_MISSES).inc()
        return hit

    def put(self, key: int) -> Optional[int]:
        """Insert a validated key; returns the evicted key, if any."""
        if self.capacity <= 0:
            return None
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                return None
            victim = None
            if len(self._lru) >= self.capacity:
                victim, _ = self._lru.popitem(last=False)
            self._lru[key] = None
        if victim is not None:
            _M_EVICTIONS.inc()
        return victim

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)
