"""Response cache: skip re-validating steady-state submissions
(counterpart of ``horovod_tpu/response_cache.py``).

A hit means this (process set, fingerprint) pair was already validated
identically on every process, so the consistency exchange is skipped.
Every process runs the same deterministic LRU with the same capacity and
inserts a key only after a successful cross-process validation, so the
caches never diverge on the hit path. Capacity comes from
``HVD_TPU_CACHE_CAPACITY`` (alias ``HOROVOD_CACHE_CAPACITY``, default
1024; 0 disables caching). Hits, misses and evictions are counted in the
JAX package's metric families. The LRU is the native one
(``_native/csrc/cache.cc``) when the library loads, with an OrderedDict
under ``HVD_TPU_NATIVE=0``; both give the same hits, misses and victims.
"""

import collections
import ctypes
import threading
from typing import Optional

from . import metrics as _metrics
from ._native import get as _native_get

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
        self._nat = _native_get()
        self._h = None
        if self._nat is not None:
            self._h = self._nat.cdll.hvd_cache_create(self.capacity)
        self._lock = threading.Lock()
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()

    def __del__(self):
        # the one place the native LRU is freed (see TensorTable.__del__)
        h, self._h = getattr(self, "_h", None), None
        if h:
            try:
                self._nat.cdll.hvd_cache_destroy(h)
            except Exception:
                pass

    def lookup(self, key: int) -> bool:
        """True when ``key`` was validated before (refreshes LRU order)."""
        if self.capacity <= 0:
            _M_MISSES.inc()  # disabled cache: every check re-exchanges
            return False
        if self._h is not None:
            hit = bool(self._nat.cdll.hvd_cache_lookup(self._h, key))
            (_M_HITS if hit else _M_MISSES).inc()
            return hit
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
        if self._h is not None:
            evicted = ctypes.c_uint64(0)
            if self._nat.cdll.hvd_cache_put(self._h, key,
                                            ctypes.byref(evicted)):
                _M_EVICTIONS.inc()
                return int(evicted.value)
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

    def erase(self, key: int) -> None:
        """Invalidate one entry (reference: stalled tensors are
        invalidated, stall_inspector.cc:31-60); its next submission
        re-validates."""
        if self._h is not None:
            self._nat.cdll.hvd_cache_erase(self._h, key)
            return
        with self._lock:
            self._lru.pop(key, None)

    def clear(self) -> None:
        """Drop every entry."""
        if self._h is not None:
            self._nat.cdll.hvd_cache_clear(self._h)
            return
        with self._lock:
            self._lru.clear()

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._nat.cdll.hvd_cache_size(self._h))
        with self._lock:
            return len(self._lru)
