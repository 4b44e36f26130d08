"""Response cache: skip re-validating steady-state submissions
(counterpart of ``horovod_tpu/response_cache.py``, its pure-Python LRU).

A hit means this (process set, fingerprint) pair was already validated
identically on every process, so the consistency exchange is skipped.
Every process runs the same deterministic LRU with the same capacity and
inserts a key only after a successful cross-process validation, so the
caches never diverge on the hit path. Capacity comes from
``HVD_TPU_CACHE_CAPACITY`` (alias ``HOROVOD_CACHE_CAPACITY``, default
1024; 0 disables caching).
"""

import collections
import threading
from typing import Optional


class ResponseCache:
    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()

    def lookup(self, key: int) -> bool:
        """True when ``key`` was validated before (refreshes LRU order)."""
        if self.capacity <= 0:
            return False
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                return True
        return False

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
        return victim

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)
