"""``ResponseCache.erase`` and ``clear`` of the port
(horovod_tpu_torch/response_cache.py) against the JAX package's
(horovod_tpu/response_cache.py:110-124): one seeded sequence of lookup,
put, erase, clear and len through both packages' caches, on the native
LRU and on the pure-Python one (``HVD_TPU_NATIVE=0``: the module's
``_native_get`` answers None). Every answer (hits, victims, lengths) and
the hit, miss and eviction counters' movements must be equal."""

import numpy as np
import pytest

from horovod_tpu import metrics as jmetrics
from horovod_tpu import response_cache as jrc
from horovod_tpu._native import get as jnative_get
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import response_cache as trc
from horovod_tpu_torch._native import get as tnative_get

COUNTERS = ("hvd_tpu_response_cache_hits_total",
            "hvd_tpu_response_cache_misses_total",
            "hvd_tpu_response_cache_evictions_total")


def _ops(seed, n=600):
    """Mostly lookups and puts over 24 keys (some with high bits set), an
    erase one time in six and a clear one time in sixty."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        r = rng.randint(60)
        op = ("clear" if r == 0 else "erase" if r < 10 else "len" if r < 20
              else "lookup" if r < 40 else "put")
        out.append((op, int(rng.randint(0, 24))
                    | (int(rng.randint(0, 4)) << 62)))
    return out


def _run(cache, ops):
    out = []
    for op, key in ops:
        if op == "len":
            out.append(len(cache))
        elif op == "clear":
            out.append(cache.clear())
        else:
            out.append(getattr(cache, op)(key))
    return out


def _counters(snapshot):
    return {k: snapshot()[k] for k in COUNTERS}


@pytest.mark.parametrize("capacity", [0, 1, 4, 16])
@pytest.mark.parametrize("path", ["native", "python"])
def test_erase_and_clear_match_jax(path, capacity, monkeypatch):
    if path == "python":
        monkeypatch.setattr(trc, "_native_get", lambda: None)
        monkeypatch.setattr(jrc, "_native_get", lambda: None)
    elif tnative_get() is None or jnative_get() is None:
        pytest.skip("no C++ compiler: neither native runtime builds")
    ops = _ops(100 + capacity)
    port, jax_cache = trc.ResponseCache(capacity), jrc.ResponseCache(capacity)
    assert (port._h is not None) == (path == "native")
    tb, jb = _counters(tmetrics.snapshot), _counters(jmetrics.snapshot)
    got = _run(port, ops)
    ta = _counters(tmetrics.snapshot)
    want = _run(jax_cache, ops)
    ja = _counters(jmetrics.snapshot)
    assert got == want
    assert {k: ta[k] - tb[k] for k in COUNTERS} \
        == {k: ja[k] - jb[k] for k in COUNTERS}
    if capacity == 4:
        # the sequence evicts, erases a present key and clears a full cache
        lens = [v for (op, _), v in zip(ops, got) if op == "len"]
        assert max(lens) == 4 and 0 in lens
        assert any(v is not None for (op, _), v in zip(ops, got)
                   if op == "put")


@pytest.mark.parametrize("path", ["native", "python"])
def test_erase_makes_the_next_lookup_miss_and_clear_empties(path,
                                                            monkeypatch):
    if path == "python":
        monkeypatch.setattr(trc, "_native_get", lambda: None)
    elif tnative_get() is None:
        pytest.skip("no C++ compiler: the native runtime does not build")
    cache = trc.ResponseCache(8)
    for key in (1, 2, 3, 1 << 63):
        cache.put(key)
    cache.erase(2)
    cache.erase(99)          # an absent key is no error
    assert len(cache) == 3
    assert not cache.lookup(2) and cache.lookup(1) and cache.lookup(1 << 63)
    cache.clear()
    assert len(cache) == 0 and not cache.lookup(1)
    assert cache.put(5) is None and len(cache) == 1
