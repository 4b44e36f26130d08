"""Opt-in runtime lock-order sentinel (a copy of ``horovod_tpu/_locks.py``:
the port imports nothing of the JAX package).

The static ``lock-order`` checker (``tools/analyze``) proves the
*declared* acquisition graph acyclic, but it cannot see dynamic dispatch
(callbacks, metric cells, handler threads). This module closes that gap
at runtime: with ``HVD_TPU_LOCK_CHECK=1`` every lock created through
:func:`lock` is wrapped in a :class:`_CheckedLock` that

* records, per thread, the stack of checked locks currently held;
* on each acquisition of ``B`` while holding ``A``, registers the
  global ordering edge ``A -> B`` (keyed by lock *name*, so every
  instance of a class contributes to one discipline);
* raises :class:`LockOrderError` **before blocking** when the reverse
  edge ``B -> A`` was ever observed anywhere in the process — the
  interleaving that, under the right timing, is a deadlock;
* raises :class:`LockOrderError` when a thread re-acquires the exact
  lock instance it already holds (a guaranteed self-deadlock for a
  non-reentrant lock).

With the knob off (the default) :func:`lock` returns a plain
``threading.Lock`` — zero overhead, nothing recorded. The port's stall
inspector creates its lock through this factory, and
``tests/conftest.py`` turns the sentinel on for the whole suite, so an
ordering regression fails a test instead of deadlocking a job.
"""

import threading
from typing import Dict, Optional, Tuple

__all__ = ["lock", "LockOrderError", "enabled", "reset", "order_edges"]


class LockOrderError(RuntimeError):
    """Two checked locks were acquired in both orders (potential
    deadlock), or a thread re-acquired a lock instance it already holds."""


#: enabled-state cache: None = not yet resolved from the knob registry
_ENABLED: Optional[bool] = None

#: held-lock stack per thread: list of (name, id(instance))
_HELD = threading.local()

#: observed ordering edges: (held_name, acquired_name) -> provenance
#: string recorded at first observation. Guarded by _GRAPH_LOCK (a plain
#: lock — the sentinel must not instrument itself).
_EDGES: Dict[Tuple[str, str], str] = {}
_GRAPH_LOCK = threading.Lock()


def enabled() -> bool:
    """Whether the sentinel is active (``HVD_TPU_LOCK_CHECK``)."""
    global _ENABLED
    if _ENABLED is None:
        from . import config as _config
        _ENABLED = bool(_config.Config().get(_config.LOCK_CHECK))
    return _ENABLED


def reset() -> None:
    """Drop every recorded edge and re-read the knob (tests only)."""
    global _ENABLED
    with _GRAPH_LOCK:
        _EDGES.clear()
    _ENABLED = None


def order_edges() -> Dict[Tuple[str, str], str]:
    """Snapshot of the observed acquisition-order graph (introspection)."""
    with _GRAPH_LOCK:
        return dict(_EDGES)


def _stack():
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


class _CheckedLock:
    """A ``threading.Lock`` that reports into the ordering sentinel."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Lock()

    def _check_and_record(self) -> None:
        stack = _stack()
        me = id(self)
        for held_name, held_id in stack:
            if held_id == me:
                raise LockOrderError(
                    f"thread {threading.current_thread().name!r} "
                    f"re-acquired lock {self.name!r} it already holds "
                    f"(self-deadlock on a non-reentrant lock)")
        held_names = {n for n, _ in stack if n != self.name}
        if not held_names:
            return
        with _GRAPH_LOCK:
            for held in held_names:
                rev = _EDGES.get((self.name, held))
                if rev is not None:
                    raise LockOrderError(
                        f"lock-order violation: thread "
                        f"{threading.current_thread().name!r} acquires "
                        f"{self.name!r} while holding {held!r}, but the "
                        f"opposite order was observed earlier ({rev}) — "
                        f"this interleaving can deadlock")
            prov = (f"{held_names!r} -> {self.name!r} on thread "
                    f"{threading.current_thread().name!r}")
            for held in held_names:
                _EDGES.setdefault((held, self.name), prov)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_and_record()
        got = self._inner.acquire(blocking, timeout)
        if got:
            _stack().append((self.name, id(self)))
        return got

    def release(self) -> None:
        self._inner.release()
        stack = _stack()
        me = id(self)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][1] == me:
                del stack[i]
                break

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<_CheckedLock {self.name!r} at {id(self):#x}>"


def lock(name: str):
    """A lock participating in the ordering sentinel when
    ``HVD_TPU_LOCK_CHECK`` is on; a plain ``threading.Lock`` otherwise.

    ``name`` identifies the lock's *role* (conventionally
    ``<module>.<Class>.<attr>``); every instance created under one name
    shares one ordering discipline.
    """
    if enabled():
        return _CheckedLock(name)
    return threading.Lock()
