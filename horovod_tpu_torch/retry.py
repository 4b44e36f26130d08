"""Shared transient-fault retry policy: capped exponential backoff with
full jitter and an overall deadline (a copy of ``horovod_tpu/retry.py``).

The reference tolerates coordinator blips only in ``HTTPStore::wait``
(common/gloo/http_store.cc retries inside its poll loop); every other
host-plane call dies on the first socket error. Here the policy is a
first-class object applied uniformly to the KV rendezvous client
(runner/rendezvous.py) and elastic worker registration
(elastic/worker.py), so a congested coordinator or a dropped SYN is a
retry, not a dead job.

Shape (AWS "full jitter"): retry ``k`` (1-based) sleeps
``uniform(0, min(max_backoff, initial_backoff * 2**(k-1)))``, stopping at
``max_attempts`` total attempts or when the per-call ``deadline`` would
be exceeded — whichever comes first. Knobs::

    HVD_TPU_RETRY_MAX_ATTEMPTS     total attempts, default 5
    HVD_TPU_RETRY_INITIAL_BACKOFF  seconds, default 0.05
    HVD_TPU_RETRY_MAX_BACKOFF      seconds, default 2.0
    HVD_TPU_RETRY_DEADLINE         seconds per call, default 60

Observability: every retry bumps ``hvd_tpu_retry_attempts_total{site}``;
a call that gives up bumps ``hvd_tpu_retry_exhausted_total`` — a climbing
exhausted count is the operator signal that the fabric is sicker than the
policy can hide.

Determinism note: when ``HVD_TPU_FAULT_SEED`` drives a chaos run, jitter
timing still varies — only *which* faults fire is seeded. Outcomes stay
deterministic because retry decisions depend on exception class, not
timing.
"""

import http.client
import random
import socket
import time
from typing import Callable, Optional
from urllib.error import HTTPError, URLError

from . import config as _config
from . import metrics as _metrics

_M_ATTEMPTS = _metrics.counter(
    "hvd_tpu_retry_attempts_total",
    "Retries of transient host-plane failures, by site.", labels=("site",))
_M_EXHAUSTED = _metrics.counter(
    "hvd_tpu_retry_exhausted_total",
    "Calls whose transient failures outlasted the retry policy "
    "(max attempts or deadline) and were surfaced to the caller.")


def is_transient(exc: BaseException) -> bool:
    """Classify an exception as transient (retry) vs fatal (surface now).

    Transient: connection-shaped failures — refused/reset sockets,
    timeouts, URL-layer errors, malformed/truncated HTTP exchanges, and
    5xx server responses. Fatal: HTTP 4xx (the request itself is wrong)
    and everything else (programming errors, validation failures, data
    plane errors — retrying those cannot help and, on the SPMD path,
    could desynchronize ranks).
    """
    if isinstance(exc, HTTPError):       # URLError subclass: check first
        return exc.code >= 500
    if isinstance(exc, (ConnectionError, TimeoutError, URLError,
                        socket.timeout, http.client.HTTPException)):
        return True
    return False


class RetryPolicy:
    """Immutable policy; ``call`` wraps one operation."""

    __slots__ = ("max_attempts", "initial_backoff", "max_backoff",
                 "deadline", "_sleep", "_rng")

    def __init__(self, max_attempts: int = 5, initial_backoff: float = 0.05,
                 max_backoff: float = 2.0, deadline: float = 60.0,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        self.max_attempts = max(1, int(max_attempts))
        self.initial_backoff = max(0.0, float(initial_backoff))
        self.max_backoff = max(0.0, float(max_backoff))
        self.deadline = float(deadline)
        self._sleep = sleep
        self._rng = rng or random.Random()

    @classmethod
    def from_config(cls, cfg: Optional[_config.Config] = None,
                    **overrides) -> "RetryPolicy":
        cfg = cfg or _config.Config()
        kwargs = dict(
            max_attempts=cfg.get(_config.RETRY_MAX_ATTEMPTS),
            initial_backoff=cfg.get(_config.RETRY_INITIAL_BACKOFF),
            max_backoff=cfg.get(_config.RETRY_MAX_BACKOFF),
            deadline=cfg.get(_config.RETRY_DEADLINE))
        kwargs.update(overrides)
        return cls(**kwargs)

    def backoff(self, attempt: int) -> float:
        """Full-jitter sleep before retry number ``attempt`` (1-based)."""
        cap = min(self.max_backoff,
                  self.initial_backoff * (2.0 ** (attempt - 1)))
        return self._rng.uniform(0.0, cap)

    def call(self, fn: Callable, site: str,
             classify: Callable[[BaseException], bool] = is_transient):
        """Invoke ``fn()`` with retries. Fatal errors and the final
        transient error propagate unchanged (callers keep their existing
        exception surface; the elastic layer maps them to
        HorovodInternalError where recovery applies)."""
        start = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 — classified below
                attempt += 1
                if not classify(e):
                    raise
                if attempt >= self.max_attempts:
                    _M_EXHAUSTED.inc()
                    raise
                delay = self.backoff(attempt)
                if time.monotonic() - start + delay > self.deadline:
                    _M_EXHAUSTED.inc()
                    raise
                _M_ATTEMPTS.labels(site=site).inc()
                import logging
                logging.getLogger("horovod_tpu_torch.retry").info(
                    "transient failure at %s (attempt %d/%d, retrying in "
                    "%.3fs): %s", site, attempt, self.max_attempts, delay, e)
                self._sleep(delay)
