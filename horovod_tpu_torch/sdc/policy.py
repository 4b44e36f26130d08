"""SDC reaction policy: skip, roll back, quarantine (a copy of
``horovod_tpu/sdc/policy.py``).

One detection is noise; a pattern is a broken chip. The policy turns
the guard/fingerprint detections into the three escalating reactions
the defense plane promises (docs/robustness.md):

1. **skip** — a lone guard trip drops the poisoned update (the step is
   retried once by the training loop, then the batch is dropped);
2. **rollback** — a second trip inside the window, or any fingerprint
   divergence (parameters already poisoned — skipping future updates
   cannot unpoison them), restores the last *good* checkpoint;
3. **quarantine** — ``HVD_TPU_SDC_STRIKES`` locally-attributed
   detections inside the window report this host to the elastic driver
   (``send_sdc_report`` -> journaled ``sdc`` scope ->
   ``ElasticDriver.record_sdc_report`` -> ``blacklist_host``).

*Good* is earned, not assumed: a checkpointed step becomes the rollback
target only after the guard has passed ``HVD_TPU_SDC_CONFIRM_STEPS``
subsequent steps — an undetected corruption written to disk never gets
promoted under itself.
"""

import collections
import logging
from typing import Callable, List, Optional

from .. import config as _config
from .. import metrics as _metrics
from .guard import Detection

log = logging.getLogger("horovod_tpu.sdc")

_M_ROLLBACKS = _metrics.counter(
    "hvd_tpu_sdc_rollbacks_total",
    "Automatic rollbacks to the last-good checkpoint triggered by the "
    "SDC policy (repeated guard trips or a fingerprint divergence).")
_M_LAST_GOOD = _metrics.gauge(
    "hvd_tpu_sdc_last_good_step",
    "Newest checkpoint step promoted to 'good' — it survived "
    "HVD_TPU_SDC_CONFIRM_STEPS subsequent guarded steps and is the "
    "current SDC rollback target.")

#: guarded steps a detection stays relevant: trips further apart than
#: this are treated as independent blips, not a pattern
WINDOW_STEPS = 100

#: trips inside the window before skipping escalates to rollback
ROLLBACK_TRIPS = 2

SKIP = "skip"
ROLLBACK = "rollback"


def _default_report(kind: str, strikes: int) -> bool:
    from ..elastic.worker import notification_manager
    return notification_manager.send_sdc_report(kind, strikes=strikes)


class SdcPolicy:
    """Per-process reaction policy; drive it from the training loop:

    * ``on_saved(step)`` after every checkpoint save;
    * ``on_clean_step()`` after every guarded step that passed — returns
      a step to promote to last-good (or None);
    * ``on_detection(det)`` on every :class:`Detection` — returns
      ``SKIP`` or ``ROLLBACK``;
    * ``on_rollback()`` after the loop actually restored — counts the
      metric and resets the trip window (the restored state is clean).
    """

    def __init__(self, confirm_steps: Optional[int] = None,
                 strikes: Optional[int] = None,
                 report: Optional[Callable[[str, int], bool]] = None):
        cfg = _config.live_config()
        self.confirm_steps = int(cfg.get(_config.SDC_CONFIRM_STEPS)) \
            if confirm_steps is None else int(confirm_steps)
        self.strikes = int(cfg.get(_config.SDC_STRIKES)) \
            if strikes is None else int(strikes)
        self._report = report if report is not None else _default_report
        self._step = 0
        #: [step_saved_at, clean_steps_since] per unpromoted checkpoint
        self._pending: List[List[int]] = []
        self._trips: "collections.deque" = collections.deque()
        self._local_strikes: "collections.deque" = collections.deque()
        self._reported = False
        self.last_good: Optional[int] = None

    # -- promotion -----------------------------------------------------------
    def on_saved(self, step: int) -> None:
        self._pending.append([int(step), 0])

    def on_clean_step(self) -> Optional[int]:
        self._step += 1
        promoted = None
        for entry in self._pending:
            entry[1] += 1
        while self._pending and self._pending[0][1] >= self.confirm_steps:
            promoted = self._pending.pop(0)[0]
        if promoted is not None:
            self.last_good = promoted
            _M_LAST_GOOD.set(promoted)
            log.info("sdc: step %d promoted to last-good (%d clean "
                     "steps since)", promoted, self.confirm_steps)
        return promoted

    # -- reaction ------------------------------------------------------------
    def on_detection(self, det: Detection) -> str:
        self._step += 1
        self._trips.append(self._step)
        self._prune(self._trips)
        if det.local:
            self._local_strikes.append(self._step)
            self._prune(self._local_strikes)
            n = len(self._local_strikes)
            if n >= self.strikes and not self._reported:
                # report once per offender: the driver quarantines on
                # the first report, repeats would just churn the journal
                self._reported = True
                log.warning(
                    "sdc: %d locally-attributed detection(s) within %d "
                    "steps — reporting this host for quarantine",
                    n, WINDOW_STEPS)
                try:
                    self._report(det.kind, n)
                except Exception:
                    log.warning("sdc: quarantine report failed",
                                exc_info=True)
        # a poisoned-parameters signal, or a pattern of trips, means
        # skipping forward cannot help: the state itself is suspect
        if det.kind == "fingerprint" or len(self._trips) >= ROLLBACK_TRIPS:
            return ROLLBACK
        return SKIP

    def on_rollback(self) -> None:
        _M_ROLLBACKS.inc()
        # the restored state predates every recorded trip and every
        # unconfirmed checkpoint; both windows restart clean
        self._trips.clear()
        self._pending.clear()

    def _prune(self, dq: "collections.deque") -> None:
        while dq and dq[0] <= self._step - WINDOW_STEPS:
            dq.popleft()
