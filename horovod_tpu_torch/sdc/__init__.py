"""Silent-data-corruption defense plane (counterpart of
``horovod_tpu/sdc``).

* :mod:`guard`: per-step detection: all-reduced finite checks and a
  loss-spike EWMA bound, reduced on the gradients' device
  (:func:`guard_update` as tensors, :class:`StepGuard` eager), and the
  ``worker.grads`` drill site (:func:`corrupt_grads`);
* :mod:`fingerprint`: periodic cross-replica parameter checksums
  published through the schedule KV scope; a divergence names the
  offending rank;
* :mod:`policy`: skip / roll-back-to-last-good / quarantine escalation
  (:class:`SdcPolicy`);
* :mod:`report`: the journaled ``sdc`` rendezvous scope codec the
  worker uses to report a repeat offender to the elastic driver.
"""

from .fingerprint import (FingerprintMonitor, fingerprint_diverged,  # noqa: F401
                          fold_fingerprint, fold_leaf_fingerprints)
from .guard import (Detection, StepGuard, corrupt_grads,  # noqa: F401
                    guard_update)
from .policy import ROLLBACK, SKIP, SdcPolicy  # noqa: F401
from .report import SDC_SCOPE, decode_report, encode_report  # noqa: F401

__all__ = [
    "Detection", "StepGuard", "corrupt_grads", "guard_update",
    "FingerprintMonitor", "fingerprint_diverged", "fold_fingerprint",
    "fold_leaf_fingerprints",
    "SdcPolicy", "SKIP", "ROLLBACK",
    "SDC_SCOPE", "encode_report", "decode_report",
]
