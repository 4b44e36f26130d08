"""Retention policy and background garbage collection (a copy of
``horovod_tpu/checkpointing/gc.py``).

Two composable knobs (``HVD_TPU_CHECKPOINT_KEEP`` /
``HVD_TPU_CHECKPOINT_KEEP_PERIOD``):

* **keep-last-N** — the N newest completed steps survive;
* **keep-every-K** — steps divisible by K survive forever (the
  "milestone" archive a long job keeps for offline eval).

A step survives if *either* rule wants it; the newest completed step
always survives (a GC pass must never delete the thing a crash would
restore from). With neither knob set, GC is off and every step is kept —
the facade's historical behavior.

Deletion is crash-consistent by ordering: the ``COMMIT`` marker goes
first (atomically demoting the step to "partial", which discovery
already skips), then the rest of the tree. A GC pass killed halfway
leaves a partial dir that the next pass sweeps, never a
restorable-looking half-checkpoint.
"""

import logging
import os
import shutil
from typing import Iterable, List, Set

from . import layout

log = logging.getLogger("horovod_tpu_torch.checkpointing")


def retained_steps(steps: Iterable[int], keep: int = 0,
                   keep_period: int = 0) -> Set[int]:
    """The subset of ``steps`` the policy preserves. No policy = keep all."""
    steps = sorted(set(steps))
    if not steps or (keep <= 0 and keep_period <= 0):
        return set(steps)
    out: Set[int] = {steps[-1]}
    if keep > 0:
        out.update(steps[-keep:])
    if keep_period > 0:
        out.update(s for s in steps if s % keep_period == 0)
    return out


def _delete_step(directory: str, step: int) -> None:
    path = layout.step_dir(directory, step)
    commit = os.path.join(path, layout.COMMIT_NAME)
    try:
        os.unlink(commit)           # demote to partial first
        layout.fsync_dir(path)
    except FileNotFoundError:
        pass                        # legacy or already-partial dir
    # no ignore_errors: a failed removal must reach collect()'s warning
    # path and stay OUT of the removed count — the step is already
    # demoted, so a later pass retries the sweep
    shutil.rmtree(path)


def collect(directory: str, keep: int = 0, keep_period: int = 0,
            fault_point=None) -> List[int]:
    """One GC pass; returns the steps it removed.

    Superseded completed steps outside the retained set go, and so do
    partial (crashed-save) dirs older than the newest completed step —
    they can never complete. Failures are logged, never raised: GC runs
    on the background writer and a full-disk ``rmtree`` hiccup must not
    poison an otherwise healthy save pipeline.
    """
    completed = layout.completed_steps(directory)    # newest first
    if not completed:
        return []
    if fault_point is not None:
        fault_point.fire()
    retain = retained_steps(completed, keep, keep_period)
    removed: List[int] = []
    newest = completed[0]
    for step in layout.all_step_dirs(directory):
        state = layout.classify(layout.step_dir(directory, step))
        if state == layout.PARTIAL:
            if step >= newest:
                continue            # possibly still being written
        elif step in retain:
            continue
        try:
            _delete_step(directory, step)
            removed.append(step)
        except OSError:
            log.warning("checkpoint gc: failed to remove step %d under %s",
                        step, directory, exc_info=True)
    if removed:
        log.info("checkpoint gc: removed %d superseded step(s) under %s: %s",
                 len(removed), directory, removed)
    return removed
