"""The end-to-end statistics of a training window.

``train_step_ms`` is all the time of the window over all the steps
completed in it (not a mean of per-step rates). ``train_step_ms_p90`` is
the 90th percentile of every step's time in the window, each step timed
by CUDA events at its boundaries and, across chips, taken from its
slowest rank.
"""

import math
from typing import Dict, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile with linear interpolation between the
    closest ranks (numpy's default)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def slowest_rank(per_rank: List[Sequence[float]]) -> List[float]:
    """Each step's time as its slowest rank's."""
    if len({len(r) for r in per_rank}) != 1:
        raise ValueError("ranks completed different numbers of steps")
    return [max(ts) for ts in zip(*per_rank)]


def window_metrics(window_s: float, step_ms: Sequence[float]
                   ) -> Dict[str, float]:
    """The window's end-to-end metrics from its length (the job's: the
    slowest rank's) and its steps' times."""
    if not step_ms:
        raise ValueError("a window with no steps")
    return {"train_step_ms": 1e3 * window_s / len(step_ms),
            "train_step_ms_p90": percentile(step_ms, 90)}
