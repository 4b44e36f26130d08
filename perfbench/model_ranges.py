"""Device time under a model's own ranges and autograd nodes, for the
per-layer readers of ``metrics/``.

While a ``torch.profiler`` session records, the port's models open
``record_function`` ranges around their layers (``hvd.moe.route``,
``hvd.moe.experts``, ``hvd.moe.combine``, ``hvd.conv.short``; see the
port's ``tracing.py``), and the profiler names each autograd node's
backward ``autograd::engine::evaluate_function: <Node>``. A kernel counts
once, however many of the matched operations it was launched under
(ranges nest), by the launch's correlation id on the launching thread.
"""

import bisect
from collections import defaultdict
from typing import Optional, Tuple


def device_ms_per_step(run, prefixes: Tuple[str, ...] = (),
                       names: Tuple[str, ...] = ()) -> Optional[float]:
    """Device ms per step of the kernels launched, in the window of the
    trace that records host operations, under a host operation whose name
    starts with one of ``prefixes`` or holds one of ``names``; None when
    no such operation ran."""
    t = run.host_trace
    lo, hi, _ = t.window
    ops = [h for h in t.host if lo <= h[1] < hi
           and (h[0].startswith(prefixes) or any(n in h[0] for n in names))]
    if not ops:
        return None
    by_thread = defaultdict(list)
    for corr, (ts, tid) in t.launches.items():
        by_thread[tid].append((ts, corr))
    for v in by_thread.values():
        v.sort()
    inside = set()
    for _, ts, dur, tid in ops:
        starts = by_thread.get(tid, [])
        i = bisect.bisect_left(starts, (ts, -1))
        while i < len(starts) and starts[i][0] <= ts + dur:
            inside.add(starts[i][1])
            i += 1
    us = sum(dur for _, _, dur, corr in t.device if corr in inside)
    return 1e-3 * us / run.steps
