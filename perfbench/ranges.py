"""The program's own profiler ranges in a host trace.

While a ``torch.profiler`` session records, ``horovod_tpu_torch``'s
training step opens a ``record_function`` range ``hvd.<span>`` around
each part of its reduction (``tracing.py``): ``hvd.opt.drain``,
``hvd.opt.wait``, ``hvd.opt.update``, ``hvd.host.sync``,
``hvd.collective:<verb>:<name>`` and ``hvd.dispatch.run``. A session
records the ranges and operations of the threads it follows: the
caller's and the autograd engine's; the collectives' dispatcher thread,
started before the session, is not among them, so its launches appear
(by thread id) with no host operation around them. A program without
the ranges (an older one) leaves these readers nothing: they return
None. Helpers over ``trace.Trace`` for the readers under ``metrics/``.
"""

from typing import Iterable, List, Optional, Set, Tuple

Interval = Tuple[float, float]


def merged(spans: Iterable[Interval]) -> List[Interval]:
    """The union of ``spans`` as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_us(xs: List[Interval], ys: List[Interval]) -> float:
    """Microseconds in both unions (each sorted and disjoint)."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def ranges(trace, prefixes: Tuple[str, ...]) -> List[tuple]:
    """The host operations in the window whose names start with one of
    ``prefixes``, as ``trace.host`` holds them."""
    lo, hi, _ = trace.window
    return [h for h in trace.host
            if h[0].startswith(prefixes) and lo <= h[1] < hi]


def idle_intervals(trace) -> List[Interval]:
    """The window's intervals with no device operation but NCCL's."""
    lo, hi, _ = trace.window
    gaps, at = [], lo
    for a, b in trace._busy_intervals(False):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def launches_under(trace, ops: List[tuple]) -> Set[int]:
    """Correlation ids of the kernel launches made on an operation's
    thread inside its interval, for each of ``ops``."""
    out = set()
    for _, ts, dur, tid in ops:
        out.update(corr for corr, (t, th) in trace.launches.items()
                   if th == tid and ts <= t <= ts + dur)
    return out


def unfollowed_launches(trace) -> Set[int]:
    """Correlation ids of the window's launches made by threads that ran
    no recorded host operation: threads the session does not follow
    (the collectives' dispatcher)."""
    lo, hi, _ = trace.window
    followed = {h[3] for h in trace.host}
    return {corr for corr, (t, th) in trace.launches.items()
            if th not in followed and lo <= t < hi}


def device_us(trace, correlations: Set[int]) -> float:
    return sum(dur for _, _, dur, corr in trace.device
               if corr in correlations)


def in_ranges_share(trace, prefixes: Tuple[str, ...]) -> Optional[float]:
    """The share of the window's device idle time during which some
    thread was inside one of the ranges named by ``prefixes``; None
    when the window holds no such range."""
    inside = ranges(trace, prefixes)
    if not inside:
        return None
    idle = idle_intervals(trace)
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return 0.0
    lo, hi, _ = trace.window
    spans = merged((max(ts, lo), min(ts + dur, hi))
                   for _, ts, dur, _ in inside)
    return overlap_us(idle, spans) / total
