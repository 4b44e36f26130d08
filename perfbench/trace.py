"""Reading a traced window: the profiler's device trace and the phase
events of each traced step.

A ``--trace 1`` run profiles two short windows of steps with
``torch.profiler``, exports each Chrome trace to a temporary file and
reads it back here. The first records the device alone (CUDA activity:
kernels, copies, fills and the launches), which adds little host time to
a step; its window lies between two marker kernels (``MARKER``) launched
after a device synchronize and before the closing one. The second also
records every host operation (CPU activity), which adds host time to
each and so lengthens a step that its host paces; its window is the host
span ``perfbench.window``, which ends after a device synchronize, so
every device operation of the window lies in it. From a trace:

- busy time: the union of the intervals in which a kernel, a copy or a
  fill ran on any stream, inside the window;
- the same union without NCCL's kernels (whose names hold ``nccl``; an
  NCCL kernel also spins while it waits for slower ranks), and the time
  in which only NCCL's kernels ran;
- the device operations that took most time, by name;
- the longest gaps inside the window in which no operation but NCCL's
  ran, each named by the innermost host operation running, on any
  thread, at the gap's middle (what the host was doing while the device
  waited);
- the device time of the kernels launched under a host operation (by
  the launch's correlation id, on the launching thread, inside the
  operation's interval), which per-layer readers use.

:class:`TracedRun` is what a per-layer metric's ``read(run)`` receives.
"""

import bisect
import dataclasses
import json
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "perfbench.window"
#: the kernel of ``torch.cuda._sleep``, which marks the ends of a window
#: traced without host operations
MARKER = "spin_kernel"
#: characters of a device operation's name kept in the breakdown
NAME_CHARS = 120
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def is_comm(name: str) -> bool:
    """Whether a device operation is one of NCCL's kernels."""
    return "nccl" in name.lower()


@dataclasses.dataclass
class Trace:
    #: (name, start us, duration us, correlation id) of device operations
    device: List[Tuple[str, float, float, Optional[int]]]
    #: (name, start us, duration us, thread) of host operations
    host: List[Tuple[str, float, float, int]]
    #: correlation id -> (start us, thread) of kernel launches
    launches: Dict[int, Tuple[float, int]]
    #: (start us, end us, thread) of the window span
    window: Tuple[float, float, int]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        device, host, launches, window = [], [], {}, None
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                device.append((e.get("name", "?"), ts, dur,
                               args.get("correlation")))
            elif cat in LAUNCH_CATS:
                if "correlation" in args:
                    launches[args["correlation"]] = (ts, e.get("tid"))
            elif cat in HOST_CATS:
                host.append((e.get("name", "?"), ts, dur, e.get("tid")))
                if e.get("name") == WINDOW_SPAN:
                    window = (ts, ts + dur, e.get("tid"))
        if window is None:
            # a trace without host operations: the window lies between
            # the marker kernels launched at its ends
            marks = sorted((ts, ts + dur) for name, ts, dur, _ in device
                           if MARKER in name)
            if len(marks) < 2:
                raise ValueError(f"{path}: no {WINDOW_SPAN} span and no two "
                                 f"{MARKER} kernels in the trace")
            window = (marks[0][1], marks[-1][0], None)
            device = [d for d in device if MARKER not in d[0]]
        return cls(device, host, launches, window)

    # -- the window ---------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _busy_intervals(self, comm: bool = True
                        ) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals in the window;
        with ``comm=False`` without NCCL's kernels."""
        lo, hi, _ = self.window
        spans = sorted((max(ts, lo), min(ts + dur, hi))
                       for name, ts, dur, _ in self.device
                       if ts + dur > lo and ts < hi
                       and (comm or not is_comm(name)))
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy_intervals()) * 1e-6

    @property
    def compute_busy_s(self) -> float:
        """Seconds in which an operation other than NCCL's ran."""
        return sum(b - a for a, b in self._busy_intervals(False)) * 1e-6

    @property
    def comm_only_s(self) -> float:
        """Seconds in which an NCCL kernel ran and no other operation
        did."""
        return self.busy_s - self.compute_busy_s

    def top_device_ops(self, n: int = 10) -> List[list]:
        lo, hi, _ = self.window
        total: Dict[str, float] = defaultdict(float)
        for name, ts, dur, _ in self.device:
            if lo <= ts < hi:
                total[name] += dur
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], us * 1e-6] for name, us in ranked]

    def idle_gaps(self, n: int = 10) -> List[list]:
        lo, hi, _ = self.window
        gaps, at = [], lo
        for a, b in self._busy_intervals(False):
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if hi > at:
            gaps.append((at, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        ops = [h for h in self.host if h[0] != WINDOW_SPAN]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            inside = [h for h in ops if h[1] <= mid <= h[1] + h[2]]
            name = min(inside, key=lambda h: h[2])[0] if inside \
                else "host: outside any operation"
            out.append([name, (b - a) * 1e-6])
        return out

    # -- device time by what launched it -----------------------------------
    def device_seconds_under(self, pattern: str) -> Optional[float]:
        """Seconds of the device operations launched under a host
        operation whose name holds ``pattern``, inside the window; None
        when no such operation ran."""
        lo, hi, _ = self.window
        ops = [h for h in self.host if pattern in h[0] and lo <= h[1] < hi]
        if not ops:
            return None
        by_thread: Dict[int, List[Tuple[float, int]]] = defaultdict(list)
        for corr, (ts, t) in self.launches.items():
            by_thread[t].append((ts, corr))
        for v in by_thread.values():
            v.sort()
        inside = set()
        for _, ts, dur, t in ops:
            starts = by_thread.get(t, [])
            i = bisect.bisect_left(starts, (ts, -1))
            while i < len(starts) and starts[i][0] <= ts + dur:
                inside.add(starts[i][1])
                i += 1
        return sum(dur for _, _, dur, corr in self.device
                   if corr in inside) * 1e-6

    def kernel_durations(self, pattern: str) -> List[float]:
        """Seconds of each kernel in the window whose name holds
        ``pattern``."""
        lo, hi, _ = self.window
        return [dur * 1e-6 for name, ts, dur, _ in self.device
                if pattern in name and lo <= ts < hi]


@dataclasses.dataclass
class TracedRun:
    """What a per-layer metric's ``read(run)`` receives.

    ``trace``: the device's trace of a profiled sub-window of ``steps``
    steps (the device alone); ``host_trace``: the same number of steps
    traced with every host operation, for what the device did under
    which host operation. ``phases``: per
    step of the window before it (hooks on, profiler off), the ms of each
    phase (``forward``, ``backward``, ``drain``; see ``worker.Phases``).
    ``window_s`` and ``step_ms``: that window's seconds and each of its
    steps' device ms (the slowest rank's). ``flops_per_step``: the
    configuration's model FLOPs of one chip's step; ``peaks``: the card's
    row of ``counts.PEAKS`` (empty for a card not in it)."""
    trace: Trace
    host_trace: Trace
    steps: int
    phases: List[Dict[str, float]]
    window_s: float
    step_ms: List[float]
    config: dict
    traffic: dict
    chips: int
    flops_per_step: float
    peaks: Dict[str, float]

    def phase_ms(self, name: str) -> Optional[float]:
        if not self.phases:
            return None
        return statistics.fmean(p[name] for p in self.phases)

    @property
    def step_s(self) -> float:
        """The window's seconds per step: all its time over all its
        steps."""
        return self.window_s / len(self.step_ms)
