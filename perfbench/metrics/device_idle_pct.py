"""device_idle_pct (%): share of the profiled window in which no device
operation other than NCCL's ran (an NCCL kernel also spins while it
waits for slower ranks): one minus the union of the profiler's device
intervals without NCCL's kernels over the window's length. The profiler
adds host time to every operation it records, so where the host paces
the step this share reads higher than in a window without it."""


def read(run):
    window = run.trace.window_s
    if window <= 0:
        return None
    return 100.0 * (1.0 - run.trace.compute_busy_s / window)
