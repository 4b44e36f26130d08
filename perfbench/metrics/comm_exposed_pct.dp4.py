"""comm_exposed_pct.dp4 (%): share of the profiled window in which an
NCCL kernel ran (``collectives.py``'s allreduces over NCCL) and no other
device operation did: the exchange that the backward does not hide, rank
skew included (an NCCL kernel spins while it waits for slower ranks).
None where the window held no NCCL kernel."""


def read(run):
    window = run.trace.window_s
    if window <= 0 or run.trace.busy_s == run.trace.compute_busy_s:
        return None
    return 100.0 * run.trace.comm_only_s / window
