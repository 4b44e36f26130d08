"""idle_in_reduction_pct (%): the share of the device's idle time (no
operation but NCCL's), in the window of the trace that records host
operations, during which some thread was inside one of the program's
reduction ranges: ``hvd.opt.*`` (the drain, each bucket's wait, the
inner update), ``hvd.dispatch.*``, ``hvd.host.sync`` (the join marker's
read) or ``hvd.collective:*`` (a bucket's submission), by the overlap of
intervals. The rest of the idle time lies outside the reduction: in the
forward, the backward's own host work, or between steps. None where the
program opens none of these ranges."""

from perfbench import ranges

PREFIXES = ("hvd.opt.", "hvd.dispatch.", "hvd.host.sync", "hvd.collective:")


def read(run):
    share = ranges.in_ranges_share(run.host_trace, PREFIXES)
    return None if share is None else 100.0 * share
