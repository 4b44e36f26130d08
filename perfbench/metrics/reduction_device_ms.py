"""reduction_device_ms (ms): device time per step of the gradients'
reduction in ``optimizer.py`` and ``collectives.py``, in the trace that
records host operations: the kernels launched under the program's
``hvd.opt.drain`` range (the partly ready buckets, the join marker and
the write-back of the averaged gradients) or ``hvd.dispatch.run`` range
(each bucket's concatenation, wire call, scale and split), and those
launched by the collectives' dispatcher thread where the session does
not follow it (``ranges.py``). NCCL's kernels count, their wait for
slower ranks included. None where the program opens no ``hvd.opt.drain``
range."""

from perfbench import ranges


def read(run):
    t = run.host_trace
    drains = ranges.ranges(t, ("hvd.opt.drain",))
    if not drains:
        return None
    corr = ranges.launches_under(
        t, drains + ranges.ranges(t, ("hvd.dispatch.run",)))
    corr |= ranges.unfollowed_launches(t)
    return 1e-3 * ranges.device_us(t, corr) / run.steps
