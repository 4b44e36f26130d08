"""drain_ms (ms): host time of ``optimizer.step()`` per step, as the
benchmark's wrapper around the optimizer instance's ``step`` times it:
``optimizer.py``'s drain of every fusion bucket's reduction through
``collectives.py`` (the wait for the dispatcher's handles and the write
back of the averaged gradients), then the inner optimizer's update
launches."""


def read(run):
    return run.phase_ms("drain")
