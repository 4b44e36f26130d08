"""backward_ms (ms): device time per step from the model forward's end
to the optimizer step's start (the loss, ``loss.backward()`` and the
bucket allreduces the DistributedOptimizer's hooks launch inside it),
between the benchmark's CUDA events: the forward hook's and the one its
wrapper around the optimizer instance's ``step`` records on entry."""


def read(run):
    return run.phase_ms("backward")
