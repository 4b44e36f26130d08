"""forward_ms (ms): device time of the model's forward per step, between
the CUDA events that the benchmark's forward pre-hook and forward hook on
the model (``models/transformer.py``, ``models/resnet.py``) record, over
the traced run's window."""


def read(run):
    return run.phase_ms("forward")
