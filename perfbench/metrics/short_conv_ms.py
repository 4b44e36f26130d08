"""short_conv_ms (ms): device time per step of the gated short
convolutions (``models/lfm2.py``'s ``ShortConvFunction``: the two gates
and the causal depthwise taps, without the two projections): the kernels
launched under the range ``hvd.conv.short`` and under the autograd node
``ShortConvFunctionBackward``. None where the program opens no such
range (a model without the layer)."""

from perfbench.model_ranges import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ("hvd.conv.short",),
                              ("ShortConvFunctionBackward",))
