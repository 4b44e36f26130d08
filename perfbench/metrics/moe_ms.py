"""moe_ms (ms): device time per step of the dropless expert layer
(``parallel/moe.py``'s ``dropless_moe``): the kernels launched under its
ranges ``hvd.moe.route`` (router, top-k, the sort of the slots by
expert), ``hvd.moe.experts`` (the held experts' grouped SwiGLU) and
``hvd.moe.combine`` (the weighted sum back), and under the backward of
its expert products (the autograd node ``ExpertMatmulFunctionBackward``).
The backward of the router and of the combine runs under torch's own
nodes, which other layers share, and is not counted. None where the
program opens no such range (a model without the layer)."""

from perfbench.model_ranges import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ("hvd.moe.",),
                              ("ExpertMatmulFunctionBackward",))
