"""attn_bwd_ms (ms): device time per step of the attention's backward:
the kernels launched under the flash attention's autograd backward node
(``ops/flash_attention.py``'s ``FlashAttentionFunction``, whose backward
is ``flash_bwd_plain``), found by the node's name in the trace that
records host operations (each launch's correlation id ties a kernel to
the launching thread's operation). None when no such node ran (another
attention is on the path)."""

#: the autograd node's name as the profiler records it
NODE = "FlashAttentionFunctionBackward"


def read(run):
    seconds = run.host_trace.device_seconds_under(NODE)
    if seconds is None:
        return None
    return 1e3 * seconds / run.steps
