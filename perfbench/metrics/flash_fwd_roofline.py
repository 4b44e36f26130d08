"""flash_fwd_roofline (%): the flash forward kernel's share of its
roofline (``ops/csrc/flash_fwd.cu``). The least time of one call, the
larger of its operations over the bf16 peak and its bytes over the peak
bandwidth (``counts.flash_bound``: q, k, v read and out written once in
bf16, the fp32 lse written once, two products over the causal pairs),
over the profiler's mean device time per call of the kernels whose name
holds ``KERNEL``. A change that replaces the kernel brings a metric of
its own; this one then finds nothing and reports nothing."""

from perfbench import counts

KERNEL = "flash_fwd"


def read(run):
    times = run.trace.kernel_durations(KERNEL)
    if not times:
        return None
    cfg, traffic = run.config, run.traffic
    bh = traffic["batch_per_chip"] * cfg["n_head"]
    _, _, least = counts.flash_bound(bh, traffic["seq_len"],
                                     cfg["n_embd"] // cfg["n_head"], True)
    return 100.0 * least / (sum(times) / len(times))
