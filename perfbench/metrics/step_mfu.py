"""step_mfu (%): the whole training step's share of the card's bf16 peak.

The configuration's model FLOPs of one chip's step (the benchmark's own
count: ``counts.gpt2_flops_per_step``, ``chip_smoke.model_flops_per_step``'s
formula, for GPT-2; ``torch.utils.flop_counter`` on the plain reference
on the meta device for ResNet), over the traced run's window time per
step (all its time over all its steps, profiler off), over the peak of
``counts.PEAKS``. It bounds every kernel's roofline share on the path.
"""


def read(run):
    if not run.peaks or run.flops_per_step <= 0:
        return None
    return 100.0 * run.flops_per_step / run.step_s / run.peaks["bf16_flops"]
