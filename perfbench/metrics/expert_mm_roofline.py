"""expert_mm_roofline (%): the expert products' share of their roofline.
The least time of a traced step's products (``counts_moe.expert_mm_bound``:
in each sparse layer 3 products x (1 forward + 2 backward) over the slots
that went to the held experts, each reading the held experts' bf16
weights and its two token slabs once; the larger of operations over the
bf16 peak and bytes over the peak bandwidth), over the device time per
step of the kernels launched under ``aten::_grouped_mm``, forward and
backward (``parallel/moe.py``'s ``ExpertMatmulFunction``), in the trace
that records host operations.

The slots are the program's own record of the profiled calls
(``parallel.moe.PROFILED_HELD_SLOTS``, device values read here, after
the traces): the host-traced window's steps are the last ones profiled,
so their calls are the record's last ``steps x sparse layers``. The
router's draw moves the slots from seed to seed, so their balanced
expectation is no yardstick for the products' time. A change that
computes the products with another kernel brings a metric of its own;
this one then finds nothing and reports nothing."""

from perfbench import counts_moe
from perfbench.model_ranges import device_ms_per_step

OP = "aten::_grouped_mm"


def traced_slots(run):
    """The held experts' slots a traced step, summed over its sparse
    layers; None where the program keeps no record of them."""
    try:
        from horovod_tpu_torch.parallel import moe
    except ImportError:
        return None
    record = list(getattr(moe, "PROFILED_HELD_SLOTS", ()))
    calls = run.steps * (run.config["num_hidden_layers"]
                         - run.config["num_dense_layers"])
    if len(record) < calls:
        return None
    return sum(int(s) for s in record[-calls:]) / run.steps


def read(run):
    ms = device_ms_per_step(run, (OP,))
    slots = traced_slots(run)
    if not ms or not slots:
        return None
    _, _, least = counts_moe.expert_mm_bound(run.config, slots)
    return 100.0 * 1e3 * least / ms
