"""A rank of a multi-chip run, as the port's launcher starts it:

    python -m horovod_tpu_torch.runner -np <chips> --launcher local \
        python -m perfbench.launched --workload <name> ... --out <path>

Before torch is imported, the rank keeps its host threads on its own
share of the run's cores: the cores this process may use, in order, cut
into ``HVD_TPU_LOCAL_SIZE`` equal runs, of which it takes run number
``HVD_TPU_LOCAL_RANK`` (the launcher's identity of the worker). Every
thread the rank starts later (torch's intra-op pool, the autograd
thread, the port's dispatcher, NCCL's proxy) inherits that set, and
torch's intra-op thread count is sized to it, as ``mpirun --bind-to``
and ``torchrun``'s ``OMP_NUM_THREADS`` arrange for a Horovod job. The
rank writes the cores it took to standard error. Then it runs
``worker.main``.
"""

import os
import sys


def pin() -> list:
    """Keep this process on its share of the cores; returns the cores."""
    rank = int(os.environ["HVD_TPU_LOCAL_RANK"])
    size = int(os.environ["HVD_TPU_LOCAL_SIZE"])
    cores = sorted(os.sched_getaffinity(0))
    share = max(1, len(cores) // size)
    mine = cores[rank * share:(rank + 1) * share] or cores
    os.sched_setaffinity(0, mine)
    os.environ["OMP_NUM_THREADS"] = str(len(mine))
    sys.stderr.write(f"perfbench: local rank {rank} of {size} pinned to "
                     f"cores {mine} of {cores}, {len(mine)} intra-op "
                     f"threads\n")
    return mine


if __name__ == "__main__":
    _cores = pin()
    import torch
    torch.set_num_threads(len(_cores))
    from perfbench import worker
    sys.exit(worker.main())
