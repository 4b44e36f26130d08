"""One rank of a gloo world of the tiny LM cell on the CPU, for
``test_perfbench_check``: ``python -m perfbench.tests.dp_world <root>
<fault> <out>`` with the port's ``HVD_TPU_*`` identity in the env.
``fault`` is ``none`` or ``no_exchange`` (every bucket's allreduce left
out: each rank keeps its own rows' gradient)."""

import json
import sys
import time

import torch


def main(root: str, fault: str, out: str) -> None:
    torch.set_num_threads(2)
    from horovod_tpu_torch.optimizer import DistributedOptimizer
    from perfbench import worker
    if fault == "no_exchange":
        DistributedOptimizer.synchronize = lambda self: None
        DistributedOptimizer.step = lambda self, closure=None: \
            self._opt.step(closure)
        DistributedOptimizer._hook = lambda self, p: None
    r = worker.run_rank("tiny_lm", 2**31 + 5, 0.2, False, time.time(),
                        device="cpu", root=root, check_chip=False)
    if r is not None:
        with open(out, "w") as f:
            json.dump(r, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
