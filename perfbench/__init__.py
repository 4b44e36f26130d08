"""The benchmark of horovod_tpu_torch: ``python3 perfbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the root
of a checkout (see ``run.py``; the cells are in ``BENCHMARK.json``)."""
