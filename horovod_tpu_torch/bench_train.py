"""Times the full-width transformer training step on one GPU, for
comparing two trees of the port on one card in one call.

    python3 horovod_tpu_torch/bench_train.py [--steps N] [--label L]

imports ``horovod_tpu_torch`` from ``sys.path``, so with
``PYTHONPATH=<other checkout>`` it times that checkout's package (which
builds its own kernels) with this script. Runs ``make_transformer_train_step``
on the default TransformerConfig at batch 8 x 2048 (chip_smoke.py's
``train`` phase: weights from seed 0, tokens from seed 1), one warm-up
step, then N timed steps, each a host clock around the step and a device
synchronize. Prints one JSON line: the package's path, the card, and the
step times in ms.
"""

import argparse
import json
import subprocess
import time

import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_train: needs a CUDA device")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerConfig
    from horovod_tpu_torch.parallel import make_transformer_train_step
    hvd.init()
    cfg = TransformerConfig()
    data = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len + 1),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1), device="cuda")
    tokens, targets = data[:, :-1], data[:, 1:]
    bundle = make_transformer_train_step(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    bundle.step(tokens, targets).item()
    ms = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle.step(tokens, targets)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    bundle.optimizer.remove_hooks()
    hvd.shutdown()
    print(json.dumps({"label": args.label, "package": hvd.__file__,
                      "card": smi, "step_ms": ms,
                      "mean_ms": sum(ms) / len(ms), "min_ms": min(ms),
                      "median_ms": sorted(ms)[len(ms) // 2]}), flush=True)


if __name__ == "__main__":
    main()
