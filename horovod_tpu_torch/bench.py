"""Headline benchmark of the port: ResNet-50 synthetic training throughput
on the card (counterpart of the repository's root ``bench.py``).

    python -m horovod_tpu_torch.bench [--model resnet50] [--batch N]
        [--stem conv|space_to_depth] [--budget SECONDS]

Prints one JSON line per finished stage, cheapest stage first,

    {"metric": "resnet50_synthetic_images_per_sec_per_chip", "value": N,
     "unit": "images/sec/chip", "vs_baseline": N, "batch_per_chip": B,
     "mfu": x, "stem": "conv", "platform": "gpu", "device_kind": ...}

and re-prints the best line last, so the last JSON line is the result
whenever the run ends. ``vs_baseline`` is against the one absolute
throughput the reference publishes (docs/benchmarks.rst:27-43: 1656.82
images/sec on 16 Pascal GPUs, 103.55 a GPU).

The ladder (``benchmark.synthetic_resnet50_ladder``, stages of one batch
size share a rig): a tiny stage at batch 32, batch 32 at the reference's
length (10 warmup, 10 x 10), then batch 128 and 256; ``--batch N`` runs a
quick and a full stage at N instead. A stage that would start with less
than its margin of the ``--budget`` left (a new rig 100 s, a warm one
30 s) is not started; SIGTERM prints the best line so far and exits.
A stage that fails (out of memory) is reported on stderr and the ladder
goes on. Without a CUDA device it exits non-zero: the port has no CPU
ladder.
"""

import argparse
import json
import os
import signal
import sys
import time

REFERENCE_IMG_PER_SEC_PER_CHIP = 1656.82 / 16  # docs/benchmarks.rst:27-43
METRIC = "resnet50_synthetic_images_per_sec_per_chip"
NEW_RIG_MARGIN_S = 100.0
WARM_RIG_MARGIN_S = 30.0


def _stages(batch=None, stem=None):
    full = dict(num_warmup_batches=10, num_batches_per_iter=10,
                num_iters=10, scanned=True, stem=stem)
    if batch:
        return [dict(batch_per_chip=batch, num_warmup_batches=1,
                     num_batches_per_iter=2, num_iters=1, stem=stem),
                dict(full, batch_per_chip=batch)]
    return [
        # a first number seconds after the rig is built
        dict(batch_per_chip=32, num_warmup_batches=1,
             num_batches_per_iter=2, num_iters=1, stem=stem),
        # the reference's measurement: batch 32, 10 warmup, 10 x 10
        dict(full, batch_per_chip=32, scanned=False),
        dict(full, batch_per_chip=128),
        dict(full, batch_per_chip=256),
    ]


def result_json(r) -> dict:
    out = {
        "metric": METRIC,
        "value": r.images_per_sec_per_chip,
        "unit": "images/sec/chip",
        "vs_baseline": r.images_per_sec_per_chip
        / REFERENCE_IMG_PER_SEC_PER_CHIP,
        "batch_per_chip": r.batch_per_chip,
        "num_chips": r.num_chips,
        "total_images_per_sec": r.images_per_sec_total,
        "iter_mean_s": r.iter_mean_s,
        "iter_std_s": r.iter_std_s,
        "platform": r.platform,
        "device_kind": r.device_kind,
        "mfu": r.mfu,
        "flops_per_step": r.flops_per_step,
        "peak_memory_gib": r.peak_memory_gib,
    }
    if r.stem:
        out["stem"] = r.stem
    return out


def _emit(d) -> None:
    print(json.dumps(d), flush=True)


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--stem", default=None,
                    choices=("conv", "space_to_depth"))
    ap.add_argument("--budget", type=float, default=420.0,
                    help="wall-clock seconds for the whole ladder")
    args = ap.parse_args(argv)
    deadline = time.time() + args.budget

    import torch
    if not torch.cuda.is_available():
        _log("no CUDA device: this benchmark runs on the card only")
        return 2
    torch.backends.cudnn.benchmark = True

    from . import basics
    from .benchmark import synthetic_resnet50_ladder
    so_far = {}     # the best line, for a SIGTERM mid-stage

    def on_term(signum, frame):
        if so_far:
            _emit(so_far)
        os._exit(0 if so_far else 1)
    signal.signal(signal.SIGTERM, on_term)

    stages = _stages(args.batch, args.stem)
    ladder = synthetic_resnet50_ladder(stages, model_name=args.model)
    try:
        best = _run(stages, ladder, deadline, so_far.update)
    finally:
        ladder.close()
        if basics.is_initialized():
            basics.shutdown()
    if best is None:
        return 1
    _emit(best)
    return 0


def _run(stages, ladder, deadline, on_best):
    best = None
    warm = False
    for i, st in enumerate(stages):
        same_rig = warm and i > 0 and \
            st["batch_per_chip"] == stages[i - 1]["batch_per_chip"]
        margin = WARM_RIG_MARGIN_S if same_rig else NEW_RIG_MARGIN_S
        if i > 0 and time.time() > deadline - margin:
            _log(f"{deadline - time.time():.0f} s left < {margin:.0f} s "
                 f"margin; stopping before stage {i + 1}")
            break
        t0 = time.time()
        r, err = next(ladder)
        if err is not None:
            warm = False
            _log(f"stage {i + 1} ({st}) failed: {type(err).__name__}: "
                 f"{err}"[:1500])
            continue
        warm = True
        line = result_json(r)
        _log(f"stage {i + 1}: batch {r.batch_per_chip}, "
             f"{r.images_per_sec_per_chip:.1f} img/s/chip in "
             f"{time.time() - t0:.0f} s")
        _emit(line)
        if best is None or line["value"] > best["value"]:
            best = line
            on_best(best)
    return best


if __name__ == "__main__":
    sys.exit(main())
