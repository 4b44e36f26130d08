"""A checkout in miniature for the CPU tests: ``BENCHMARK.json``, the
metric readers, and tiny configurations and mixes of both families (the
real ones' keys, small sizes), with limits for their checks."""

import json
import os
import shutil

from perfbench import spec
from perfbench.families import gpt2, resnet

TINY_GPT2 = {"vocab_size": 512, "n_positions": 64, "n_ctx": 64,
             "n_embd": 64, "n_layer": 2, "n_head": 4}
TINY_RESNET = {"stage_sizes": [1, 1], "num_filters": 16, "num_classes": 10,
               "image_size": 64}
#: limits for the tiny cells, set as the benchmark's are, from readings
#: on the CPU: the largest of sound runs over seeds 1-12, 2**31 + 77 and
#: 2**32 + 9 (the lower reading) against the least of the control's over
#: seeds 1-6 and of half the batch left out (the upper). LM: loss_gap
#: 4.3e-5 against the control's 1.3e-4; grad_gap 4.2e-3 against 3.3e-2;
#: grad_gap_median 3.1e-4 against 5.0e-3; change_gap 3.1e-3, which the
#: control does not separate (5.6e-3): half the batch's 4.2e-2;
#: change_gap_median 2.4e-4 against 1.6e-3. CNN: loss_gap 4.6e-4
#: against 2.0e-3; grad_gap 0.045 against 0.27; change_gap 0.063 against
#: 0.23; stats_gap 8.7e-4 against half the batch's 2.7e-3.
LIMITS = {
    "tiny_lm": {"loss_gap": 8e-5, "grad_gap": 0.012,
                "grad_gap_median": 1.5e-3, "change_gap": 0.02,
                "change_gap_median": 8e-4},
    "tiny_cnn": {"loss_gap": 1.2e-3, "grad_gap": 0.12, "change_gap": 0.13,
                 "stats_gap": 2e-3},
}


def _count(leaves) -> int:
    n = 0
    for _, shape, _ in leaves:
        size = 1
        for s in shape:
            size *= s
        n += size
    return n


def _load(root, *parts):
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def _dump(obj, root, *parts):
    path = os.path.join(root, *parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make(root: str, chips: int = 1) -> str:
    """Write the miniature checkout under ``root``; returns ``root``."""
    real = spec.ROOT
    shutil.copytree(os.path.join(real, "perfbench", "metrics"),
                    os.path.join(root, "perfbench", "metrics"))
    gpt = {**_load(real, "perfbench", "configs", "gpt2-medium.json"),
           **TINY_GPT2}
    gpt["parameters"] = _count(gpt2.leaves(gpt))
    _dump(gpt, root, "perfbench", "configs", "tiny-gpt2.json")
    cnn = {**_load(real, "perfbench", "configs", "resnet50-v1.5.json"),
           **TINY_RESNET}
    cnn["parameters"] = _count(resnet.leaves(cnn))
    _dump(cnn, root, "perfbench", "configs", "tiny-resnet.json")
    lm = {**_load(real, "perfbench", "traffic", "lm-b8-s1024.json"),
          "batch_per_chip": 4, "seq_len": 64, "pool_batches": 4,
          "trace_steps": 2}
    _dump(lm, root, "perfbench", "traffic", "tiny-lm.json")
    im = {**_load(real, "perfbench", "traffic", "img-b256-224.json"),
          "batch_per_chip": 16, "image_size": 64, "pool_batches": 4,
          "trace_steps": 2}
    _dump(im, root, "perfbench", "traffic", "tiny-cnn.json")
    bench = _load(real, "BENCHMARK.json")
    bench["configs"] = [
        {"name": "tiny-gpt2", "source": "tiny", "reduced": [], "why": "test",
         "file": "perfbench/configs/tiny-gpt2.json"},
        {"name": "tiny-resnet", "source": "tiny", "reduced": [],
         "why": "test", "file": "perfbench/configs/tiny-resnet.json"}]
    bench["workloads"] = [
        {"name": "tiny_lm", "config": "tiny-gpt2", "traffic": "tiny-lm",
         "chips": chips, "why": "test"},
        {"name": "tiny_cnn", "config": "tiny-resnet", "traffic": "tiny-cnn",
         "chips": chips, "why": "test"}]
    # each metric listed for a real cell is listed for its tiny stand-in:
    # the one-chip cells' for the tiny cells, the four-chip cell's for
    # the tiny LM cell on more than one chip
    stand_in = {"gpt2m_b8": ["tiny_lm"], "resnet50_b256": ["tiny_cnn"],
                "gpt2m_b8_dp4": ["tiny_lm"] if chips > 1 else []}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({c for w in m["workloads"]
                                     for c in stand_in.get(w, [])})
    _dump(bench, root, "BENCHMARK.json")
    for cell, limits in LIMITS.items():
        if chips > 1:   # every rank's parameters equal after the exchange
            limits = {**limits, "ranks_differ": 0}
        _dump({k: {"limit": v} for k, v in limits.items()}, root,
              "perfbench", "limits", f"{cell}.json")
    return root
