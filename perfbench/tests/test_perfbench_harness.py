"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as files, with their entries in BENCHMARK.json,
are found by name and run, in a temporary copy, with no existing file
edited; a tiny cell runs end to end on the CPU (the look for a card
skipped), traced, and its line carries the added metric."""

import hashlib
import json
import os
import time

import pytest

from perfbench import run, spec, worker
from perfbench.tests import tiny


def _digests(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def _add(root):
    """A configuration, a mix and a metric as new files, and their
    entries appended to BENCHMARK.json."""
    with open(os.path.join(root, "perfbench", "configs",
                           "tiny-gpt2.json")) as f:
        cfg = json.load(f)
    cfg["n_layer"] = 3
    cfg["parameters"] = tiny._count(
        spec.cell("tiny_lm", root).family.leaves(cfg))
    with open(os.path.join(root, "perfbench", "configs", "added-gpt2.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "perfbench", "traffic", "added-mix.json"),
              "w") as f:
        json.dump({"kind": "tokens", "batch_per_chip": 2, "seq_len": 64,
                   "pool_batches": 5, "trace_steps": 1,
                   "optimizer": {"name": "adamw", "lr": 1e-3,
                                 "betas": [0.9, 0.999], "eps": 1e-8,
                                 "weight_decay": 1e-4}}, f)
    with open(os.path.join(root, "perfbench", "metrics", "added.steps.py"),
              "w") as f:
        f.write("def read(run):\n    return float(len(run.step_ms))\n")
    with open(os.path.join(root, "perfbench", "limits", "added_cell.json"),
              "w") as f:
        json.dump({k: {"limit": v} for k, v in
                   tiny.LIMITS["tiny_lm"].items()}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "added-gpt2", "source": "x",
                             "file": "perfbench/configs/added-gpt2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "added_cell", "config": "added-gpt2",
                               "traffic": "added-mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "added.steps", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "train_step_ms",
                               "workloads": ["added_cell"]})
    with open(path, "w") as f:
        json.dump(bench, f)


def test_added_files_are_found_by_name(tmp_path):
    root = tiny.make(str(tmp_path))
    before = _digests(root)
    _add(root)
    after = _digests(root)
    changed = [p for p in before if before[p] != after[p]]
    assert changed == ["BENCHMARK.json"]
    added = sorted(set(after) - set(before))
    assert added == sorted([
        os.path.join("perfbench", "configs", "added-gpt2.json"),
        os.path.join("perfbench", "traffic", "added-mix.json"),
        os.path.join("perfbench", "metrics", "added.steps.py"),
        os.path.join("perfbench", "limits", "added_cell.json")])

    cell = spec.cell("added_cell", root)
    assert cell.config["n_layer"] == 3
    assert cell.traffic["batch_per_chip"] == 2
    assert cell.family.__name__ == "perfbench.families.gpt2"
    assert cell.reference.__name__ == "perfbench.reference.gpt2"
    names = [m["name"] for m in cell.per_layer]
    assert "added.steps" in names
    # metrics listed for other cells stay out; unlisted ones stay in
    assert "attn_bwd_ms" not in names and "step_mfu" in names
    # the old cells are untouched
    assert "added.steps" not in [m["name"] for m in
                                 spec.cell("tiny_lm", root).per_layer]


@pytest.mark.parametrize("trace", [False, True])
def test_an_added_cell_runs_on_the_cpu(tmp_path, trace):
    import torch
    torch.set_num_threads(4)
    root = tiny.make(str(tmp_path))
    _add(root)
    cell = spec.cell("added_cell", root)
    r = worker.run_rank("added_cell", 2**31 + 11, 0.3, trace, time.time(),
                        device="cpu", root=root, check_chip=False)
    r["device_name"] = "cpu"
    line = run.result_line(cell, r, trace)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 3
    assert list(line)[-1] == "checks"
    if trace:
        metrics = line["metrics"]
        # the window's steps; the two profiled passes ran one step each
        # before their windows besides
        profiled = 2 * (cell.traffic["trace_steps"] + 1)
        assert metrics["added.steps"]["value"] == r["attempted"] - profiled
        assert metrics["added.steps"]["unit"] == "1"
        for name in ("forward_ms", "backward_ms", "drain_ms",
                     "device_idle_pct"):
            assert metrics[name]["value"] > 0
        assert "breakdown" in line
    else:
        assert set(line["metrics"]) == {"train_step_ms", "setup_s"}


def test_the_committed_cells_resolve():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.family.Program is not None
        assert callable(cell.reference.loss_and_grads)
        assert cell.limits, f"{w['name']} has no limits file"
        assert {m["name"] for m in cell.end_to_end} >= {"train_step_ms",
                                                       "setup_s"}
        for m in cell.per_layer:
            assert callable(spec.load_metric(m["name"]).read)
