"""The readings that the limits of ``limits/<workload>.json`` are set
from. Not part of a benchmark run.

Two stages, so that a multi-chip cell's reference work runs on one chip:

    # the program's readings of the checked steps, one world, many seeds
    # (appended to --out)
    python3 -m perfbench.calibrate program --workload W --seeds 1,2,3 \
        --out readings.jsonl
    (on more than one chip: under ``python -m horovod_tpu_torch.runner
    -np <chips> --launcher local``; rank 0 writes)

    # the reference's readings on one chip, and the gaps: the program's
    # (the lower readings), the control's and the planted faults' (the
    # upper readings)
    python3 -m perfbench.calibrate reference --workload W \
        --readings readings.jsonl --control-seeds 1,2,3 --out gaps.jsonl

The control is the reference put in the program's place and computed in
float8 (``reference/precision.py``). The faults are planted in the
reference put in the program's place: ``half_batch`` (half of the global
batch left out, the mean taken over the rest) and, on more than one chip,
``no_exchange`` (the gradient of one chip's rows alone: the exchange
between chips left out). A step that returns its state unchanged reads
``change_gap`` = 1 with no run.
"""

import argparse
import json
import statistics
import sys

import torch

from perfbench import check, spec, worker


def worst_leaves(prog: dict, ref: dict, n: int = 4) -> dict:
    """The ``n`` leaves with the largest gaps of each per-leaf number:
    [leaf, gap, the reference's norm] (for the look at what a number's
    worst leaf is)."""
    out = {}
    for key in ("grad", "change", "stats"):
        if not ref.get(key):
            continue
        med = statistics.median(ref[key].values())
        rows = sorted(((name, abs(prog[key][name] - r) / max(r, med, 1e-30), r)
                       for name, r in ref[key].items()),
                      key=lambda row: -row[1])
        out[key] = rows[:n]
    return out


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def program(args) -> None:
    cell = spec.cell(args.workload)
    me = worker.Rank(cell, 0)
    out = []
    for seed in _seeds(args.seeds):
        me.seed = seed
        me.build()
        r = me.checked_steps()
        r.pop("step_s")
        row = {"seed": seed, "readings": r}
        if me.size > 1:
            row["ranks_differ"] = check.ranks_differ(
                me.gather(me.checksums()))
        out.append(row)
        me.drop_program()
        print(json.dumps({"seed": seed, "allocated_bytes":
                          torch.cuda.memory_allocated()}), flush=True)
    peak = me.peak_memory()
    me.close()
    if me.rank == 0:
        with open(args.out, "a") as f:
            for row in out:
                f.write(json.dumps({**row, "memory_peak_bytes": peak}) + "\n")


def reference(args) -> None:
    cell = spec.cell(args.workload)
    dev = torch.device("cuda", 0)
    rows = cell.chips * cell.traffic["batch_per_chip"]
    faults = {"half_batch": slice(0, rows // 2)}
    if cell.chips > 1:
        faults["no_exchange"] = slice(0, cell.traffic["batch_per_chip"])
    controls = set(_seeds(args.control_seeds))
    rows_in = []
    if args.readings:
        with open(args.readings) as f:
            rows_in = [json.loads(line) for line in f if line.strip()]
    # control seeds with no program readings: the control and the faults
    rows_in += [{"seed": s} for s in sorted(controls)
                if s not in {r["seed"] for r in rows_in}]
    with open(args.out, "w") as out:
        for row in rows_in:
            seed = row["seed"]
            ref = worker.reference_readings(cell, seed, dev)
            rec = {"seed": seed, "leaves": {}, "raw": {"reference": ref}}
            if "readings" in row:
                rec["program"] = check.gaps(row["readings"], ref)
                if "ranks_differ" in row:
                    rec["program"]["ranks_differ"] = row["ranks_differ"]
                rec["leaves"]["program"] = worst_leaves(row["readings"], ref)
                rec["raw"]["program"] = row["readings"]
            if seed in controls:
                ctl = worker.reference_readings(cell, seed, dev, "fp8")
                rec["control"] = check.gaps(ctl, ref)
                rec["leaves"]["control"] = worst_leaves(ctl, ref)
                rec["raw"]["control"] = ctl
                for name, sel in faults.items():
                    bad = worker.reference_readings(cell, seed, dev, rows=sel)
                    rec[name] = check.gaps(bad, ref)
                    rec["raw"][name] = bad
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(json.dumps({k: v for k, v in rec.items()
                              if k not in ("raw", "leaves")}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("stage", choices=("program", "reference"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--readings")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    program(a) if a.stage == "program" else reference(a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
