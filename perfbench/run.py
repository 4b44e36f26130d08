"""Run one cell of the benchmark of horovod_tpu_torch once.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names its configuration, traffic mix and chips; see
``spec.py`` for how the rest is found and ``worker.py`` for what a run
does. A cell on one chip runs in this process; on more, this process
starts one worker per chip with the port's launcher (``python -m
horovod_tpu_torch.runner -np <chips> --launcher local``), as users start
a Horovod job, each worker running ``launched.py``; rank 0 hands its
result back through a file in a temporary directory (under ``TMPDIR``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, the card's peaks and power limit and each card's SM clock,
power draw and temperature in the window (``card.py``) under ``card``,
and last ``checks``: each number compared with its limit, also printed as
the last lines of standard error. Without the cards the cell asks for, or if JAX
or the JAX package was loaded, the run exits non-zero and prints no
result.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: seconds a multi-chip run's workers may take in all
WORKER_TIMEOUT_S = 330


def _launch(cell, args) -> dict:
    """Run the cell's workers under the port's launcher; rank 0's result."""
    from perfbench import worker
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    out = os.path.join(tmp, "result.json")
    env = {**os.environ, **worker.cache_env(), "PYTHONPATH": ROOT}
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "-np", str(cell.chips), "--launcher", "local",
           sys.executable, "-m", "perfbench.launched",
           "--workload", cell.name, "--seed", str(args.seed),
           "--seconds", str(args.seconds), "--trace", str(args.trace),
           "--started", repr(STARTED), "--out", out]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, start_new_session=True,
                            stdout=sys.stderr)
    try:
        code = proc.wait(timeout=WORKER_TIMEOUT_S - (time.time() - STARTED))
    except subprocess.TimeoutExpired:
        code = None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    try:
        if code != 0:
            raise SystemExit(f"the workers failed (launcher exit {code})")
        with open(out) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def result_line(cell, r: dict, trace: bool) -> dict:
    """The result line's fields in their order, ``checks`` last."""
    from perfbench import check, counts, stats
    correct, rows = check.judge(r["gaps"], r["limits"])
    if trace:
        ranks = r["per_rank_metrics"]
        names = [m["name"] for m in cell.per_layer]
        values = {n: sum(m[n] for m in ranks) / len(ranks) for n in names
                  if all(n in m for m in ranks)}
        units = {m["name"]: m["unit"] for m in cell.per_layer}
    else:
        values = stats.window_metrics(r["window_seconds"], r["step_ms"])
        values["setup_s"] = r["setup_s"]
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = {n: values[n] for n in units}
    device = {"platform": "gpu", "kind": r["device_name"],
              "count": cell.chips,
              "memory_peak_bytes": r["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": r["attempted"],
            "failed": r["failed"],
            "metrics": {n: {"value": v, "unit": units[n]}
                        for n, v in values.items()},
            "device": device}
    if trace:
        device["busy_s"] = sum(r["busy_s"]) / len(r["busy_s"])
        device["window_s"] = max(r["window_s"])
        line["breakdown"] = r["breakdown"]
    line["card"] = {"power_limit": counts.power_limit(),
                    "peaks": counts.peaks(r["device_name"]),
                    "in_window": r["card_in_window"]}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in rows}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from perfbench import spec, worker
    cell = spec.cell(args.workload)
    import horovod_tpu_torch  # noqa: F401  the system under test
    worker.need_cards(cell.chips)
    if cell.chips == 1:
        r = worker.run_rank(cell.name, args.seed, args.seconds,
                            bool(args.trace), STARTED)
    else:
        r = _launch(cell, args)
    forbidden = sorted(set(r["forbidden"])
                       | set(spec.forbidden_loaded(list(sys.modules))))
    if forbidden:
        sys.stderr.write(f"forbidden modules were loaded: {forbidden}\n")
        return 3
    line = result_line(cell, r, bool(args.trace))
    sys.stderr.write(f"gaps read (those with a limit are compared): "
                     f"{json.dumps(r['gaps'])}\n")
    sys.stderr.write(f"cards in the window: "
                     f"{json.dumps(line['card']['in_window'])}\n")
    for name, c in line["checks"].items():
        sys.stderr.write(f"check {name} = {c['value']!r} limit "
                         f"{c['limit']!r}\n")
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
