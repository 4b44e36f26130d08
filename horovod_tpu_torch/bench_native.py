"""Times, on one GPU, what the native host runtime could move on the
card: the flash kernel's launches at the serving shapes while a serving
engine runs, and the in-process world reset, each in child processes on
the native runtime and under ``HVD_TPU_NATIVE=0``, taken in turns.

    python3 -m horovod_tpu_torch.bench_native [--order NPPN]
        [--windows 15] [--resets 5] [--out PATH]

Each child (``N``: the native runtime, ``P``: ``HVD_TPU_NATIVE=0``)
makes one world on the card at size 1 and:

1. times ``flash_fwd_cuda`` at BH 12 and BH 24 (S 2048, D 64, bf16,
   causal: serving buckets 1 and 2 of the default TransformerConfig) in
   ``--windows`` windows of 20 launches each, as ``chip_smoke.py``'s
   ``cuda_ms`` does (2 warm-up launches, then CUDA events around 20), with
   nothing else running ("init");
2. starts the serving phase's engine (the default TransformerConfig,
   weights from seed 3, served from a checkpoint with a 0.2 s reload
   poll, buckets 1, 2, 4, 8, every request traced), answers one wave of
   64 one-row requests from 8 clients, and times the same windows while
   the engine and its server stay up ("serving"); then closes the server
   and the engine, as ``chip_smoke.py``'s serving phase does before it
   times the kernel, and times them again ("after_serving"), and at BH
   12 with the garbage collector disabled ("after_serving_gc_off");
3. traces one BH 12 window after serving with torch.profiler: each
   kernel's device time, and the time from one kernel's start to the
   next one's (the launch interval the host sets);
4. times ``elastic.run.reset`` (drain, shutdown, init) ``--resets``
   times, then as many ``shutdown()`` and ``init()`` calls apart.

For every window it records the wall time of the host's launch loop and
the garbage collections that ran inside it (generation and ms, through
``gc.callbacks``). The parent prints one JSON line per child and a
summary line (per mode and context: the least, the median and the
greatest window), with the card's name and power limit, and writes
everything to ``--out``.
"""

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

BHS = (12, 24)
ITERS = 20
WARMUP = 2
SEQ, HEAD_DIM = 2048, 64
SERVE_BUCKETS = (1, 2, 4, 8)
WAVE_CLIENTS, WAVE_REQUESTS = 8, 8


class _GcWatch:
    """Collections that start and end while it is armed: (generation,
    ms) for each."""

    def __init__(self):
        self.armed = False
        self.seen = []
        self._t0 = None

    def __call__(self, phase, info):
        if not self.armed:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seen.append((info["generation"],
                              1e3 * (time.perf_counter() - self._t0)))
            self._t0 = None


def _windows(torch, fa, qkv, n, watch):
    q, k, v = qkv
    rows = []
    for _ in range(n):
        for _ in range(WARMUP):
            fa.flash_fwd_cuda(q, k, v, 0, 0, True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        watch.seen = []
        watch.armed = True
        t0 = time.perf_counter()
        start.record()
        for _ in range(ITERS):
            fa.flash_fwd_cuda(q, k, v, 0, 0, True)
        end.record()
        host_s = time.perf_counter() - t0
        end.synchronize()
        watch.armed = False
        rows.append({"ms": start.elapsed_time(end) / ITERS,
                     "host_us_per_launch": 1e6 * host_s / ITERS,
                     "gc": list(watch.seen)})
    return rows


def _profile(torch, fa, qkv):
    """One window of ITERS launches under torch.profiler: the kernel's
    device us per launch and the us from one kernel's start to the
    next's, read from the exported Chrome trace (None when the profiler
    saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = qkv
    for _ in range(WARMUP):
        fa.flash_fwd_cuda(q, k, v, 0, 0, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fa.flash_fwd_cuda(q, k, v, 0, 0, True)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and "flash" in e.get("name", "")),
                     key=lambda e: e["ts"])
    if not kernels:
        return {"kernels_seen": 0, "device_us": None, "start_to_start_us": None}
    durs = [float(e["dur"]) for e in kernels]
    gaps = [float(b["ts"]) - float(a["ts"])
            for a, b in zip(kernels, kernels[1:])]
    return {"kernels_seen": len(kernels),
            "device_us": statistics.median(durs),
            "device_us_max": max(durs),
            "start_to_start_us": statistics.median(gaps) if gaps else None,
            "start_to_start_us_max": max(gaps) if gaps else None}


def _serving(torch, work, cfg):
    """The serving phase's engine and server (module docstring, 2),
    after one wave of requests; returns (engine, server)."""
    import dataclasses
    import urllib.request
    import numpy as np
    from horovod_tpu_torch import checkpointing as cp
    from horovod_tpu_torch import serving, tracing
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.parallel import flash_attention_fn
    mgr = cp.CheckpointManager(os.path.join(work, "ckpt"))
    live = Transformer(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(3))
    mgr.save(1, {n: p.detach() for n, p in live.named_parameters()},
             async_=False)
    del live
    model = Transformer(dataclasses.replace(
        cfg, attention_fn=flash_attention_fn), device="meta")

    def apply(params, x):
        logits = torch.func.functional_call(model, params, (x.long(),))
        last = torch.log_softmax(logits[:, -1], dim=-1)
        lp, tok = last.max(dim=-1)
        return torch.stack([tok.float(), lp], dim=-1)
    os.environ.update({"HVD_TPU_TRACE_SAMPLE": "1",
                       "HVD_TPU_TRACE_DIR": os.path.join(work, "spans")})
    tracing.reset()
    engine = serving.InferenceEngine(
        apply, checkpoint_dir=mgr.directory, max_batch=max(SERVE_BUCKETS),
        buckets=SERVE_BUCKETS, batch_timeout_ms=5.0, queue_depth=64,
        deadline_ms=0, reload_poll_seconds=0.2, warmup=True,
        example=np.zeros(cfg.max_seq_len, np.float32))
    server = serving.InferenceServer(engine, port=0, addr="127.0.0.1")
    url = f"http://127.0.0.1:{server.start()}/v1/infer"
    rng = np.random.RandomState(0)
    rows = rng.randint(0, cfg.vocab_size,
                       (WAVE_CLIENTS * WAVE_REQUESTS, cfg.max_seq_len))
    codes = []

    def client(c):
        for j in range(WAVE_REQUESTS):
            body = json.dumps({"inputs": [
                rows[c * WAVE_REQUESTS + j].tolist()]}).encode()
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                codes.append(resp.status)
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(WAVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if codes.count(200) != WAVE_CLIENTS * WAVE_REQUESTS:
        raise AssertionError(f"the wave was not answered: {codes}")
    return engine, server


def _resets(torch, n):
    import importlib
    from horovod_tpu_torch import basics
    # (the package's ``elastic.run`` is the decorator; the module is this)
    run_mod = importlib.import_module("horovod_tpu_torch.elastic.run")
    out = {"reset_ms": [], "shutdown_ms": [], "init_ms": []}
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_mod.reset(None)
        torch.cuda.synchronize()
        out["reset_ms"].append(1e3 * (time.perf_counter() - t0))
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        basics.shutdown()
        t1 = time.perf_counter()
        basics.init()
        torch.cuda.synchronize()
        out["shutdown_ms"].append(1e3 * (t1 - t0))
        out["init_ms"].append(1e3 * (time.perf_counter() - t1))
    return out


def child(mode: str, out_path: str, windows: int, resets: int) -> int:
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _native
    from horovod_tpu_torch.models import TransformerConfig
    from horovod_tpu_torch.ops import flash_attention as fa
    hvd.init()
    cfg = TransformerConfig()
    gen = torch.Generator(device="cuda").manual_seed(11)
    qkv = {bh: tuple(torch.randn(bh, SEQ, HEAD_DIM, generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for _ in range(3)) for bh in BHS}
    watch = _GcWatch()
    gc.callbacks.append(watch)
    res = {"mode": mode, "native": _native.available(),
           "library": _native.path,
           "init": {bh: _windows(torch, fa, qkv[bh], windows, watch)
                    for bh in BHS}}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out_path)) as work:
        engine, server = _serving(torch, work, cfg)
        res["serving"] = {bh: _windows(torch, fa, qkv[bh], windows, watch)
                          for bh in BHS}
        server.close()       # closes the engine too, as chip_smoke.py's
        res["after_serving"] = {bh: _windows(torch, fa, qkv[bh], windows,
                                             watch) for bh in BHS}
        gc.disable()
        res["after_serving_gc_off"] = {
            12: _windows(torch, fa, qkv[12], windows, watch)}
        gc.enable()
        res["profile_bh12"] = _profile(torch, fa, qkv[12])
    res["threads_after_serving"] = sorted(t.name for t in
                                          threading.enumerate())
    res["resets"] = _resets(torch, resets)
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def _summary(runs):
    """Per mode and context: least, median and greatest window ms, host
    us per launch and the windows a collection ran in."""
    out = {}
    for r in runs:
        m = out.setdefault(r["mode"], {})
        for ctx in ("init", "serving", "after_serving",
                    "after_serving_gc_off"):
            for bh, rows in r[ctx].items():
                cell = m.setdefault(f"{ctx}_bh{bh}", {
                    "ms": [], "host_us": [], "windows_with_gc": 0,
                    "windows": 0})
                cell["ms"] += [x["ms"] for x in rows]
                cell["host_us"] += [x["host_us_per_launch"] for x in rows]
                cell["windows_with_gc"] += sum(1 for x in rows if x["gc"])
                cell["windows"] += len(rows)
        for k, v in r["resets"].items():
            m.setdefault(k, []).extend(v)
        m.setdefault("profile_bh12", []).append(r["profile_bh12"])
    for m in out.values():
        for key, cell in list(m.items()):
            if isinstance(cell, dict):
                for k in ("ms", "host_us"):
                    xs = cell[k]
                    cell[k] = {"min": min(xs), "median": statistics.median(xs),
                               "max": max(xs)}
            elif key.endswith("_ms"):
                m[key] = {"min": min(cell), "median": statistics.median(cell),
                          "max": max(cell), "all": cell}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", default="NPPN")
    ap.add_argument("--windows", type=int, default=15)
    ap.add_argument("--resets", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(
        "chiprun_out", "bench_native.json"))
    ap.add_argument("--child", nargs=2, metavar=("MODE", "OUT"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_native: needs a CUDA device")
    if args.child:
        return child(args.child[0], args.child[1], args.windows,
                     args.resets)
    if set(args.order) - set("NP"):
        raise SystemExit("--order takes N and P only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = []
    for i, mode in enumerate(args.order):
        env = dict(os.environ)
        env.pop("HVD_TPU_NATIVE", None)
        if mode == "P":
            env["HVD_TPU_NATIVE"] = "0"
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        path = os.path.join(out_dir, f"bench_native_{i}{mode}.json")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.bench_native",
             "--windows", str(args.windows), "--resets", str(args.resets),
             "--child", mode, path], env=env, cwd=root,
            capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"bench_native: child {i} ({mode}) exited "
                             f"{r.returncode}")
        with open(path) as f:
            run = json.load(f)
        if run["native"] != (mode == "N"):
            raise SystemExit(f"bench_native: child {i} ({mode}) loaded "
                             f"native={run['native']}")
        run["seconds"] = time.perf_counter() - t0
        runs.append(run)
        print(json.dumps({"child": i, "mode": mode,
                          "seconds": run["seconds"],
                          "profile_bh12": run["profile_bh12"],
                          "resets": run["resets"]}), flush=True)
    summary = {"card": card.strip(), "order": args.order,
               "iters": ITERS, "windows": args.windows,
               "summary": _summary(runs)}
    with open(args.out, "w") as f:
        json.dump({**summary, "runs": runs}, f)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
