"""One rank's run of a cell: set-up, the checked steps, the measured
window, with ``--trace 1`` the phase events and the profiled sub-window,
and the comparison with the plain reference.

``run.py`` calls :func:`run_rank` in its own process for a cell on one
chip; for more chips it starts one process per chip with the port's
launcher, each running ``launched.py``, and rank 0 writes the result to
the path given by ``--out``.

The steps of a run:

1. Set-up: the port's world (``hvd.init``), the system under test built
   from the family's file (``families/<family>.py``), rank 0's weights
   drawn on the device from the seed and copied in, every rank's copy
   set by ``hvd.broadcast_parameters``, and this rank's pool of batches
   drawn from (seed, rank).
2. The checked steps: three steps through the window's own call, on the
   pool's first three batches, read as ``check.py`` says. They also warm
   up every shape the window uses. Their time sets the window's number
   of steps, ``--seconds`` over the time of one step, agreed once by all
   ranks.
3. The window: that many steps back to back (a closed loop; the host
   reads nothing of a step), a CUDA event at each step's end. It starts
   after a device synchronize (and a barrier across ranks) and ends with
   one; set-up ends where it starts. With ``--trace 1`` the same window
   also records CUDA events at the model's forward (module hooks) and at
   the optimizer's ``step`` (a wrapper around the instance's method),
   and times that ``step`` on the host; then ``trace_steps`` more steps
   run under ``torch.profiler`` twice: once recording the device alone,
   once with every host operation too (``trace.py``).
4. The system under test is freed and the world shut down; rank 0 runs
   the reference over the same weights and global batches, three steps,
   and compares.
"""

import argparse
import gc
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: the harness's own files in a checkout (the program's compile caches)
OUT_DIR = os.path.join(ROOT, "build", "perfbench")


def cache_env() -> Dict[str, str]:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run in a checkout builds or compiles anything. The flash
    kernel's library and the native host runtime build into the port's
    own fixed ``build/torch_kernels`` and ``build/torch_native``."""
    base = os.path.join(OUT_DIR, "cache")
    return {"TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": os.path.join(base, "inductor")}


def _setup_path() -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    os.environ.update(cache_env())


_setup_path()

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from perfbench import card, check, counts, feed, spec, stats  # noqa: E402
from perfbench.reference import exact_float32, optim  # noqa: E402
from perfbench.reference.precision import Precision  # noqa: E402
from perfbench.trace import WINDOW_SPAN, Trace, TracedRun  # noqa: E402


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.detach().float().norm()) for n, t in tensors.items()}


class _Mark:
    """A point in time on the device's stream (a CUDA event) or, on the
    CPU, on the host's clock."""

    def __init__(self, cuda: bool):
        self.event = None
        if cuda:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.t = time.perf_counter()

    def ms_to(self, later: "_Mark") -> float:
        if self.event is not None:
            return self.event.elapsed_time(later.event)
        return 1e3 * (later.t - self.t)


class Phases:
    """CUDA events at each step's phases, taken from outside the program:
    a forward pre-hook and a forward hook on the model, and a wrapper
    around the optimizer instance's ``step`` (an attribute of the
    instance, removed again by :meth:`remove`), which also times the
    call on the host. Per step: ``forward`` (the model's forward, device
    ms), ``backward`` (the forward's end to the optimizer step's start:
    the loss, the backward and the bucket launches inside it, device ms)
    and ``drain`` (the host ms of ``optimizer.step()``: the wait for the
    buckets' reductions and the inner update)."""

    def __init__(self, model, optimizer, cuda: bool):
        self.model, self.optimizer, self.cuda = model, optimizer, cuda
        self.marks: List[Dict[str, _Mark]] = []
        self.drain_s: List[float] = []
        self._handles = [model.register_forward_pre_hook(self._pre),
                         model.register_forward_hook(self._post)]
        inner = optimizer.step

        def step(*args, **kwargs):
            self._mark("step")
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            self.drain_s.append(time.perf_counter() - t0)
            return out
        optimizer.step = step

    def _mark(self, label: str) -> None:
        self.marks[-1][label] = _Mark(self.cuda)

    def _pre(self, module, args):
        self.marks.append({})
        self._mark("forward")

    def _post(self, module, args, out):
        self._mark("forward_end")

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        del self.optimizer.step

    def per_step(self) -> List[Dict[str, float]]:
        """Each step's phases in ms (read after a synchronize)."""
        return [{"forward": m["forward"].ms_to(m["forward_end"]),
                 "backward": m["forward_end"].ms_to(m["step"]),
                 "drain": 1e3 * d}
                for m, d in zip(self.marks, self.drain_s)]


class Rank:
    """This process's part of a run."""

    def __init__(self, cell: spec.Cell, seed: int, device=None):
        import horovod_tpu_torch as hvd
        self.cell, self.seed = cell, seed
        self.hvd = hvd
        hvd.init(device=device)
        self.rank, self.size = hvd.rank(), hvd.size()
        if self.size != cell.chips:
            raise RuntimeError(f"cell {cell.name} runs on {cell.chips} chips, "
                               f"the world has {self.size} processes")
        self.device = hvd.basics.world().device
        self.cuda = self.device.type == "cuda"
        # the harness's own bookkeeping goes over gloo, apart from the
        # port's NCCL collectives
        self.group = dist.new_group(backend="gloo") if self.size > 1 else None
        self.family = cell.family
        self.program = None

    # -- set-up ---------------------------------------------------------------
    def build(self) -> None:
        cell, fam = self.cell, self.family
        weights = None
        if self.rank == 0:   # the others receive rank 0's by broadcast
            weights = feed.make_weights(fam.leaves(cell.config), self.seed,
                                        self.device)
        self.program = fam.Program(cell.config, cell.traffic, weights,
                                   self.device)
        del weights
        x, y = feed.batches(cell.traffic, fam.classes(cell.config),
                            self.seed, self.rank, self.device)
        self.pool = [self.program.batch(x[i], y[i]) for i in range(x.shape[0])]
        del x, y

    def batch(self, i: int):
        return self.pool[i % len(self.pool)]

    def checked_steps(self) -> dict:
        """The first three steps through the window's call, read as
        ``check.py`` says; returns the readings and the seconds of the
        last two steps."""
        prog = self.program
        initial = {n: p.detach().clone() for n, p in prog.named_parameters()}
        initial_bufs = {n: b.detach().clone()
                        for n, b in prog.named_buffers().items()}
        losses, seconds, grad = [], [], None
        for k in range(3):
            t0 = time.perf_counter()
            losses.append(float(prog.step(*self.batch(k))))
            seconds.append(time.perf_counter() - t0)
            if k == 0:
                grad = _norms(prog.first_grads(initial))
        change = {n: float((p.detach() - initial[n]).norm())
                  for n, p in prog.named_parameters()}
        moved = {n: float((b.detach().float() - initial_bufs[n]).norm())
                 for n, b in prog.named_buffers().items()}
        del initial, initial_bufs
        # the global batch's mean loss: every rank holds as many rows
        losses = [self.agree(v, "sum") / self.size for v in losses]
        return {"losses": losses, "grad": grad, "change": change,
                "stats": moved, "step_s": sum(seconds[1:]) / 2}

    def agree(self, value: float, op: str) -> float:
        """``value`` reduced over the ranks (max or sum) on the harness's
        group."""
        if self.size == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()),
                        group=self.group)
        return float(t[0])

    def gather(self, obj):
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
        if self.size > 1:
            dist.barrier(group=self.group)

    # -- the window -----------------------------------------------------------
    def window(self, steps: int, phases: Optional[Phases] = None) -> dict:
        """``steps`` steps back to back from batch 3 on; the wall-clock
        time it started, its seconds, each step's device milliseconds and
        the count of steps whose loss was not finite."""
        prog = self.program
        losses = torch.empty(steps, device=self.device)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)] if self.cuda else []
        self.barrier()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        started = time.time()
        t0 = time.perf_counter()
        if self.cuda:
            events[0].record()
        for i in range(steps):
            losses[i].copy_(prog.step(*self.batch(3 + i)), non_blocking=True)
            if self.cuda:
                events[i + 1].record()
        if self.cuda:
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])] \
            if self.cuda else [1e3 * seconds / steps] * steps
        return {"started": started, "seconds": seconds, "step_ms": step_ms,
                "failed": int((~torch.isfinite(losses)).sum())}

    def profiled(self, steps: int, first: int) -> dict:
        """``steps`` steps under ``torch.profiler`` twice, from batch
        ``first`` on: the device's trace (CUDA activity alone, between
        two marker kernels) and the host's (CPU and CUDA activities,
        inside the host span ``WINDOW_SPAN``); see ``trace.py``. One step
        runs under each profiler before its window, so the profiler's
        start-up is not in it. A trace goes to a temporary file (under
        ``TMPDIR``), is read back and deleted."""
        from torch.profiler import ProfilerActivity, profile, record_function
        prog = self.program
        losses = torch.empty(2, steps + 1, device=self.device)
        host = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])

        def run_steps(out, start):
            for i, slot in enumerate(out):
                slot.copy_(prog.step(*self.batch(start + i)),
                           non_blocking=True)

        def traced(k: int, activities, marked: bool) -> Trace:
            start = first + k * (steps + 1)
            self.barrier()
            with profile(activities=activities) as prof:
                run_steps(losses[k, :1], start)
                self.barrier()
                if marked:
                    torch.cuda._sleep(1000)
                    run_steps(losses[k, 1:], start + 1)
                    torch.cuda._sleep(1000)
                    torch.cuda.synchronize(self.device)
                else:
                    with record_function(WINDOW_SPAN):
                        run_steps(losses[k, 1:], start + 1)
                        if self.cuda:
                            torch.cuda.synchronize(self.device)
            fd, path = tempfile.mkstemp(prefix="perfbench-trace-",
                                        suffix=".json")
            os.close(fd)
            try:
                prof.export_chrome_trace(path)
                return Trace.load(path)
            finally:
                os.remove(path)
        device = traced(0, [ProfilerActivity.CUDA], True) if self.cuda \
            else traced(0, host, False)
        return {"device": device, "host": traced(1, host, False),
                "failed": int((~torch.isfinite(losses)).sum())}

    def checksums(self) -> List[List[float]]:
        """Each leaf's sum and sum of squares in float64: equal on every
        rank after an exchange that gave every rank the same average."""
        out = []
        with torch.no_grad():
            for _, p in self.program.named_parameters():
                d = p.detach().double()
                out.append([float(d.sum()), float((d * d).sum())])
        return out

    def peak_memory(self) -> int:
        """The peak device memory this process allocated in the window
        (the peak is reset where the window starts)."""
        if not self.cuda:
            return 0
        return torch.cuda.max_memory_allocated(self.device)

    def drop_program(self) -> None:
        """Free the system under test's device memory: its gradients, its
        optimizer's state and hooks, and its parameters' storage (held
        empty, so that whatever may still refer to a parameter holds no
        memory), then the program and the pool."""
        prog = self.program
        if prog is not None:
            opt = prog.optimizer
            if hasattr(opt, "remove_hooks"):
                opt.remove_hooks()
            getattr(opt, "_opt", opt).state.clear()
            with torch.no_grad():
                for p in prog.model.parameters():
                    p.grad = None
                    p.data = p.data.new_empty(0)
        self.program = self.pool = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def close(self) -> None:
        """Free the system under test and shut the world down."""
        self.drop_program()
        self.hvd.shutdown()


# -- the reference ------------------------------------------------------------

def reference_readings(cell: spec.Cell, seed: int, device,
                       precision: str = "fp32", rows=None) -> dict:
    """The reference's readings over the cell's first three global
    batches (all chips' rows, or the rows ``rows`` selects: a planted
    fault), from the seed's weights, in ``precision``."""
    fam, ref = cell.family, cell.reference
    prec = Precision(precision)
    w = feed.make_weights(fam.leaves(cell.config), seed, device)
    w0 = {n: t.clone() for n, t in w.items()}
    bufs = fam.buffers(cell.config, device)
    b0 = {n: t.clone() for n, t in bufs.items()}
    opt = optim.make(cell.traffic["optimizer"])
    classes = fam.classes(cell.config)
    losses, grad = [], None
    with exact_float32():
        for k in range(3):
            xb, yb = feed.global_batch(cell.traffic, classes, seed,
                                       cell.chips, k, device)
            if rows is not None:
                xb, yb = xb[rows], yb[rows]
            loss, grads, batch_stats = ref.loss_and_grads(
                w, (xb, yb), cell.config, prec)
            if k == 0:
                grad = _norms(grads)
            opt.step(w, grads)
            ref.update_running(bufs, batch_stats, cell.config)
            losses.append(loss)
            del grads, batch_stats, xb, yb
    out = {"losses": losses, "grad": grad,
           "change": {n: float((w[n] - w0[n]).norm()) for n in w},
           "stats": {n: float((bufs[n] - b0[n]).norm()) for n in bufs}}
    del w, w0, bufs, b0
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


# -- one run ----------------------------------------------------------------

def _log(rank: int, started: float, what: str) -> None:
    """A line on standard error: the seconds since the run started."""
    sys.stderr.write(f"perfbench: rank {rank} +{time.time() - started:.2f}s "
                     f"{what}\n")


def run_rank(workload: str, seed: int, seconds: float, trace: bool,
             started: float, device=None, root: str = spec.ROOT,
             check_chip: bool = True) -> Optional[dict]:
    """This process's part of one run of ``workload``. Rank 0 returns the
    result's fields (``run.py`` prints them); other ranks return None.
    ``check_chip=False`` skips the look for a card (the CPU tests)."""
    cell = spec.cell(workload, root)
    if check_chip and device is None:
        need_cards(cell.chips)
    me = Rank(cell, seed, device)
    _log(me.rank, started, "world up")
    me.build()
    _log(me.rank, started, "program built, weights and batches made")
    readings = me.checked_steps()
    step_s = me.agree(readings.pop("step_s"), "max")
    steps = max(3, math.ceil(seconds / step_s))
    _log(me.rank, started, f"checked steps done: {step_s:.4f} s a step, "
         f"{steps} steps in the window")
    phases = Phases(me.program.model, me.program.optimizer, me.cuda) \
        if trace else None
    with card.Sampler(me.device.index or 0) as sampler:
        w = me.window(steps, phases)
    out = {"setup_s": me.agree(w["started"] - started, "max"),
           "window_seconds": me.agree(w["seconds"], "max"),
           "step_ms": stats.slowest_rank(me.gather(w["step_ms"])),
           "attempted": steps,
           "card_in_window": me.gather(sampler.summary())}
    failed = w["failed"]
    out["memory_peak_bytes"] = int(me.agree(me.peak_memory(), "max"))
    if trace:
        phases.remove()
        t = me.profiled(cell.traffic["trace_steps"], 3 + steps)
        failed += t["failed"]
        out["attempted"] += 2 * cell.traffic["trace_steps"] + 2
        run = TracedRun(
            trace=t["device"], host_trace=t["host"],
            steps=cell.traffic["trace_steps"],
            phases=phases.per_step(),
            window_s=out["window_seconds"], step_ms=out["step_ms"],
            config=cell.config, traffic=cell.traffic, chips=cell.chips,
            flops_per_step=cell.family.flops_per_step(cell.config,
                                                      cell.traffic),
            peaks=counts.peaks(device_name(me.device)) or {})
        mine = {}
        for m in cell.per_layer:
            value = spec.load_metric(m["name"], cell.root).read(run)
            if value is not None:
                mine[m["name"]] = float(value)
        out.update(per_rank_metrics=me.gather(mine),
                   busy_s=me.gather(t["device"].busy_s),
                   window_s=me.gather(t["device"].window_s),
                   breakdown={"device_ops": t["device"].top_device_ops(),
                              "idle_gaps": t["host"].idle_gaps()})
    _log(me.rank, started, "window done")
    out["failed"] = int(me.agree(failed, "sum"))
    sums = me.gather(me.checksums()) if me.size > 1 else None
    out["forbidden"] = sorted(set(sum(me.gather(
        spec.forbidden_loaded(list(sys.modules))), [])))
    out["device_name"] = device_name(me.device)
    me.close()
    if me.rank != 0:
        return None
    ref = reference_readings(cell, seed, me.device)
    _log(me.rank, started, "reference done")
    out["gaps"] = check.gaps(readings, ref)
    if sums is not None:
        out["gaps"]["ranks_differ"] = check.ranks_differ(sums)
    out["limits"] = cell.limits
    return out


def device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def need_cards(n: int) -> None:
    """Exit non-zero unless this machine has ``n`` CUDA cards."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on NVIDIA GPUs")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} CUDA devices, this machine has "
                         f"{torch.cuda.device_count()}")


def main(argv=None) -> int:
    """A launched rank of a multi-chip run: ``--out`` receives rank 0's
    result as JSON."""
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--started", type=float, required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    result = run_rank(a.workload, a.seed, a.seconds, bool(a.trace), a.started)
    if result is not None:
        tmp = a.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, a.out)
    return 0
