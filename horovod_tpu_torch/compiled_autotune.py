"""Compiled-plane autotuning: pick the fastest reduction variant by
measurement, identically on every process (counterpart of
``horovod_tpu/compiled_autotune.py``).

The reference tunes its hot path online, scored on measured throughput,
with rank 0's choice broadcast to all workers (reference:
horovod/common/parameter_manager.h:33-105, controller.cc:33-47
SynchronizeParameters). The compiled plane's
decision is which reduction a step runs:

* the strategy: ``hierarchical`` (the mean over the inner mesh dim
  first, then the outer dim, the NCCLHierarchicalAllreduce shape) or
  ``flat`` (one collective over both);
* the packing: ``per_leaf`` (one reduction per gradient) or ``packed``
  (one flat buffer per dtype bucket, the fusion-buffer shape).

Protocol: every process times each variant in the same order (variants
issue collectives, so all processes run them in lockstep); then rank 0's
fastest is broadcast and adopted everywhere. On the card each call is
followed by ``torch.cuda.synchronize`` (the JAX package's
``block_until_ready``). The eager fusion threshold keeps its own online
tuner (``parameter_manager.py``).
"""

import time
from typing import Callable, Dict, Sequence, Tuple

import torch

from . import basics as _basics
from . import collectives as _c
from . import config as _config
from . import metrics as _metrics

_M_VARIANTS = _metrics.counter(
    "hvd_tpu_autotune_compiled_variants_total",
    "Compiled-plane program variants measured by autotune_variants().")
_M_TUNES = _metrics.counter(
    "hvd_tpu_autotune_compiled_tunes_total",
    "Completed compiled-plane tuning rounds (one variant adopted "
    "world-wide per round).")


def _finish(w) -> None:
    if w.device.type == "cuda":
        torch.cuda.synchronize(w.device)


def autotune_variants(variants: Dict[str, Callable], args: Sequence = (),
                      warmup: int = 1, iters: int = 3,
                      key: str = "default"
                      ) -> Tuple[str, Callable, Dict[str, float]]:
    """Measure each variant and return ``(chosen_name, chosen_fn, times)``.

    Variants run in sorted-name order on every process, each ``warmup``
    calls and then ``iters`` timed ones (seconds a call in ``times``). The
    choice is rank 0's argmin, broadcast so that every process adopts the
    same variant."""
    if not variants:
        raise ValueError("no variants to tune over")
    w = _basics.world()
    names = sorted(variants)
    times: Dict[str, float] = {}
    for n in names:
        fn = variants[n]
        for _ in range(max(0, warmup)):
            fn(*args)
            _finish(w)
        t0 = time.perf_counter()
        for _ in range(max(1, iters)):
            fn(*args)
            _finish(w)
        times[n] = (time.perf_counter() - t0) / max(1, iters)
        _M_VARIANTS.inc()
    best_idx = names.index(min(names, key=lambda n: times[n]))
    if w.size > 1:
        out = _c.broadcast(torch.tensor([best_idx], dtype=torch.int32),
                           root_rank=0,
                           name=f"hvd_tpu.autotune.compiled.{key}")
        best_idx = int(out[0])
    chosen = names[best_idx]
    _M_TUNES.inc()
    _log_choice(w, key, chosen, times)
    return chosen, variants[chosen], times


def _log_choice(w, key: str, chosen: str, times: Dict[str, float]) -> None:
    path = w.config.get(_config.AUTOTUNE_LOG)
    if not path or w.rank != 0:
        return
    try:
        with open(path, "a") as f:
            f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} compiled[{key}] "
                    f"chose {chosen}; times="
                    + ", ".join(f"{k}={v:.6f}s" for k, v in
                                sorted(times.items())) + "\n")
    except OSError:
        pass


def tune_distributed_step(make_step: Callable[..., Callable],
                          args: Sequence = (),
                          strategies: Sequence[str] = ("hierarchical",
                                                       "flat"),
                          packings: Sequence[str] = ("per_leaf", "packed"),
                          warmup: int = 1, iters: int = 3,
                          key: str = "train_step"
                          ) -> Tuple[dict, Callable]:
    """Tune a training step over the compiled-plane reduction options.

    ``make_step(reduce_strategy=..., packing=...)`` returns a callable,
    typically a step around a ``DistributedOptimizer(axis_name=...,
    inner_axis=..., reduce_strategy=..., packing=...)``. Every combination
    is built and measured; the fastest (rank 0's) wins. Returns
    ``({"reduce_strategy": s, "packing": p}, step_fn)``.

    Example::

        def make_step(reduce_strategy, packing):
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.01),
                named_parameters=model.named_parameters(),
                axis_name="cross", inner_axis="local",
                reduce_strategy=reduce_strategy, packing=packing)
            def step(x, y):
                opt.zero_grad()
                loss_fn(model(x), y).backward()
                opt.step()
            return step
        options, step = tune_distributed_step(make_step, (x, y))
    """
    variants = {
        f"{s}/{p}": make_step(reduce_strategy=s, packing=p)
        for s in strategies for p in packings}
    chosen, fn, _ = autotune_variants(
        variants, args, warmup=warmup, iters=iters, key=key)
    s, p = chosen.split("/", 1)
    return {"reduce_strategy": s, "packing": p}, fn
