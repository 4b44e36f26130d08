"""Online autotuning of the fusion threshold, scored by throughput
(counterpart of ``horovod_tpu/parameter_manager.py``).

Analogue of the reference ParameterManager (horovod/common/
parameter_manager.{h,cc}: warmup/sample schedule scoring bytes/sec). The
tuned surface is the **fusion threshold** (gradient bucket size), the
latency/overlap trade the reference tunes its threshold for: the port's
``DistributedOptimizer`` re-plans its buckets at the next step boundary
whenever the threshold changes.

Protocol (the JAX package's, step for step):

* every reduction step of ``DistributedOptimizer`` reports
  ``record(bytes, seconds)`` (timed with a device sync, only while
  tuning is active);
* after ``HVD_TPU_AUTOTUNE_STEPS_PER_SAMPLE`` steps a sample completes with
  score = bytes/sec; the first ``HVD_TPU_AUTOTUNE_WARMUP_SAMPLES`` samples
  of a phase are discarded;
* each scored sample feeds the optimizer, which proposes the next value.
  The port has no native GP/BO (the JAX package's ``_native``): it always
  uses the deterministic Python optimizer, the JAX package's fallback
  (its path under ``HVD_TPU_NATIVE=0``);
* after ``HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES`` samples the knob locks
  on the best value seen and tuning moves to the next knob: the fusion
  threshold, then ``HVD_TPU_PACK_CUTOFF``. The port's grouped allreduce
  packs every member, so nothing reads the cutoff (ROADMAP B5); its phase
  runs as the JAX package's does, so the schedule is the same.

Cross-process agreement (reference controller.cc:33-47
SynchronizeParameters): divergent thresholds would give processes
different buckets, i.e. different collective sequences, so in a
multi-process world rank 0's proposal is broadcast at every sample
boundary (a collective, so through the dispatcher thread in the process's
one order of wire calls); boundaries align because every process counts
the same ``record()`` calls.
"""

import math
import time
from typing import Optional

from . import config as _config
from . import metrics as _metrics

# The live tuned values as gauges: when throughput shifts after a knob
# lock, the operator sees WHICH threshold the tuner settled on without
# grepping the autotune log.
_M_FUSION_GAUGE = _metrics.gauge(
    "hvd_tpu_autotune_fusion_threshold_bytes",
    "Current gradient-bucket fusion threshold (autotuned or configured).")
_M_CUTOFF_GAUGE = _metrics.gauge(
    "hvd_tpu_autotune_pack_cutoff_bytes",
    "Current host-packing cutoff (autotuned or configured).")
_M_SAMPLES = _metrics.counter(
    "hvd_tpu_autotune_samples_total",
    "Autotune throughput samples scored (warmup samples excluded).")

# Tuned knobs in phase order: (config name, log2 lo, log2 hi).
# Fusion threshold searches [1 MB, 256 MB]; pack cutoff [4 KB, 4 MB].
_KNOBS = (
    ("FUSION_THRESHOLD", 20.0, 28.0),
    ("PACK_CUTOFF", 12.0, 22.0),
)


class _PythonFallbackOptimizer:
    """Deterministic 1-D maximizer used when the native GP/BO is unbuilt:
    sweeps a coarse grid, then golden-section refines around the incumbent.
    Same interface as the native BO (observe/suggest), same determinism
    property (identical history -> identical suggestion)."""

    def __init__(self, lo: float, hi: float):
        self._lo, self._hi = lo, hi
        # 5-point grid over THIS knob's bounds (a class-level grid baked
        # to the fusion-threshold range sent the PACK_CUTOFF phase
        # probing 64-256 MB cutoffs — round-5 review finding)
        self._GRID = [lo + i * (hi - lo) / 4.0 for i in range(5)]
        self._obs = []

    def observe(self, x: float, y: float):
        self._obs.append((x, y))

    def suggest(self) -> float:
        n = len(self._obs)
        if n < len(self._GRID):
            return self._GRID[n]
        best_x, _ = max(self._obs, key=lambda o: o[1])
        # shrinking probes alternating around the incumbent
        k = n - len(self._GRID)
        step = (self._hi - self._lo) / (2.0 ** (k // 2 + 2))
        probe = best_x + (step if k % 2 == 0 else -step)
        return min(self._hi, max(self._lo, probe))


class ParameterManager:
    """Created by ``init()`` when HVD_TPU_AUTOTUNE is set; consulted by
    ``DistributedOptimizer`` each step."""

    def __init__(self, world):
        cfg = world.config
        self._world = world
        self._warmup_samples = int(
            cfg.get(_config.AUTOTUNE_WARMUP_SAMPLES))
        self._warmup_left = self._warmup_samples
        self._steps_per_sample = max(
            1, int(cfg.get(_config.AUTOTUNE_STEPS_PER_SAMPLE)))
        self._max_samples = int(
            cfg.get(_config.AUTOTUNE_BAYES_OPT_MAX_SAMPLES))
        self._log_path = cfg.get(_config.AUTOTUNE_LOG)
        self._values = {name: int(cfg.get(getattr(_config, name)))
                        for name, _lo, _hi in _KNOBS}
        self._phase = 0
        self._samples_done = 0
        self._step_in_sample = 0
        self._bytes_acc = 0
        self._time_acc = 0.0
        self._finished = False
        self._publish_gauges()
        self._enter_phase(0)

    def _publish_gauges(self) -> None:
        _M_FUSION_GAUGE.set(self._values["FUSION_THRESHOLD"])
        _M_CUTOFF_GAUGE.set(self._values["PACK_CUTOFF"])

    def _enter_phase(self, phase: int) -> None:
        self._phase = phase
        name, lo, hi = _KNOBS[phase]
        self._opt = _PythonFallbackOptimizer(lo, hi)
        self._best = (self._values[name], -1.0)
        self._samples_done = 0
        self._warmup_left = self._warmup_samples

    @property
    def _knob_name(self) -> str:
        return _KNOBS[self._phase][0]

    # -- interface consulted by the reduction path ---------------------------
    @property
    def active(self) -> bool:
        return not self._finished

    @property
    def fusion_threshold(self) -> int:
        return self._values["FUSION_THRESHOLD"]

    def record(self, nbytes: int, seconds: float) -> None:
        """Report one reduction step's traffic and wall time."""
        if self._finished:
            return
        self._bytes_acc += int(nbytes)
        self._time_acc += float(seconds)
        self._step_in_sample += 1
        if self._step_in_sample < self._steps_per_sample:
            return
        score = self._bytes_acc / max(self._time_acc, 1e-9)
        self._step_in_sample = 0
        self._bytes_acc = 0
        self._time_acc = 0.0
        if self._warmup_left > 0:
            self._warmup_left -= 1
            self._log(f"warmup {self._knob_name}="
                      f"{self._values[self._knob_name]} "
                      f"score={score:.3e} (discarded)")
            return
        self._observe_and_advance(score)

    def _observe_and_advance(self, score: float) -> None:
        name = self._knob_name
        value = self._values[name]
        x = math.log2(max(value, 1))
        if score > self._best[1]:
            self._best = (value, score)
        self._samples_done += 1
        _M_SAMPLES.inc()
        self._log(f"sample {self._samples_done} {name}={value} "
                  f"score={score:.3e} bytes/sec")
        if self._samples_done >= self._max_samples:
            # per-process best scores differ; rank 0's pick is adopted
            # everywhere, like every other proposal
            self._values[name] = int(self._sync(float(self._best[0])))
            self._world.config.set(name, self._values[name])
            self._publish_gauges()
            if self._phase + 1 < len(_KNOBS):
                self._log(f"knob locked: {name}={self._values[name]} "
                          f"score={self._best[1]:.3e}; tuning "
                          f"{_KNOBS[self._phase + 1][0]} next")
                self._enter_phase(self._phase + 1)
            else:
                self._finished = True
                summary = " ".join(
                    f"{n}={self._values[n]}" for n, _l, _h in _KNOBS)
                self._log(f"tuning complete: {summary} "
                          f"score={self._best[1]:.3e}")
            return
        self._opt.observe(x, score)
        proposal = 1 << int(round(self._sync(self._opt.suggest())))
        self._values[name] = proposal
        self._world.config.set(name, self._values[name])
        self._publish_gauges()

    def _sync(self, proposal: float) -> float:
        """Adopt rank 0's proposal in a multi-process world (reference:
        SynchronizeParameters broadcast, controller.cc:33-47)."""
        if self._world.size <= 1:
            return proposal
        import torch
        from . import collectives as _c
        out = _c.broadcast(torch.tensor([proposal], dtype=torch.float64),
                           root_rank=0, name="hvd_tpu.autotune.param")
        return float(out[0])

    def _log(self, msg: str) -> None:
        if not self._log_path or self._world.rank != 0:
            return
        try:
            with open(self._log_path, "a") as f:
                f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} {msg}\n")
        except OSError:
            pass


def maybe_create(world) -> Optional[ParameterManager]:
    if not world.config.get(_config.AUTOTUNE):
        return None
    return ParameterManager(world)
