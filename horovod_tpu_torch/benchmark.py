"""Synthetic training benchmark (counterpart of ``horovod_tpu/benchmark.py``,
the analogue of the reference's pytorch_synthetic_benchmark.py; defaults
of docs/benchmarks.rst:66-85: ResNet-50, batch 32 per worker, 10 warmup
batches, 10 iterations x 10 batches, img/sec per worker and in total).

One process per card, data parallel: every process builds the same model
from the same seed, takes its rows of one synthetic global batch (bf16
activations on fp32 parameters; images NCHW in ``channels_last`` memory
on the card, the NHWC layout the JAX package computes in), and steps ``torch.optim.SGD(0.01 * size,
momentum=0.9)`` or ``Adam(1e-3)`` wrapped in the port's
``DistributedOptimizer`` (gradients averaged). With more than one process
every BatchNorm takes its statistics over the global batch
(``models.layers.sync_batch_norm_``), as XLA does for the JAX rig's
batch sharded over 'dp'; in a world of one the two are the same and the
local statistics are used. The loss is the mean softmax cross-entropy.

FLOPs of a step are counted with ``torch.utils.flop_counter`` on a copy
of the model on the meta device (convolutions and matrix products,
forward and backward), where the JAX rig reads XLA's cost analysis; the
ResNet-50-at-224 constant is kept as the fallback, and a model that can
be counted neither way reports no MFU.
"""

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class BenchResult:
    images_per_sec_per_chip: float
    images_per_sec_total: float
    num_chips: int
    batch_per_chip: int
    iter_mean_s: float
    iter_std_s: float
    platform: str = "unknown"
    device_kind: str = "unknown"
    flops_per_step: Optional[float] = None
    mfu: Optional[float] = None
    stem: Optional[str] = "conv"   # None: model has no stem knob
    # the port's addition: peak device memory of the stage (None on CPU)
    peak_memory_gib: Optional[float] = None


# Peak dense bf16 FLOP/s per chip by device kind (public spec-sheet
# numbers; a lookup, used only to turn measured throughput into MFU).
_PEAK_BF16_FLOPS = (
    ("h100", 989e12),
    ("v6e", 918e12), ("trillium", 918e12),
    ("v5p", 459e12),
    ("v5e", 197e12), ("v5litepod", 197e12), ("v5 lite", 197e12),
    ("v4", 275e12),
    ("v3", 123e12),
    ("v2", 45e12),
)

# ResNet-50 forward at 224x224 is ~4.1 GMACs = ~8.2 GFLOPs an image;
# forward + backward ~= 3x forward.
_RESNET50_TRAIN_FLOPS_PER_IMAGE = 3 * 8.2e9

NUM_CLASSES = 1000


def _resolve_stem(model_name: str, stem: Optional[str]) -> Optional[str]:
    """The stem knob exists only on the ResNet family: the stage's stem,
    else "conv". Shared by _Rig and the ladder so the ladder's rebuild
    check agrees with what the rig built."""
    if not model_name.startswith("resnet"):
        return None
    return stem or "conv"


def peak_flops_per_chip(device_kind: str) -> Optional[float]:
    k = (device_kind or "").lower()
    for name, peak in _PEAK_BF16_FLOPS:
        if name in k:
            return peak
    return None


def _build_model(model_name: str, stem: Optional[str], image_size: int,
                 device, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.bfloat16):
    from .models import InceptionV3, ResNet18, ResNet50, ResNet101, VGG16
    common = dict(num_classes=NUM_CLASSES, dtype=dtype, device=device,
                  generator=generator)
    # the reference's scaling trio (docs/benchmarks.rst:13-14); dropout
    # off for a deterministic throughput workload
    builders = {
        "resnet18": lambda: ResNet18(stem=stem, **common),
        "resnet50": lambda: ResNet50(stem=stem, **common),
        "resnet101": lambda: ResNet101(stem=stem, **common),
        "vgg16": lambda: VGG16(dropout_rate=0.0, image_size=image_size,
                               **common),
        # tf_cnn_benchmarks' name; canonical input 299 px, any >= 75 runs
        "inception3": lambda: InceptionV3(dropout_rate=0.0,
                                          image_size=image_size, **common),
    }
    if model_name not in builders:
        raise ValueError(f"unknown model {model_name!r}; expected one of "
                         f"{sorted(builders)}")
    return builders[model_name]()


def _step_flops(model_name: str, stem: Optional[str], image_size: int,
                batch: int) -> Optional[float]:
    """FLOPs of one training step (forward and backward) at ``batch``,
    counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode
    model = _build_model(model_name, stem, image_size, "meta")
    x = torch.empty(batch, 3, image_size, image_size, device="meta",
                    dtype=torch.bfloat16)
    y = torch.zeros(batch, dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as counter:
        F.cross_entropy(model(x), y).backward()
    total = counter.get_total_flops()
    return float(total) if total > 0 else None


class _Rig:
    """Benchmark state for one (model, batch, stem) configuration: the
    model, its optimizer and one synthetic batch, built once per batch
    size; ``run_stage`` can then be called again (a quick measurement,
    then a longer one) on the warm rig. ``device``: the card (default)
    or "cpu"; ``dtype``: the activations' (the JAX rig's bf16; fp32 to
    hold a step to the JAX rig's math in fp32)."""

    def __init__(self, batch_per_chip: int, image_size: int,
                 model_name: str, optimizer_name: str,
                 stem: Optional[str] = None, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        from . import basics
        from .models.layers import sync_batch_norm_
        from .optimizer import DistributedOptimizer

        if not basics.is_initialized():
            basics.init(device=device)
        dev = basics.resolve_device(device)
        self.device = dev
        self.n = n = basics.size()
        rank = basics.rank()
        self.batch_per_chip = batch_per_chip
        self.global_batch = global_batch = batch_per_chip * n
        if dev.type == "cuda":
            self.platform = "gpu"
            self.device_kind = torch.cuda.get_device_name(dev)
        else:
            self.platform = self.device_kind = dev.type
        memory = torch.channels_last if dev.type == "cuda" \
            else torch.contiguous_format

        # stem-less models record None, so a result never claims a stem
        # A/B that did not happen and the ladder never rebuilds for one
        self.stem = _resolve_stem(model_name, stem)
        model = _build_model(model_name, self.stem, image_size, dev,
                             torch.Generator(device=dev).manual_seed(1),
                             dtype)
        self.model = model.to(memory_format=memory).train()
        if n > 1:
            sync_batch_norm_(self.model)

        # one global batch from a seed; this process takes its rows
        gen = torch.Generator(device=dev).manual_seed(0)
        images = torch.randn(global_batch, 3, image_size, image_size,
                             generator=gen, device=dev)
        labels = torch.randint(0, NUM_CLASSES, (global_batch,),
                               generator=gen, device=dev)
        rows = slice(rank * batch_per_chip, (rank + 1) * batch_per_chip)
        self.images = images[rows].to(dtype).contiguous(
            memory_format=memory)
        self.labels = labels[rows].contiguous()

        # LR scaled by the world size, the reference's hvd.size() recipe
        params = self.model.parameters()
        base = {"sgd": lambda: torch.optim.SGD(params, lr=0.01 * n,
                                               momentum=0.9),
                "adam": lambda: torch.optim.Adam(params, lr=1e-3)}
        self.optimizer = DistributedOptimizer(
            base[optimizer_name](),
            named_parameters=self.model.named_parameters())

        self.flops_per_step = _step_flops(model_name, self.stem, image_size,
                                          batch_per_chip)
        if self.flops_per_step is None and model_name == "resnet50" \
                and image_size == 224:
            self.flops_per_step = (_RESNET50_TRAIN_FLOPS_PER_IMAGE
                                   * batch_per_chip)
        self.loss = None
        self._warmed_up = 0

    def step(self) -> torch.Tensor:
        """One training step; returns the loss (on the device)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(self.model(self.images), self.labels)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _run_batches(self, k: int, scanned: bool = False) -> None:
        """``k`` steps. Plain: fenced by reading the last loss back to the
        host, as the JAX rig does. ``scanned`` (the JAX rig's one
        ``fori_loop`` XLA call for the k steps): the k steps issued back
        to back and fenced by one device synchronize, with no host readback
        at all; in eager PyTorch the two differ only in that fence."""
        for _ in range(k):
            self.loss = self.step()
        if scanned and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        else:
            self.loss.item()

    def run_stage(self, num_warmup_batches: int, num_batches_per_iter: int,
                  num_iters: int, scanned: bool = False,
                  verbose: bool = False) -> BenchResult:
        # warmup counts accumulate: a second stage on a warm rig runs only
        # the warmup it asked for beyond what earlier stages ran
        extra = max(0, num_warmup_batches - self._warmed_up)
        if extra:
            self._run_batches(extra, scanned=scanned)
            self._warmed_up += extra
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

        durations = []
        for i in range(num_iters):
            t0 = time.perf_counter()
            self._run_batches(num_batches_per_iter, scanned=scanned)
            dt = time.perf_counter() - t0
            durations.append(dt)
            if verbose:
                ips = self.global_batch * num_batches_per_iter / dt
                print(f"Iter #{i}: {ips:.1f} img/sec total")

        durations = np.array(durations)
        imgs = self.global_batch * num_batches_per_iter
        ips_total = float(np.mean(imgs / durations))

        peak = peak_flops_per_chip(self.device_kind)
        mfu = None
        if peak and self.flops_per_step:
            mfu = self.flops_per_step * (ips_total / self.global_batch) / peak
        return BenchResult(
            images_per_sec_per_chip=ips_total / self.n,
            images_per_sec_total=ips_total,
            num_chips=self.n,
            batch_per_chip=self.batch_per_chip,
            iter_mean_s=float(durations.mean()),
            iter_std_s=float(durations.std()),
            platform=self.platform,
            device_kind=self.device_kind,
            flops_per_step=self.flops_per_step,
            mfu=mfu,
            stem=self.stem,
            peak_memory_gib=(torch.cuda.max_memory_allocated(self.device)
                             / 2**30 if cuda else None),
        )

    def close(self) -> None:
        """Remove the optimizer's gradient hooks."""
        self.optimizer.remove_hooks()


def synthetic_resnet50_benchmark(
        batch_per_chip: int = 32,
        num_warmup_batches: int = 10,
        num_batches_per_iter: int = 10,
        num_iters: int = 10,
        image_size: int = 224,
        model_name: str = "resnet50",
        optimizer_name: str = "sgd",
        verbose: bool = False,
        device=None) -> BenchResult:
    rig = _Rig(batch_per_chip, image_size, model_name, optimizer_name,
               device=device)
    try:
        return rig.run_stage(num_warmup_batches, num_batches_per_iter,
                             num_iters, verbose=verbose)
    finally:
        rig.close()


def synthetic_resnet50_ladder(stages, image_size: int = 224,
                              model_name: str = "resnet50",
                              optimizer_name: str = "sgd", device=None):
    """Generator: run ``stages`` cheapest-first, yielding
    ``(BenchResult | None, error | None)`` per stage. Stages with the same
    ``batch_per_chip`` and stem share one rig; another batch size or stem
    drops the previous rig before building the next (device memory).

    A stage's failure (a larger batch running out of memory) is yielded
    as ``(None, exc)``, not raised: raising out of a generator ends it,
    which would cancel every later stage. A failed stage also drops its
    rig, so the next stage builds a fresh one.

    Each stage is a dict with keys ``batch_per_chip``,
    ``num_warmup_batches``, ``num_batches_per_iter``, ``num_iters`` and
    optionally ``scanned`` and ``stem``. The caller decides whether to
    pull the next stage (its wall-clock budget).
    """
    rig = None

    def drop(r):
        if r is not None:
            r.close()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    try:
        for st in stages:
            b = st["batch_per_chip"]
            # a stage without a stem resolves to the default exactly as
            # _Rig does, so it rebuilds after a stem-overridden stage
            want_stem = _resolve_stem(model_name, st.get("stem"))
            try:
                if rig is None or rig.batch_per_chip != b \
                        or want_stem != rig.stem:
                    drop(rig)
                    rig = None
                    rig = _Rig(b, image_size, model_name, optimizer_name,
                               stem=want_stem, device=device)
                yield rig.run_stage(st["num_warmup_batches"],
                                    st["num_batches_per_iter"],
                                    st["num_iters"],
                                    scanned=st.get("scanned", False)), None
            except Exception as e:  # noqa: BLE001 - the caller triages
                drop(rig)
                rig = None
                yield None, e
    finally:
        drop(rig)
