"""Microbenchmarks of horovod_tpu_torch (counterpart of
``horovod_tpu/microbench.py`` and its root script ``microbench.py``): the
same sections, the same result keys, on the card unless asked otherwise.

* :func:`eager_sweep`: payload sweep (1 KB -> 256 MB) of the eager
  ``allreduce`` / ``grouped_allreduce`` verbs on device tensors: seconds,
  bytes/s, the async dispatch latency (time for ``allreduce_async`` to
  return), and the ratio against the in-jit reduction of the same payload
  (``injit_reduce_s``, ``eager_over_injit``, as in the JAX package): a
  function compiled with ``torch.compile`` whose ``hvd.allreduce`` lowers
  to the in-graph collective (``collectives``' in-jit route). The gap is
  the verbs' host overhead: dispatcher hand-off, fusion, consistency
  checks.
* :func:`bucketed_optimizer_sweep`: ResNet-50's 161 gradients, one
  allreduce each against the fusion planner's buckets.
* :func:`injit_optimizer_sweep`: the compiled plane
  (``DistributedOptimizer(axis_name=...)``, ``_CompiledPlaneOptimizer``)
  on the same gradients, reducing eagerly: per-leaf, packed, packed with
  bf16 on the wire, packed with int8 and error feedback; the analytic
  ``wire_mb``. The name is the JAX section's, which times the reduction
  inside ``shard_map``; the port's reduction in a compiled graph is
  ``eager_sweep``'s ``injit_reduce_s`` and the compiled training step.
* :func:`scaling_sweep_point`: one point of the data-parallel CNN step
  (``benchmark._Rig``) over the world.
* generation: :func:`generation_sweep` (continuous batching against
  static full batches), :func:`sampling_sweep`, :func:`prefix_sweep`,
  :func:`spec_sweep` and :func:`resume_sweep`, at the JAX package's own
  tiny configurations; their parameters come from ``params=`` (for
  example the JAX package's, carried across by
  :func:`~horovod_tpu_torch.models.convert.params_from_flax`) or from a
  seeded ``torch.Generator``.
* :func:`sdc_guard_sweep`, :func:`tracing_overhead_sweep`,
  :func:`hedging_sweep` (the fleet router's hedge race against scripted
  HTTP stubs) and :func:`disagg_sweep` (pooled prefill/decode fleet
  against colocated), each with the JAX sweep's assertions: outputs
  bit-identical across modes, no KV block leaked, a warm repeat moving
  zero transfer bytes.

Command line::

    python -m horovod_tpu_torch.microbench [--quick] [--sections a,b]
        [--out PATH] [--device cuda|cpu]

runs every section (``--sections`` picks some: eager_1proc, eager_2proc,
scaling, injit, generation, sdc, tracing, failover, disagg), on the card
unless ``--device cpu`` is given, and prints one JSON line per section
(``{"section": ..., "device": ..., "backend": ..., "result": ...}``);
``--out`` also writes them all as one JSON document. NCCL cannot put two
ranks on one GPU, so ``eager_2proc`` and the scaling points above one
process always run as gloo worlds over CPU tensors, and their lines say
so (``"device": "cpu", "backend": "gloo"``): they are never the card's
numbers. It never writes ``MICROBENCH.json``, which holds the JAX
package's numbers.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# Payload ladder: 1 KB -> 256 MB (the reference's fusion threshold is
# 64 MB, common.h:95). The top sizes are where bandwidth dominates, the
# bottom where per-dispatch overhead dominates.
DEFAULT_SIZES = (1 << 10, 1 << 14, 1 << 17, 1 << 20, 1 << 23, 1 << 26,
                 1 << 28)

SECTIONS = ("eager_1proc", "eager_2proc", "scaling", "injit", "generation",
            "sdc", "tracing", "failover", "disagg")

MB_TAG = "MB_JSON "


def _timeit(fn, iters: int, warmup: int = 1) -> float:
    """Best wall-clock seconds of ``fn()`` over ``iters`` runs (min, the
    ``timeit`` convention: outside interference only ever adds time, so
    the minimum is the least noisy estimate of the code's cost). ``fn``
    must fence its own device work."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts))


def _device(device=None) -> torch.device:
    from .basics import resolve_device
    return resolve_device(device)


def _fence(dev: torch.device) -> None:
    """Wait for the device's queued work (the host-visible end of a
    timed call); a CPU tensor's work is done when the call returns."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the collective plane
# ---------------------------------------------------------------------------

def _injit_sum(t):
    """``hvd.allreduce`` of ``t`` as the in-jit route lowers it (called
    compiled by :func:`eager_sweep`)."""
    import horovod_tpu_torch as hvd
    return hvd.allreduce(t, op=hvd.Sum)


def eager_sweep(sizes: Sequence[int] = DEFAULT_SIZES, iters: int = 5,
                group: int = 8,
                compile_backend: str = "inductor") -> List[dict]:
    """Sweep the eager verbs over payload sizes. Must run inside an
    initialized world (any process count); every rank runs the same
    sequence, and the results are the same on every rank. The in-jit
    reduction compiles with ``compile_backend``, once per payload size
    (outside the timed rounds)."""
    import horovod_tpu_torch as hvd
    from . import basics

    dev = basics.device()
    nproc = hvd.size()
    results = []
    for size in sizes:
        n_el = max(1, size // 4)
        x = torch.ones((n_el,), dtype=torch.float32, device=dev)
        payload = n_el * 4
        # more rounds at the cheap sizes: per-round load swings dominate
        # small payloads on a shared host
        rounds = iters if payload > (8 << 20) else max(iters, 12)

        def run_allreduce():
            hvd.allreduce(x, op=hvd.Sum, name=f"mb_ar_{size}")
            _fence(dev)

        chunk = max(1, n_el // group)
        xs = [torch.ones((chunk,), dtype=torch.float32, device=dev)
              for _ in range(group)]

        def run_grouped():
            hvd.grouped_allreduce(xs, op=hvd.Sum, name=f"mb_gar_{size}")
            _fence(dev)

        # the same global payload reduced in a compiled graph: the verb
        # lowered to the in-graph collective, no dispatcher
        injit = torch.compile(_injit_sum, fullgraph=True, dynamic=False,
                              backend=compile_backend)
        staged = x.clone()

        def run_direct():
            injit(staged)
            _fence(dev)

        # the variants interleave round by round, so load swings hit
        # every variant alike; each keeps its best round
        run_allreduce(), run_grouped(), run_direct()
        t_eager = t_grouped = t_direct = float("inf")
        lat = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            run_allreduce()
            t_eager = min(t_eager, time.perf_counter() - t0)
            t0 = time.perf_counter()
            run_grouped()
            t_grouped = min(t_grouped, time.perf_counter() - t0)
            t0 = time.perf_counter()
            run_direct()
            t_direct = min(t_direct, time.perf_counter() - t0)
            # async dispatch latency: how long the caller is blocked per
            # submission
            t0 = time.perf_counter()
            h = hvd.allreduce_async(x, op=hvd.Sum, name=f"mb_ard_{size}")
            lat.append(time.perf_counter() - t0)
            hvd.synchronize(h)
        _fence(dev)
        results.append({
            "payload_bytes": payload,
            "nproc": nproc,
            "eager_allreduce_s": t_eager,
            "eager_bytes_per_s": payload / t_eager,
            "dispatch_latency_s": float(np.median(lat)),
            "grouped_allreduce_s": t_grouped,
            "grouped_bytes_per_s": (chunk * 4 * group) / t_grouped,
            "injit_reduce_s": t_direct,
            "eager_over_injit": t_eager / t_direct if t_direct > 0 else None,
        })
    return results


def resnet50_grad_shapes() -> List[tuple]:
    """ResNet-50's 161 parameter shapes (25,557,032 parameters, ~97.5 MB
    fp32) from the port's model, in torch's layout (convolutions OIHW, the
    classifier (out, in)): the parameter set the reference's 64 MB fusion
    threshold was tuned on (Horovod's docs/benchmarks.rst). The model is
    built on the meta device, so nothing is allocated."""
    from .models import ResNet50
    model = ResNet50(num_classes=1000, device="meta")
    return [tuple(p.shape) for p in model.parameters()]


def bucketed_optimizer_sweep(iters: int = 5,
                             threshold_mb: int = 64) -> dict:
    """One allreduce per gradient against bucketed grouped allreduces
    over ResNet-50's 161 gradients at the default fusion threshold (the
    claim behind tensor fusion, collective_operations.cc:37-81)."""
    import horovod_tpu_torch as hvd
    from . import basics
    from .fusion import plan_buckets

    dev = basics.device()
    shapes = resnet50_grad_shapes()
    grads = [torch.ones(s, dtype=torch.float32, device=dev) for s in shapes]
    total_bytes = sum(g.numel() * 4 for g in grads)
    buckets = plan_buckets([(s, np.float32) for s in shapes],
                           threshold_mb * (1 << 20))

    def run_per_param():
        hs = [hvd.allreduce_async(g, op=hvd.Sum, name=f"mb_pp_{i}")
              for i, g in enumerate(grads)]
        for h in hs:
            hvd.synchronize(h)
        _fence(dev)

    def run_bucketed():
        hs = [hvd.grouped_allreduce_async(
                  [grads[i] for i in b], op=hvd.Sum, name=f"mb_bk_{j}")
              for j, b in enumerate(buckets)]
        for h in hs:
            hvd.synchronize(h)
        _fence(dev)

    run_per_param(), run_bucketed()
    t_pp = t_bk = float("inf")
    for _ in range(max(iters, 5)):
        t0 = time.perf_counter()
        run_per_param()
        t_pp = min(t_pp, time.perf_counter() - t0)
        t0 = time.perf_counter()
        run_bucketed()
        t_bk = min(t_bk, time.perf_counter() - t0)
    return {
        "scenario": "resnet50_bucketed_optimizer",
        "num_grads": len(grads),
        "total_mb": round(total_bytes / (1 << 20), 1),
        "threshold_mb": threshold_mb,
        "num_buckets": len(buckets),
        "per_param_s": t_pp,
        "bucketed_s": t_bk,
        "bucketed_speedup": round(t_pp / t_bk, 2) if t_bk > 0 else None,
    }


def injit_optimizer_sweep(iters: int = 5) -> dict:
    """The compiled plane on ResNet-50's 161 gradients: per-leaf, packed,
    packed with bf16 on the wire and packed with int8 (error feedback)
    reductions of ``_CompiledPlaneOptimizer`` (``DistributedOptimizer``
    with ``axis_name=`` over the world's ("cross", "local") mesh), the
    gradients already on the device: the reduction's cost, not a host
    transfer. The counterpart of :func:`bucketed_optimizer_sweep` on the
    eager plane. The section keeps the JAX package's name (there it runs
    under ``shard_map``); here it times ``synchronize()``, the whole
    reduction in one dispatcher hand-off.

    ``wire_mb`` is the analytic payload each rank puts into the
    collectives (fp32 x4, bf16 x2, int8 x1 bytes an element; fp16 would
    put fp32 back on the wire through its upcast sum, which is why bf16
    is the half that counts).
    """
    import horovod_tpu_torch as hvd
    from . import basics
    from .compression import Compression
    from .fusion import packed_plan
    from .mesh import cross_local_mesh
    from .optimizer import _packed_threshold

    dev = basics.device()
    n = hvd.size()
    rank = hvd.rank()
    shapes = resnet50_grad_shapes()
    names = [f"g{i}" for i in range(len(shapes))]
    rng = np.random.RandomState(0)
    grads_host = {}
    for k, s in zip(names, shapes):
        rows = [rng.standard_normal(s).astype(np.float32) * (d + 1)
                for d in range(n)]
        grads_host[k] = rows[rank]
    total_bytes = sum(int(np.prod(s, dtype=np.int64)) * 4 for s in shapes)
    threshold = _packed_threshold()
    plan = packed_plan([tuple(s) for s in shapes],
                       ["float32"] * len(shapes), threshold)
    mesh = cross_local_mesh()

    def make_variant(packing, compression):
        params = {k: torch.nn.Parameter(torch.zeros(s, device=dev))
                  for k, s in zip(names, shapes)}
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(list(params.values()), lr=0.0),
            named_parameters=list(params.items()), axis_name="cross",
            mesh=mesh, packing=packing, compression=compression)
        grads = {k: torch.from_numpy(v).to(dev)
                 for k, v in grads_host.items()}

        def run():
            for k, p in params.items():
                p.grad = grads[k].clone()
            opt.synchronize()
            _fence(dev)
            return {k: p.grad for k, p in params.items()}
        return run

    elem_bytes = {"per_leaf": 4, "packed": 4, "packed_bf16": 2,
                  "packed_int8": 1}
    variants = {
        "per_leaf": make_variant("per_leaf", Compression.none),
        "packed": make_variant("packed", Compression.none),
        "packed_bf16": make_variant("packed", Compression.bf16),
        "packed_int8": make_variant("packed", Compression.int8),
    }
    firsts = {k: run() for k, run in variants.items()}
    ref = firsts["per_leaf"]

    def max_err(u):
        return max(float((u[k].float() - ref[k].float()).abs().max())
                   for k in names)

    errs = {k: max_err(firsts[k]) for k in variants if k != "per_leaf"}
    del firsts, ref
    best = {k: float("inf") for k in variants}
    for _ in range(max(iters, 3)):
        for k, run in variants.items():
            t0 = time.perf_counter()
            run()
            best[k] = min(best[k], time.perf_counter() - t0)

    out = {
        "scenario": "resnet50_injit_reduce",
        "num_grads": len(shapes),
        "total_mb": round(total_bytes / (1 << 20), 1),
        "num_devices": n,
        "threshold_mb": threshold // (1 << 20),
        "num_buckets": len(plan),
        "variants": {},
    }
    for k in variants:
        row = {
            "time_s": best[k],
            "wire_mb": round(total_bytes * elem_bytes[k] / 4 / (1 << 20), 1),
            "collectives_per_step": len(shapes) if k == "per_leaf"
            else len(plan),
        }
        if k != "per_leaf":
            row["max_abs_err_vs_fp32"] = errs[k]
        out["variants"][k] = row
    pl, pk = best["per_leaf"], best["packed"]
    out["packed_speedup_vs_per_leaf"] = round(pl / pk, 2) if pk > 0 else None
    return out


def scaling_sweep_point(batch_per_device: int = 8, image_size: int = 32,
                        model_name: str = "resnet18",
                        num_iters: int = 3,
                        num_batches_per_iter: int = 5,
                        device=None) -> dict:
    """One point of the data-parallel scaling sweep: the CNN train step of
    ``python -m horovod_tpu_torch.bench`` (``benchmark._Rig``) over the
    world (initialized on ``device`` if it is not yet)."""
    from .benchmark import _Rig

    rig = _Rig(batch_per_device, image_size, model_name, "sgd",
               device=device)
    try:
        r = rig.run_stage(num_warmup_batches=2,
                          num_batches_per_iter=num_batches_per_iter,
                          num_iters=num_iters)
    finally:
        rig.close()
    return {
        "num_devices": r.num_chips,
        "batch_per_device": r.batch_per_chip,
        "images_per_sec_total": r.images_per_sec_total,
        "images_per_sec_per_device": r.images_per_sec_per_chip,
        "platform": r.platform,
    }


# ---------------------------------------------------------------------------
# the generation plane
# ---------------------------------------------------------------------------

def _model_params(cfg, params, dev, seed: int = 0):
    """(model on meta, parameters on ``dev``): ``params`` (a flat dict by
    dotted name) moved to the device, else drawn with a seeded
    generator."""
    from .models.transformer import Transformer
    model = Transformer(cfg, device="meta")
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        src = Transformer(cfg, device=dev, generator=gen)
        params = {n: p.detach() for n, p in src.named_parameters()}
    return model, {n: torch.as_tensor(p).to(dev) for n, p in params.items()}


def _gen_workload(num_requests: int, shared_prefix: int = 0, params=None,
                  device=None):
    """The generation sweeps' shared fixture: the JAX package's tiny fp32
    bench transformer (vocab 512, 4 layers, d_model 128, 4 heads of 32,
    max_seq_len 128) plus its deterministic mixed-length workload (numpy
    seed 0): a few long generations among bursts of short ones, prompts
    of 4-23 tokens, ``shared_prefix`` identical system-prompt tokens in
    front of each. Returns ``(model, params, cfg, prompts, new_lens,
    device)``."""
    from .models.transformer import TransformerConfig
    dev = _device(device)
    cfg = TransformerConfig(vocab_size=512, num_layers=4, d_model=128,
                            num_heads=4, head_dim=32, max_seq_len=128,
                            dtype=torch.float32)
    model, params = _model_params(cfg, params, dev)
    rng = np.random.RandomState(0)
    system = rng.randint(0, cfg.vocab_size, (shared_prefix,)).tolist()
    new_lens = [(32, 4, 4, 4, 8, 4, 16, 4)[i % 8]
                for i in range(num_requests)]
    prompts = [system + rng.randint(0, cfg.vocab_size,
                                    (4 + (i * 5) % 20,)).tolist()
               for i in range(num_requests)]
    return model, params, cfg, prompts, new_lens, dev


def _run_clients(fn, n: int, first_alone: bool = False) -> None:
    """``fn(i)`` for i in range(n), concurrently (request 0 first and
    alone when ``first_alone``)."""
    import threading
    start = 0
    if first_alone:
        fn(0)
        start = 1
    threads = [threading.Thread(target=fn, args=(i,))
               for i in range(start, n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _delta(snap1, snap0, key):
    return snap1.get(key, 0) - snap0.get(key, 0)


def generation_sweep(num_requests: int = 24, batch_slots: int = 8,
                     block_size: int = 8, params=None,
                     device=None) -> dict:
    """Continuous batching against static full-batch generation on a
    mixed-length prompt workload. Both run the same paged forward over
    pools of the same shapes: static through the raw-logits
    :func:`~.serving.generation.build_program`, continuous through the
    :class:`~.serving.generation.GenerationEngine` (whose greedy tokens
    equal the host argmax), every program warmed off the clock.

    * static: batches of ``batch_slots`` in arrival order; each prefills,
      reserves KV for its longest sequence in every slot and decodes
      until its longest request finishes.
    * continuous: the engine end to end (admission into freed slots,
      immediate retirement, paged allocation on growth).

    Reported per mode: wall seconds, useful tokens/s, decode steps and
    peak KV bytes (the allocator's high-water mark x block bytes, against
    the static reservation). The two modes' tokens must be equal.
    """
    from . import metrics as _metrics
    from .models.transformer import PagedCache
    from .serving.generation import (GenerationEngine, block_bytes,
                                     build_program, make_pools)
    from .serving.generation.scheduler import DECODE_WIDTH

    model, params, cfg, prompts, new_lens, dev = _gen_workload(
        num_requests, params=params, device=device)
    prefill_chunk = 16
    total_new = sum(new_lens)
    per_block = block_bytes(cfg, block_size)
    program = build_program(model)
    max_blocks = -(-cfg.max_seq_len // block_size)
    i32 = dict(dtype=torch.int32, device=dev)

    def run_static():
        peak_blocks = 0
        decode_steps = 0
        outs = {}
        t0 = time.perf_counter()
        for lo in range(0, num_requests, batch_slots):
            group = list(range(lo, min(lo + batch_slots, num_requests)))
            longest = max(len(prompts[i]) + new_lens[i] for i in group)
            per_seq = -(-longest // block_size)
            # the static reservation: the worst case for every slot
            peak_blocks = max(peak_blocks, per_seq * len(group))
            k, v = make_pools(cfg, batch_slots * max_blocks + 1, block_size,
                              device=dev)
            tables = np.zeros((batch_slots, max_blocks), np.int32)
            for j in range(len(group)):
                tables[j, :per_seq] = 1 + j * per_seq + np.arange(per_seq)
            tables_d = torch.tensor(tables, **i32)
            seqs = [list(prompts[i]) for i in group]
            for j, i in enumerate(group):
                done = 0
                while done < len(prompts[i]):
                    chunk = prompts[i][done:done + prefill_chunk]
                    buf = np.zeros((1, prefill_chunk), np.int32)
                    buf[0, :len(chunk)] = chunk
                    cache = PagedCache(k, v, tables_d[j:j + 1],
                                       torch.tensor([done], **i32),
                                       torch.tensor([len(chunk)], **i32))
                    logits, cache = program(params, cache,
                                            torch.tensor(buf, **i32))
                    k, v = cache.k, cache.v
                    done += len(chunk)
                seqs[j].append(int(logits[0, len(chunk) - 1].argmax()))
            # decode to the batch's longest: finished lanes keep stepping
            batch_max = max(new_lens[i] for i in group)
            for _step in range(batch_max - 1):
                tokens = np.zeros((batch_slots, DECODE_WIDTH), np.int32)
                lengths = np.zeros((batch_slots,), np.int32)
                live = np.zeros((batch_slots,), np.int32)
                for j in range(len(group)):
                    tokens[j, 0] = seqs[j][-1]
                    lengths[j] = len(seqs[j]) - 1
                    live[j] = 1
                cache = PagedCache(k, v, tables_d,
                                   torch.tensor(lengths, **i32),
                                   torch.tensor(live, **i32))
                logits, cache = program(params, cache,
                                        torch.tensor(tokens, **i32))
                k, v = cache.k, cache.v
                decode_steps += 1
                nxt = logits[:, 0].argmax(-1).cpu().numpy()
                for j in range(len(group)):
                    seqs[j].append(int(nxt[j]))
            for j, i in enumerate(group):
                outs[i] = seqs[j][len(prompts[i]):
                                  len(prompts[i]) + new_lens[i]]
        wall = time.perf_counter() - t0
        return wall, peak_blocks, decode_steps, outs

    def run_continuous():
        snap0 = _metrics.snapshot()
        engine = GenerationEngine(
            model, params=params, block_size=block_size,
            num_blocks=batch_slots * max_blocks + 1, max_seqs=batch_slots,
            prefill_chunk=prefill_chunk, queue_depth=num_requests,
            deadline_ms=0, reload_poll_seconds=0, device=dev)
        outs = [None] * num_requests
        t0 = time.perf_counter()

        def client(i):
            outs[i] = engine.generate(prompts[i], max_tokens=new_lens[i],
                                      timeout=600)

        _run_clients(client, num_requests)
        wall = time.perf_counter() - t0
        snap1 = _metrics.snapshot()
        occ0 = snap0.get("hvd_tpu_gen_batch_occupancy",
                         {"count": 0, "sum": 0})
        occ1 = snap1["hvd_tpu_gen_batch_occupancy"]
        steps = int(occ1["count"] - occ0["count"])
        occupancy = (occ1["sum"] - occ0["sum"]) / max(1, steps)
        preempt = _delta(snap1, snap0, "hvd_tpu_gen_preemptions_total")
        peak = engine.allocator.peak_in_use
        leaked = engine.allocator.in_use
        engine.close()
        assert leaked == 0, f"{leaked} KV blocks leaked"
        return wall, peak, steps, occupancy, preempt, outs

    with torch.inference_mode():
        run_static()
    run_continuous()
    with torch.inference_mode():
        st_wall, st_peak, st_steps, st_outs = run_static()
    ct_wall, ct_peak, ct_steps, ct_occ, ct_preempt, ct_outs = \
        run_continuous()
    mismatch = sum(st_outs[i] != ct_outs[i] for i in range(num_requests))
    assert mismatch == 0, f"{mismatch} sequences diverged across modes"

    return {
        "scenario": "mixed_length_generation",
        "num_requests": num_requests,
        "batch_slots": batch_slots,
        "block_size": block_size,
        "num_blocks": batch_slots * max_blocks + 1,
        "model": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                  "heads": cfg.num_heads, "head_dim": cfg.head_dim,
                  "vocab": cfg.vocab_size, "max_seq_len": cfg.max_seq_len},
        "total_prompt_tokens": sum(len(p) for p in prompts),
        "total_new_tokens": total_new,
        "static": {
            "wall_s": round(st_wall, 3),
            "tokens_per_s": round(total_new / st_wall, 1),
            "decode_steps": st_steps,
            "peak_kv_blocks": st_peak,
            "peak_kv_bytes": st_peak * per_block,
        },
        "continuous": {
            "wall_s": round(ct_wall, 3),
            "tokens_per_s": round(total_new / ct_wall, 1),
            "decode_steps": ct_steps,
            "avg_occupancy": round(ct_occ, 2),
            "preemptions": int(ct_preempt),
            "peak_kv_blocks": ct_peak,
            "peak_kv_bytes": ct_peak * per_block,
        },
        "continuous_speedup": round(st_wall / ct_wall, 2),
        "kv_bytes_vs_static_reservation": round(ct_peak / st_peak, 3)
        if st_peak else None,
    }


def sampling_sweep(num_requests: int = 16, batch_slots: int = 8,
                   block_size: int = 8, params=None,
                   device=None) -> dict:
    """Sampling modes under synchronous and double-buffered stepping:
    ``greedy`` and ``sampled`` (temperature, top-k, top-p, seeded per
    request), each at ``async_depth`` 0 and 1, through the engine.
    Reported per mode: wall seconds, useful tokens/s and the host and
    device ms per scheduler iteration from the
    ``hvd_tpu_gen_step_seconds{component}`` histograms. Each sampling
    mode's outputs must be identical across the two depths."""
    from . import metrics as _metrics
    from .serving.generation import GenerationEngine

    model, params, cfg, prompts, new_lens, dev = _gen_workload(
        num_requests, params=params, device=device)
    total_new = sum(new_lens)
    max_blocks = -(-cfg.max_seq_len // block_size)
    sampled_kw = dict(temperature=0.9, top_k=32, top_p=0.9)

    def run_mode(sampled: bool, async_depth: int):
        snap0 = _metrics.snapshot()
        engine = GenerationEngine(
            model, params=params, block_size=block_size,
            num_blocks=batch_slots * max_blocks + 1, max_seqs=batch_slots,
            prefill_chunk=16, queue_depth=num_requests, deadline_ms=0,
            async_depth=async_depth, reload_poll_seconds=0, device=dev)
        outs = [None] * num_requests
        t0 = time.perf_counter()

        def client(i):
            kw = dict(sampled_kw, seed=1000 + i) if sampled else {}
            outs[i] = engine.generate(prompts[i], max_tokens=new_lens[i],
                                      timeout=600, **kw)

        _run_clients(client, num_requests)
        wall = time.perf_counter() - t0
        snap1 = _metrics.snapshot()
        leaked = engine.allocator.in_use
        engine.close()
        assert leaked == 0, f"{leaked} KV blocks leaked"
        split = {}
        for comp in ("host", "device"):
            key = f'hvd_tpu_gen_step_seconds{{component="{comp}"}}'
            h0 = snap0.get(key, {"sum": 0.0, "count": 0})
            h1 = snap1.get(key, {"sum": 0.0, "count": 0})
            steps = h1["count"] - h0["count"]
            split[comp] = (h1["sum"] - h0["sum"]) / max(1, steps)
            split["iters"] = int(steps)
        return {
            "wall_s": round(wall, 3),
            "tokens_per_s": round(total_new / wall, 1),
            "scheduler_iters": split["iters"],
            "host_ms_per_step": round(split["host"] * 1e3, 3),
            "device_ms_per_step": round(split["device"] * 1e3, 3),
        }, outs

    modes, outputs = {}, {}
    run_mode(sampled=False, async_depth=0)
    run_mode(sampled=True, async_depth=0)
    for name, sampled, depth in (("greedy_sync", False, 0),
                                 ("greedy_async1", False, 1),
                                 ("sampled_sync", True, 0),
                                 ("sampled_async1", True, 1)):
        modes[name], outputs[name] = run_mode(sampled, depth)
    assert outputs["greedy_sync"] == outputs["greedy_async1"], \
        "greedy outputs diverged between sync and async stepping"
    assert outputs["sampled_sync"] == outputs["sampled_async1"], \
        "seeded sampled outputs diverged between sync and async stepping"

    return {
        "scenario": "on_device_sampling",
        "num_requests": num_requests,
        "batch_slots": batch_slots,
        "block_size": block_size,
        "num_blocks": batch_slots * max_blocks + 1,
        "total_new_tokens": total_new,
        "sampled_params": sampled_kw,
        "modes": modes,
        "async_speedup_greedy": round(
            modes["greedy_sync"]["wall_s"]
            / modes["greedy_async1"]["wall_s"], 2),
        "async_speedup_sampled": round(
            modes["sampled_sync"]["wall_s"]
            / modes["sampled_async1"]["wall_s"], 2),
    }


def prefix_sweep(num_requests: int = 24, batch_slots: int = 8,
                 block_size: int = 16, params=None, device=None) -> dict:
    """Automatic prefix caching on a shared-system-prompt workload: every
    request is one 64-token system prompt plus a short private suffix.
    ``cache_off`` prefills every prompt in full; ``cache_on`` serves
    request 0 alone first (so does ``cache_off``), then the concurrent
    burst attaches the system prompt's blocks and prefills only its
    suffix. Outputs must be identical across modes and no block may
    leak; per mode: wall seconds, tokens/s, prefilled tokens and the
    prefix cache's hit, miss and eviction counters."""
    from . import metrics as _metrics
    from .serving.generation import GenerationEngine

    system_tokens = 64
    model, params, cfg, prompts, new_lens, dev = _gen_workload(
        num_requests, shared_prefix=system_tokens, params=params,
        device=device)
    total_new = sum(new_lens)
    max_blocks = -(-cfg.max_seq_len // block_size)
    num_blocks = batch_slots * max_blocks + 1

    def run(prefix_cache):
        snap0 = _metrics.snapshot()
        engine = GenerationEngine(
            model, params=params, block_size=block_size,
            num_blocks=num_blocks, max_seqs=batch_slots,
            prefill_chunk=16, queue_depth=num_requests, deadline_ms=0,
            prefix_cache=prefix_cache, reload_poll_seconds=0, device=dev)
        outs = [None] * num_requests
        t0 = time.perf_counter()

        def client(i):
            outs[i] = engine.generate(prompts[i], max_tokens=new_lens[i],
                                      timeout=600)

        _run_clients(client, num_requests, first_alone=True)
        wall = time.perf_counter() - t0
        snap1 = _metrics.snapshot()
        leaked = engine.allocator.in_use
        engine.close()
        assert leaked == 0, f"{leaked} KV blocks leaked"
        return {
            "wall_s": round(wall, 3),
            "tokens_per_s": round(total_new / wall, 1),
            "prefill_tokens": int(_delta(
                snap1, snap0, 'hvd_tpu_gen_tokens_total{phase="prefill"}')),
            "hit_tokens": int(_delta(
                snap1, snap0, 'hvd_tpu_gen_prefix_cache_hit_tokens_total'
                '{source="local"}')),
            "miss_tokens": int(_delta(
                snap1, snap0, "hvd_tpu_gen_prefix_cache_miss_tokens_total")),
            "evictions": int(_delta(
                snap1, snap0, "hvd_tpu_gen_prefix_cache_evictions_total")),
        }, outs

    run(prefix_cache=False)
    run(prefix_cache=True)
    cold, cold_outs = run(prefix_cache=False)
    warm, warm_outs = run(prefix_cache=True)
    mismatch = sum(cold_outs[i] != warm_outs[i] for i in range(num_requests))
    assert mismatch == 0, f"{mismatch} sequences diverged across modes"

    return {
        "scenario": "shared_prefix_generation",
        "num_requests": num_requests,
        "batch_slots": batch_slots,
        "block_size": block_size,
        "num_blocks": num_blocks,
        "system_prompt_tokens": system_tokens,
        "total_prompt_tokens": sum(len(p) for p in prompts),
        "total_new_tokens": total_new,
        "cache_off": cold,
        "cache_on": warm,
        "cache_speedup": round(cold["wall_s"] / warm["wall_s"], 2),
        "prefill_reduction": round(
            1.0 - warm["prefill_tokens"] / cold["prefill_tokens"], 3),
    }


def spec_sweep(max_tokens: int = 96, spec_tokens: int = 4,
               block_size: int = 16, repeats: int = 3, params=None,
               device=None) -> dict:
    """N-gram speculative decoding against plain decode on one stream at
    a time (the latency rig: 8 layers x d_model 256, vocab 512, fp32),
    spec off and on, on two workloads: ``repetitive`` (greedy: the
    continuation settles into a cycle the prompt-lookup drafter replays)
    and ``random`` (seeded temperature/top-k/top-p sampling: the drafts
    almost never match). Outputs must be identical with speculation on
    and off for both, and no block may leak. Per mode: wall seconds a
    generation, tokens/s, the accept rate and the verify step's ms."""
    from . import metrics as _metrics
    from .models.transformer import TransformerConfig
    from .serving.generation import GenerationEngine

    dev = _device(device)
    cfg = TransformerConfig(vocab_size=512, num_layers=8, d_model=256,
                            num_heads=4, head_dim=64, max_seq_len=256,
                            dtype=torch.float32)
    model, params = _model_params(cfg, params, dev)
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, cfg.vocab_size, (8,)).tolist()
    max_blocks = -(-cfg.max_seq_len // block_size)
    sampled_kw = dict(temperature=0.9, top_k=32, top_p=0.9, seed=1234)

    def run(spec_mode, sampled):
        engine = GenerationEngine(
            model, params=params, block_size=block_size,
            num_blocks=2 * max_blocks + 1, max_seqs=1, prefill_chunk=16,
            queue_depth=4, deadline_ms=0, spec_mode=spec_mode,
            spec_tokens=spec_tokens, max_beams=1, reload_poll_seconds=0,
            device=dev)
        kw = dict(sampled_kw) if sampled else {}
        engine.generate(prompt, max_tokens=max_tokens, timeout=600, **kw)
        snap0 = _metrics.snapshot()
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = engine.generate(prompt, max_tokens=max_tokens,
                                  timeout=600, **kw)
        wall = (time.perf_counter() - t0) / repeats
        snap1 = _metrics.snapshot()
        leaked = engine.allocator.in_use
        engine.close()
        assert leaked == 0, f"{leaked} KV blocks leaked"
        drafted = _delta(snap1, snap0, "hvd_tpu_gen_spec_drafted_total")
        accepted = _delta(snap1, snap0, "hvd_tpu_gen_spec_accepted_total")
        vkey = 'hvd_tpu_gen_step_seconds{component="verify"}'
        v0 = snap0.get(vkey, {"sum": 0.0, "count": 0})
        v1 = snap1.get(vkey, {"sum": 0.0, "count": 0})
        vsteps = v1["count"] - v0["count"]
        row = {"wall_s": round(wall, 3),
               "tokens_per_s": round(max_tokens / wall, 1)}
        if spec_mode != "off":
            row["drafted"] = int(drafted)
            row["accepted"] = int(accepted)
            row["accept_rate"] = round(accepted / max(1, drafted), 3)
            row["verify_steps"] = int(vsteps)
            row["verify_ms_per_step"] = round(
                (v1["sum"] - v0["sum"]) / max(1, vsteps) * 1e3, 3)
        return row, out

    # each run warms its engine with one generation off the clock (the
    # JAX sweep also runs both modes once first, to compile)
    modes, outputs = {}, {}
    for name, spec_mode, sampled in (
            ("repetitive_off", "off", False),
            ("repetitive_spec", "ngram", False),
            ("random_off", "off", True),
            ("random_spec", "ngram", True)):
        modes[name], outputs[name] = run(spec_mode, sampled)
    assert outputs["repetitive_off"] == outputs["repetitive_spec"], \
        "greedy outputs diverged between spec off and on"
    assert outputs["random_off"] == outputs["random_spec"], \
        "seeded sampled outputs diverged between spec off and on"

    return {
        "scenario": "speculative_decoding",
        "num_layers": cfg.num_layers,
        "d_model": cfg.d_model,
        "max_tokens": max_tokens,
        "spec_tokens": spec_tokens,
        "block_size": block_size,
        "sampled_params": {k: v for k, v in sampled_kw.items()
                           if k != "seed"},
        "modes": modes,
        "spec_speedup_repetitive": round(
            modes["repetitive_off"]["wall_s"]
            / modes["repetitive_spec"]["wall_s"], 2),
        "spec_speedup_random": round(
            modes["random_off"]["wall_s"]
            / modes["random_spec"]["wall_s"], 2),
        "bit_identical": True,
    }


def resume_sweep(emitted: int = 256, prompt_len: int = 8,
                 block_size: int = 8, params=None, device=None) -> dict:
    """The cost of a mid-stream failover resume (``prompt + emitted``
    resubmitted with the journaled seed and ``sample_offset``) after
    ``emitted`` delivered tokens, prefix cache on and off: the time to
    the resumed first token, the gap a client sees. The tiny bench
    transformer at ``max_seq_len = prompt_len + emitted + 8``; both
    engines must continue the same sampled stream."""
    from .models.transformer import TransformerConfig
    from .serving.generation import GenerationEngine

    dev = _device(device)
    cfg = TransformerConfig(vocab_size=512, num_layers=4, d_model=128,
                            num_heads=4, head_dim=32,
                            max_seq_len=prompt_len + emitted + 8,
                            dtype=torch.float32)
    model, params = _model_params(cfg, params, dev)
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, cfg.vocab_size, (prompt_len,)).tolist()
    num_blocks = 2 * ((prompt_len + emitted + 8) // block_size + 2)
    sampling = dict(temperature=0.9, top_k=40, top_p=0.95, seed=7)

    def run(prefix_cache):
        with GenerationEngine(model, params=params, block_size=block_size,
                              num_blocks=num_blocks, max_seqs=2,
                              prefill_chunk=32, deadline_ms=0,
                              prefix_cache=prefix_cache,
                              reload_poll_seconds=0, device=dev) as eng:
            head = eng.result(
                eng.submit(prompt, max_tokens=emitted, **sampling),
                timeout=1200)
            t0 = time.perf_counter()
            tail = eng.result(
                eng.submit(prompt + head, max_tokens=1,
                           sample_offset=emitted, **sampling),
                timeout=1200)
            first_token_ms = (time.perf_counter() - t0) * 1e3
            return head, tail, round(first_token_ms, 2)

    head_on, tail_on, ms_on = run(True)
    head_off, tail_off, ms_off = run(False)
    return {
        "scenario": "stream_resume_cost",
        "emitted_tokens": emitted,
        "prompt_len": prompt_len,
        "bit_identical": bool(head_on == head_off and tail_on == tail_off),
        "resume_first_token_ms_cache_on": ms_on,
        "resume_first_token_ms_cache_off": ms_off,
        "cached_resume_speedup": round(ms_off / max(ms_on, 1e-9), 2),
    }


# ---------------------------------------------------------------------------
# SDC guard, tracing
# ---------------------------------------------------------------------------

def sdc_guard_sweep(steps: int = 40, rounds: int = 3,
                    fingerprint_every: int = 20, device=None) -> dict:
    """The SDC defence's cost on ResNet-50's 161 gradients: an SGD update
    over the whole gradient set (one multi-tensor ``_foreach`` pass),
    plain against guarded by :func:`~.sdc.guard_update` (the update
    applied only on a clean verdict, chosen on the device: no host sync),
    plus the parameter fingerprint fold every ``fingerprint_every``
    steps."""
    from . import sdc

    dev = _device(device)
    shapes = resnet50_grad_shapes()
    rng = np.random.RandomState(0)
    params = [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.01)
              .to(dev) for s in shapes]
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.001)
             .to(dev) for s in shapes]
    total_bytes = sum(p.numel() * 4 for p in params)
    loss = torch.ones((), dtype=torch.float32, device=dev)

    def step_plain(ps):
        return torch._foreach_add(ps, grads, alpha=-0.01)

    def step_guarded(ps, ewma):
        code, ewma = sdc.guard_update(grads, loss, ewma, factor=10.0)
        ok = code == 0
        new = torch._foreach_add(ps, grads, alpha=-0.01)
        return [torch.where(ok, n, p) for n, p in zip(new, ps)], code, ewma

    def run_plain():
        ps = params
        for _ in range(steps):
            ps = step_plain(ps)
        _fence(dev)

    def run_guarded():
        ps = params
        ewma = torch.ones((), dtype=torch.float32, device=dev)
        for i in range(steps):
            ps, _, ewma = step_guarded(ps, ewma)
            if (i + 1) % fingerprint_every == 0:
                sdc.fold_fingerprint(ps)
        _fence(dev)

    with torch.no_grad():
        t0 = time.perf_counter()
        fp = sdc.fold_fingerprint(params)
        fingerprint_s = time.perf_counter() - t0
        assert 0 <= fp < 2 ** 32
        run_plain(), run_guarded()
        t_plain = t_guard = float("inf")
        for _ in range(max(rounds, 2)):
            t0 = time.perf_counter()
            run_plain()
            t_plain = min(t_plain, time.perf_counter() - t0)
            t0 = time.perf_counter()
            run_guarded()
            t_guard = min(t_guard, time.perf_counter() - t0)

    plain_ms = t_plain / steps * 1e3
    guard_ms = t_guard / steps * 1e3
    return {
        "scenario": "resnet50_sdc_guard",
        "platform": dev.type,
        "num_grads": len(shapes),
        "total_mb": round(total_bytes / (1 << 20), 1),
        "steps_timed": steps,
        "fingerprint_every": fingerprint_every,
        "plain_ms_per_step": round(plain_ms, 3),
        "guarded_ms_per_step": round(guard_ms, 3),
        "fingerprint_fold_ms": round(fingerprint_s * 1e3, 3),
        "fingerprint_amortized_ms": round(
            fingerprint_s * 1e3 / fingerprint_every, 4),
        "overhead_pct": round((guard_ms - plain_ms) / plain_ms * 100, 2)
        if plain_ms > 0 else None,
        "target_pct": 2.0,
    }


def tracing_overhead_sweep(requests: int = 20000, rounds: int = 3) -> dict:
    """Per-request cost of the tracer on the serving hot path's call
    sites (a root ``request_span``, a nested span, a retroactive
    ``emit_span`` and one ``collective`` hook a request) with
    ``HVD_TPU_TRACE_SAMPLE=0`` (the default: every site reduces to the
    module's no-op guard) and ``=1`` (every request traced into the
    in-memory ring, no span file), against a bare loop."""
    from . import tracing

    rids = [f"{i:016x}" for i in range(requests)]
    entry = ("allreduce", "grad_0", (1024,), "float32")

    def run_bare():
        for _ in range(requests):
            t = time.monotonic()
            assert t

    def run_traced():
        for rid in rids:
            with tracing.request_span("server.generate", rid):
                with tracing.span("gen.prefill"):
                    tracing.collective(entry)
                t = time.monotonic()
                tracing.emit_span(tracing.current(), "gen.decode", t, t)

    def set_rate(rate):
        os.environ["HVD_TPU_TRACE_SAMPLE"] = rate
        tracing.reset()

    prior = os.environ.get("HVD_TPU_TRACE_SAMPLE")
    prior_dir = os.environ.pop("HVD_TPU_TRACE_DIR", None)
    try:
        t_bare = t_off = t_on = float("inf")
        for _ in range(max(rounds, 2) + 1):    # the first round warms up
            t0 = time.perf_counter()
            run_bare()
            t_bare = min(t_bare, time.perf_counter() - t0)
            set_rate("0")
            assert tracing.tracer() is None
            t0 = time.perf_counter()
            run_traced()
            t_off = min(t_off, time.perf_counter() - t0)
            set_rate("1")
            assert tracing.tracer() is not None
            t0 = time.perf_counter()
            run_traced()
            t_on = min(t_on, time.perf_counter() - t0)
    finally:
        if prior is None:
            os.environ.pop("HVD_TPU_TRACE_SAMPLE", None)
        else:
            os.environ["HVD_TPU_TRACE_SAMPLE"] = prior
        if prior_dir is not None:
            os.environ["HVD_TPU_TRACE_DIR"] = prior_dir
        tracing.reset()

    bare_us = t_bare / requests * 1e6
    off_us = t_off / requests * 1e6
    on_us = t_on / requests * 1e6
    return {
        "scenario": "request_tracing_overhead",
        "requests_timed": requests,
        "call_sites_per_request": 4,
        "spans_per_request_on": 4,
        "bare_us_per_req": round(bare_us, 4),
        "off_us_per_req": round(off_us, 4),
        "on_us_per_req": round(on_us, 4),
        "off_overhead_us_per_req": round(off_us - bare_us, 4),
        "on_overhead_us_per_req": round(on_us - off_us, 4),
        "on_over_off": round(on_us / off_us, 2) if off_us > 0 else None,
    }


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def _stub_server(slow_every: int, slow_ms: float, fast_ms: float):
    """A latency-scripted replica: every ``slow_every``-th POST (cancels
    excluded) sleeps ``slow_ms``, the rest ``fast_ms``."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Stub(BaseHTTPRequestHandler):
        count = 0
        lock = threading.Lock()

        def do_GET(self):  # noqa: N802 — /healthz for circuit probes
            self._answer(b'{"ok": true}')

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            self.rfile.read(length)
            if self.path != "/v1/cancel":
                with type(self).lock:
                    type(self).count += 1
                    n = type(self).count
                time.sleep((slow_ms if n % slow_every == 0 else fast_ms)
                           / 1e3)
            self._answer(b'{"outputs": []}')

        def _answer(self, body):
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def hedging_sweep(requests: int = 80, slow_every: int = 10,
                  slow_ms: float = 250.0, fast_ms: float = 4.0,
                  hedge_quantile: float = 0.8) -> dict:
    """Tail latency of the fleet router's hedged retries when one request
    in ``slow_every`` stalls on its replica for ``slow_ms``. The replicas
    are latency-scripted HTTP stubs (no model): what is measured is the
    router's hedge race. p50/p99 with hedging off and on; the p99 ratio
    is the number. The quantile sits below the slow fraction (0.8 <
    0.9), since the router indexes its sorted latency window at
    ``int(q * n)``; the retry budget is held wide open for the run."""
    import urllib.request

    from . import metrics as _metrics
    from .serving import fleet

    knobs = {"HVD_TPU_FLEET_HEDGE_QUANTILE": None,
             "HVD_TPU_FLEET_RETRY_BUDGET_RATIO": "1.0",
             "HVD_TPU_FLEET_RETRY_BUDGET_BURST": "64"}

    def measure(quantile):
        knobs["HVD_TPU_FLEET_HEDGE_QUANTILE"] = str(quantile)
        prior = {k: os.environ.get(k) for k in knobs}
        os.environ.update(knobs)
        stubs = [_stub_server(slow_every, slow_ms, fast_ms)
                 for _ in range(2)]
        try:
            router = fleet.FleetRouter(
                {f"r{i}": f"http://127.0.0.1:{s.server_address[1]}"
                 for i, s in enumerate(stubs)},
                port=0, addr="127.0.0.1")
            router.start()
            lat = []
            body = json.dumps({"inputs": [[0.0]]}).encode()
            try:
                for _ in range(requests):
                    req = urllib.request.Request(
                        router.url + "/v1/infer", data=body, method="POST",
                        headers={"Content-Type": "application/json"})
                    t0 = time.perf_counter()
                    with urllib.request.urlopen(req, timeout=30) as resp:
                        resp.read()
                    lat.append((time.perf_counter() - t0) * 1e3)
            finally:
                router.stop()
            return lat
        finally:
            for k, v in prior.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            for s in stubs:
                s.shutdown()
                s.server_close()

    off = measure(0.0)
    before = _metrics.snapshot()
    on = measure(hedge_quantile)
    snap = _metrics.snapshot()

    def pct(xs, q):
        return round(float(np.percentile(np.asarray(xs), q)), 2)

    launched = _delta(snap, before,
                      'hvd_tpu_fleet_hedges_total{outcome="launched"}')
    won = _delta(snap, before, 'hvd_tpu_fleet_hedges_total{outcome="won"}')
    return {
        "scenario": "fleet_hedging_tail",
        "requests": requests,
        "slow_every": slow_every,
        "slow_ms": slow_ms,
        "fast_ms": fast_ms,
        "hedge_quantile": hedge_quantile,
        "off": {"p50_ms": pct(off, 50), "p99_ms": pct(off, 99)},
        "on": {"p50_ms": pct(on, 50), "p99_ms": pct(on, 99),
               "hedges_launched": int(launched), "hedges_won": int(won)},
        "p99_speedup": round(pct(off, 99) / max(pct(on, 99), 1e-9), 2),
    }


def disagg_sweep(num_requests: int = 16, batch_slots: int = 8,
                 block_size: int = 16, params=None, device=None) -> dict:
    """Disaggregated prefill/decode serving against colocated, end to end
    through HTTP fleets of the port's servers on the shared-system-prompt
    workload: two colocated replicas behind a plain router, then one
    prefill and one decode replica behind a pooled router (every request
    prefills on the prefill pool, the KV manifest is offered to the
    decode replica, and only missing blocks move). Outputs must be
    identical across modes, and a fully warm repeat through the pooled
    fleet must move zero transfer bytes. Per mode: wall seconds, tokens/s
    and per-request p50/p99; the pooled row adds the transfer bytes and
    seconds and the ``source="transfer"`` prefix hits."""
    import urllib.request

    from . import metrics as _metrics
    from .serving import InferenceServer
    from .serving import fleet
    from .serving.generation import GenerationEngine

    system_tokens = 64
    model, params, cfg, prompts, new_lens, dev = _gen_workload(
        num_requests, shared_prefix=system_tokens, params=params,
        device=device)
    total_new = sum(new_lens)
    max_blocks = -(-cfg.max_seq_len // block_size)
    num_blocks = batch_slots * max_blocks + 1

    def make_replica(role):
        eng = GenerationEngine(
            model, params=params, block_size=block_size,
            num_blocks=num_blocks, max_seqs=batch_slots,
            prefill_chunk=16, queue_depth=num_requests, deadline_ms=0,
            role=role, reload_poll_seconds=0, device=dev)
        srv = InferenceServer(None, port=0, addr="127.0.0.1",
                              gen_engine=eng)
        srv.start()
        return srv

    def post(url, doc):
        req = urllib.request.Request(
            url, data=json.dumps(doc).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    TB = "hvd_tpu_disagg_transfer_bytes_total"
    TS = "hvd_tpu_disagg_transfer_seconds"
    HIT_T = ('hvd_tpu_gen_prefix_cache_hit_tokens_total'
             '{source="transfer"}')

    def run(pooled):
        if pooled:
            srvs = {"p0": make_replica("prefill"),
                    "d0": make_replica("decode")}
            pools = {"p0": "prefill", "d0": "decode"}
        else:
            srvs = {"r0": make_replica("colocated"),
                    "r1": make_replica("colocated")}
            pools = None
        router = fleet.FleetRouter(
            {rid: f"http://127.0.0.1:{s.port}" for rid, s in srvs.items()},
            port=0, addr="127.0.0.1", pools=pools)
        router.start()
        outs = [None] * num_requests
        lat = [0.0] * num_requests
        try:
            snap0 = _metrics.snapshot()
            t0 = time.perf_counter()

            def client(i):
                t1 = time.perf_counter()
                outs[i] = post(router.url + "/v1/generate",
                               {"prompt": prompts[i],
                                "max_tokens": new_lens[i]})["tokens"]
                lat[i] = (time.perf_counter() - t1) * 1e3
            # request 0 alone first: the pooled fleet's cold transfer
            # ships the shared system prompt once
            _run_clients(client, num_requests, first_alone=True)
            wall = time.perf_counter() - t0
            snap1 = _metrics.snapshot()
            repeat = post(router.url + "/v1/generate",
                          {"prompt": prompts[0],
                           "max_tokens": new_lens[0]})["tokens"]
            snap2 = _metrics.snapshot()
            assert repeat == outs[0], "warm repeat diverged"
            warm_bytes = _delta(snap2, snap1, TB)
            if pooled:
                assert warm_bytes == 0, \
                    f"warm shared prefix moved {warm_bytes} bytes"
        finally:
            router.stop()
            for s in srvs.values():
                s.close()

        lat_np = np.asarray(lat)
        row = {
            "wall_s": round(wall, 3),
            "tokens_per_s": round(total_new / wall, 1),
            "p50_ms": round(float(np.percentile(lat_np, 50)), 2),
            "p99_ms": round(float(np.percentile(lat_np, 99)), 2),
        }
        if pooled:
            row["transfer_bytes"] = int(_delta(snap1, snap0, TB))
            row["transfer_seconds"] = round(_delta(snap1, snap0, TS), 4)
            row["transfer_hit_tokens"] = int(_delta(snap1, snap0, HIT_T))
            row["warm_repeat_transfer_bytes"] = int(warm_bytes)
        return row, outs

    run(pooled=False)
    run(pooled=True)
    colo, colo_outs = run(pooled=False)
    pool, pool_outs = run(pooled=True)
    mismatch = sum(colo_outs[i] != pool_outs[i] for i in range(num_requests))
    assert mismatch == 0, f"{mismatch} sequences diverged across modes"

    return {
        "scenario": "disagg_prefill_decode",
        "num_requests": num_requests,
        "batch_slots": batch_slots,
        "block_size": block_size,
        "num_blocks": num_blocks,
        "system_prompt_tokens": system_tokens,
        "total_new_tokens": total_new,
        "bit_identical": True,
        "colocated": colo,
        "pooled": pool,
    }


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _in_world(device, fn):
    """``fn()`` inside a world of one on ``device``, shut down after."""
    from . import basics
    basics.init(device=device)
    try:
        return fn()
    finally:
        basics.shutdown()


#: tries of a worker world whose rank-0 store finds its port taken
_WORLD_ATTEMPTS = 3


def _spawn_world(nproc: int, worker_args: List[str], timeout: float):
    """A gloo world of ``nproc`` CPU processes running this module with
    ``worker_args``; rank 0's MB_JSON rows (raises if a rank fails). The
    coordinator port is picked here and bound by rank 0 seconds later,
    after its interpreter starts; a port some other socket took in
    between (EADDRINUSE: a busy host's ephemeral connections) is retried
    with a new one."""
    import tempfile
    from .basics import _free_port
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    for attempt in range(_WORLD_ATTEMPTS):
        port = _free_port()
        procs, logs = [], []
        for rank in range(nproc):
            env = dict(os.environ,
                       HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                       HVD_TPU_SIZE=str(nproc), HVD_TPU_RANK=str(rank),
                       CUDA_VISIBLE_DEVICES="", PYTHONPATH=path)
            logs.append((tempfile.TemporaryFile(mode="w+"),
                         tempfile.TemporaryFile(mode="w+")))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "horovod_tpu_torch.microbench",
                 *worker_args], env=env, text=True, stdout=logs[-1][0],
                stderr=logs[-1][1]))
        # a rank that fails leaves its peers waiting on the store: stop
        # them at once rather than at their rendezvous timeout
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                break
            time.sleep(0.1)
        outs, err = [], ""
        for out_f, err_f in logs:
            out_f.seek(0)
            err_f.seek(0)
            outs.append(out_f.read())
            err += err_f.read()
            out_f.close()
            err_f.close()
        sys.stderr.write(err)
        rcs = [p.returncode for p in procs]
        if not any(rcs):
            return [json.loads(line[len(MB_TAG):])
                    for line in outs[0].splitlines()
                    if line.startswith(MB_TAG)]
        if "EADDRINUSE" not in err or attempt == _WORLD_ATTEMPTS - 1:
            raise RuntimeError(f"worker world {worker_args} failed: "
                               f"rcs {rcs}")


def _worker(kind: str, quick: bool) -> int:
    """One rank of a gloo world over CPU tensors (``--worker``)."""
    from . import basics
    basics.init(device="cpu")
    try:
        if kind == "eager":
            rows = eager_sweep(sizes=DEFAULT_SIZES[:4] if quick
                               else DEFAULT_SIZES, iters=3 if quick else 5)
            rows.append(bucketed_optimizer_sweep(iters=2 if quick else 3))
        else:
            rows = [scaling_sweep_point(
                batch_per_device=4 if quick else 8,
                num_iters=2 if quick else 3,
                num_batches_per_iter=3 if quick else 5, device="cpu")]
        if basics.rank() == 0:
            for row in rows:
                print(MB_TAG + json.dumps(row), flush=True)
    finally:
        basics.shutdown()
    return 0


def _split_bucketed(rows):
    return ([r for r in rows if "scenario" not in r],
            next((r for r in rows if "scenario" in r), None))


def run_section(name: str, quick: bool, device,
                cpu_worlds: bool = True) -> dict:
    """One section's line: ``{"section", "device", "backend", "result"}``
    (device and backend are those the section's numbers were taken on).
    ``cpu_worlds=False`` leaves out scaling's gloo worlds of CPU
    processes beside the card's own point."""
    dev = _device(device)
    here = {"device": dev.type,
            "backend": "nccl" if dev.type == "cuda" else "gloo"}
    cpu = {"device": "cpu", "backend": "gloo"}
    if name in ("eager_1proc", "eager_2proc"):
        if name == "eager_1proc":
            rows = _in_world(dev, lambda: eager_sweep(
                sizes=DEFAULT_SIZES[:4] if quick else DEFAULT_SIZES,
                iters=3 if quick else 5) + [bucketed_optimizer_sweep(
                    iters=2 if quick else 3)])
            where = here
        else:
            rows = _spawn_world(2, ["--worker", "eager"]
                                + (["--quick"] if quick else []), 900)
            where = cpu
        plain, bucketed = _split_bucketed(rows)
        return {**where, "result": {"rows": plain, "bucketed": bucketed}}
    if name == "scaling":
        points = [dict(_in_world(dev, lambda: scaling_sweep_point(
            batch_per_device=4 if quick else 8,
            num_iters=2 if quick else 3,
            num_batches_per_iter=3 if quick else 5, device=dev)), **here)]
        for n in ((1, 2) if quick else (1, 2, 4)) if cpu_worlds else ():
            if n == 1 and dev.type == "cpu":
                continue
            row = _spawn_world(n, ["--worker", "scaling"]
                               + (["--quick"] if quick else []), 600)[0]
            points.append(dict(row, **cpu))
        for p in points:
            base = next(b for b in points if b["num_devices"] == 1
                        and b["device"] == p["device"])
            p["efficiency_vs_1dev"] = round(
                p["images_per_sec_total"]
                / (p["num_devices"] * base["images_per_sec_total"]), 3)
        devices = {p["device"] for p in points}
        return {"device": devices.pop() if len(devices) == 1 else "mixed",
                "backend": "see points", "result": points}
    if name == "injit":
        return {**here, "result": [_in_world(
            dev, lambda: injit_optimizer_sweep(iters=2 if quick else 4))]}
    if name == "generation":
        return {**here, "result": {
            "generation": generation_sweep(
                num_requests=12 if quick else 24, device=dev),
            "generation_sampling": sampling_sweep(
                num_requests=8 if quick else 16, device=dev),
            "generation_prefix": prefix_sweep(
                num_requests=12 if quick else 24, device=dev),
            # 96 tokens even when quick: the accept rate needs the
            # repetition to settle in
            "generation_spec": spec_sweep(max_tokens=96,
                                          repeats=2 if quick else 3,
                                          device=dev)}}
    if name == "sdc":
        return {**here, "result": sdc_guard_sweep(
            steps=20 if quick else 40, rounds=2 if quick else 3,
            device=dev)}
    if name == "tracing":
        return {"device": "host", "backend": None,
                "result": tracing_overhead_sweep(
                    requests=5000 if quick else 20000,
                    rounds=2 if quick else 3)}
    if name == "failover":
        return {**here, "result": {
            "hedging": hedging_sweep(requests=40 if quick else 80),
            "resume": resume_sweep(emitted=96 if quick else 256,
                                   device=dev)}}
    if name == "disagg":
        return {**here, "result": disagg_sweep(
            num_requests=8 if quick else 16,
            batch_slots=4 if quick else 8, device=dev)}
    raise ValueError(f"unknown section {name!r}; expected one of "
                     f"{', '.join(SECTIONS)}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.microbench",
        description="Microbenchmarks of horovod_tpu_torch, one JSON line "
                    "per section.")
    ap.add_argument("--quick", action="store_true",
                    help="the smaller sizes (as the root microbench.py's "
                         "--quick)")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated sections (default: all)")
    ap.add_argument("--out", default=None,
                    help="also write every section's line to this JSON file")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--worker", choices=("eager", "scaling"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args.worker, args.quick)
    names = [s.strip() for s in args.sections.split(",") if s.strip()]
    unknown = sorted(set(names) - set(SECTIONS))
    if unknown:
        ap.error(f"unknown sections {unknown}; expected some of "
                 f"{', '.join(SECTIONS)}")
    dev = _device(args.device)
    t0 = time.perf_counter()
    doc: Dict[str, dict] = {"quick": args.quick}
    for name in names:
        t = time.perf_counter()
        line = {"section": name, **run_section(name, args.quick, dev),
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        doc[name] = line
    doc["wall_s"] = time.perf_counter() - t0
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
