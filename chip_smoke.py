#!/usr/bin/env python3
"""Smoke test of horovod_tpu_torch on one NVIDIA GPU (an H100 SXM is the
target): the quickest proof that the port builds and trains on the card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Each phase prints one JSON line; any failure raises and exits non-zero.

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: every CUDA kernel of the port, from the sources in the checkout;
3. kernel: each kernel against its plain PyTorch version on the card, at
   the training shape and at edge cases, each with its tolerance, and two
   planted faults that the bf16 tolerance must reject; then its time, the
   plain version's, the PyTorch library call's and the bound;
4. gradient: the flash autograd Function's dq, dk, dv (lse cotangent
   included) against autograd through the plain reference;
5. ring: ring attention over sp = 4 driven on one card, every ring
   position in turn (parallel.ring_attention_local: the per-step compute
   of the process-group version, with the K/V blocks held here), at the
   default config's attention (B 8, H 12, D 64, bf16, causal) and S 8192,
   so each step's kernel call is the training shape (BH 96, S 2048, D 64)
   with nonzero device offsets. Forward and backward are held to one
   full-sequence flash call at S 8192 and to the plain fp32 attention at
   B 1; the launches are counted (16 forward, 16 recomputed in backward)
   and the ring is timed against the single call.
6. tensor_parallel: the full-width default model's decoder layer 0 split
   into tp = 4 blocks (parallel.mesh_utils.tensor_parallel_blocks and
   tensor_parallel_local: each
   block's attention over 3 of the 12 heads and its MLP over 768 of the
   3072 columns run in turn on the card, the partial outputs summed in
   bf16 as the tp group's sum does), B 8, S 2048, so each block's flash
   call is at BH 24, S 2048, D 64, bf16, causal. Held to the unsplit
   layer (relative L2), 4 launches counted, and the kernel at BH 24 held
   to its plain version and timed against the BH-96 call, its plain
   version, SDPA and its bound.
7. train: the full-width default TransformerConfig (111,121,920
   parameters, bf16 activations) trained for a few steps at batch
   8 x 2048 through hvd.init() (NCCL), broadcast_parameters and
   DistributedOptimizer(AdamW), after a small run that holds the flash
   path's losses against the plain attention's; the kernel launch counts
   are reset just before the full-width steps and read just after. Then
   the same full-width steps with the model's default attention, whose
   losses the flash path's must track.
8. checkpoint: the trained bundle's state (444.5 MB of parameters, 889 MB
   of AdamW state) saved through the port's CheckpointManager under
   build/, once synchronously and once asynchronously; 2 more steps,
   restore, the same 2 steps again: losses and parameters bit-identical
   (torch.equal). A planted bad shard must raise IntegrityError, and a
   restore with fallback must then land on the previous step. Prints the
   sync save's ms and GB/s, the async save's on-thread snapshot ms, and
   the restore's ms and GB/s.
9. cnn: the CNN zoo through the synthetic benchmark's rig
   (horovod_tpu_torch.benchmark._Rig: DistributedOptimizer(SGD) on NCCL at
   size 1, bf16 activations on fp32 parameters, channels_last, cuDNN
   autotuning on). ResNet-50 at full width (224 x 224, 1000 classes)
   timed at batch 256 with the conv and the space-to-depth stem and at
   batch 128 with the conv stem: img/s, ms/step, MFU from the FLOPs
   counted for a step against the 989 TFLOP/s bf16 peak, peak memory,
   finite losses; then one timed step each of VGG16 (224) and
   InceptionV3 (299). Last, the same ResNet-50 in fp32 at batch 4 on the
   card and on the port's CPU path from the same weights (BatchNorm
   parameters and statistics drawn at random, so every block computes):
   eval logits, train-mode logits and the updated batch statistics held
   to the CPU's, and one SGD step's parameter update, whole and tensor by
   tensor, held to an fp64 step on the CPU that replays the card's ReLU
   decisions (see TOL_CNN_UPDATE). No kernel
   of the port runs here: the JAX package's CNNs reach no Pallas kernel.
10. collectives: every collective verb on CUDA tensors through NCCL at
   size 1, at the full-width trainer's sizes (its parameters, its AdamW
   state, its gradient set in the optimizer's 7 buckets): parameter and
   optimizer-state broadcast, grouped allreduce under every op, allgather,
   alltoall with explicit splits, grouped broadcast, a process set, the
   object verbs on the optimizer's state_dict(), SyncBatchNorm forward and
   backward against nn.BatchNorm, then join() and join_round(); each is
   checked exactly against its size-1 answer and timed (ms and GB/s, one
   line per verb; NCCL at size 1 is a device copy, so these are the
   port's own overheads, not a network's).

11. elastic: the launcher and elastic training (after the world of the
   phases above is shut down). (a) ``python -m horovod_tpu_torch.runner
   -np 1`` starts this script as a worker (``--elastic-worker static``):
   3 full-width steps of the default config on NCCL, on the train phase's
   seeds, whose losses must equal the train phase's first 3, bit for bit.
   (b) The same with ``--min-np 1 --host-discovery-script`` (a script that
   prints localhost:1): the elastic driver, the rendezvous, the
   notification service and heartbeats, the worker under
   hvd.elastic.run with a TorchState committed, durably, every step;
   prints each commit's on-thread save ms and durable-write ms and the
   flash launches, and the losses must again equal the train phase's.
   (c) In this process, at full width: hvd.elastic.run with a TorchState;
   the training function raises HostsUpdatedInterrupt once after step 2's
   commit, the in-process reset re-forms NCCL at size 1, and the run
   completes 4 steps. The state on re-entry must equal the commit
   (torch.equal, parameters and AdamW state) and the final parameters an
   uninterrupted 4-step run's (torch.equal); prints the reset's ms.
12. estimator: Estimator.fit on the default config at full width through
   the flash kernel, NCCL at size 1, one epoch of 32 sequences x 2048
   from seed 0 (4 steps at batch 8), the default Adam. (a) Its per-step
   losses and final parameters equal, bit for bit, a hand loop over the
   same data.batches order with the same model, DistributedOptimizer(Adam)
   and loss; 12 flash launches a step; its steady step ms beside the train
   phase's. (b) The same fit under the SDC guard with fingerprints every
   step and a bitflip in the second step's local gradients: the guard
   trips once, the batch is retried, no rollback, and the parameters
   equal (a)'s (torch.equal); prints the guard's and the fingerprint
   fold's ms a call beside the time to read the 444.5 MB of parameters
   once at the card's bandwidth. (c) That fit's epoch-end checkpoint
   restores equal to (a)'s parameters. (d) predict on 3 and 5 rows
   (buckets 4 and 8): the rows equal the live rows of a forward at the
   padded shape, and lie within TOL_PREDICT_REL of an unpadded forward.
   (e) The fit again in a world made with HVD_TPU_AUTOTUNE and small
   sample settings: the threshold changes, the buckets are re-planned,
   and the losses and parameters equal (a)'s bit for bit.
13. reductions: the compiled-plane DistributedOptimizer (axis_name=
   "cross", inner_axis="local", mesh= the world's ("cross", "local")
   DeviceMesh, both dims of size 1) training the train phase's model,
   weights, data and AdamW, NCCL at size 1, 4 steps under each
   (reduce_strategy, packing) without compression, under packed +
   Compression.int8, and under op=Adasum; then tune_distributed_step over
   the four variants (each a fresh model, 4 calls). At size 1 every
   uncompressed reduction is the identity: those losses, Adasum's and
   every tuned variant's equal one another and the train phase's (the
   eager plane) bit for bit; int8's are finite, its first equal, the rest
   within TOL_INT8_LOSS. Prints each variant's steady ms a step, the int8
   reduction's ms a step against its memory bound, the adopted variant
   and the flash launches (12 a step).

Then a {"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

# tolerances, kernel against plain version (at the kernel's key tile) on
# the same inputs. fp32 outputs differ only by the order of fp32 sums (and
# expf against torch.exp): absolute TOL_FP32.
TOL_FP32 = 1e-5
# bf16 and fp16 outputs are the same fp32 sums in another order, rounded to
# the output type; the two disagree only where their fp32 values straddle
# a rounding boundary, of the output or of one element of P (rounded to
# V's type before P.V). So (1) every element lies within
#     2 ulp(|ref|) + 2^-m (P|V|)
# (one output rounding, with room for the fp32 noise, plus a one-step
# change of every P element at once; m is the type's mantissa bits and P|V|
# the plain version run on |V|), and (2) at most MISMATCH_LIMIT of the
# elements differ at all. (2) catches faults that stay inside (1), such as
# P not rounded before P.V: the planted faults below must fail it.
MANTISSA_BITS = {"bfloat16": 7, "float16": 10}
MISMATCH_LIMIT = 0.05
TOL_LSE = 1e-4
TOL_GRAD = 1e-4          # fp32 gradients, same reason as TOL_FP32
TOL_SMALL_LOSS = 1e-4    # fp32 losses of the small flash-vs-plain run
# full-width bf16 losses, flash against the model's default attention from
# the same weights and data. The default attention rounds the scores to
# bf16 before the softmax (flash keeps them fp32), which moves a loss that
# is a mean over 16384 tokens by far less than TOL_FULL_LOSS_EARLY over
# steps 1-2; from step 3 AdamW at 1e-3 amplifies the difference of the two
# roundings from step to step, so steps 3-4 are held to 1% of the loss.
TOL_FULL_LOSS_EARLY = 1e-3
TOL_FULL_LOSS_LATE = 0.1

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3

TRAIN_STEPS = 4
BATCH = 8

# ring phase: sp positions and global sequence length
RING_SP = 4
RING_SEQ = 8192
# ring output (bf16) against one full-sequence flash call, per element:
#     2 ulp(|full|) + 3 * 2^-8 (P|V|)
# one output rounding on each side (with room for the fp32 noise); 2^-8
# (P|V|) for the ring's partial outputs, each rounded to bf16 before the
# log-sum-exp merge (their merge weights sum to one, and each partial is
# at most its share of P|V|); and 2^-8 (P|V|) twice for P, which each side
# rounds to bf16 relative to another running max (per shard in the ring).
# Against the exact fp32 attention the full call's terms drop out:
#     2 ulp(|ref|) + 2 * 2^-8 (P|V|).
RING_P_TERMS_VS_FULL = 3
RING_P_TERMS_VS_EXACT = 2
# gradients (bf16 dq, dk, dv; the backward is the fp32 plain version on
# both sides, fed by bf16 outputs that differ as above): relative L2 error
# within 2^-7, a few bf16 roundings (2^-8 each) of every element
TOL_RING_GRAD_REL = 2.0 ** -7

# tensor_parallel phase: tp blocks of decoder layer 0. The split layer's
# output (bf16) against the unsplit layer's: each block's products are
# rounded to bf16 before the tp sum, which adds in bf16 (a rounding per
# add), and the q/k/v and MLP products run at a quarter of the width, so
# every element carries a few more bf16 roundings (2^-8 each) than the
# unsplit layer's: relative L2 within 2^-7, as the ring's gradients.
TP = 4
TOL_TP_REL = 2.0 ** -7


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(logs) -> dict:
    """{kernel instantiation: its ptxas spill and register lines} from the
    ``nvcc -Xptxas -v`` logs of a build."""
    types = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32"}
    report, entry = {}, None
    for line in "\n".join(logs).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            t = re.search(r"(flash_fwd_[a-z]+)I(\w+?)Li(\d+)E", m.group(1))
            entry = (f"{t.group(1)}<{types.get(t.group(2), t.group(2))}, "
                     f"{t.group(3)}>" if t else m.group(1))
        elif entry and ("registers" in line or "spill" in line):
            report.setdefault(entry, []).append(
                line.split("info    :")[-1].strip())
    return report


def visible_pairs(sq, sk, causal, q_off, k_off) -> int:
    """(query, key) pairs the attention has to compute for these inputs."""
    if not causal:
        return sq * sk
    return sum(min(max(q_off + i - k_off + 1, 0), sk) for i in range(sq))


def half_agreement(torch, fa, out, ref, q, k, v, q_off, k_off, causal):
    """A bf16/fp16 output against the plain version's: (the largest
    |out - ref| over its bound, the share of elements that differ); the
    limits are 1 and MISMATCH_LIMIT."""
    bits = MANTISSA_BITS[str(ref.dtype).split(".")[-1]]
    r = ref.float()
    _, e = torch.frexp(r.abs().clamp_min(torch.finfo(ref.dtype).tiny))
    ulp = torch.ldexp(torch.ones_like(r), e - 1 - bits)
    pv, _ = fa.flash_fwd_plain(q, k, v.abs(), q_off, k_off, causal,
                               block_k=fa.KEY_TILE)
    diff = (out.float() - r).abs()
    bound = 2 * ulp + 2.0 ** -bits * pv.float()
    return (diff / bound).max().item(), (diff > 0).float().mean().item()


def planted_faults(torch, fa, q, k, v, ref):
    """Two faults, each run through the plain version at the main-path
    shape, that the bf16 limits must reject: P not rounded to bf16 before
    P.V, and keys 1024-1087 of V weighted 1 + 2^-6."""
    bh, s, d = q.shape
    q4, k4, v4 = (t.view(1, bh, s, d).transpose(1, 2) for t in (q, k, v))
    unrounded = fa.mha_reference(q4, k4, v4, causal=True).transpose(1, 2) \
        .reshape(bh, s, d)
    v_bad = v.clone()
    v_bad[:, 1024:1088] = (v_bad[:, 1024:1088].float()
                           * (1 + 2.0 ** -6)).to(v.dtype)
    misweighted, _ = fa.flash_fwd_plain(q, k, v_bad, 0, 0, True,
                                        block_k=fa.KEY_TILE)
    readings = {}
    for name, bad in (("p_not_rounded", unrounded),
                      ("v_tile_misweighted", misweighted)):
        ratio, share = half_agreement(torch, fa, bad, ref, q, k, v, 0, 0,
                                      True)
        readings[name] = {"max_over_bound": ratio, "mismatch_share": share,
                          "rejected": ratio > 1 or share > MISMATCH_LIMIT}
    emit({"phase": "kernel_planted_faults", "kernel": "flash_fwd",
          "shape": [bh, s, s, d], "mismatch_limit": MISMATCH_LIMIT,
          **readings})
    if not all(r["rejected"] for r in readings.values()):
        raise AssertionError("the bf16 limits accept a planted fault")


def kernel_cases(torch, fa):
    """Kernel against plain version on the card; returns the main-path
    case's inputs and error."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
    cases = [
        # name, BH, S_q, S_k, D, dtype, causal, q_off, k_off
        ("main_path", 96, 2048, 2048, 64, "bfloat16", True, 0, 0),
        ("main_shape_fp32", 96, 2048, 2048, 64, "float32", True, 0, 0),
        ("non_causal", 24, 1024, 1024, 64, "bfloat16", False, 0, 0),
        ("offsets_visible", 2, 32, 32, 16, "float32", True, 64, 32),
        ("offsets_masked", 2, 32, 32, 16, "float32", True, 0, 32),
        ("ragged_sk_19", 4, 24, 19, 16, "float32", False, 0, 0),
        ("small_fp32", 6, 48, 48, 16, "float32", True, 0, 0),
        ("fp16_d128", 4, 300, 300, 128, "float16", True, 0, 0),
        ("bf16_d32_ragged", 4, 130, 77, 32, "bfloat16", True, 60, 0),
        # edges of the bf16 kernel's tiles: one row past a tile, less than
        # one q-tile, one head, offsets that are not tile multiples, rows
        # that see no key beside rows that do inside one tile, D 128
        ("bf16_s2049", 8, 2049, 2049, 64, "bfloat16", True, 0, 0),
        ("bf16_s64", 8, 64, 64, 64, "bfloat16", True, 0, 0),
        ("bf16_bh1", 1, 2048, 2048, 64, "bfloat16", True, 0, 0),
        ("bf16_q_offset", 8, 2048, 4096, 64, "bfloat16", True, 2048 + 37,
         0),
        ("bf16_k_offset_masked_rows", 8, 512, 512, 64, "bfloat16", True, 0,
         100),
        ("bf16_d128_s2048", 16, 2048, 2048, 128, "bfloat16", True, 0, 0),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    main = None
    for (name, bh, sq, sk, d, dts, causal, qo, ko) in cases:
        q = torch.randn(bh, sq, d, generator=gen, device="cuda").to(dt[dts])
        k = torch.randn(bh, sk, d, generator=gen, device="cuda").to(dt[dts])
        v = torch.randn(bh, sk, d, generator=gen, device="cuda").to(dt[dts])
        out, lse = fa.flash_fwd_cuda(q, k, v, qo, ko, causal)
        ref, ref_lse = fa.flash_fwd_plain(q, k, v, qo, ko, causal,
                                          block_k=fa.KEY_TILE)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out.float()).all())
        if dts == "float32":
            limits = {"tol_out": TOL_FP32}
            ok = ok and err <= TOL_FP32
        else:
            ratio, share = half_agreement(torch, fa, out, ref, q, k, v, qo,
                                          ko, causal)
            limits = {"max_over_bound": ratio, "mismatch_share": share,
                      "mismatch_limit": MISMATCH_LIMIT}
            ok = ok and ratio <= 1 and share <= MISMATCH_LIMIT
        # a row that sees no key gives exactly 0 and lse ~ -1e30
        sees = torch.arange(sq, device="cuda") + qo >= ko if causal \
            else torch.ones(sq, dtype=torch.bool, device="cuda")
        masked_rows = int((~sees).sum())
        if masked_rows:
            ok = ok and out[:, ~sees].abs().max().item() == 0.0 \
                and lse[:, ~sees].max().item() <= -1e29
        err_lse = None
        if masked_rows < sq:
            err_lse = (lse[:, sees] - ref_lse[:, sees]).abs().max().item()
            ok = ok and err_lse <= TOL_LSE
        emit({"phase": "kernel", "kernel": "flash_fwd", "case": name,
              "shape": [bh, sq, sk, d], "dtype": dts, "causal": causal,
              "q_offset": qo, "k_offset": ko, "max_abs_err_out": err,
              **limits, "max_abs_err_lse": err_lse,
              "tol_lse": TOL_LSE, "rows_seeing_no_key": masked_rows,
              "ok": ok})
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version in case {name}")
        if name == "main_path":
            planted_faults(torch, fa, q, k, v, ref)
            main = (q, k, v, causal, err)
        elif name == "main_shape_fp32":
            emit({"phase": "kernel_timing_fp32", "kernel": "flash_fwd",
                  "shape": [bh, sq, sk, d], "ms": cuda_ms(
                      lambda: fa.flash_fwd_cuda(q, k, v, 0, 0, causal), 5)})
    return main


def flash_bound(q, causal):
    """(bytes, operations, {"bound_ms", "bound_by"}) of one forward call
    on (BH, S, D) inputs like ``q``: q, k, v read and out written once in
    their type, the fp32 lse written once; two products over the visible
    (query, key) pairs at the bf16 peak."""
    bh, s, d = q.shape
    nbytes = (4 * q.numel()) * q.element_size() + bh * s * 4
    flops = 4 * d * bh * visible_pairs(s, s, causal, 0, 0)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return nbytes, flops, {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def kernel_timing(torch, fa, main):
    import torch.nn.functional as F
    q, k, v, causal, err = main
    bh, s, d = q.shape
    ms = cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, 0, 0, causal), 20)
    plain_ms = cuda_ms(lambda: fa.flash_fwd_plain(
        q, k, v, 0, 0, causal, block_k=fa.KEY_TILE), 5)
    q4, k4, v4 = (t.view(BATCH, bh // BATCH, s, d) for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal), 20)
    # the backward that runs on the main path (plain PyTorch, fp32)
    out, lse = fa.flash_fwd_cuda(q, k, v, 0, 0, causal)
    g = torch.randn_like(q)
    g_lse = torch.zeros_like(lse)
    bwd_plain_ms = cuda_ms(lambda: fa.flash_bwd_plain(
        q, k, v, out, lse, g, g_lse, 0, 0, causal), 3)
    nbytes, flops, bound = flash_bound(q, causal)
    row = {"name": "flash_fwd", "route": "cuda",
           "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
           "replaces": "horovod_tpu/ops/flash_attention.py:83",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound, "library_ms": library_ms}
    emit({"phase": "kernel_timing", "kernel": "flash_fwd",
          "shape": [bh, s, s, d], "dtype": str(q.dtype), "bytes": nbytes,
          "flops": flops, "tflops": flops / (ms * 1e-3) / 1e12,
          "bound_share": row["bound_ms"] / ms,
          "library_tflops": flops / (library_ms * 1e-3) / 1e12,
          "bwd_plain_ms": bwd_plain_ms, **row})
    return row


def gradient_check(torch, fa):
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, S, H, D = 2, 96, 2, 32
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda")
               for _ in range(3))
    w = torch.randn(B, S, H, D, generator=gen, device="cuda")

    def loss_and_grads(fn):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out, lse = fn(qq, kk, vv)
        ((out * w).sum() + torch.sin(lse).sum()).backward()
        return qq.grad, kk.grad, vv.grad

    def reference(qq, kk, vv):
        out = fa.mha_reference(qq, kk, vv, causal=True)
        s = torch.einsum("bqhd,bkhd->bhqk", qq, kk) / math.sqrt(D)
        mask = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
        lse = torch.logsumexp(s.masked_fill(~mask, fa.NEG_INF), dim=-1)
        return out, lse.transpose(1, 2)

    before = fa.LAUNCHES["flash_fwd"]
    got = loss_and_grads(lambda a, b, c: fa.flash_attention_with_lse(
        a, b, c, causal=True))
    if fa.LAUNCHES["flash_fwd"] != before + 1:
        raise AssertionError("the autograd Function did not launch the "
                             "kernel")
    want = loss_and_grads(reference)
    errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
    ok = max(errs) <= TOL_GRAD
    emit({"phase": "gradient", "shape": [B, S, H, D], "dtype": "float32",
          "max_abs_err_dq_dk_dv": errs, "tol": TOL_GRAD, "ok": ok})
    if not ok:
        raise AssertionError("flash gradients disagree with the reference")


def ring_phase(torch, fa):
    """Ring attention at sp = RING_SP on one card: every position's
    per-step compute in turn, counted, checked and timed."""
    import importlib
    ra = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")
    n, S = RING_SP, RING_SEQ
    sl = S // n
    heads, d = 12, 64
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, g = (torch.randn(BATCH, S, heads, d, generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(4))

    def split(x):
        return [x[:, j * sl:(j + 1) * sl] for j in range(n)]

    def ring(qq, kk, vv):
        kv = list(zip(split(kk), split(vv)))
        return torch.cat([ra.ring_attention_local(qb, kv, j, causal=True)
                          for j, qb in enumerate(split(qq))], dim=1)

    def run(fn):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(g)
        return out.detach(), [t.grad for t in leaves]

    # the path: counts set to 0 just before, read just after
    torch.cuda.synchronize()
    fa.LAUNCHES["flash_fwd"] = 0
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ring(*leaves)
    fwd_launches = fa.LAUNCHES["flash_fwd"]
    out.backward(g)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_fwd"]
    ring_out, ring_grads = out.detach(), [t.grad for t in leaves]
    del out, leaves

    def to_bh(x):
        return x.transpose(1, 2).reshape(BATCH * heads, x.shape[1], d)

    def ulp(x):
        _, e = torch.frexp(x.abs().clamp_min(torch.finfo(torch.bfloat16)
                                             .tiny))
        return torch.ldexp(torch.ones_like(x), e - 8)

    pv, _ = fa.flash_fwd_plain(to_bh(q), to_bh(k), to_bh(v).abs(), 0, 0,
                               True, block_k=fa.KEY_TILE)
    pv = pv.float().reshape(BATCH, heads, S, d).transpose(1, 2)
    full_out, full_grads = run(lambda a, b, c: fa.flash_attention(
        a, b, c, causal=True))
    diff = (ring_out.float() - full_out.float()).abs()
    ratio_full = (diff / (2 * ulp(full_out.float())
                          + RING_P_TERMS_VS_FULL * 2.0 ** -8 * pv)).max()

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()
    grad_rel_full = [rel(a, b) for a, b in zip(ring_grads, full_grads)]
    del full_out, full_grads

    # the plain fp32 attention at B 1 (a dense 8192^2 score tensor a head)
    one = [t[:1].detach().float().requires_grad_() for t in (q, k, v)]
    ref = fa.mha_reference(*one, causal=True)
    ref.backward(g[:1].float())
    ref = ref.detach()
    ratio_exact = ((ring_out[:1].float() - ref).abs()
                   / (2 * ulp(ref) + RING_P_TERMS_VS_EXACT * 2.0 ** -8
                      * pv[:1])).max()
    grad_rel_exact = [rel(a[:1], b.grad) for a, b in zip(ring_grads, one)]
    del one, ref, pv, ring_grads

    # times: the ring (all positions, one card) against the single call
    with torch.no_grad():
        ring_fwd_ms = cuda_ms(lambda: ring(q, k, v), 3)
        full_fwd_ms = cuda_ms(lambda: fa.flash_attention(q, k, v,
                                                         causal=True), 5)
        qs, ks, vs = (to_bh(x[:, :sl].contiguous()) for x in (q, k, v))
        kernel_ms = {name: cuda_ms(lambda qo=qo, ko=ko: fa.flash_fwd_cuda(
            qs, ks, vs, fa.offset_tensor(qo, q.device),
            fa.offset_tensor(ko, q.device), True), 10)
            for name, qo, ko in (("diagonal", 0, 0), ("past", sl, 0),
                                 ("future_masked", 0, sl))}
        o0 = torch.zeros(BATCH, sl, heads, d, dtype=torch.float32,
                         device="cuda")
        lse0 = torch.full((BATCH, sl, heads), ra.NEG_INF,
                          dtype=torch.float32, device="cuda")
        step_ms = cuda_ms(lambda: ra._flash_step(
            q[:, sl:2 * sl], k[:, :sl], v[:, :sl], o0, lse0,
            fa.offset_tensor(sl, q.device), fa.offset_tensor(0, q.device),
            True), 10)
    ring_fb_ms = cuda_ms(lambda: run(ring), 2, warmup=1)
    full_fb_ms = cuda_ms(lambda: run(lambda a, b, c: fa.flash_attention(
        a, b, c, causal=True)), 2, warmup=1)

    want = n * n
    ok = (fwd_launches == want and launches - fwd_launches == want
          and ratio_full.item() <= 1 and ratio_exact.item() <= 1
          and max(grad_rel_full + grad_rel_exact) <= TOL_RING_GRAD_REL
          and bool(torch.isfinite(ring_out.float()).all()))
    result = {
        "phase": "ring", "sp": n, "seq": S, "batch": BATCH, "heads": heads,
        "head_dim": d, "dtype": "bfloat16", "causal": True,
        "kernel_call_shape": [BATCH * heads, sl, sl, d],
        "launches_forward": fwd_launches,
        "launches_backward_recompute": launches - fwd_launches,
        "launches_expected_each": want,
        "max_over_bound_vs_full_call": ratio_full.item(),
        "max_over_bound_vs_exact_b1": ratio_exact.item(),
        "bound_p_terms": [RING_P_TERMS_VS_FULL, RING_P_TERMS_VS_EXACT],
        "grad_rel_l2_vs_full_call_dq_dk_dv": grad_rel_full,
        "grad_rel_l2_vs_exact_b1_dq_dk_dv": grad_rel_exact,
        "tol_grad_rel": TOL_RING_GRAD_REL,
        "ring_forward_ms": ring_fwd_ms, "full_call_forward_ms": full_fwd_ms,
        "ring_forward_backward_ms": ring_fb_ms,
        "full_call_forward_backward_ms": full_fb_ms,
        "ring_step_ms": step_ms, "step_kernel_ms": kernel_ms, "ok": ok}
    emit(result)
    del q, k, v, g, ring_out
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("ring attention disagrees, or its launches "
                             "are not the expected count")
    return launches


def flash_timing(torch, fa, bh, s, d, causal=True, plain_iters=3):
    """The kernel at (bh, s, s, d) bf16 against its plain version (the
    bf16 limits of the kernel cases), then its ms, the plain version's,
    SDPA's and the bound (bytes and operations, as kernel_timing)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out, _ = fa.flash_fwd_cuda(q, k, v, 0, 0, causal)
    ref, _ = fa.flash_fwd_plain(q, k, v, 0, 0, causal, block_k=fa.KEY_TILE)
    ratio, share = half_agreement(torch, fa, out, ref, q, k, v, 0, 0,
                                  causal)
    ms = cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, 0, 0, causal), 20)
    plain_ms = cuda_ms(lambda: fa.flash_fwd_plain(
        q, k, v, 0, 0, causal, block_k=fa.KEY_TILE), plain_iters)
    q4, k4, v4 = (t.view(BATCH, bh // BATCH, s, d) for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal), 20)
    _, flops, bound = flash_bound(q, causal)
    return {"shape": [bh, s, s, d], "max_abs_err": (
                out.float() - ref.float()).abs().max().item(),
            "max_over_bound": ratio, "mismatch_share": share,
            "agrees": ratio <= 1 and share <= MISMATCH_LIMIT,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **bound, "tflops": flops / (ms * 1e-3) / 1e12}


def tensor_parallel_phase(torch, fa):
    """Decoder layer 0 of the full-width default model split into TP
    blocks on one card (see the module docstring)."""
    import dataclasses
    from horovod_tpu_torch.models import Transformer, TransformerConfig
    from horovod_tpu_torch.parallel import flash_attention_fn
    from horovod_tpu_torch.parallel.mesh_utils import (
        tensor_parallel_blocks, tensor_parallel_local)
    cfg = dataclasses.replace(TransformerConfig(), num_layers=1,
                              attention_fn=flash_attention_fn)
    layer = Transformer(cfg, generator=torch.Generator(
        device="cuda").manual_seed(3)).layer_0
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(BATCH, cfg.max_seq_len, cfg.d_model, generator=gen,
                    device="cuda").to(cfg.dtype)
    blocks = tensor_parallel_blocks(layer, TP)
    with torch.no_grad():
        want = layer(x, None)
        fa.LAUNCHES["flash_fwd"] = 0
        got = tensor_parallel_local(layer, blocks, x, None)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_fwd"]
        diff = (got.float() - want.float())
        rel = (diff.norm() / want.float().norm()).item()
        split_ms = cuda_ms(lambda: tensor_parallel_local(
            layer, blocks, x, None), 5)
        layer_ms = cuda_ms(lambda: layer(x, None), 5)
    heads = cfg.num_heads // TP
    block = flash_timing(torch, fa, BATCH * heads, cfg.max_seq_len,
                         cfg.head_dim)
    whole = flash_timing(torch, fa, BATCH * cfg.num_heads, cfg.max_seq_len,
                         cfg.head_dim)
    ok = (launches == TP and rel <= TOL_TP_REL and block["agrees"]
          and bool(torch.isfinite(got.float()).all()))
    emit({"phase": "tensor_parallel", "tp": TP, "batch": BATCH,
          "seq": cfg.max_seq_len, "heads_per_block": heads,
          "mlp_columns_per_block": cfg.d_model * cfg.mlp_ratio // TP,
          "kernel_call_shape": [BATCH * heads, cfg.max_seq_len,
                                cfg.max_seq_len, cfg.head_dim],
          "launches": launches, "launches_expected": TP,
          "rel_l2_vs_unsplit_layer": rel, "tol_rel_l2": TOL_TP_REL,
          "max_abs_err_vs_unsplit_layer": diff.abs().max().item(),
          "split_layer_forward_ms": split_ms,
          "unsplit_layer_forward_ms": layer_ms,
          "flash_bh24": block, "flash_bh96": whole, "ok": ok})
    del layer, blocks, x, want, got, diff
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the tp-split layer disagrees with the layer, "
                             "or its launches are not the expected count")
    return launches, block


def small_training_reference(torch, hvd):
    """A small fp32 model trained 3 steps through the flash kernel and
    through the plain attention, from the same weights and data."""
    from horovod_tpu_torch.models import TransformerConfig
    from horovod_tpu_torch.parallel import make_transformer_train_step
    cfg = TransformerConfig(vocab_size=128, num_layers=2, d_model=64,
                            num_heads=4, head_dim=16, max_seq_len=64,
                            dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(2)
    data = torch.randint(0, cfg.vocab_size, (4, cfg.max_seq_len + 1),
                         generator=gen, device="cuda")
    losses = {}
    for attention in ("flash", "default"):
        b = make_transformer_train_step(
            cfg, attention=attention,
            generator=torch.Generator(device="cuda").manual_seed(3))
        losses[attention] = [b.step(data[:, :-1], data[:, 1:]).item()
                             for _ in range(3)]
        b.optimizer.remove_hooks()
    err = max(abs(a - b) for a, b in zip(losses["flash"], losses["default"]))
    ok = err <= TOL_SMALL_LOSS
    emit({"phase": "train_small_reference", "losses": losses,
          "max_abs_err": err, "tol": TOL_SMALL_LOSS, "ok": ok})
    if not ok:
        raise AssertionError("flash training disagrees with plain attention")


def model_flops_per_step(cfg) -> float:
    """Model FLOPs of one training step, no recompute: 6 x matmul
    parameters x tokens (the tied logits projection included), plus causal
    attention's two products, forward (1x) and backward (2x)."""
    E, H, D, L = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.num_layers
    dense = L * (4 * E * H * D + 2 * E * cfg.mlp_ratio * E) \
        + cfg.vocab_size * E
    tokens = BATCH * cfg.max_seq_len
    pairs = visible_pairs(cfg.max_seq_len, cfg.max_seq_len, True, 0, 0)
    attention = 3 * L * 4 * BATCH * H * D * pairs
    return 6.0 * dense * tokens + attention


def step_breakdown(torch, bundle, tokens, targets):
    """One more step, timed by phase with CUDA events (the bucket
    allreduces run inside backward, their drain inside the optimizer)."""
    import torch.nn.functional as F
    model, opt = bundle.model, bundle.optimizer
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    logits = model(tokens)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    torch.cuda.synchronize()
    emit({"phase": "train_breakdown",
          "forward_and_loss_ms": ev[0].elapsed_time(ev[1]),
          "backward_ms": ev[1].elapsed_time(ev[2]),
          "allreduce_drain_and_adamw_ms": ev[2].elapsed_time(ev[3])})


def train_main_path(torch, hvd, fa, collectives, cfg, tokens, targets):
    from horovod_tpu_torch.parallel import make_transformer_train_step
    bundle = make_transformer_train_step(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    hvd.broadcast_parameters(bundle.model.state_dict(), root_rank=0)
    n_params = sum(p.numel() for p in bundle.model.parameters())
    if n_params != 111_121_920:
        raise AssertionError(f"default config has {n_params} parameters")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.LAUNCHES["flash_fwd"] = 0
    collectives.COUNTS["allreduce"] = 0
    losses, seconds = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = bundle.step(tokens, targets).item()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = fa.LAUNCHES["flash_fwd"]
    allreduces = collectives.COUNTS["allreduce"]

    steady = seconds[1:]
    step_s = sum(steady) / len(steady)
    flops = model_flops_per_step(cfg)
    result = {
        "phase": "train", "config": "TransformerConfig() default",
        "params": n_params, "batch": BATCH, "seq": cfg.max_seq_len,
        "steps": TRAIN_STEPS, "losses": losses,
        "ln_vocab": math.log(cfg.vocab_size),
        "step_seconds": seconds,
        "ms_per_step_steady": 1e3 * step_s,
        "tokens_per_s_steady": BATCH * cfg.max_seq_len / step_s,
        "model_flops_per_step": flops,
        "mfu_vs_bf16_peak": flops / step_s / PEAK_BF16_FLOPS,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "flash_launches": launches, "allreduce_launches": allreduces,
        "world_size": hvd.size(), "backend": hvd.basics.world().backend}
    emit(result)
    step_breakdown(torch, bundle, tokens, targets)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near ln(vocab)")
    if launches != cfg.num_layers * TRAIN_STEPS:
        raise AssertionError(f"{launches} flash launches, expected "
                             f"{cfg.num_layers * TRAIN_STEPS}")
    if allreduces <= 0:
        raise AssertionError("no allreduce was launched")
    return launches, losses, bundle, result["ms_per_step_steady"]


def train_default_reference(torch, cfg, tokens, targets, flash_losses):
    """The same full-width steps from the same weights and data with the
    model's default attention; its losses must track the flash path's."""
    from horovod_tpu_torch.parallel import make_transformer_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = make_transformer_train_step(
        cfg, attention="default",
        generator=torch.Generator(device="cuda").manual_seed(0))
    losses = [bundle.step(tokens, targets).item()
              for _ in range(TRAIN_STEPS)]
    bundle.optimizer.remove_hooks()
    errs = [abs(a - b) for a, b in zip(flash_losses, losses)]
    tols = [TOL_FULL_LOSS_EARLY if i < 2 else TOL_FULL_LOSS_LATE
            for i in range(TRAIN_STEPS)]
    ok = all(e <= t for e, t in zip(errs, tols))
    emit({"phase": "train_default_reference", "losses_default": losses,
          "losses_flash": flash_losses, "abs_diff": errs, "tol": tols,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "ok": ok})
    if not ok:
        raise AssertionError("full-width flash losses disagree with the "
                             "default attention's")


def checkpoint_phase(torch, bundle, tokens, targets):
    """Save, resume and fall back through the port's CheckpointManager
    (see the module docstring); the directory is removed afterwards."""
    import shutil
    from horovod_tpu_torch import checkpointing as cp
    from horovod_tpu_torch.checkpointing.snapshot import tree_flatten
    from horovod_tpu_torch.parallel import (
        restore_mesh_train_state, save_mesh_train_state, train_state_tree)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    mgr = cp.CheckpointManager(root)
    leaves = [t for _, t in tree_flatten(train_state_tree(bundle))[0]]
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    params = list(bundle.model.parameters())
    at_save = [p.detach().clone() for p in params]

    def seconds(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    sync_s = seconds(lambda: save_mesh_train_state(mgr, 1, bundle))
    snapshot_s = seconds(lambda: save_mesh_train_state(mgr, 2, bundle,
                                                       async_=True))
    persist_s = seconds(mgr.wait_until_finished)

    def two_steps():
        return [bundle.step(tokens, targets).item() for _ in range(2)]
    losses_a = two_steps()
    params_a = [p.detach().clone() for p in params]
    restore_s = seconds(lambda: restore_mesh_train_state(mgr, bundle))
    restored_equal = all(torch.equal(p, q) for p, q in zip(params, at_save))
    losses_b = two_steps()
    identical = losses_a == losses_b and all(
        torch.equal(p, q) for p, q in zip(params, params_a))
    del params_a

    # a planted bad shard in the newest step: restore must refuse it, and
    # the fallback must land on the previous step
    step2 = cp.step_dir(root, 2)
    shard = max((os.path.join(step2, "shards", f)
                 for f in os.listdir(os.path.join(step2, "shards"))),
                key=os.path.getsize)
    at = os.path.getsize(shard) // 2
    with open(shard, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0x55]))
    try:
        mgr.restore(step=2, target=train_state_tree(bundle))
        refused = False
    except cp.IntegrityError:
        refused = True
    restore_mesh_train_state(mgr, bundle)
    fell_back = mgr.all_steps() == [1] and all(
        torch.equal(p, q) for p, q in zip(params, at_save))
    shutil.rmtree(root, ignore_errors=True)
    ok = restored_equal and identical and refused and fell_back
    gb = nbytes / 1e9
    emit({"phase": "checkpoint", "state_bytes": nbytes,
          "leaves": len(leaves), "sync_save_ms": sync_s * 1e3,
          "sync_save_gb_per_s": gb / sync_s,
          "async_save_snapshot_ms": snapshot_s * 1e3,
          "async_save_persist_wait_ms": persist_s * 1e3,
          "restore_ms": restore_s * 1e3,
          "restore_gb_per_s": gb / restore_s,
          "losses_before_restore": losses_a,
          "losses_after_restore": losses_b,
          "restored_state_equal": restored_equal,
          "resumed_steps_bit_identical": identical,
          "bad_shard_refused": refused,
          "fallback_restored_previous_step": fell_back, "ok": ok})
    if not ok:
        raise AssertionError("checkpoint save/restore is not bit-exact, or "
                             "a bad shard was not caught")


# cnn phase. Parity, card against CPU in fp32 (TF32 off, cuDNN autotuning
# off): both sum in fp32 in other orders (cuDNN's and oneDNN's conv
# algorithms), so forward values and batch statistics agree to relative L2
# TOL_CNN_FWD. One SGD step's update is held to an fp64 step on the CPU
# that replays the card's ReLU decisions: with BatchNorm scales drawn in
# [0.5, 1.5) (so every residual branch computes), the few ReLU inputs
# within rounding of zero that take the other sign in fp32 (tens among
# millions) move the update of every earlier layer by a few percent, on
# either device (the phase prints that count and the card's distance
# from the CPU's update). On a CPU ResNet-50 at 64 and 112 px, batch 4,
# fp32 against plain fp64 is 2.3e-2 and 1.6e-2; with the fp64 step taking
# fp32's ReLU masks, 8.1e-5 and 3.9e-5, and no parameter tensor's update
# is more than 1.4e-4 off. So the replayed update is held to the fixed
# TOL_CNN_UPDATE, as a whole and tensor by tensor: a layout, padding,
# statistics or backward fault in any one layer moves that layer's
# update past it (a 1% error in one conv's kernel gradient does).
CNN_TIMED = ((256, "conv"), (256, "space_to_depth"), (128, "conv"))
CNN_OTHERS = (("vgg16", 224, 64), ("inception3", 299, 64))
CNN_PARITY_BATCH = 4
TOL_CNN_FWD = 1e-4
TOL_CNN_UPDATE = 1e-3


def rel_l2(torch, got, want) -> float:
    got = torch.cat([t.double().reshape(-1).cpu() for t in got])
    want = torch.cat([t.double().reshape(-1).cpu() for t in want])
    return ((got - want).norm() / want.norm()).item()


@contextlib.contextmanager
def relu_masks(torch, masks: list, replay: bool):
    """Inside, ``F.relu`` records whether each input is positive into
    ``masks`` (on the CPU), or, with ``replay``, multiplies each input by
    the recorded mask of the same call in turn, so a model reruns another
    run's ReLU decisions (same derivative: 1 where positive, else 0)."""
    F = torch.nn.functional
    relu = F.relu
    recorded = iter(masks)

    def masked(t, inplace=False):
        if replay:
            return t * next(recorded).to(t.device, t.dtype)
        masks.append((t > 0).cpu())
        return relu(t, inplace=inplace)

    F.relu = masked
    try:
        yield
    finally:
        F.relu = relu
    if replay and next(recorded, None) is not None:
        raise AssertionError("the replayed run made fewer ReLU calls")


def resnet_parity(torch, build, batch: int, size: int) -> dict:
    """The model ``build(dtype=, device=, generator=)`` in fp32 on the card
    and on the port's CPU path from the same weights (BatchNorm parameters
    and statistics drawn at random) and batch, and in fp64 on the CPU with
    the card's ReLU masks: relative L2 of the eval logits, train-mode
    logits and updated batch statistics, card against CPU, and of one SGD
    step's parameter update, card against fp64, over all parameters and
    for the parameter tensor farthest off; beside them, for reading
    only, the train-mode ReLU inputs whose sign the card and the CPU
    disagree on and the card's update against the CPU's."""
    import copy

    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(4)
    cpu = build(dtype=torch.float32, device="cpu", generator=gen)
    with torch.no_grad():
        for name, t in list(cpu.named_parameters()) + list(
                cpu.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "var"):
                t.uniform_(0.5, 1.5, generator=gen)
            elif leaf in ("bias", "mean"):
                t.normal_(0.0, 0.1, generator=gen)
    exact = copy.deepcopy(cpu).double()
    for m in exact.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    card = build(dtype=torch.float32, device="cuda")
    card.load_state_dict(cpu.state_dict())
    card.to(memory_format=torch.channels_last)
    x = torch.randn(batch, 3, size, size, generator=gen)
    y = torch.randint(0, 1000, (batch,), generator=gen)
    out, masks = {}, {"cuda": [], "cpu": []}
    for model, dev in ((card, "cuda"), (cpu, "cpu"), (exact, "fp64")):
        xx = x.double() if dev == "fp64" else x.to(dev)
        if dev == "cuda":
            xx = xx.contiguous(memory_format=torch.channels_last)
        model.eval()
        with torch.no_grad():
            eval_logits = model(xx)
        model.train()
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        before = [p.detach().clone() for p in model.parameters()]
        with relu_masks(torch, masks["cuda" if dev == "fp64" else dev],
                        replay=dev == "fp64"):
            logits = model(xx)
            F.cross_entropy(logits, y.to(xx.device)).backward()
        opt.step()
        out[dev] = {
            "eval_logits": [eval_logits], "train_logits": [logits.detach()],
            "batch_stats": [b for _, b in model.named_buffers()],
            "sgd_update": [p.detach() - q for p, q in
                           zip(model.parameters(), before)]}
    errs = {k: rel_l2(torch, out["cuda"][k], out["cpu"][k])
            for k in ("eval_logits", "train_logits", "batch_stats")}
    errs["sgd_update"] = rel_l2(torch, out["cuda"]["sgd_update"],
                                out["fp64"]["sgd_update"])
    leaves = sorted((rel_l2(torch, [a], [b]), name) for a, b, (name, _) in
                    zip(out["cuda"]["sgd_update"], out["fp64"]["sgd_update"],
                        card.named_parameters()))
    errs["sgd_update_worst_leaf"] = leaves[-1][0]
    info = {"sgd_update_worst_leaf_name": leaves[-1][1],
            "relu_sign_flips": sum(
                int((a != b).sum()) for a, b in
                zip(masks["cuda"], masks["cpu"])),
            "relu_inputs": sum(m.numel() for m in masks["cuda"]),
            "sgd_update_cuda_vs_cpu": rel_l2(
                torch, out["cuda"]["sgd_update"], out["cpu"]["sgd_update"])}
    return errs, info


def cnn_limits() -> dict:
    """The limit of each of :func:`resnet_parity`'s errors it is held to."""
    limits = {k: TOL_CNN_FWD for k in
              ("eval_logits", "train_logits", "batch_stats")}
    limits["sgd_update"] = limits["sgd_update_worst_leaf"] = TOL_CNN_UPDATE
    return limits


def cnn_parity(torch):
    """fp32 ResNet-50 at 224 px on the card against the port's CPU path."""
    from horovod_tpu_torch.models import ResNet50
    errs, info = resnet_parity(torch, ResNet50, CNN_PARITY_BATCH, 224)
    limits = cnn_limits()
    ok = all(errs[k] <= limits[k] for k in limits)
    emit({"phase": "cnn_parity", "model": "ResNet50 fp32, 224 px",
          "batch": CNN_PARITY_BATCH, "rel_l2": errs, "limit": limits,
          "ok": ok, **info})
    if not ok:
        raise AssertionError("ResNet-50 on the card disagrees with the "
                             "port's CPU path")


def cnn_phase(torch):
    """ResNet-50 timed through the benchmark's rig, its fp32 parity with
    the CPU path, and one timed step of VGG16 and InceptionV3."""
    from horovod_tpu_torch import benchmark as bm
    autotune = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True

    def run(model_name, image_size, batch, stem, warmup, per_iter, iters):
        rig = bm._Rig(batch, image_size, model_name, "sgd", stem=stem)
        try:
            losses = [rig.step().item() for _ in range(warmup)]
            r = rig.run_stage(0, per_iter, iters)
            losses.append(float(rig.loss))
        finally:
            rig.close()
            del rig
            torch.cuda.empty_cache()
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{model_name}: non-finite loss {losses}")
        row = {"model": model_name, "image_size": image_size,
               "batch": batch, "stem": r.stem,
               "img_per_s": r.images_per_sec_per_chip,
               "ms_per_step": 1e3 * r.iter_mean_s / per_iter,
               "flops_per_step": r.flops_per_step, "mfu": r.mfu,
               "peak_memory_gib": r.peak_memory_gib,
               "steps_timed": per_iter * iters, "losses": losses}
        emit({"phase": "cnn", **row})
        return row

    try:
        rows = [run("resnet50", 224, batch, stem, 3, 5, 4)
                for batch, stem in CNN_TIMED]
        rows += [run(name, size, batch, None, 2, 1, 1)
                 for name, size, batch in CNN_OTHERS]
    finally:
        torch.backends.cudnn.benchmark = autotune
    cnn_parity(torch)
    return rows


COLLECTIVES_NOTE = ("NCCL at size 1 is a device copy: these are the port's "
                    "own overheads (dispatcher hop, fusion copies, scales), "
                    "not a network's")
COLLECTIVE_REPS = 3
TOL_SYNC_BN = 1e-4   # fp32, E[x^2] - E[x]^2 against BatchNorm's variance


def timed_ms(torch, fn, reps: int) -> float:
    """Mean host-clock ms of ``fn`` over ``reps`` runs after one warm-up,
    each run ending in a device synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def collectives_phase(torch, hvd, collectives, bundle):
    """Every collective verb on NCCL at size 1, at the sizes of the
    full-width trainer: its 111,121,920 fp32 parameters, its AdamW state,
    and its gradient set in the DistributedOptimizer's buckets. Each verb
    is checked exactly against its size-1 answer (the scales are powers of
    two) and timed; one JSON line per verb."""
    import torch.distributed as dist
    model, opt = bundle.model, bundle.optimizer
    buckets = [[p.grad for p in members] for members in opt._bucket_members]
    grads = [g for b in buckets for g in b]
    if len(buckets) != 7 or any(g is None for g in grads):
        raise AssertionError(f"expected 7 buckets of gradients, got "
                             f"{len(buckets)}")
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    flat = [torch.cat([g.reshape(-1) for g in b]) for b in buckets]
    out = {}

    def report(verb, fn, nbytes, check, reps=COLLECTIVE_REPS, plain=None,
               **extra):
        """Time ``fn`` and check its result; ``plain`` is the same wire
        work called straight from this thread (no dispatcher, no checks),
        timed beside it."""
        before = sum(collectives.COUNTS.values())
        ms = timed_ms(torch, fn, reps)
        calls = (sum(collectives.COUNTS.values()) - before) / (reps + 1)
        exact = bool(check())
        if plain is not None:
            extra["plain_ms"] = timed_ms(torch, plain, reps)
        emit({"phase": "collectives", "verb": verb, "ms": ms,
              "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6,
              "wire_calls": calls, "exact": exact,
              "note": COLLECTIVES_NOTE, **extra})
        if not exact:
            raise AssertionError(f"{verb} disagrees with its size-1 answer")

    def fused(fn):
        """Per bucket: flatten, ``fn`` on the flat buffer, split back."""
        def run():
            for b in buckets:
                f = torch.cat([g.reshape(-1) for g in b])
                fn(f)
                torch.split(f, [g.numel() for g in b])
        return run

    sd = model.state_dict()
    want_sd = {k: v.clone() for k, v in sd.items()}
    report("broadcast_parameters",
           lambda: hvd.broadcast_parameters(sd, root_rank=0),
           sum(v.numel() * v.element_size() for v in sd.values()),
           lambda: all(torch.equal(sd[k], want_sd[k]) for k in sd),
           plain=lambda: [dist.broadcast(v, 0) for v in sd.values()],
           tensors=len(sd))
    del want_sd
    states = [opt.state[p] for g in opt.param_groups for p in g["params"]]
    tensors = [(s, k) for s in states for k, v in s.items()
               if isinstance(v, torch.Tensor)]
    want_state = [s[k].clone() for s, k in tensors]
    report("broadcast_optimizer_state",
           lambda: hvd.broadcast_optimizer_state(opt, root_rank=0),
           sum(s[k].numel() * s[k].element_size() for s, k in tensors),
           lambda: all(torch.equal(s[k], w) for (s, k), w in
                       zip(tensors, want_state)),
           tensors=len(tensors))
    del want_state

    for op, pre, post in ((hvd.Average, 0.5, 4.0), (hvd.Sum, 0.5, 4.0),
                          (hvd.Min, 1.0, 1.0), (hvd.Max, 1.0, 1.0),
                          (hvd.Product, 1.0, 1.0), (hvd.Adasum, 0.5, 4.0)):
        def run(op=op, pre=pre, post=post):
            hs = [hvd.grouped_allreduce_async(
                b, op=op, prescale_factor=pre, postscale_factor=post,
                name=f"collectives.bucket.{i}") for i, b in enumerate(buckets)]
            out["reduced"] = [hvd.synchronize(h) for h in hs]
        factor = pre * post
        plain = None
        if op == hvd.Sum:
            plain = fused(lambda f: (dist.all_reduce(f), f.mul_(factor)))
        report(f"grouped_allreduce.{op.value}", run, grad_bytes,
               lambda factor=factor: all(
                   torch.equal(o, g * factor if factor != 1.0 else g)
                   for b, outs in zip(buckets, out["reduced"])
                   for g, o in zip(b, outs)),
               plain=plain, buckets=len(buckets), prescale=pre,
               postscale=post)
    out.clear()

    def ragged_cases():
        empty = hvd.allgather(flat[0][:0].view(0, 1))
        scalar = hvd.allgather(flat[0][3])
        rows = hvd.allgather(buckets[0][0])
        return (empty.shape == (0, 1) and scalar.shape == (1,)
                and torch.equal(scalar[0], flat[0][3])
                and torch.equal(rows, buckets[0][0]))
    report("allgather",
           lambda: out.__setitem__("g", [hvd.allgather(f) for f in flat]),
           grad_bytes,
           lambda: ragged_cases() and all(torch.equal(g, f) for g, f in
                                          zip(out["g"], flat)),
           plain=lambda: [dist.all_gather_into_tensor(torch.empty_like(f), f)
                          for f in flat],
           buckets=len(flat))
    report("alltoall",
           lambda: out.__setitem__("a", [hvd.alltoall(f, splits=[len(f)])
                                         for f in flat]),
           grad_bytes,
           lambda: all(torch.equal(a, f) for a, f in zip(out["a"], flat)),
           plain=lambda: [dist.all_to_all_single(torch.empty_like(f), f)
                          for f in flat],
           buckets=len(flat), splits="explicit, one entry per process")
    report("grouped_broadcast",
           lambda: out.__setitem__("b", [hvd.grouped_broadcast(b, 0)
                                         for b in buckets]),
           grad_bytes,
           lambda: all(torch.equal(o, g) for b, outs in zip(buckets, out["b"])
                       for g, o in zip(b, outs)),
           plain=fused(lambda f: dist.broadcast(f, 0)),
           buckets=len(buckets))
    ps = hvd.process_set_mesh(0)
    report("grouped_allreduce.process_set_0",
           lambda: out.__setitem__("p", [hvd.grouped_allreduce(
               b, op=hvd.Sum, process_set=ps) for b in buckets]),
           grad_bytes,
           lambda: all(torch.equal(o, g) for b, outs in zip(buckets, out["p"])
                       for g, o in zip(b, outs)),
           process_set=list(ps.ranks))
    out.clear()

    state = opt.state_dict()
    state_bytes = sum(v.numel() * v.element_size()
                      for s in state["state"].values() for v in s.values()
                      if isinstance(v, torch.Tensor))

    def same_state(got):
        return got["param_groups"] == state["param_groups"] and all(
            torch.equal(got["state"][i][k], v)
            for i, s in state["state"].items() for k, v in s.items())
    report("broadcast_object",
           lambda: out.__setitem__("o", hvd.broadcast_object(state, 0)),
           state_bytes, lambda: same_state(out["o"]), reps=1,
           object="optimizer.state_dict()")
    report("allgather_object",
           lambda: out.__setitem__("o", hvd.allgather_object(state)),
           state_bytes,
           lambda: len(out["o"]) == 1 and same_state(out["o"][0]), reps=1,
           object="optimizer.state_dict()")
    out.clear()

    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(BATCH * 2048, 768, generator=gen, device="cuda")
    dy = torch.randn(BATCH * 2048, 768, generator=gen, device="cuda")
    sync_bn = hvd.SyncBatchNorm(768).cuda()
    plain_bn = torch.nn.BatchNorm1d(768).cuda()

    def fwd_bwd(bn):
        xx = x.clone().requires_grad_()
        y = bn(xx)
        (y * dy).sum().backward()
        return y, xx.grad
    plain_ms = timed_ms(torch, lambda: fwd_bwd(plain_bn), COLLECTIVE_REPS)

    def sync_bn_agrees():
        (y, gx), (ry, rgx) = fwd_bwd(sync_bn), fwd_bwd(plain_bn)
        out["bn_err"] = max((y - ry).abs().max().item(),
                            (gx - rgx).abs().max().item())
        return out["bn_err"] <= TOL_SYNC_BN
    report("SyncBatchNorm.forward_backward", lambda: fwd_bwd(sync_bn),
           2 * x.numel() * x.element_size(), sync_bn_agrees,
           shape=list(x.shape), plain_batch_norm_ms=plain_ms,
           tol=TOL_SYNC_BN)
    emit({"phase": "collectives_sync_bn_error",
          "max_abs_err_out_and_dx": out["bn_err"]})

    # join last: afterwards this process contributes zeros to reductions
    def join_checks():
        probe = flat[0][:8]
        return (out["round_before"] == 1 and out["last"] == 0
                and hvd.joined() and hvd.join_round() == 0
                and torch.equal(hvd.allreduce(probe, op=hvd.Sum),
                                torch.zeros_like(probe)))
    out["round_before"] = hvd.join_round()
    report("join", lambda: out.__setitem__("last", hvd.join()), 8,
           join_checks, reps=1)


# -- elastic phase -----------------------------------------------------------

ELASTIC_STEPS = 3        # steps of each launched worker
RESET_STEPS = 4          # steps of the in-process reset run
RESET_AFTER = 2          # the interrupt comes after this step's commit


def _train_bundle(torch, cfg, broadcast: bool = True):
    """The main path's bundle and batch: the same seeds as ``train``.
    Under hvd.elastic.run pass ``broadcast=False``: the state's sync() is
    where rank 0's weights reach every worker, and a worker that joins a
    running job must issue no collective the survivors do not (they
    re-enter at sync(), not at the top of the script)."""
    from horovod_tpu_torch.parallel import make_transformer_train_step
    import horovod_tpu_torch as hvd
    bundle = make_transformer_train_step(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    if broadcast:
        hvd.broadcast_parameters(bundle.model.state_dict(), root_rank=0)
    data = torch.randint(0, cfg.vocab_size, (BATCH, cfg.max_seq_len + 1),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1), device="cuda")
    return bundle, data[:, :-1], data[:, 1:]


def elastic_worker(mode: str, out_path: str) -> int:
    """A worker the port's launcher starts (``chip_smoke.py
    --elastic-worker static|elastic <out.json>``): the full-width default
    model, ELASTIC_STEPS steps on the main path's seeds; under ``elastic``
    through hvd.elastic.run with a TorchState committed every step."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerConfig
    from horovod_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init()
    bundle, tokens, targets = _train_bundle(torch, TransformerConfig(),
                                            broadcast=mode == "static")
    losses, commits = [], []
    fa.LAUNCHES["flash_fwd"] = 0
    if mode == "static":
        losses = [bundle.step(tokens, targets).item()
                  for _ in range(ELASTIC_STEPS)]
    else:
        state = hvd.elastic.TorchState(bundle.model, bundle.optimizer,
                                       step=0)

        @hvd.elastic.run
        def train(state):
            while state.step < ELASTIC_STEPS:
                losses.append(bundle.step(tokens, targets).item())
                state.step += 1
                state.commit()
                commits.append(state.last_commit_seconds)
        train(state)
    out = {"mode": mode, "losses": losses, "flash_launches":
           fa.LAUNCHES["flash_fwd"], "rank": hvd.rank(), "size": hvd.size(),
           "backend": hvd.basics.world().backend,
           "device": str(hvd.device()),
           "commit_save_ms": [1e3 * a for a, _ in commits],
           "commit_durable_ms": [1e3 * b for _, b in commits],
           "state_dir": os.environ.get("HVD_TPU_ELASTIC_STATE_DIR", ""),
           "elastic_env": os.environ.get("HVD_TPU_ELASTIC", "")}
    with open(out_path, "w") as f:
        json.dump(out, f)
    hvd.shutdown()
    return 0


def kill_matching(token: str) -> None:
    """SIGKILL every process whose command line holds ``token`` (the
    workers a launcher started in sessions of their own, when the launcher
    had to be killed)."""
    import signal
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read().decode(errors="replace")
        except OSError:
            continue
        if token in cmdline:
            with contextlib.suppress(OSError):
                os.kill(int(pid), signal.SIGKILL)


def launch_runner(args, token: str, timeout: float = 600):
    """``python -m horovod_tpu_torch.runner *args`` from the checkout's
    root; returns (exit code, output, seconds). Past ``timeout`` the
    launcher and every process holding ``token`` are killed."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", *args], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        kill_matching(token)
        out, _ = proc.communicate()
        out += f"\n[killed after {timeout} s]"
    return proc.returncode, out, time.perf_counter() - t0


def elastic_phase(torch, fa, cfg, main_losses):
    """The launcher and elastic training on the card (module docstring,
    phase 11). Returns the flash launches of each of its three paths."""
    import importlib
    import shutil
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, metrics
    from horovod_tpu_torch.exceptions import HostsUpdatedInterrupt
    run_mod = importlib.import_module("horovod_tpu_torch.elastic.run")
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_elastic")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    me = os.path.join(root, "chip_smoke.py")
    want = main_losses[:ELASTIC_STEPS]

    # 1. static launch, -np 1
    out = os.path.join(work, "static.json")
    code, log, secs = launch_runner(
        ["-np", "1", "--", sys.executable, me, "--elastic-worker", "static",
         out], token=out)
    if code != 0:
        raise AssertionError(f"static launch exited {code}:\n{log[-6000:]}")
    static = json.load(open(out))
    static.update(phase="elastic_static_launch", launcher_seconds=secs,
                  in_process_losses=want, ok=static["losses"] == want)
    emit(static)
    if not static["ok"]:
        raise AssertionError("a launched worker's losses differ from the "
                             "same steps run in-process")

    # 2. elastic launch at size 1: driver, rendezvous, notification
    # service, heartbeats, a TorchState commit (durable) every step
    script = os.path.join(work, "discover.sh")
    with open(script, "w") as f:
        f.write("#!/bin/sh\necho localhost:1\n")
    os.chmod(script, 0o755)
    out = os.path.join(work, "elastic.json")
    code, log, secs = launch_runner(
        ["-np", "1", "--min-np", "1", "--host-discovery-script", script,
         "--", sys.executable, me, "--elastic-worker", "elastic", out],
        token=out)
    if code != 0:
        raise AssertionError(f"elastic launch exited {code}:\n{log[-6000:]}")
    el = json.load(open(out))
    el.update(phase="elastic_launch", launcher_seconds=secs,
              in_process_losses=want,
              state_dir_removed=not os.path.exists(el["state_dir"]),
              ok=el["losses"] == want and el["elastic_env"] == "1"
              and len(el["commit_save_ms"]) == ELASTIC_STEPS
              and el["flash_launches"] == cfg.num_layers * ELASTIC_STEPS)
    emit(el)
    if not el["ok"]:
        raise AssertionError("the elastic launch at size 1 misbehaved")

    # 3. the reset in-process at full width, on NCCL
    hvd.init()
    ref, tokens, targets = _train_bundle(torch, cfg)
    ref_losses = [ref.step(tokens, targets).item()
                  for _ in range(RESET_STEPS)]
    ref_params = {k: v.clone() for k, v in ref.model.state_dict().items()}
    ref.optimizer.remove_hooks()
    del ref
    torch.cuda.empty_cache()
    bundle, tokens, targets = _train_bundle(torch, cfg, broadcast=False)
    state = hvd.elastic.TorchState(bundle.model, bundle.optimizer, step=0)
    record = {"losses": [], "commit_save_ms": []}
    restarts = metrics.snapshot().get("hvd_tpu_worker_restarts_total", 0)
    old_world = basics.world()

    def equal_to_snapshot():
        saved = state._saved_state
        live = bundle.model.state_dict()
        ok = all(torch.equal(live[k].cpu(), saved["model"][k])
                 for k in live)
        live_opt = bundle.optimizer.state_dict()["state"]
        for i, entry in saved["optimizer"]["state"].items():
            ok = ok and all(torch.equal(live_opt[i][k].cpu(), v)
                            for k, v in entry.items())
        return ok

    def body(state):
        if "reset_ms" in record and "equal_after_reset" not in record:
            record["equal_after_reset"] = equal_to_snapshot()
            record["step_at_reentry"] = state.step
        while state.step < RESET_STEPS:
            record["losses"].append(bundle.step(tokens, targets).item())
            state.step += 1
            state.commit()
            record["commit_save_ms"].append(
                1e3 * state.last_commit_seconds[0])
            if state.step == RESET_AFTER and "reset_ms" not in record:
                raise HostsUpdatedInterrupt()

    def timed_reset(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_mod.reset(state)
        torch.cuda.synchronize()
        record["reset_ms"] = 1e3 * (time.perf_counter() - t0)

    fa.LAUNCHES["flash_fwd"] = 0
    hvd.elastic.run_fn(body, timed_reset)(state)
    reset_launches = fa.LAUNCHES["flash_fwd"]
    final = bundle.model.state_dict()
    same_final = all(torch.equal(final[k], ref_params[k]) for k in final)
    new_world = basics.world()
    result = {
        "phase": "elastic_reset", "steps": RESET_STEPS,
        "interrupted_after_step": RESET_AFTER,
        "reset_ms": record["reset_ms"],
        "commit_save_ms": record["commit_save_ms"],
        "step_at_reentry": record.get("step_at_reentry"),
        "state_equal_to_commit_after_reset":
            record.get("equal_after_reset", False),
        "final_params_equal_uninterrupted": same_final,
        "losses": record["losses"], "uninterrupted_losses": ref_losses,
        "new_world": new_world is not old_world,
        "backend": new_world.backend,
        "restarts": metrics.snapshot().get(
            "hvd_tpu_worker_restarts_total", 0) - restarts,
        "flash_launches": reset_launches}
    result["ok"] = (result["state_equal_to_commit_after_reset"]
                    and same_final and result["new_world"]
                    and result["backend"] == "nccl"
                    and result["restarts"] == 1
                    and result["step_at_reentry"] == RESET_AFTER
                    and reset_launches == cfg.num_layers * RESET_STEPS)
    emit(result)
    bundle.optimizer.remove_hooks()
    hvd.shutdown()
    shutil.rmtree(work, ignore_errors=True)
    if not result["ok"]:
        raise AssertionError("the in-process reset misbehaved")
    return {"elastic_static": static["flash_launches"],
            "elastic_launch": el["flash_launches"],
            "elastic_reset": reset_launches}


# -- estimator phase ---------------------------------------------------------

EST_SEQS = 32            # sequences of the epoch: 4 steps at batch 8
# predict rows (bf16 activations, fp32 logits) against an unpadded
# forward: the same model at another M, where cuBLAS may pick another
# algorithm and so round some bf16 activations the other way; each
# element then carries a few bf16 roundings (2^-8 each) more or less:
# relative L2 within 2^-7, as the tp layer's
TOL_PREDICT_REL = 2.0 ** -7
AUTOTUNE_SETTINGS = {"AUTOTUNE": True, "AUTOTUNE_WARMUP_SAMPLES": 1,
                     "AUTOTUNE_STEPS_PER_SAMPLE": 1,
                     "AUTOTUNE_BAYES_OPT_MAX_SAMPLES": 2}


def _estimator_model(torch, cfg):
    """The default config at full width with the flash kernel, weights
    from seed 0 (the same on every call)."""
    import dataclasses
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.parallel import flash_attention_fn
    return Transformer(dataclasses.replace(cfg, attention_fn=flash_attention_fn),
                       device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))


def _fit(torch, fa, est, x, y, **kw):
    """est.fit for one epoch at batch 8, recording each step's loss and
    end time; returns (losses, step seconds, flash launches)."""
    from horovod_tpu_torch.callbacks import Callback
    losses, ends = [], []

    class Record(Callback):
        def on_batch_end(self, batch, logs=None):
            losses.append(logs["loss"])
            ends.append(time.perf_counter())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fa.LAUNCHES["flash_fwd"] = 0
    est.fit(x, y, epochs=1, batch_size=BATCH, callbacks=[Record()], **kw)
    launches = fa.LAUNCHES["flash_fwd"]
    starts = [t0] + ends[:-1]
    return losses, [b - a for a, b in zip(starts, ends)], launches


def _same_params(torch, model, ref) -> bool:
    state = model.state_dict()
    return all(torch.equal(state[k].cpu(), v) for k, v in ref.items())


def estimator_phase(torch, fa, cfg, train_ms):
    """The Estimator on the card (module docstring, phase 12). Returns
    the flash launches of each of its paths."""
    import shutil
    import numpy as np
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, data, faults, metrics, sdc
    from horovod_tpu_torch.estimator import Estimator, cross_entropy_loss
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt_dir = os.path.join(root, "build", "chip_estimator")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rng = np.random.RandomState(0)
    seqs = rng.randint(0, cfg.vocab_size, (EST_SEQS, cfg.max_seq_len + 1))
    x, y = seqs[:, :-1], seqs[:, 1:]
    hvd.init()
    launches = {}

    # (a) fit, the default Adam, against a hand loop over the same order
    est = Estimator(_estimator_model(torch, cfg), seed=0)
    losses, secs, launches["estimator_fit"] = _fit(torch, fa, est, x, y)
    fitted = {k: v.detach().cpu().clone() for k, v in est.params.items()}
    steady_ms = 1e3 * sum(secs[1:]) / len(secs[1:])
    est._opt.remove_hooks()
    del est
    torch.cuda.empty_cache()
    model = _estimator_model(torch, cfg)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3 * hvd.dp_size()),
        named_parameters=model.named_parameters())
    hand = []
    for bx, by in data.batches((x, y), BATCH, seed=0):
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model(torch.from_numpy(bx).cuda()),
                                  torch.from_numpy(by).cuda())
        loss.backward()
        opt.step()
        hand.append(loss.item())
    same_hand = _same_params(torch, model, fitted)
    opt.remove_hooks()
    del model, opt
    torch.cuda.empty_cache()
    fit = {"phase": "estimator_fit", "config": "TransformerConfig() default",
           "sequences": EST_SEQS, "batch": BATCH, "losses": losses,
           "hand_loop_losses": hand, "params_equal_hand_loop": same_hand,
           "step_seconds": secs, "ms_per_step_steady": steady_ms,
           "train_phase_ms_per_step_steady": train_ms,
           "flash_launches": launches["estimator_fit"]}
    fit["ok"] = (losses == hand and same_hand
                 and len(losses) == EST_SEQS // BATCH
                 and fit["flash_launches"] == cfg.num_layers * len(losses)
                 and all(math.isfinite(v) for v in losses))
    emit(fit)
    if not fit["ok"]:
        raise AssertionError("Estimator.fit disagrees with the hand loop")

    # (b) + (c): the same fit under the guard, a bitflip in the second
    # step's local gradients, a checkpoint at the epoch's end
    env = {"HVD_TPU_SDC_GUARD": "1", "HVD_TPU_SDC_FINGERPRINT_EVERY": "1"}
    os.environ.update(env)
    faults.configure("worker.grads:bitflip:step=2:once", seed=0)
    snap = metrics.snapshot()
    timings = {"guard": [], "fold": []}
    check, fold = sdc.StepGuard.check, sdc.fingerprint.fold_fingerprint

    def timed(kind, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timings[kind].append(1e3 * (time.perf_counter() - t))
            return out
        return run
    sdc.StepGuard.check = timed("guard", check)
    sdc.fingerprint.fold_fingerprint = timed("fold", fold)
    try:
        est = Estimator(_estimator_model(torch, cfg), seed=0,
                        checkpoint_dir=ckpt_dir)
        g_losses, g_secs, launches["estimator_guarded"] = _fit(
            torch, fa, est, x, y)
    finally:
        sdc.StepGuard.check = check
        sdc.fingerprint.fold_fingerprint = fold
        for k in env:
            os.environ.pop(k, None)
        faults.configure("", seed=0)
    after = metrics.snapshot()

    def delta(key):
        return after.get(key, 0.0) - snap.get(key, 0.0)
    same_guarded = _same_params(torch, est.model, fitted)
    restored = checkpoint.restore(ckpt_dir)
    same_ckpt = sorted(restored) == sorted(fitted) and all(
        torch.equal(restored[k], v) for k, v in fitted.items())
    param_bytes = sum(v.numel() * v.element_size() for v in fitted.values())
    guarded = {
        "phase": "estimator_guarded",
        "fault": "worker.grads:bitflip:step=2:once",
        "losses": g_losses, "step_seconds": g_secs,
        "trips": delta('hvd_tpu_sdc_detections_total{kind="nonfinite"}'),
        "rollbacks": delta("hvd_tpu_sdc_rollbacks_total"),
        "fingerprint_divergences": delta(
            'hvd_tpu_sdc_detections_total{kind="fingerprint"}'),
        "params_equal_unguarded": same_guarded,
        "guard_ms": timings["guard"], "fold_ms": timings["fold"],
        "param_bytes": param_bytes,
        "read_params_once_bound_ms": 1e3 * param_bytes / PEAK_BYTES,
        "flash_launches": launches["estimator_guarded"],
        "checkpoint_restores_equal": same_ckpt}
    guarded["ok"] = (g_losses == losses and same_guarded
                     and guarded["trips"] == 1 and guarded["rollbacks"] == 0
                     and guarded["fingerprint_divergences"] == 0
                     and len(timings["guard"]) == len(losses) + 1
                     and len(timings["fold"]) == len(losses)
                     and guarded["flash_launches"]
                     == cfg.num_layers * (len(losses) + 1)
                     and same_ckpt)
    emit(guarded)
    if not guarded["ok"]:
        raise AssertionError("the guarded fit, or its checkpoint, "
                             "misbehaved")

    # (d) predict at buckets 4 and 8
    rows = {}
    fa.LAUNCHES["flash_fwd"] = 0
    for n in (3, 5):
        rows[n] = est.predict(x[:n])
    launches["estimator_predict"] = fa.LAUNCHES["flash_fwd"]
    pred = {"phase": "estimator_predict",
            "buckets": sorted(est._predict_cache.compiled_buckets),
            "flash_launches": launches["estimator_predict"],
            "tol_rel_l2": TOL_PREDICT_REL}
    exact, rel = True, []
    with torch.no_grad():
        for n, got in rows.items():
            b = est._predict_cache.bucket(n)
            padded = np.zeros((b, x.shape[1]), x.dtype)
            padded[:n] = x[:n]
            at_bucket = est.model(torch.from_numpy(padded).cuda())[:n]
            exact = exact and torch.equal(got, at_bucket)
            unpadded = est.model(torch.from_numpy(x[:n]).cuda())
            rel.append(rel_l2(torch, got, unpadded))
    pred.update(rows_exact_at_padded_shape=exact, rel_l2_unpadded=rel,
                shape=list(rows[5].shape))
    pred["ok"] = (exact and pred["buckets"] == [4, 8]
                  and all(r <= TOL_PREDICT_REL for r in rel)
                  and pred["flash_launches"] == cfg.num_layers * 2
                  and bool(torch.isfinite(rows[5]).all()))
    emit(pred)
    est._opt.remove_hooks()
    del est, rows
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not pred["ok"]:
        raise AssertionError("predict disagrees with the forward")

    # (e) autotune: a world whose ParameterManager scores every step
    hvd.shutdown()
    hvd.init(config_overrides=AUTOTUNE_SETTINGS)
    scored = metrics.snapshot().get("hvd_tpu_autotune_samples_total", 0.0)
    est = Estimator(_estimator_model(torch, cfg), seed=0)
    t_losses, t_secs, launches["estimator_autotune"] = _fit(
        torch, fa, est, x, y)
    plans = est._opt.plans
    tuned = {"phase": "estimator_autotune", "settings": AUTOTUNE_SETTINGS,
             "losses": t_losses, "untuned_losses": losses,
             "step_seconds": t_secs,
             "thresholds": [t for t, _ in plans],
             "buckets_per_plan": [len(b) for _, b in plans],
             "samples_scored": metrics.snapshot().get(
                 "hvd_tpu_autotune_samples_total", 0.0) - scored,
             "params_equal_untuned": _same_params(torch, est.model, fitted),
             "flash_launches": launches["estimator_autotune"]}
    tuned["ok"] = (t_losses == losses and tuned["params_equal_untuned"]
                   and tuned["samples_scored"] >= 2 and len(plans) >= 2
                   and len(set(tuned["thresholds"])) >= 2)
    emit(tuned)
    est._opt.remove_hooks()
    del est
    hvd.shutdown()
    torch.cuda.empty_cache()
    if not tuned["ok"]:
        raise AssertionError("the autotuned fit misbehaved")
    return launches, steady_ms


# reductions phase: the compiled-plane DistributedOptimizer. At size 1
# every uncompressed reduction is the identity, so those variants (and
# Adasum over groups of one) train exactly as the eager plane's train
# phase. int8 quantizes each 64 MB bucket to 255 levels of its absmax,
# with the error fed back: step 1's loss (the same weights) is exact, and
# steps 2-4 are held to TOL_INT8_LOSS of the uncompressed run's (5% of
# ln(vocab); AdamW moves only the parameters whose gradient quantizes to
# a nonzero level until their residual reaches one).
TOL_INT8_LOSS = 0.5
RED_VARIANTS = [(s, p) for s in ("hierarchical", "flat")
                for p in ("per_leaf", "packed")]


def _compiled_step(torch, cfg, tokens, targets, **kw):
    """The train phase's model, weights (seed 0) and AdamW behind a
    compiled-plane DistributedOptimizer over the ("cross", "local") mesh;
    returns (step function, optimizer). The step returns its loss."""
    import dataclasses
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.parallel import flash_attention_fn
    from horovod_tpu_torch.parallel.train import default_optimizer
    model = Transformer(
        dataclasses.replace(cfg, attention_fn=flash_attention_fn),
        device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    opt = hvd.DistributedOptimizer(
        default_optimizer(model.parameters()),
        named_parameters=model.named_parameters(), axis_name="cross",
        inner_axis="local", mesh=hvd.cross_local_mesh(), **kw)

    def step():
        opt.zero_grad(set_to_none=True)
        logits = model(tokens)
        loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               targets.reshape(-1).long())
        loss.backward()
        opt.step()
        return loss.detach()
    return step, opt


def _run_steps(torch, step):
    losses, seconds = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step().item())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return losses, 1e3 * sum(seconds[1:]) / len(seconds[1:])


def int8_reduction_timing(torch, opt, reps: int = 5) -> dict:
    """The int8 reduction of one step's gradients (every bucket, through
    the dispatcher) timed with CUDA events, against the least time the
    card needs for it: read each gradient and its residual once, write
    the reduced gradient and the new residual once (16 bytes a parameter
    at fp32; q, the gathered copy and fp64 temporaries are not counted)."""
    n = sum(p.numel() for _, p in opt._params)
    ms = cuda_ms(opt.synchronize, reps, warmup=1)
    nbytes = 16 * n
    return {"int8_reduce_ms": ms, "int8_reduce_bound_ms":
            1e3 * nbytes / PEAK_BYTES, "int8_reduce_bytes": nbytes,
            "int8_reduce_bound_by": "bytes", "params": n}


def reductions_phase(torch, fa, cfg, train_losses) -> int:
    """The compiled-plane DistributedOptimizer on the card (module
    docstring, phase 13). Returns its flash launches."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.compiled_autotune import tune_distributed_step
    hvd.init()
    data = torch.randint(0, cfg.vocab_size, (BATCH, cfg.max_seq_len + 1),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1), device="cuda")
    tokens, targets = data[:, :-1], data[:, 1:]
    mesh = hvd.cross_local_mesh()
    result = {"phase": "reductions", "mesh": dict(zip(
        mesh.mesh_dim_names, mesh.mesh.shape)), "steps": TRAIN_STEPS,
        "variants": {}}
    fa.LAUNCHES["flash_fwd"] = 0
    runs = {f"{s}/{p}": dict(reduce_strategy=s, packing=p)
            for s, p in RED_VARIANTS}
    runs["int8"] = dict(packing="packed", compression=hvd.Compression.int8)
    runs["adasum"] = dict(op=hvd.Adasum)
    for name, kw in runs.items():
        before = fa.LAUNCHES["flash_fwd"]
        step, opt = _compiled_step(torch, cfg, tokens, targets, **kw)
        losses, ms = _run_steps(torch, step)
        result["variants"][name] = {
            "losses": losses, "ms_per_step_steady": ms,
            "flash_launches": fa.LAUNCHES["flash_fwd"] - before}
        if name == "int8":
            result.update(int8_reduction_timing(torch, opt))
        del step, opt
        torch.cuda.empty_cache()

    # the tuner: each variant a fresh model, its warmup and timed calls
    # the same TRAIN_STEPS steps as above
    tuned_losses = []

    def make_step(reduce_strategy, packing):
        step = _compiled_step(torch, cfg, tokens, targets,
                              reduce_strategy=reduce_strategy,
                              packing=packing)[0]
        return lambda: tuned_losses.append(step().item())
    options, _ = tune_distributed_step(make_step, warmup=1,
                                       iters=TRAIN_STEPS - 1,
                                       key="chip_smoke")
    launches = fa.LAUNCHES["flash_fwd"]
    result["tuned"] = {"options": options, "losses_by_variant": [
        tuned_losses[i:i + TRAIN_STEPS]
        for i in range(0, len(tuned_losses), TRAIN_STEPS)]}
    result["flash_launches"] = launches
    hvd.shutdown()
    torch.cuda.empty_cache()

    v = result["variants"]
    plain = v["hierarchical/per_leaf"]["losses"]
    checks = {
        "uncompressed_equal": all(v[f"{s}/{p}"]["losses"] == plain
                                  for s, p in RED_VARIANTS),
        "equal_to_train_phase": plain == train_losses,
        "adasum_equal": v["adasum"]["losses"] == plain,
        "int8_finite": all(math.isfinite(x) for x in v["int8"]["losses"]),
        "int8_first_equal": v["int8"]["losses"][0] == plain[0],
        "int8_within_tol": all(abs(a - b) <= TOL_INT8_LOSS for a, b in
                               zip(v["int8"]["losses"], plain)),
        "tuned_equal": result["tuned"]["losses_by_variant"]
        == [plain] * len(RED_VARIANTS),
        "launches_per_step": all(
            r["flash_launches"] == cfg.num_layers * TRAIN_STEPS
            for r in v.values()) and launches == cfg.num_layers
        * TRAIN_STEPS * (len(runs) + len(RED_VARIANTS)),
    }
    result.update(checks=checks, tol_int8_loss=TOL_INT8_LOSS,
                  ok=all(checks.values()))
    emit(result)
    if not result["ok"]:
        raise AssertionError(f"reductions phase failed: {checks}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import collectives
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.models import TransformerConfig

    # fp32 products in full fp32 on the card, for the comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    per_kernel = _build.build()
    ptxas = ptxas_report(_build.build_logs.values())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_seconds": per_kernel, "ptxas": ptxas})

    main_case = kernel_cases(torch, fa)
    row = kernel_timing(torch, fa, main_case)
    gradient_check(torch, fa)
    ring_launches = ring_phase(torch, fa)
    tp_launches, tp_row = tensor_parallel_phase(torch, fa)

    hvd.init(process_sets=[[0]])
    small_training_reference(torch, hvd)
    cfg = TransformerConfig()
    data = torch.randint(0, cfg.vocab_size, (BATCH, cfg.max_seq_len + 1),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1), device="cuda")
    tokens, targets = data[:, :-1], data[:, 1:]
    row["launches"], losses, bundle, train_ms = train_main_path(
        torch, hvd, fa, collectives, cfg, tokens, targets)
    train_default_reference(torch, cfg, tokens, targets, losses)
    checkpoint_phase(torch, bundle, tokens, targets)
    cnn_phase(torch)
    bundle.optimizer.remove_hooks()
    # last: its join() leaves this process contributing zeros
    collectives_phase(torch, hvd, collectives, bundle)
    hvd.shutdown()
    del bundle
    torch.cuda.empty_cache()
    elastic_launches = elastic_phase(torch, fa, cfg, losses)
    estimator_launches, _ = estimator_phase(torch, fa, cfg, train_ms)
    reduction_launches = reductions_phase(torch, fa, cfg, losses)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{**{key: row[key] for key in keys},
                       "launches_by_path": {"train": row["launches"],
                                            "ring": ring_launches,
                                            "tensor_parallel": tp_launches,
                                            **elastic_launches,
                                            **estimator_launches,
                                            "reductions":
                                                reduction_launches},
                       "tensor_parallel_bh24": {
                           key: tp_row[key] for key in (
                               "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "max_abs_err")}}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--elastic-worker"]:
        sys.exit(elastic_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
