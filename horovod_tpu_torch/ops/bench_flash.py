"""Compare builds of the flash-attention forward kernel on one NVIDIA GPU.

Builds each given CUDA source (default: this checkout's
``csrc/flash_fwd.cu``) with the port's own nvcc flags, holds each one's
bf16/fp16 output against the plain version on a few edge cases with
``chip_smoke.py``'s limits, then times every build at several shapes, in
turns (A B B A). Two sources, for example this checkout's kernel and a
parent commit's unpacked with ``git archive``, are compared on one card in
one run. From the root of a checkout (it uses ``chip_smoke.py``'s check
and timer):

    python3 -m horovod_tpu_torch.ops.bench_flash [SOURCE.cu ...]

Prints the card's name and power limit, then one JSON line per check and
per shape. Exits non-zero without a CUDA device or when a check fails.
"""

import ctypes
import json
import math
import os
import subprocess
import sys

import torch

from chip_smoke import MISMATCH_LIMIT, TOL_LSE, cuda_ms, half_agreement

from . import _build
from . import flash_attention as fa

# (name, BH, S_q, S_k, D, dtype, causal, q_offset, k_offset)
CASES = [
    ("main", 96, 2048, 2048, 64, torch.bfloat16, True, 0, 0),
    ("ragged", 3, 131, 200, 64, torch.bfloat16, True, 70, 0),
    ("d128_fp16", 4, 300, 300, 128, torch.float16, True, 0, 0),
    ("d16_non_causal", 3, 131, 200, 16, torch.bfloat16, False, 0, 0),
    ("rows_seeing_no_key", 2, 256, 256, 64, torch.bfloat16, True, 0, 100),
    ("s2049", 2, 2049, 2049, 64, torch.bfloat16, True, 0, 0),
]
# (name, BH, S, D, causal): the training shape first
SHAPES = [
    ("causal_2048", 96, 2048, 64, True),
    ("non_causal_2048", 96, 2048, 64, False),
    ("causal_8192", 24, 8192, 64, True),
    ("causal_2048_d128", 48, 2048, 128, True),
]


def build(sources):
    """nvcc every source in parallel; returns {label: launch function}."""
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "bench_flash")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        label = f"{i}:{os.path.relpath(src)}"
        lib = os.path.join(out_dir, f"flash_fwd_{i}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib, src]
        procs.append((label, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for label, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{label}: nvcc failed\n{log}")
        fns[label] = fa.bind(ctypes.CDLL(lib))
    return fns


def launch(fn, q, k, v, q_off, k_off, causal):
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[1], dtype=torch.float32,
                      device=q.device)
    qo = fa.offset_tensor(q_off, q.device)
    ko = fa.offset_tensor(k_off, q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), qo.data_ptr(), ko.data_ptr(), q.shape[0],
             q.shape[1], k.shape[1], q.shape[2], fa._DTYPE_CODES[q.dtype],
             int(causal), 1.0 / math.sqrt(q.shape[2]),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    return out, lse


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device", file=sys.stderr)
        return 1
    sources = argv or [os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "csrc", _build.SOURCES["flash_fwd"])]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    fns = build(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(bh, sq, sk, d, dtype):
        return [torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype)
                for s in (sq, sk, sk)]

    failed = False
    for name, bh, sq, sk, d, dtype, causal, q_off, k_off in CASES:
        q, k, v = qkv(bh, sq, sk, d, dtype)
        ref, ref_lse = fa.flash_fwd_plain(q, k, v, q_off, k_off, causal)
        sees = ref_lse > -1e29
        for label, fn in fns.items():
            out, lse = launch(fn, q, k, v, q_off, k_off, causal)
            torch.cuda.synchronize()
            ratio, share = half_agreement(torch, fa, out, ref, q, k, v,
                                          q_off, k_off, causal)
            err_lse = (lse - ref_lse)[sees].abs().max().item()
            ok = (ratio <= 1 and share <= MISMATCH_LIMIT
                  and err_lse <= TOL_LSE and bool((out[~sees] == 0).all()))
            failed |= not ok
            print(json.dumps({"source": label, "case": name,
                              "max_over_bound": ratio,
                              "mismatch_share": share,
                              "max_abs_err_lse": err_lse, "ok": ok}),
                  flush=True)
    for name, bh, s, d, causal in SHAPES:
        q, k, v = qkv(bh, s, s, d, torch.bfloat16)
        order = list(fns) + list(fns)[::-1]
        times = {label: [] for label in fns}
        for label in order:
            times[label].append(cuda_ms(lambda: launch(
                fns[label], q, k, v, 0, 0, causal), 20))
        print(json.dumps({"shape": name, "bh": bh, "s": s, "d": d,
                          "causal": causal,
                          "ms": {lb: min(t) for lb, t in times.items()}}),
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
