"""The yardstick's arithmetic: operations and bytes computed from shapes,
and the card's published peaks.

Frozen copies, so that a change to the program cannot move the count it
is judged by:

- :func:`visible_pairs` and :func:`flash_bound` are ``chip_smoke.py``'s
  functions of the same names (the repository root's on-card smoke run);
- :func:`gpt2_flops_per_step` is ``chip_smoke.model_flops_per_step`` with
  the batch as an argument;
- ``PEAK_BF16_FLOPS`` and ``PEAK_BYTES`` are ``chip_smoke.py``'s constants:
  NVIDIA's data sheet for the H100 SXM (dense bf16, HBM3), which assume
  the card's full 700 W power limit. A run writes the card's own limit
  beside them (:func:`power_limit`).
"""

import subprocess
from typing import Dict, Optional, Tuple

#: H100 SXM dense bf16 FLOP/s and HBM3 bytes/s (NVIDIA data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAKS = {"h100": {"bf16_flops": PEAK_BF16_FLOPS, "bytes": PEAK_BYTES}}


def peaks(device_kind: str) -> Optional[Dict[str, float]]:
    """The peak table's row for a card named ``device_kind``
    (``torch.cuda.get_device_name``), or None for a card not in it."""
    kind = device_kind.lower()
    for key, row in PEAKS.items():
        if key in kind:
            return row
    return None


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, one
    line per card; "unknown" where nvidia-smi does not answer."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return "; ".join(line.strip() for line in r.stdout.splitlines()
                     if line.strip())


def visible_pairs(sq: int, sk: int, causal: bool, q_off: int = 0,
                  k_off: int = 0) -> int:
    """(query, key) pairs the attention has to compute for these inputs."""
    if not causal:
        return sq * sk
    return sum(min(max(q_off + i - k_off + 1, 0), sk) for i in range(sq))


def flash_bound(bh: int, s: int, d: int, causal: bool,
                element_size: int = 2) -> Tuple[int, int, float]:
    """(bytes, operations, least seconds) of one flash forward call on
    (BH, S, D) inputs: q, k, v read and out written once in their type,
    the fp32 lse written once; two products over the visible (query, key)
    pairs at the bf16 peak. The least time is the larger of operations
    over the peak FLOP/s and bytes over the peak bytes/s."""
    nbytes = 4 * bh * s * d * element_size + bh * s * 4
    flops = 4 * d * bh * visible_pairs(s, s, causal)
    return nbytes, flops, max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS)


def gpt2_flops_per_step(cfg: dict, batch: int) -> float:
    """Model FLOPs of one training step of a GPT-2-shaped decoder on
    ``batch`` rows of ``n_positions`` tokens, no recompute: 6 x matmul
    parameters x tokens (the tied logits projection included), plus causal
    attention's two products, forward (1x) and backward (2x)."""
    E, H, L = cfg["n_embd"], cfg["n_head"], cfg["n_layer"]
    D, S = E // H, cfg["n_positions"]
    dense = L * (4 * E * H * D + 2 * E * 4 * E) + cfg["vocab_size"] * E
    pairs = visible_pairs(S, S, True)
    attention = 3 * L * 4 * batch * H * D * pairs
    return 6.0 * dense * batch * S + attention
