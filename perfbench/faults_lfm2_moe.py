"""Planted faults for the LFM2-MoE cells' check. Not part of a benchmark
run: the readings that show each fault over a limit of
``limits/<workload>.json``.

    python3 -m perfbench.faults_lfm2_moe --workload lfm2moe_b1_s8192 \
        --seeds 1,2 --out faults.jsonl

Each fault is planted in the plain reference (``reference/lfm2_moe.py``)
put in the program's place, one at a time; its three checked steps are
compared with the sound reference's on the same seed (``check.gaps``),
as a run compares the program's:

- ``biased_weights``: the picks weighted by their biased scores;
- ``top3``: three experts a token, not four;
- ``unnormalised``: the picks' weights not divided by their sum;
- ``centred_conv``: the short convolution's taps centred on the token
  (one after it seen), not causal;
- ``interleaved_rotary``: rotary pairs of neighbouring features, not the
  rotate-half halves;
- ``no_qk_norm``: q and k not normalised per head;
- ``kv_head_mod``: query head h reads K/V head h % (K/V heads), not
  h // (heads / K/V heads).
"""

import argparse
import contextlib
import json
import sys

import torch
import torch.nn.functional as F

from perfbench import check, spec, worker
from perfbench.reference import lfm2_moe as ref


def _route_biased(logits, bias, cfg):
    scores = torch.sigmoid(logits) + bias
    _, picked = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1)
    weights = scores.gather(-1, picked)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    return picked, weights * cfg["routed_scaling_factor"]


def _route_top3(logits, bias, cfg):
    return _sound["route"](logits, bias, {**cfg, "num_experts_per_tok": 3})


def _route_unnormalised(logits, bias, cfg):
    return _sound["route"](logits, bias, {**cfg, "norm_topk_prob": False})


def _centred_conv(b, c, x, w):
    D, L = w.shape
    z = (b * x).transpose(1, 2)
    conv = F.conv1d(z, w[:, None, :], padding=L // 2, groups=D)
    return c * conv.transpose(1, 2)


def _interleaved_rotary(x, positions, theta):
    Dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float64,
                                       device=x.device) / Dh)
    ang = (positions.double()[:, None] * inv[None]).repeat_interleave(2, -1)
    cos, sin = ang.cos().float(), ang.sin().float()
    rot = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).flatten(-2)
    return x * cos[:, None] + rot * sin[:, None]


FAULTS = {
    "biased_weights": {"route": _route_biased},
    "top3": {"route": _route_top3},
    "unnormalised": {"route": _route_unnormalised},
    "centred_conv": {"short_conv": _centred_conv},
    "interleaved_rotary": {"rotary": _interleaved_rotary},
    "no_qk_norm": {"qk_norm": lambda x, scale, eps: x},
    "kv_head_mod": {"kv_head": lambda h, heads, kv: h % kv},
}
_sound = {name: getattr(ref, name)
          for parts in FAULTS.values() for name in parts}


@contextlib.contextmanager
def planted(name: str):
    """The reference with fault ``name`` in place of its sound parts."""
    for attr, fn in FAULTS[name].items():
        setattr(ref, attr, fn)
    try:
        yield
    finally:
        for attr in FAULTS[name]:
            setattr(ref, attr, _sound[attr])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default=",".join(FAULTS))
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    cell = spec.cell(a.workload)
    if cell.config["family"] != "lfm2_moe":
        raise SystemExit(f"{a.workload} is not an lfm2_moe cell")
    dev = torch.device("cuda", 0)
    limits = cell.limits or {}
    with open(a.out, "a") as out:
        for seed in (int(s) for s in a.seeds.split(",") if s):
            sound = worker.reference_readings(cell, seed, dev)
            for name in a.faults.split(","):
                with planted(name):
                    bad = worker.reference_readings(cell, seed, dev)
                gaps = check.gaps(bad, sound)
                over = sorted(n for n, e in limits.items()
                              if not gaps.get(n, float("nan")) <= e["limit"])
                rec = {"seed": seed, "fault": name, "gaps": gaps,
                       "over": over}
                out.write(json.dumps(rec) + "\n")
                out.flush()
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
