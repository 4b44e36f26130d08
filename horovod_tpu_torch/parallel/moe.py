"""Expert parallelism (Mixture-of-Experts) over the 'ep' mesh axis
(counterpart of ``horovod_tpu/parallel/moe.py``).

Switch-Transformer-style top-1 routing with capacity, dispatched between
processes by one pair of all-to-alls: experts shard over the ep group,
each member computes only its experts, and tokens move one all-to-all
each way. Shapes are static (capacity fixed by the token count);
overflowing tokens are dropped and their outputs are zero (the residual
connection carries them), the standard capacity-factor semantics.
"""

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .comm import all_to_all


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def route_top1(gate_logits: torch.Tensor, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 router (per group of tokens).

    Args:
      gate_logits: (T, E) router scores for T tokens over E experts.
      capacity: max tokens per expert held by this group.
    Returns:
      dispatch: (T, E, C) one-hot dispatch mask.
      combine:  (T, E, C) combine weights (gate prob on the dispatch slot).
    A tie goes to the lowest expert index (argmax's first maximum); tokens
    fill an expert's slots in token order and those past ``capacity`` are
    dropped.
    """
    T, E = gate_logits.shape
    probs = torch.softmax(gate_logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)                    # (T,)
    onehot = F.one_hot(expert, E).float()                   # (T, E)
    # position of each token within its expert's queue
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0        # (T, E)
    keep = (pos >= 0) & (pos < capacity)
    pos = torch.clamp(pos, 0, capacity - 1).long()
    dispatch = (F.one_hot(pos, capacity).float()
                * (onehot * keep)[..., None])               # (T, E, C)
    gate = torch.sum(probs * onehot, dim=-1)                # (T,)
    combine = dispatch * gate[:, None, None]
    return dispatch, combine


def moe_mlp(x, gate_w, w_in, w_out, group, capacity_factor: float = 1.25,
            act=_gelu):
    """MoE FFN; every member of ``group`` (the ep axis) calls it.

    Args:
      x: (T_local, D) this member's tokens (flatten batch x seq first).
      gate_w: (D, E_total) router weights (the same on every member).
      w_in: (E_local, D, Hd) this member's expert up-projections.
      w_out: (E_local, Hd, D) this member's expert down-projections.
    Returns (T_local, D).
    """
    n = dist.get_world_size(group)
    T, D = x.shape
    E_local = w_in.shape[0]
    E = E_local * n
    capacity = max(1, int(capacity_factor * T / E))

    logits = x @ gate_w.to(x.dtype)                         # (T, E)
    dispatch, combine = route_top1(logits, capacity)

    xf = x.float()
    buf = torch.einsum("td,tec->ecd", xf, dispatch)         # (E, C, D)
    # each member keeps the rows for ITS experts from every peer:
    # (E, C, D) = (n, E_local, C, D) -> (E_local, n*C, D)
    C = buf.shape[1]
    got = all_to_all(buf, group).reshape(n, E_local, C, D)
    buf = got.permute(1, 0, 2, 3).reshape(E_local, n * C, D)
    h = torch.einsum("ecd,edh->ech", buf.to(x.dtype), w_in.to(x.dtype))
    h = act(h)
    out = torch.einsum("ech,ehd->ecd", h, w_out.to(x.dtype))
    # route back: (E_local, n*C, D) -> (E, C, D), peer j's rows to peer j
    out = out.float().reshape(E_local, n, C, D).permute(1, 0, 2, 3)
    out = all_to_all(out, group).reshape(E, C, D)
    y = torch.einsum("ecd,tec->td", out, combine)
    return y.to(x.dtype)


class MoEMlp:
    """Parameter container and init for :func:`moe_mlp`: ``gate_w`` (D,
    E), ``w_in`` (E, D, Hd), ``w_out`` (E, Hd, D), fp32, N(0, 0.02)."""

    def __init__(self, d_model: int, hidden: int, num_experts: int):
        self.d_model = d_model
        self.hidden = hidden
        self.num_experts = num_experts

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        D, Hd, E = self.d_model, self.hidden, self.num_experts
        return {"gate_w": (D, E), "w_in": (E, D, Hd), "w_out": (E, Hd, D)}

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None
             ) -> Dict[str, torch.Tensor]:
        """Fresh parameters drawn with ``generator`` (on ``device``, by
        default the generator's)."""
        dev = device if device is not None else generator.device
        return {name: torch.randn(shape, generator=generator,
                                  device=dev) * 0.02
                for name, shape in self.shapes().items()}
