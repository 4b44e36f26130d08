"""Expert parallelism (Mixture-of-Experts) over the 'ep' mesh axis
(counterpart of ``horovod_tpu/parallel/moe.py``).

Two layers:

* :func:`moe_mlp`: Switch-Transformer-style top-1 routing with capacity,
  dispatched between processes by one pair of all-to-alls: experts shard
  over the ep group, each member computes only its experts, and tokens
  move one all-to-all each way. Shapes are static (capacity fixed by the
  token count); overflowing tokens are dropped and their outputs are
  zero (the residual connection carries them), the standard
  capacity-factor semantics.
* :func:`dropless_moe`: top-k routing over every expert with nothing
  dropped, computing the part of the layer's output that the experts
  this process holds give (``experts_held``, a contiguous range of the
  router's outputs; member r of an ep group of n holds the r-th n-th).
  The router scores each token on all experts (sigmoid, a fixed
  selection bias, top k, the picked scores normalised), the token slots
  are sorted by expert on the device into a slab of T x k rows with the
  held experts' rows first, and the held experts' SwiGLU runs as grouped
  products (``torch._grouped_mm``) whose group ends stay in device
  memory, so a step reads nothing back to the host. The absent experts'
  part is left out; on one chip there is no exchange.
"""

import collections
from typing import Deque, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import profiler as _profiler

from .. import tracing as _tracing
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


# -- dropless top-k over the experts held ------------------------------------

def route_topk(logits: torch.Tensor, expert_bias: Optional[torch.Tensor],
               k: int, normalize: bool = True, scaling: float = 1.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sigmoid top-k router (LFM2-MoE's, DeepSeek-V3's without groups).

    ``logits`` (T, E) in fp32. Scores are ``sigmoid(logits)``; the ``k``
    experts are picked on ``score + expert_bias`` (the bias only selects),
    and their weights are the unbiased scores, divided by their sum plus
    1e-6 when ``normalize``, times ``scaling``. Returns the experts (T, k)
    int64 and their weights (T, k) fp32."""
    scores = torch.sigmoid(logits.float())
    biased = scores if expert_bias is None else scores + expert_bias.float()
    _, experts = torch.topk(biased, k, dim=-1)
    weights = scores.gather(-1, experts)
    if normalize:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-6)
    return experts, weights * scaling


def _grouped_rows(x: torch.Tensor, w: torch.Tensor,
                  ends: torch.Tensor) -> torch.Tensor:
    """Rows [ends[g-1], ends[g]) of ``x`` (M, K) times ``w[g]`` (G, K, N);
    the rows past ``ends[-1]`` come out zero."""
    out = torch._grouped_mm(x, w, offs=ends)
    rows = torch.arange(x.shape[0], device=x.device)
    return out.masked_fill((rows >= ends[-1])[:, None], 0)


class ExpertMatmulFunction(torch.autograd.Function):
    """The experts' products over a slab sorted by expert: ``x`` (M, K),
    ``w`` (G, K, N) the held experts' matrices, ``ends`` (G,) int32 the
    device-side end of each expert's rows. Forward and backward are
    grouped products (``torch._grouped_mm``): dx per group against
    ``w[g]``'s transpose, dw per group over its rows. Rows past the last
    end (slots of experts not held) give and take zero. An expert with
    no rows gets a zero gradient."""

    @staticmethod
    def forward(ctx, x, w, ends):
        ctx.save_for_backward(x, w, ends)
        return _grouped_rows(x, w, ends)

    @staticmethod
    def backward(ctx, g):
        x, w, ends = ctx.saved_tensors
        g = g.contiguous()
        dx = _grouped_rows(g, w.transpose(1, 2), ends)
        dw = torch._grouped_mm(x.t(), g, offs=ends)
        return dx, dw, None


class SwiGLUFunction(torch.autograd.Function):
    """``silu(gate) * up`` of ``h`` = [gate | up] (..., 2F), in ``h``'s
    dtype; it saves ``h`` alone and recomputes the SiLU in the
    backward."""

    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        gate, up = h.chunk(2, dim=-1)
        return F.silu(gate) * up

    @staticmethod
    def backward(ctx, g):
        h, = ctx.saved_tensors
        acc = torch.promote_types(h.dtype, torch.float32)
        gate, up = (t.to(acc) for t in h.chunk(2, dim=-1))
        sig = torch.sigmoid(gate)
        g = g.to(acc)
        dgate = g * up * sig * (1 + gate * (1 - sig))
        return torch.cat([dgate, g * gate * sig], dim=-1).to(h.dtype)


class CombineFunction(torch.autograd.Function):
    """``sum_k weights[t, k] * picked[t, k]``: (T, k, D) outputs in the
    activation dtype and (T, k) fp32 weights to (T, D), summed in fp32
    (fp64 for fp64 inputs); it saves its two inputs and nothing of fp32
    at the outputs' size."""

    @staticmethod
    def forward(ctx, picked, weights):
        ctx.save_for_backward(picked, weights)
        acc = torch.promote_types(picked.dtype, weights.dtype)
        out = picked[:, 0].to(acc) * weights[:, :1]
        for j in range(1, picked.shape[1]):
            out.addcmul_(picked[:, j], weights[:, j:j + 1])
        return out.to(picked.dtype)

    @staticmethod
    def backward(ctx, g):
        picked, weights = ctx.saved_tensors
        acc = torch.promote_types(picked.dtype, weights.dtype)
        dpicked = (g[:, None].to(acc) * weights[..., None]).to(picked.dtype)
        dweights = torch.einsum("td,tkd->tk", g.to(acc), picked.to(acc))
        return dpicked, dweights.to(weights.dtype)


#: ``dropless_moe``'s counters of a sampled step: the tokens' slots that
#: went to the experts held, the busiest and idlest held expert's slots,
#: and the slots dropped (none: the layer is dropless)
COUNTERS = ("held_assignments", "held_load_max", "held_load_min",
            "dropped")


#: while a ``torch.profiler`` session records, each ``dropless_moe``
#: call's slots that went to the experts held, newest last: a 0-d device
#: tensor, never read on the step (the rows its grouped products ran
#: over, for a reader of the profiled steps' work)
PROFILED_HELD_SLOTS: Deque[torch.Tensor] = collections.deque(maxlen=4096)


def load_counters(counts: torch.Tensor) -> Dict[str, int]:
    """The counters of :data:`COUNTERS` from the held experts' slot counts
    (a device tensor): one read back to the host, made only for a step
    that a trace samples."""
    c = counts.tolist()
    return {"held_assignments": int(sum(c)), "held_load_max": int(max(c)),
            "held_load_min": int(min(c)), "dropped": 0}


def dropless_moe(x: torch.Tensor, router: torch.Tensor,
                 expert_bias: Optional[torch.Tensor], w_gate_up: torch.Tensor,
                 w_down: torch.Tensor, experts_held: Tuple[int, int], k: int,
                 normalize: bool = True, scaling: float = 1.0
                 ) -> torch.Tensor:
    """A dropless top-k SwiGLU expert layer's part from the experts held.

    ``x`` (T, D) in the activation dtype; ``router`` (D, E) fp32 over all
    E experts (its product runs in fp32); ``expert_bias`` (E,) or None;
    ``w_gate_up`` (G, D, 2F), each held expert's gate and up projections
    side by side, and ``w_down`` (G, F, D), in the activation dtype;
    ``experts_held`` = (first, stop), stop - first = G. Every token picks
    ``k`` experts (:func:`route_topk`) and gets the weighted sum of the
    picked held experts' ``down(silu(gate(x)) * up(x))``; a pick outside
    the held range adds nothing here. Returns (T, D) in ``x``'s dtype.

    Under a training step's ``step.forward`` span
    (``tracing.step_forward``) the three phases are the spans
    ``moe.route``, ``moe.experts`` and ``moe.combine``, ranges
    ``hvd.moe.*`` while a profiler records; a sampled step's
    ``moe.route`` carries :data:`COUNTERS`. While a profiler records the
    held slots join :data:`PROFILED_HELD_SLOTS`."""
    T, D = x.shape
    first, stop = experts_held
    G, E = stop - first, router.shape[1]
    if w_gate_up.shape[0] != G or w_down.shape[0] != G:
        raise ValueError(f"experts_held {experts_held} is {G} experts, the "
                         f"weights hold {w_gate_up.shape[0]}")
    with _tracing.span("moe.route") as sp:
        experts, weights = route_topk(x.float() @ router, expert_bias, k,
                                      normalize, scaling)
        # slots sorted by expert, the held experts' first: expert e sorts
        # as (e - first) mod E
        key = torch.remainder(experts - first, E).reshape(-1)
        order = torch.argsort(key, stable=True)
        counts = torch.zeros(E, dtype=torch.int32, device=x.device)
        counts.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
        ends = torch.cumsum(counts[:G], 0, dtype=torch.int32)
        if sp.recorded:
            sp.annotate(**load_counters(counts[:G]))
        if _profiler._is_profiler_enabled:
            PROFILED_HELD_SLOTS.append(ends[-1])
    with _tracing.span("moe.experts"):
        # each token's k slots, then the slab in expert order: a gather
        # by a permutation, whose gradient is a permutation back
        slab = x[:, None].expand(T, k, D).reshape(T * k, D)[order]
        h = ExpertMatmulFunction.apply(slab, w_gate_up, ends)
        out = ExpertMatmulFunction.apply(SwiGLUFunction.apply(h), w_down,
                                          ends)
    with _tracing.span("moe.combine"):
        back = torch.empty_like(order)
        back[order] = torch.arange(T * k, device=x.device)
        return CombineFunction.apply(out[back].view(T, k, D), weights)
