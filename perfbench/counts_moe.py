"""The yardstick's arithmetic for the LFM2-MoE configurations: model
FLOPs of a training step and the expert products' roofline, computed
from the configuration's shapes alone.

The model FLOPs count the held experts' work at the balanced
expectation: of a step's ``tokens x num_experts_per_tok`` slots, the
held experts' share ``num_experts / router_experts``, so that the count
does not depend on how the program routes. The expert products'
roofline counts the slots they ran over, which the router's draw moves
from seed to seed.
"""

from typing import Tuple

from .counts import PEAK_BF16_FLOPS, PEAK_BYTES, visible_pairs


def held_slots(cfg: dict, tokens: int) -> float:
    """The slots a step's ``tokens`` give the held experts, balanced."""
    return (tokens * cfg["num_experts_per_tok"] * cfg["num_experts"]
            / cfg["router_experts"])


def lfm2_flops_per_step(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on ``batch`` rows of ``seq``
    tokens, no recompute: 6 x matmul parameters x tokens (the
    convolutions' projections, the attention projections, the dense
    feed-forwards, the routers and the tied logits projection; the
    convolution's taps and the norms are not matmuls), the held experts'
    three products at 6 x their parameters x :func:`held_slots`, and
    causal attention's two products, forward (1x) and backward (2x), over
    the attention layers."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = D // H
    types = cfg["layer_types"]
    sparse = cfg["num_hidden_layers"] - cfg["num_dense_layers"]
    dense = (types.count("conv") * (3 * D * D + D * D)
             + types.count("full_attention") * (2 * D * H * Dh
                                                + 2 * D * KV * Dh)
             + cfg["num_dense_layers"] * 3 * D * cfg["intermediate_size"]
             + sparse * D * cfg["router_experts"] + V * D)
    tokens = batch * seq
    expert = 3 * D * cfg["moe_intermediate_size"]
    attention = (3 * types.count("full_attention") * 4 * batch * H * Dh
                 * visible_pairs(seq, seq, True))
    return (6.0 * dense * tokens
            + 6.0 * expert * sparse * held_slots(cfg, tokens) + attention)


def expert_mm_bound(cfg: dict, slots: float) -> Tuple[float, float, float]:
    """(bytes, operations, least seconds) of one step's expert products,
    ``slots`` the held experts' slots of the step summed over its sparse
    layers. In a layer with A slots each of 3 products (gate, up, down) x
    (1 forward + 2 backward) is ``2 x A x hidden x moe_intermediate``
    operations, and reads the held experts' bf16 weights once and its two
    token slabs (A rows of hidden and of moe_intermediate) once. The
    least time is the larger of operations over the bf16 peak and bytes
    over the peak bandwidth."""
    D, Fm = cfg["hidden_size"], cfg["moe_intermediate_size"]
    layers = cfg["num_hidden_layers"] - cfg["num_dense_layers"]
    flops = 3 * 3 * 2.0 * slots * D * Fm
    nbytes = 3 * 3 * 2.0 * (layers * cfg["num_experts"] * D * Fm
                            + slots * (D + Fm))
    return nbytes, flops, max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS)
