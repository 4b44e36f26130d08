"""LFM2-MoE hybrid decoders trained through the port's main path.

The system under test is ``horovod_tpu_torch.parallel.train
.make_transformer_train_step(cfg, attention="flash")`` given the port's
``models.lfm2.Lfm2MoeConfig`` at the configuration's widths, after
``horovod_tpu_torch.init()``: gated short convolutions, grouped-query
attention through the flash kernels (K and V repeated to the query
heads), dense SwiGLU feed-forwards and the dropless expert layer
(``parallel.moe.dropless_moe``) over the experts this chip holds, with
``DistributedOptimizer(AdamW)``. The window drives ``bundle.step``. The
weights are the benchmark's, copied in by name; the expert bias, which
the program holds as a buffer, is among them.
"""

import torch

from .. import counts_moe
from .gpt2 import _check_optimizer


def leaves(cfg: dict):
    """The leaves, in the order the benchmark draws them: matrices and the
    convolution's taps N(0, 0.02); RMSNorm scales 1 + N(0, 0.02), so that
    no leaf starts at a value that hides a fault in its gradient; the
    expert bias N(0, 0.05)."""
    D, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["conv_L_cache"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh, Fd, Fm = D // H, cfg["intermediate_size"], cfg["moe_intermediate_size"]
    G, E = cfg["num_experts"], cfg["router_experts"]
    std = cfg["initializer_range"]
    mat, scale = ("normal", 0.0, std), ("normal", 1.0, std)
    bias = ("normal", 0.0, cfg["expert_bias_std"])
    out = [("embedding", (V, D), mat)]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layer_{i}."
        out.append((p + "operator_norm.scale", (D,), scale))
        if kind == "conv":
            out += [(p + "conv.in_proj", (D, 3 * D), mat),
                    (p + "conv.weight", (D, L), mat),
                    (p + "conv.out_proj", (D, D), mat)]
        else:
            out += [(p + "attn.wq", (D, H * Dh), mat),
                    (p + "attn.wk", (D, KV * Dh), mat),
                    (p + "attn.wv", (D, KV * Dh), mat),
                    (p + "attn.wo", (H * Dh, D), mat),
                    (p + "attn.q_norm.scale", (Dh,), scale),
                    (p + "attn.k_norm.scale", (Dh,), scale)]
        out.append((p + "ffn_norm.scale", (D,), scale))
        if i < cfg["num_dense_layers"]:
            out += [(p + "mlp.w1", (D, Fd), mat), (p + "mlp.w3", (D, Fd), mat),
                    (p + "mlp.w2", (Fd, D), mat)]
        else:
            out += [(p + "moe.router", (D, E), mat),
                    (p + "moe.expert_bias", (E,), bias),
                    (p + "moe.w1", (G, D, Fm), mat),
                    (p + "moe.w3", (G, D, Fm), mat),
                    (p + "moe.w2", (G, Fm, D), mat)]
    out.append(("norm_f.scale", (D,), scale))
    return out


def buffers(cfg: dict, device):
    """Running statistics: none."""
    return {}


def classes(cfg: dict) -> int:
    return cfg["vocab_size"]


def flops_per_step(cfg: dict, traffic: dict) -> float:
    """Model FLOPs of one chip's step (its own rows)."""
    return counts_moe.lfm2_flops_per_step(cfg, traffic["batch_per_chip"],
                                          traffic["seq_len"])


def port_config(cfg: dict, seq_len: int):
    """The port's ``Lfm2MoeConfig`` of a configuration file."""
    from horovod_tpu_torch.models.lfm2 import Lfm2MoeConfig
    first, stop = cfg["experts_held"]
    if stop - first != cfg["num_experts"]:
        raise ValueError(f"experts_held {cfg['experts_held']} is not "
                         f"num_experts {cfg['num_experts']} experts")
    return Lfm2MoeConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        layer_types=tuple(cfg["layer_types"]),
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"],
        conv_L_cache=cfg["conv_L_cache"], conv_bias=cfg["conv_bias"],
        norm_eps=cfg["norm_eps"], rope_theta=float(cfg["rope_theta"]),
        num_dense_layers=cfg["num_dense_layers"],
        num_experts=cfg["router_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        norm_topk_prob=cfg["norm_topk_prob"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]),
        use_expert_bias=cfg["use_expert_bias"],
        experts_held=(first, stop), max_seq_len=seq_len,
        dtype=getattr(torch, cfg["dtype"]))


class Program:
    """The port's train step for the configuration, with the flash
    kernels as its attention and ``parallel.train.default_optimizer``
    (AdamW) in its ``DistributedOptimizer``. ``weights`` (rank 0's) are
    copied in by name; every rank then takes rank 0's through
    ``hvd.broadcast_parameters``."""

    def __init__(self, cfg: dict, traffic: dict, weights, device):
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models.lfm2 import RMSNorm
        from horovod_tpu_torch.parallel.train import \
            make_transformer_train_step

        self.bundle = make_transformer_train_step(
            port_config(cfg, traffic["seq_len"]), device=device,
            attention="flash")
        self.model, self.optimizer = self.bundle.model, self.bundle.optimizer
        _check_optimizer(self.optimizer, traffic["optimizer"])
        self.beta1 = traffic["optimizer"]["betas"][0]
        eps = {m.eps for m in self.model.modules() if isinstance(m, RMSNorm)}
        if eps != {cfg["norm_eps"]}:
            raise ValueError(f"the port's RMSNorm epsilon is {eps}, the "
                             f"configuration states {cfg['norm_eps']}")
        count = sum(p.numel() for p in self.model.parameters())
        if count != cfg["parameters"]:
            raise ValueError(f"the port's model has {count} parameters, the "
                             f"configuration states {cfg['parameters']}")
        if weights is not None:
            with torch.no_grad():
                for name, p in self.named_parameters():
                    p.copy_(weights[name])
        hvd.broadcast_parameters(self.model.state_dict(), root_rank=0)

    def batch(self, x, y):
        """The program's form of one batch of the feed."""
        return x, y

    def step(self, x, y):
        """The window's call: one optimizer step; the detached loss."""
        return self.bundle.step(x, y)

    def named_parameters(self):
        """The leaves: the parameters and the fixed expert biases."""
        yield from self.model.named_parameters()
        for name, b in self.model.named_buffers():
            if name.endswith("expert_bias"):
                yield name, b

    def named_buffers(self):
        return {}

    def first_grads(self, initial):
        """Each leaf's gradient as AdamW got it in the first step:
        ``exp_avg`` after one step is (1 - beta1) times it (zeros where
        the step left no state, as for the fixed expert biases)."""
        state = self.optimizer.state
        return {n: state[p]["exp_avg"] / (1 - self.beta1)
                if p in state and "exp_avg" in state[p]
                else torch.zeros_like(p)
                for n, p in self.named_parameters()}
