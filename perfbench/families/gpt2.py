"""GPT-2-shaped decoders trained through the port's main path.

The system under test is ``horovod_tpu_torch.parallel.train
.make_transformer_train_step(cfg, attention="flash")`` at the
configuration's widths, after ``horovod_tpu_torch.init()``: the port's
transformer with the flash forward kernel, the plain fp32 attention
backward and ``DistributedOptimizer(AdamW)``; at ``mesh=None`` on more
than one chip it is Horovod's data-parallel path. The window drives
``bundle.step``. The weights are the benchmark's, copied in by parameter
name.
"""

import torch

from .. import counts


def leaves(cfg: dict):
    """The leaves, in the order the benchmark draws them: N(0, 0.02)
    matrices as GPT-2 initialises them; LayerNorm scales 1 + N(0, 0.02)
    and biases N(0, 0.02), so that no leaf starts at a value that hides a
    fault in its gradient."""
    E, H, L, V = (cfg["n_embd"], cfg["n_head"], cfg["n_layer"],
                  cfg["vocab_size"])
    D, P, std = E // H, cfg["n_positions"], cfg["initializer_range"]
    mat, scale, bias = ("normal", 0.0, std), ("normal", 1.0, std), \
        ("normal", 0.0, std)
    out = [("embedding", (V, E), mat), ("pos_embedding", (P, E), mat)]
    for i in range(L):
        p = f"layer_{i}."
        out += [(p + "ln1.scale", (E,), scale), (p + "ln1.bias", (E,), bias)]
        out += [(p + f"attn.{w}", (E, H, D), mat) for w in ("wq", "wk", "wv")]
        out += [(p + "attn.wo", (H, D, E), mat),
                (p + "ln2.scale", (E,), scale), (p + "ln2.bias", (E,), bias),
                (p + "mlp.wi", (E, 4 * E), mat),
                (p + "mlp.wo", (4 * E, E), mat)]
    out += [("ln_f.scale", (E,), scale), ("ln_f.bias", (E,), bias)]
    return out


def buffers(cfg: dict, device):
    """Running statistics: none."""
    return {}


def classes(cfg: dict) -> int:
    return cfg["vocab_size"]


def flops_per_step(cfg: dict, traffic: dict) -> float:
    """Model FLOPs of one chip's step (its own rows)."""
    return counts.gpt2_flops_per_step(cfg, traffic["batch_per_chip"])


class Program:
    """The port's transformer train step at the configuration's widths,
    with the flash kernel as its attention and the port's default
    optimizer, ``parallel.train.default_optimizer`` (AdamW), wrapped in
    its ``DistributedOptimizer``. ``weights`` (rank 0's) are copied in by
    parameter name; every rank then takes rank 0's through
    ``hvd.broadcast_parameters``."""

    def __init__(self, cfg: dict, traffic: dict, weights, device):
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models.transformer import (LayerNorm,
                                                           TransformerConfig)
        from horovod_tpu_torch.parallel.train import \
            make_transformer_train_step

        if cfg["activation_function"] != "gelu_new":
            raise ValueError("the port's MLP is the tanh GELU (gelu_new)")
        if traffic["seq_len"] != cfg["n_positions"]:
            raise ValueError("the mix's rows must be n_positions long")
        tcfg = TransformerConfig(
            vocab_size=cfg["vocab_size"], num_layers=cfg["n_layer"],
            d_model=cfg["n_embd"], num_heads=cfg["n_head"],
            head_dim=cfg["n_embd"] // cfg["n_head"], mlp_ratio=4,
            max_seq_len=cfg["n_positions"], dtype=getattr(torch, cfg["dtype"]))
        self.bundle = make_transformer_train_step(tcfg, device=device,
                                                  attention="flash")
        self.model, self.optimizer = self.bundle.model, self.bundle.optimizer
        _check_optimizer(self.optimizer, traffic["optimizer"])
        self.beta1 = traffic["optimizer"]["betas"][0]
        eps = {m.eps for m in self.model.modules() if isinstance(m, LayerNorm)}
        if eps != {cfg["layer_norm_epsilon"]}:
            raise ValueError(f"the port's LayerNorm epsilon is {eps}, the "
                             f"configuration states "
                             f"{cfg['layer_norm_epsilon']}")
        count = sum(p.numel() for p in self.model.parameters())
        if count != cfg["parameters"]:
            raise ValueError(f"the port's model has {count} parameters, the "
                             f"configuration states {cfg['parameters']}")
        if weights is not None:
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    p.copy_(weights[name])
        hvd.broadcast_parameters(self.model.state_dict(), root_rank=0)

    def batch(self, x, y):
        """The program's form of one batch of the feed."""
        return x, y

    def step(self, x, y):
        """The window's call: one optimizer step; the detached loss."""
        return self.bundle.step(x, y)

    def named_parameters(self):
        return self.model.named_parameters()

    def named_buffers(self):
        return {}

    def first_grads(self, initial):
        """Each leaf's gradient as AdamW got it in the first step:
        ``exp_avg`` after one step is (1 - beta1) times it (zeros where
        the step left no state)."""
        state = self.optimizer.state
        return {n: state[p]["exp_avg"] / (1 - self.beta1)
                if "exp_avg" in state[p] else torch.zeros_like(p)
                for n, p in self.model.named_parameters()}


def _check_optimizer(opt, spec: dict) -> None:
    """The program's optimizer is the one the traffic mix states: torch's
    AdamW with its hyperparameters, in every parameter group."""
    inner = getattr(opt, "_opt", opt)
    if spec["name"] != "adamw" or not isinstance(inner, torch.optim.AdamW):
        raise ValueError(f"the program steps {type(inner).__name__}, the "
                         f"mix states {spec['name']}")
    want = {"lr": spec["lr"], "betas": tuple(spec["betas"]),
            "eps": spec["eps"], "weight_decay": spec["weight_decay"],
            "amsgrad": False, "maximize": False}
    for group in inner.param_groups:
        got = {k: (tuple(group[k]) if k == "betas" else group[k])
               for k in want}
        if got != want:
            raise ValueError(f"the program's AdamW has {got}, the mix "
                             f"states {want}")
