"""ResNet v1.5 trained with the Horovod loop as users write it.

The system under test is the port's ``models.ResNet50`` with the conv
stem (bf16 convolutions, fp32 BatchNorm statistics and parameters,
channels_last memory, flax's padding), as
``horovod_tpu_torch.benchmark._Rig`` builds it, stepped by ``zero_grad``
/ forward / cross-entropy / ``backward`` / ``step`` over
``hvd.DistributedOptimizer(torch.optim.SGD)``. With more than
one process every BatchNorm takes the global batch's statistics, as the
rig does. The weights are the benchmark's, copied in by name.
"""

import torch
import torch.nn.functional as F

from ..reference import resnet as reference
from ..reference.resnet import blocks


def _norms(cfg: dict):
    names = ["bn_init"]
    for name, _, proj in blocks(cfg):
        names += [f"{name}.BatchNorm_{i}" for i in range(3)]
        if proj:
            names.append(f"{name}.norm_proj")
    return names


def _channels(cfg: dict):
    """{norm or conv prefix: (out channels, in channels, kernel)}."""
    out = {"conv_init": (cfg["num_filters"], 3, 7)}
    features = cfg["num_filters"]
    for (name, _, proj), filters in zip(blocks(cfg), _filters(cfg)):
        out[f"{name}.Conv_0"] = (filters, features, 1)
        out[f"{name}.Conv_1"] = (filters, filters, 3)
        out[f"{name}.Conv_2"] = (filters * 4, filters, 1)
        if proj:
            out[f"{name}.conv_proj"] = (filters * 4, features, 1)
        features = filters * 4
    return out


def _filters(cfg: dict):
    return [cfg["num_filters"] * 2 ** i
            for i, count in enumerate(cfg["stage_sizes"])
            for _ in range(count)]


def _norm_width(cfg: dict, norm: str) -> int:
    ch = _channels(cfg)
    if norm == "bn_init":
        return cfg["num_filters"]
    block, leaf = norm.rsplit(".", 1)
    conv = "conv_proj" if leaf == "norm_proj" else f"Conv_{leaf[-1]}"
    return ch[f"{block}.{conv}"][0]


def leaves(cfg: dict):
    """Kernels N(0, 1 / fan_in) (He et al.'s variance up to a factor 2);
    BatchNorm scales 1 + N(0, 0.2) and biases N(0, 0.1), but each block's
    last BatchNorm scale N(0.2, 0.05): small, so that a block starts near
    the identity, as the port's own init (and flax's, and Goyal et al.'s)
    starts it at exactly 0, and not nought, which would leave the block's
    other leaves without a gradient in the first step and so hide a fault
    in them. (With every scale near 1 the random network is chaotic: the
    bf16 program's loss, gradients and statistics then differ from the
    float32 reference's by as much as the fp8 control's do.) The
    classifier N(0, 1 / 2048) with bias N(0, 0.01)."""
    out = []
    for prefix, (o, i, k) in _channels(cfg).items():
        out.append((f"{prefix}.kernel", (o, i, k, k),
                    ("normal", 0.0, (i * k * k) ** -0.5)))
    for norm in _norms(cfg):
        c = _norm_width(cfg, norm)
        scale = ("normal", 0.2, 0.05) if norm.endswith("BatchNorm_2") \
            else ("normal", 1.0, 0.2)
        out += [(f"{norm}.scale", (c,), scale),
                (f"{norm}.bias", (c,), ("normal", 0.0, 0.1))]
    feats = cfg["num_filters"] * 2 ** (len(cfg["stage_sizes"]) - 1) * 4
    out += [("Dense_0.kernel", (cfg["num_classes"], feats),
             ("normal", 0.0, feats ** -0.5)),
            ("Dense_0.bias", (cfg["num_classes"],), ("normal", 0.0, 0.01))]
    return out


def buffers(cfg: dict, device):
    """Running statistics as the model starts them: mean 0, variance 1."""
    out = {}
    for norm in _norms(cfg):
        c = _norm_width(cfg, norm)
        out[f"{norm}.mean"] = torch.zeros(c, device=device)
        out[f"{norm}.var"] = torch.ones(c, device=device)
    return out


def classes(cfg: dict) -> int:
    return cfg["num_classes"]


def flops_per_step(cfg: dict, traffic: dict) -> float:
    """FLOPs of one chip's training step, counted by
    ``torch.utils.flop_counter`` on the plain reference on the meta
    device (convolutions and products, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..reference.precision import Precision
    w = {n: torch.empty(s, device="meta", requires_grad=True)
         for n, s, _ in leaves(cfg)}
    b, size = traffic["batch_per_chip"], traffic["image_size"]
    x = torch.empty(b, 3, size, size, device="meta")
    y = torch.zeros(b, dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as counter:
        loss, _ = reference.loss_sum(w, x, y, cfg, Precision("fp32"),
                                     recompute=False)
        loss.backward()
    return float(counter.get_total_flops())


class Program:
    """The Horovod loop over the port's ResNet-50: ``zero_grad``, forward,
    cross-entropy, ``backward`` and ``optimizer.step()`` over
    ``hvd.DistributedOptimizer(torch.optim.SGD)``, as a user's script
    does. ``weights`` (rank 0's) are copied in by name; every rank then
    takes rank 0's through ``hvd.broadcast_parameters``."""

    def __init__(self, cfg: dict, traffic: dict, weights, device):
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models.layers import sync_batch_norm_
        from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet

        if cfg["block"] != "bottleneck":
            raise ValueError("the family builds bottleneck ResNets (the "
                             "port's ResNet50 at stages [3, 4, 6, 3])")
        self.memory = torch.channels_last if device.type == "cuda" \
            else torch.contiguous_format
        model = ResNet(stage_sizes=cfg["stage_sizes"],
                       block_cls=BottleneckBlock,
                       num_classes=cfg["num_classes"],
                       num_filters=cfg["num_filters"],
                       dtype=getattr(torch, cfg["dtype"]), stem="conv",
                       device=device)
        self.model = model.to(memory_format=self.memory).train()
        norms = {m.momentum for m in self.model.modules()
                 if hasattr(m, "momentum")} | \
            {m.epsilon for m in self.model.modules() if hasattr(m, "epsilon")}
        if norms != {cfg["bn_momentum"], cfg["bn_epsilon"]}:
            raise ValueError(f"the port's BatchNorm has momentum and epsilon "
                             f"{norms}, the configuration states "
                             f"{cfg['bn_momentum']}, {cfg['bn_epsilon']}")
        count = sum(p.numel() for p in self.model.parameters())
        if count != cfg["parameters"]:
            raise ValueError(f"the port's model has {count} parameters, the "
                             f"configuration states {cfg['parameters']}")
        if hvd.size() > 1:
            sync_batch_norm_(self.model)
        if weights is not None:
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    p.copy_(weights[name])
        o = traffic["optimizer"]
        if o["name"] != "sgd":
            raise ValueError("the image mixes train with SGD")
        self.wd = o["weight_decay"]
        self.optimizer = hvd.DistributedOptimizer(
            torch.optim.SGD(self.model.parameters(), lr=o["lr"],
                            momentum=o["momentum"], weight_decay=self.wd),
            named_parameters=self.model.named_parameters())
        hvd.broadcast_parameters(self.model.state_dict(), root_rank=0)

    def batch(self, x, y):
        return x.contiguous(memory_format=self.memory), y

    def step(self, x, y):
        """The window's call: the loop's one step; the detached loss."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(self.model(x), y)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def named_parameters(self):
        return self.model.named_parameters()

    def named_buffers(self):
        return dict(self.model.named_buffers())

    def first_grads(self, initial):
        """Each leaf's gradient as SGD got it in the first step: the
        momentum buffer after one step is the gradient plus the weight
        decay's term on the initial weights (zeros where the step left no
        state)."""
        state = self.optimizer.state
        return {n: state[p]["momentum_buffer"] - self.wd * initial[n]
                if state[p].get("momentum_buffer") is not None
                else torch.zeros_like(p)
                for n, p in self.model.named_parameters()}
