"""The traffic mixes' optimizers written out in float32, on a dict of
leaves: torch's AdamW (decoupled weight decay, bias-corrected moments)
and SGD with momentum and coupled weight decay, with the same
definitions, step by step."""

import math
from typing import Dict

import torch


class AdamW:
    def __init__(self, lr: float, betas, eps: float, weight_decay: float):
        self.lr, self.eps, self.wd = lr, eps, weight_decay
        self.b1, self.b2 = betas
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        with torch.no_grad():
            for name, p in params.items():
                g = grads[name]
                m = self.m.get(name, torch.zeros_like(p))
                v = self.v.get(name, torch.zeros_like(p))
                m = self.b1 * m + (1 - self.b1) * g
                v = self.b2 * v + (1 - self.b2) * g * g
                self.m[name], self.v[name] = m, v
                p.mul_(1 - self.lr * self.wd)
                p.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2)
                                           + self.eps))


class SGD:
    def __init__(self, lr: float, momentum: float, weight_decay: float):
        self.lr, self.mu, self.wd = lr, momentum, weight_decay
        self.buf: Dict[str, torch.Tensor] = {}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for name, p in params.items():
                d = grads[name] + self.wd * p
                b = self.buf.get(name)
                b = d.clone() if b is None else self.mu * b + d
                self.buf[name] = b
                p.sub_(self.lr * b)


def make(spec: dict):
    """The optimizer a traffic mix names (``{"name": "adamw", ...}``)."""
    kw = {k: v for k, v in spec.items() if k != "name"}
    if spec["name"] == "adamw":
        return AdamW(**kw)
    if spec["name"] == "sgd":
        return SGD(**kw)
    raise ValueError(f"unknown optimizer {spec['name']!r}")
