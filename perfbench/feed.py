"""Inputs and weights, made from the seed on the device.

One general generator reads a traffic mix's file (``traffic/<name>.json``)
and makes each rank's pool of batches from (seed, rank); another makes a
configuration's weights from its family's list of leaves. Both draw from a ``torch.Generator`` on the
device in a few large calls, so that the same seed gives the same tensors
on every call and in every process: the program and the reference are
handed the same values.

Seeds: ``--seed`` may be any whole number up to a little over 2**31 (or
larger); :func:`sub_seed` hashes it with a purpose so that weights and
data draw from streams of their own.
"""

import hashlib
from typing import Dict, List, Tuple

import torch

#: a leaf of a configuration's weights: name, shape, and how it is drawn:
#: ("normal", mean, std) is mean + std * N(0, 1)
Leaf = Tuple[str, Tuple[int, ...], Tuple]


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` derived from ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def make_weights(leaves: List[Leaf], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """fp32 tensors by leaf name, all drawn by one ``randn`` call of the
    whole count and then scaled and shifted leaf by leaf."""
    total = sum(_numel(shape) for _, shape, _ in leaves)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, (kind, mean, std) in leaves:
        if kind != "normal":
            raise ValueError(f"leaf {name}: unknown draw {kind!r}")
        n = _numel(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std).add_(mean)
        at += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def token_batches(traffic: dict, vocab: int, seed: int, rank: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s pool of token batches, (pool, batch, seq) tokens
    and next-token targets: uniform ids over the vocabulary, packed full
    sequences with no document masking, drawn from (seed, rank)."""
    if traffic.get("token_distribution", "uniform") != "uniform":
        raise ValueError("token mixes draw uniform ids only")
    seq = traffic["seq_len"]
    ids = torch.randint(0, vocab, (traffic["pool_batches"],
                                   traffic["batch_per_chip"], seq + 1),
                        generator=generator(seed, f"tokens.{rank}", device),
                        device=device)
    return ids[:, :, :-1].contiguous(), ids[:, :, 1:].contiguous()


def image_batches(traffic: dict, classes: int, seed: int, rank: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s pool of image batches: (pool, batch, 3, size,
    size) images, N(0, 1) rounded to the activation dtype the
    configuration runs in (``traffic["image_dtype"]``), and labels
    uniform over the classes, drawn from (seed, rank)."""
    size = traffic["image_size"]
    shape = (traffic["pool_batches"], traffic["batch_per_chip"])
    g = generator(seed, f"images.{rank}", device)
    images = torch.randn(*shape, 3, size, size, generator=g, device=device)
    images = images.to(getattr(torch, traffic.get("image_dtype", "float32")))
    labels = torch.randint(0, classes, shape, generator=g, device=device)
    return images, labels


BATCHES = {"tokens": token_batches, "images": image_batches}


def batches(traffic: dict, classes: int, seed: int, rank: int, device):
    """Rank ``rank``'s pool of batches of a mix, by its ``kind``."""
    kind = traffic["kind"]
    if kind not in BATCHES:
        raise ValueError(f"unknown traffic kind {kind!r}; expected one of "
                         f"{sorted(BATCHES)}")
    return BATCHES[kind](traffic, classes, seed, rank, device)


def global_batch(traffic: dict, classes: int, seed: int, ranks: int,
                 index: int, device):
    """Pool entry ``index`` of every rank, rows of rank 0 first: the
    global batch of that step, as the reference takes it."""
    parts = [batches(traffic, classes, seed, r, device) for r in range(ranks)]
    return (torch.cat([x[index] for x, _ in parts]),
            torch.cat([y[index] for _, y in parts]))
