"""The port held against the benchmark's plain references on the CPU, at
a tiny size, on weights and batches drawn from the seed as a run draws
them: in float32 the port's loss and every leaf's gradient agree with the
reference's to float32 rounding, and the reference's optimizers, written
out, step as torch's do."""

import pytest
import torch
import torch.nn.functional as F

from perfbench import feed
from perfbench.families import gpt2, resnet
from perfbench.reference import gpt2 as ref_gpt2
from perfbench.reference import optim
from perfbench.reference import resnet as ref_resnet
from perfbench.reference.precision import Precision
from perfbench.tests import tiny

SEEDS = [5, 2**31 + 19]


def _gpt2_cfg():
    cfg = {"n_layer": 2, "n_head": 4, "n_embd": 64, "n_positions": 32,
           "vocab_size": 256, "layer_norm_epsilon": 1e-6,
           "initializer_range": 0.02}
    return cfg


def _close(got, want, rtol):
    """Relative to the leaf's largest value: float32 rounding of sums in
    another order, not a tolerance for a different formula."""
    scale = want.abs().max().clamp(min=1e-12)
    return float((got - want).abs().max() / scale) <= rtol


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_decoder_agrees_with_the_reference(seed):
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                       TransformerConfig)
    from horovod_tpu_torch.parallel.train import flash_attention_fn
    torch.set_num_threads(4)
    cfg = _gpt2_cfg()
    w = feed.make_weights(gpt2.leaves(cfg), seed, "cpu")
    tokens, targets = feed.token_batches(
        {"batch_per_chip": 4, "seq_len": cfg["n_positions"],
         "pool_batches": 1}, cfg["vocab_size"], seed, 0, "cpu")
    tokens, targets = tokens[0], targets[0]
    model = Transformer(TransformerConfig(
        vocab_size=cfg["vocab_size"], num_layers=cfg["n_layer"],
        d_model=cfg["n_embd"], num_heads=cfg["n_head"], head_dim=16,
        max_seq_len=cfg["n_positions"], dtype=torch.float32,
        attention_fn=flash_attention_fn), device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    loss = F.cross_entropy(model(tokens).reshape(-1, cfg["vocab_size"]),
                           targets.reshape(-1))
    loss.backward()
    want, grads, _ = ref_gpt2.loss_and_grads(w, (tokens, targets), cfg,
                                             Precision("fp32"))
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)
    for name, p in model.named_parameters():
        assert _close(p.grad, grads[name], 2e-4), name


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_resnet_agrees_with_the_reference(seed):
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    torch.set_num_threads(4)
    cfg = {**tiny.TINY_RESNET, "bn_epsilon": 1e-5, "bn_momentum": 0.9}
    w = feed.make_weights(resnet.leaves(cfg), seed, "cpu")
    images, labels = feed.image_batches(
        {"batch_per_chip": 8, "image_size": 32, "pool_batches": 1,
         "image_dtype": "float32"}, cfg["num_classes"], seed, 0, "cpu")
    images, labels = images[0], labels[0]
    model = ResNet(stage_sizes=cfg["stage_sizes"], block_cls=BottleneckBlock,
                   num_classes=cfg["num_classes"],
                   num_filters=cfg["num_filters"], dtype=torch.float32,
                   device="cpu").train()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    loss = F.cross_entropy(model(images), labels)
    loss.backward()
    want, grads, stats = ref_resnet.loss_and_grads(
        w, (images, labels), cfg, Precision("fp32"))
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)
    for name, p in model.named_parameters():
        assert _close(p.grad, grads[name], 2e-4), name
    bufs = resnet.buffers(cfg, "cpu")
    ref_resnet.update_running(bufs, stats, cfg)
    for name, b in model.named_buffers():
        assert _close(b, bufs[name], 1e-5), name


@pytest.mark.parametrize("spec,make", [
    ({"name": "adamw", "lr": 1e-3, "betas": [0.9, 0.999], "eps": 1e-8,
      "weight_decay": 1e-4},
     lambda ps: torch.optim.AdamW(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4, foreach=False)),
    ({"name": "sgd", "lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4},
     lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9, weight_decay=1e-4,
                                foreach=False)),
])
def test_the_written_out_optimizers_step_as_torch_does(spec, make):
    g = torch.Generator().manual_seed(3)
    start = {"a": torch.randn(7, 5, generator=g),
             "b": torch.randn(11, generator=g)}
    grads = [{n: torch.randn(t.shape, generator=g) for n, t in start.items()}
             for _ in range(3)]
    mine = {n: t.clone() for n, t in start.items()}
    ref = optim.make(spec)
    params = {n: torch.nn.Parameter(t.clone()) for n, t in start.items()}
    theirs = make(list(params.values()))
    for step in grads:
        ref.step(mine, step)
        for n, p in params.items():
            p.grad = step[n].clone()
        theirs.step()
    for n, p in params.items():
        assert torch.allclose(mine[n], p.detach(), rtol=1e-6, atol=1e-7), n
