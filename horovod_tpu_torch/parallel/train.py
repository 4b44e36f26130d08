"""Training step for the transformer (counterpart of
``horovod_tpu/parallel/train.py``'s ``make_transformer_train_step`` and its
mesh train-state helpers).

Horovod's main path: the model's causal attention runs through the flash
kernel, the loss is the mean softmax cross-entropy on integer labels,
gradients are averaged across processes in fusion buckets while backward
runs, and the wrapped optimizer steps. Without a mesh each process trains
on its own batch (data parallelism), and the step injects flash attention
through ``attention_fn`` itself, as the JAX Ulysses adapter does around its
inner attention.

With a mesh (``mesh_utils.make_training_mesh``) the step takes the global
batch, the same on every process, and each process runs the model on its
block of it: the rows of its (dp, fsdp) block and the columns of its sp
block, with the positions of those columns (the JAX ``batch_spec``). When
sp > 1 the attention is ring or Ulysses over the mesh's sp group, through
the flash kernel (:func:`sharded_attention`); at sp = 1 it stays plain
flash. Processes that differ only in pp or ep hold the same block and
average as replicas.

With tp > 1 or fsdp > 1 the parameters shard as the JAX package's
``param_shardings`` lays them out under ``TRANSFORMER_RULES``: each
process keeps its block of every parameter (``Transformer.shard_``) and
the AdamW state of that block only; the forward gathers fsdp-sharded
weights just before use, runs H/tp heads and hidden/tp MLP columns, sums
the output projections over tp and takes the vocab-parallel
cross-entropy. Each gradient then reduces over the processes holding the
same block (``mesh_utils.grad_process_sets``), so the step applies the
gradient of the global mean loss, as the JAX package's one SPMD program
does. At tp = fsdp = 1 the step is the unsharded one, launch for launch.

``compiled=True`` is the counterpart of the JAX step's one compiled
program (``jax.jit(_step, donate_argnums=(0, 1))``,
``horovod_tpu/parallel/train.py:120-125``): the step runs two regions
compiled with ``torch.compile(fullgraph=True)``, so a graph break raises
instead of falling back. (a) The forward and the loss on this process's
block of the global batch, with the flash kernel as the custom op
``hvd_tpu::flash_fwd`` and, on a mesh, the sharded forward's collectives
in the graph (``comm``'s in-graph branches: the ring's shifts at int
offsets, Ulysses' all-to-alls, fsdp's gathers, tp's sums and the
vocab-parallel loss); ``loss.backward()`` then runs the compiled
backward, with their transposes, outside it (a backward inside a
compiled region breaks the graph). (b) The gradient reduction in the
graph (``DistributedOptimizer.synchronize`` under compile: the in-jit
grouped allreduce, one collective per packed bucket, or with tp or fsdp
one all-reduce per bucket over its ``grad_process_sets`` set). The inner
optimizer then steps eagerly on the local blocks, as the eager step's
does (torch's optimizers break the graph in ``step()``), so any
optimizer is taken and the update is the eager step's. The optimizer
runs without its hooks, and on a mesh the returned loss is the global
mean, as the eager mesh step's. The regions compile with
``compile_backend`` (inductor by default; the CPU tests pass
"aot_eager") through a recording backend, which notes each compiled
graph's region, nodes, in-graph all-reduces, all-gathers,
reduce-scatters and all-to-alls and flash ops in ``bundle.compile_log``
(counted over the graph and its subgraphs: an autograd Function's
forward and backward, a checkpointed ring step).

Given an ``Lfm2MoeConfig`` (``models/lfm2.py``) the step trains that
hybrid decoder on the same path (the same optimizer, loss and flash
injection; the kernel takes as many K/V heads as query heads, so the
model repeats K and V to the query heads before it), with the forward
and loss inside the span ``step.forward`` (``tracing.py``), under
which the model's ``moe.*`` and ``conv.short`` spans nest. It runs whole
on every process: ``mesh=None`` is Horovod's data parallelism; a mesh
and ``compiled`` are refused.

The mesh train-state helpers (:func:`train_state_tree`,
:func:`run_mesh_step`, :func:`save_mesh_train_state`,
:func:`restore_mesh_train_state`, :func:`drain_mesh_train_state`) run,
checkpoint and restore a bundle through the port's ``checkpointing``: its
sharded leaves are written block by block with their global offsets, so a
state saved on one mesh restores onto another.
"""

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import collectives as _c
from .. import faults as _faults
from .. import tracing as _tracing
from ..basics import resolve_device
from ..models.convert import nest
from ..models.transformer import Transformer, TransformerConfig
from ..ops.flash_attention import flash_attention
from ..optimizer import DistributedOptimizer
from .mesh_utils import (MeshSharding, axis_size, batch_spec,
                         grad_process_sets, param_shardings)

ATTENTION_KINDS = ("ring", "ulysses")

# Chaos site for the mesh train step: one hit per run_mesh_step() call,
# fired before the step runs (``worker.mesh:crash:step=N:rank=R`` kills
# rank R in its N-th mesh step, the stand-in for losing a host out of a
# dp x fsdp x tp mesh; the JAX package's site of the same name).
_FP_MESH = _faults.FaultPoint("worker.mesh")


def flash_attention_fn(q, k, v, mask, dtype):
    """``TransformerConfig.attention_fn`` running the flash kernel
    (causal masking happens inside it)."""
    del mask
    return flash_attention(q, k, v, causal=True, out_dtype=dtype)


def sharded_attention(mesh, kind: str = "ring", causal: bool = True):
    """A ``TransformerConfig.attention_fn`` running context-parallel over
    the mesh's 'sp' group: ring attention (``kind="ring"``) or Ulysses
    (``"ulysses"``), both through the flash kernel. None when sp == 1."""
    from .ring_attention import make_ring_attention
    from .ulysses import make_ulysses_attention

    if kind not in ATTENTION_KINDS:
        raise ValueError(f"attention_kind must be one of {ATTENTION_KINDS}, "
                         f"got {kind!r}")
    if axis_size(mesh, "sp") == 1:
        return None
    group = mesh.get_group("sp")
    if kind == "ring":
        return make_ring_attention(group, causal=causal)
    return make_ulysses_attention(group, causal=causal)


def default_optimizer(params) -> torch.optim.Optimizer:
    """The counterpart of ``optax.adamw(1e-3)``: optax's weight decay is
    1e-4 (torch's default is 1e-2)."""
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


@dataclasses.dataclass
class TrainStepBundle:
    model: Transformer
    optimizer: DistributedOptimizer
    #: (tokens, targets) -> detached scalar loss of the step
    step: Callable
    mesh: Any = None
    #: the parameters' layout on the mesh (tp > 1 or fsdp > 1), else None
    sharding: Optional[MeshSharding] = None
    #: compiled=True: one entry per compiled graph ({"region": "forward"
    #: or "reduce", "nodes", "all_reduces", "all_gathers",
    #: "reduce_scatters", "all_to_alls", "flash_ops"})
    compile_log: Optional[list] = None
    #: compiled=True: the step's compiled regions, (forward(tokens,
    #: targets, pos_offset) -> loss, reduce()), for timing them apart
    regions: Optional[tuple] = None


#: compile_log's keys: the in-graph operations each counts
_LOGGED_OPS = {"all_reduces": "_c10d_functional.all_reduce",
               "all_gathers": "all_gather_into_tensor",
               "reduce_scatters": "reduce_scatter_tensor",
               "all_to_alls": "all_to_all_single",
               "flash_ops": "hvd_tpu.flash_fwd"}


def _recording_backend(backend: str, region: str, log: list):
    """A torch.compile backend that notes the graph Dynamo hands it in
    ``log`` (its nodes, and the operations of ``_LOGGED_OPS`` in it and
    its subgraphs) and compiles it with ``backend``."""
    def compile_fn(gm, example_inputs):
        ops = [str(n.target) for m in gm.modules()
               if isinstance(m, torch.fx.GraphModule)
               for n in m.graph.nodes if n.op == "call_function"]
        log.append({"region": region, "nodes": len(gm.graph.nodes),
                    **{key: sum(op in o for o in ops)
                       for key, op in _LOGGED_OPS.items()}})
        from torch._dynamo import lookup_backend
        return lookup_backend(backend)(gm, example_inputs)
    return compile_fn


def _check_mesh(mesh, cfg: TransformerConfig, dev: torch.device) -> None:
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type} but the model "
                         f"on {dev}")
    sp = axis_size(mesh, "sp")
    if cfg.max_seq_len % sp != 0:
        raise ValueError(f"seq len {cfg.max_seq_len} not divisible by "
                         f"sp={sp}")


def make_transformer_train_step(
        cfg: TransformerConfig, device=None,
        optimizer: Optional[Callable] = None, attention: str = "flash",
        generator: Optional[torch.Generator] = None, mesh=None,
        attention_kind: str = "ring", compiled: bool = False,
        compile_backend: str = "inductor") -> TrainStepBundle:
    """Build the model, its DistributedOptimizer and the step function.

    ``cfg``: a ``TransformerConfig``, or an ``Lfm2MoeConfig`` for the
    LFM2-MoE decoder (no mesh, not compiled; see the module docstring).
    ``optimizer``: a callable taking the model's parameters and returning a
    ``torch.optim`` optimizer (default :func:`default_optimizer`).
    ``attention``: "flash" (the kernel) or "default" (the model's plain
    softmax attention, for comparison; not on a mesh with sp > 1). ``generator`` draws the initial
    weights (default: seed 0 on the device). ``mesh``: a training mesh
    (see the module docstring); then ``attention_kind`` ("ring" or
    "ulysses") picks the sequence-parallel attention when sp > 1, and the
    step takes the global batch and returns the global mean loss. Needs
    ``init()`` first. With tp > 1 or fsdp > 1 the weights are drawn whole,
    as without a mesh, and each process keeps its blocks. ``compiled``:
    the compiled step (see the module docstring), its regions compiled
    with ``compile_backend``."""
    dev = resolve_device(device)
    if attention not in ("flash", "default"):
        raise ValueError(f"attention must be 'flash' or 'default', "
                         f"got {attention!r}")
    attn = flash_attention_fn if attention == "flash" else None
    from ..models.lfm2 import Lfm2MoeConfig
    if isinstance(cfg, Lfm2MoeConfig):
        return _lfm2_bundle(cfg, dev, optimizer, attn, generator, mesh,
                            compiled)
    specs = None
    if mesh is not None:
        _check_mesh(mesh, cfg, dev)
        if attention != "flash" and axis_size(mesh, "sp") > 1:
            raise ValueError(f"attention={attention!r} cannot run on a "
                             f"sequence shard; sp > 1 takes attention="
                             f"'flash' and attention_kind 'ring' or "
                             f"'ulysses'")
        attn = sharded_attention(mesh, attention_kind) or attn
        if axis_size(mesh, "tp") > 1 or axis_size(mesh, "fsdp") > 1:
            shapes = {n: tuple(p.shape) for n, p in
                      Transformer(cfg, device="meta").named_parameters()}
            specs = param_shardings(mesh, shapes)   # raises before groups
    cfg = dataclasses.replace(cfg, attention_fn=attn)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = Transformer(cfg, device=dev, generator=generator)
    sharding = sets = None
    if specs is not None:
        sets = grad_process_sets(mesh, specs)
        sharding = MeshSharding(mesh, specs, owners={
            n: (ps.ranks[0] if ps is not None else 0)
            for n, (ps, _) in sets.items()})
        model.shard_(sharding)
    opt = DistributedOptimizer((optimizer or default_optimizer)(
        model.parameters()), named_parameters=model.named_parameters(),
        grad_process_sets=sets)

    if compiled:
        return _compiled_bundle(cfg, model, opt, dev, mesh, sharding,
                                compile_backend)

    def step(tokens, targets):
        pos_offset = 0
        if mesh is not None:   # this rank's block of the global batch
            rows, cols = batch_spec(mesh, *tokens.shape[:2])
            tokens, targets = tokens[rows, cols], targets[rows, cols]
            pos_offset = cols.start
        opt.zero_grad(set_to_none=True)
        logits = model(tokens.to(dev), pos_offset)
        if sharding is None:
            loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                   targets.to(dev).reshape(-1).long())
        else:
            loss = sharding.cross_entropy(logits, targets.to(dev))
        loss.backward()
        opt.step()
        if mesh is None:
            return loss.detach()
        return _c.allreduce(loss.detach(), op=_c.Average, name="mesh.loss")

    return TrainStepBundle(model=model, optimizer=opt, step=step, mesh=mesh,
                           sharding=sharding)


def _lfm2_bundle(cfg, dev, optimizer, attn, generator, mesh,
                 compiled: bool) -> TrainStepBundle:
    """The bundle of an ``Lfm2MoeConfig``: the eager step of the module
    docstring with the whole model on every process."""
    from ..models.lfm2 import Lfm2Moe
    if compiled:
        raise ValueError("the LFM2-MoE decoder has no compiled step")
    if mesh is not None:
        raise ValueError("the LFM2-MoE decoder has no mesh step: it runs "
                         "whole on each process (mesh=None, Horovod's data "
                         "parallelism)")
    cfg = dataclasses.replace(cfg, attention_fn=attn)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = Lfm2Moe(cfg, device=dev, generator=generator)
    opt = DistributedOptimizer((optimizer or default_optimizer)(
        model.parameters()), named_parameters=model.named_parameters())

    def step(tokens, targets):
        opt.zero_grad(set_to_none=True)
        with _tracing.step_forward(opt._steps):
            logits = model(tokens.to(dev))
            loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                   targets.to(dev).reshape(-1).long())
        loss.backward()
        opt.step()
        return loss.detach()

    return TrainStepBundle(model=model, optimizer=opt, step=step)


def _compiled_bundle(cfg, model, opt, dev, mesh, sharding,
                     backend: str) -> TrainStepBundle:
    """The bundle of ``compiled=True``: regions (a) and (b) of the module
    docstring around the eager backward."""
    opt.remove_hooks()
    log: list = []

    def forward_loss(tokens, targets, pos_offset):
        logits = model(tokens, pos_offset)
        if sharding is not None:
            return sharding.cross_entropy(logits, targets)
        return F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               targets.reshape(-1).long())

    forward = torch.compile(forward_loss, fullgraph=True,
                            backend=_recording_backend(backend, "forward",
                                                       log))
    reduce = torch.compile(opt.synchronize, fullgraph=True,
                           backend=_recording_backend(backend, "reduce", log))

    def step(tokens, targets):
        pos_offset = 0
        if mesh is not None:   # this rank's block of the global batch
            rows, cols = batch_spec(mesh, *tokens.shape[:2])
            tokens, targets = tokens[rows, cols], targets[rows, cols]
            pos_offset = cols.start
        opt.zero_grad(set_to_none=True)
        loss = forward(tokens.to(dev), targets.to(dev), pos_offset)
        loss.backward()
        reduce()
        opt._opt.step()
        if mesh is None:
            return loss.detach()
        return _c.allreduce(loss.detach(), op=_c.Average, name="mesh.loss")

    return TrainStepBundle(model=model, optimizer=opt, step=step, mesh=mesh,
                           sharding=sharding, compile_log=log,
                           regions=(forward, reduce))


# -- the mesh train state: run / save / restore / drain (the JAX package's
#    helpers of the same names, which its elastic recovery composes)

def _ensure_optimizer_state(opt) -> None:
    """Give every parameter of a torch Adam/AdamW, or of an SGD with
    momentum, its state before the first step, as the optimizer's first
    step would (zero moments and step 0; a zero momentum buffer, which
    the first step turns into the gradient exactly as a missing one): the
    train state then has one structure from the start, as an optax state
    has from ``init``, so a checkpoint saved after a step restores into a
    bundle that has taken none."""
    inner = getattr(opt, "_opt", opt)
    if isinstance(inner, torch.optim.SGD):
        for group in inner.param_groups:
            if group.get("momentum", 0) == 0:
                continue
            for p in group["params"]:
                if inner.state[p].get("momentum_buffer") is None:
                    inner.state[p]["momentum_buffer"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
        return
    if not isinstance(inner, (torch.optim.Adam, torch.optim.AdamW)):
        return
    for group in inner.param_groups:
        on_device = group.get("fused") or group.get("capturable")
        for p in group["params"]:
            state = inner.state[p]
            if state:
                continue
            state["step"] = torch.zeros(
                (), dtype=torch.float32,
                device=p.device if on_device else "cpu")
            state["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            if group.get("amsgrad"):
                state["max_exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def train_state_tree(bundle: TrainStepBundle) -> Dict[str, Any]:
    """The checkpointable tree of a bundle, exactly the state a mesh must
    restore to resume step-exact: ``{"params": the flax module's tree of
    parameters, "opt_state": {state key: a tree of the same shape}}``
    (``exp_avg``, ``exp_avg_sq``, ``step`` for AdamW). On a sharded mesh
    a parameter-shaped leaf is a ``checkpointing.Shard`` (this process's
    block, its global shape and offsets, whether this process writes it);
    scalars and an unsharded bundle's leaves are tensors, which the
    checkpoint writes from rank 0."""
    from ..checkpointing import Shard
    _ensure_optimizer_state(bundle.optimizer)
    sh = bundle.sharding
    me = dist.get_rank() if sh is not None else 0

    def leaf(name, t):
        if sh is None or tuple(t.shape) != sh.specs[name].local_shape:
            return t
        spec = sh.specs[name]
        return Shard(t, spec.shape, spec.starts, sh.owners[name] == me)
    named = list(bundle.model.named_parameters())
    state = bundle.optimizer.state
    keys = sorted({k for _, p in named for k in state.get(p, {})})
    return {"params": nest({n: leaf(n, p.data) for n, p in named}),
            "opt_state": {k: nest({n: leaf(n, state[p][k])
                                   for n, p in named}) for k in keys}}


def run_mesh_step(bundle: TrainStepBundle, tokens, targets):
    """One optimizer step through the bundle (fires the ``worker.mesh``
    chaos site first); returns the loss."""
    _FP_MESH.fire()
    return bundle.step(tokens, targets)


def save_mesh_train_state(manager, step: int, bundle: TrainStepBundle,
                          async_: bool = False) -> str:
    """Checkpoint the bundle's train state at ``step``. Sharded leaves are
    written block by block with their global offsets, so a later restore
    can reassemble them onto a *different* mesh."""
    return manager.save(step, train_state_tree(bundle), async_=async_,
                        force=True)


def restore_mesh_train_state(manager, bundle: TrainStepBundle,
                             step: Optional[int] = None) -> Optional[int]:
    """Restore the newest (or ``step``'s) checkpoint into the bundle,
    re-staged onto the bundle's *current* mesh: each process takes its
    blocks out of the saved global arrays, whatever mesh saved them.
    Returns the step asked for (the newest when ``step`` is None; with
    ``fallback`` an earlier committed step may have been restored, as in
    the JAX package), or None when the directory holds no checkpoint."""
    target_step = manager.latest_step() if step is None else step
    if target_step is None:
        return None
    from ..checkpointing.snapshot import tree_flatten
    target = train_state_tree(bundle)
    tree = manager.restore(step=target_step, target=target, fallback=True)
    with torch.no_grad():
        for (_, dst), (_, src) in zip(tree_flatten(target)[0],
                                      tree_flatten(tree)[0]):
            getattr(dst, "data", dst).copy_(getattr(src, "data", src))
    return target_step


def drain_mesh_train_state(manager, step: int,
                           bundle: TrainStepBundle) -> Optional[int]:
    """Preemption-drain the bundle: flush in-flight saves and force a
    final sync save of this process's blocks if the newest committed step
    is older (the shard handoff of a graceful departure)."""
    return manager.drain_for_preemption(step, train_state_tree(bundle))
