"""The training mesh (counterpart of ``horovod_tpu/parallel/mesh_utils.py``).

The JAX package lays its devices out on a six-axis mesh, ('dp', 'fsdp',
'pp', 'ep', 'sp', 'tp'), outermost first. Here the same mesh is a
``torch.distributed`` DeviceMesh over the processes of the world, one
process per card, with the same axis names in the same order: rank =
((((dp * fsdp + f) * pp + p) * ep + e) * sp + s) * tp + t. Each axis's
process group is ``mesh.get_group(axis)``.

The host logic (configs, spec parsing, reshape planning, replica groups,
axis checks) is a copy of the JAX package's, with the same error types and
messages, so one operator sees one behaviour from both packages.

Parameter sharding (the JAX package's ``param_shardings``, which
``TRANSFORMER_RULES`` drive through flax's logical axes): each parameter
dim names a logical axis, the rules map it to a mesh axis, and each
process keeps the block of the parameter at its index on those axes
(:func:`param_shardings`, :class:`ShardSpec`). :class:`MeshSharding` is
what the sharded transformer runs with: the specs, the fsdp and tp
groups, and the collectives around each product (``comm``).
:func:`grad_process_sets` gives each parameter's gradient the processes it
reduces over.
"""

import copy
import dataclasses
import itertools
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np


class MeshShapeError(ValueError):
    """A mesh (re)shape request that cannot produce a valid device grid —
    survivor count not divisible by the protected inner axes, an unknown
    axis name in a spec, or a policy that refuses the change. Raised
    before any process group is made, so the operator sees the policy and
    the counts instead of a shape error deep inside a collective."""


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes of each parallelism axis; -1 on dp means "absorb the rest"."""
    dp: int = -1      # data parallel (gradient allreduce)
    fsdp: int = 1     # sharded params/optimizer (ZeRO-3 style)
    pp: int = 1       # pipeline stages
    ep: int = 1       # expert parallel
    sp: int = 1       # sequence/context parallel (ring attention)
    tp: int = 1       # tensor parallel (innermost)


AXIS_ORDER = ("dp", "fsdp", "pp", "ep", "sp", "tp")

#: reshape policies for :func:`plan_reshape` (HVD_TPU_MESH_RESHAPE_POLICY)
RESHAPE_POLICIES = ("shrink", "degrade", "strict")


@dataclasses.dataclass(frozen=True)
class ReshapePlan:
    """Outcome of :func:`plan_reshape`: the new mesh config, the policy
    that produced it, the direction relative to the old shape ('down',
    'up', or 'none'), how many survivors the new mesh ``used``, and how
    many it ``dropped`` (non-zero only under the ``degrade`` policy)."""
    config: MeshConfig
    policy: str
    direction: str
    used: int
    dropped: int


def mesh_total(config: MeshConfig) -> int:
    """Devices a fully resolved config occupies (dp must not be -1)."""
    if config.dp <= 0:
        raise MeshShapeError(
            f"mesh config {config} has unresolved dp={config.dp}; resolve "
            "dp against a concrete device count first")
    return int(np.prod([getattr(config, a) for a in AXIS_ORDER]))


def mesh_config_from_spec(spec: str) -> MeshConfig:
    """Parse an ``axis=size`` comma list (``"dp=2,fsdp=2"``) into a
    MeshConfig. Unnamed axes default to 1 (an explicit spec is explicit —
    dp is not left at -1 unless the spec says ``dp=-1``)."""
    sizes = {a: 1 for a in AXIS_ORDER}
    if not spec or not spec.strip():
        raise MeshShapeError("empty mesh spec; expected 'axis=size' comma "
                             f"list over axes {AXIS_ORDER}")
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        axis, sep, value = part.partition("=")
        axis = axis.strip()
        if not sep or axis not in AXIS_ORDER:
            raise MeshShapeError(
                f"unknown mesh axis {axis!r} in spec {spec!r}; valid axes "
                f"(outermost first) are {AXIS_ORDER}")
        try:
            sizes[axis] = int(value)
        except ValueError:
            raise MeshShapeError(
                f"mesh axis {axis!r} has non-integer size {value!r} in "
                f"spec {spec!r}") from None
    return MeshConfig(**sizes)


def _inner_product(config: MeshConfig) -> int:
    """Product of the protected axes (everything but dp and fsdp): the
    reshape policies never break pp/ep/sp/tp groups."""
    return int(np.prod([getattr(config, a) for a in AXIS_ORDER
                        if a not in ("dp", "fsdp")]))


def _default_policy() -> str:
    from .. import basics as _basics
    from .. import config as _config
    cfg = _basics.world().config if _basics.is_initialized() \
        else _config.Config()
    return str(cfg.get(_config.MESH_RESHAPE_POLICY)).strip().lower()


def plan_reshape(config: MeshConfig, survivors: int,
                 policy: Optional[str] = None) -> ReshapePlan:
    """Compute the mesh shape ``survivors`` devices/hosts re-form into.

    Policies (``HVD_TPU_MESH_RESHAPE_POLICY``):

    * ``shrink`` (default): shrink dp first, then fsdp, never the inner
      (pp/ep/sp/tp) axes. Survivors must divide into whole inner groups
      or :class:`MeshShapeError` is raised.
    * ``degrade``: like shrink, but a survivor count that doesn't divide
      evenly drops a remainder (whole dp replica groups' worth of
      capacity idles) instead of aborting — ``plan.dropped`` says how
      many survivors sit out.
    * ``strict``: any change of shape raises :class:`MeshShapeError`.

    ``config.dp == -1`` is resolved against ``survivors`` (first
    generation); the result's direction is ``'none'`` — adopting an
    initial shape is not a reshape.
    """
    if policy is None:
        policy = _default_policy()
    if policy not in RESHAPE_POLICIES:
        raise MeshShapeError(
            f"unknown mesh reshape policy {policy!r}; valid policies are "
            f"{RESHAPE_POLICIES}")
    survivors = int(survivors)
    inner = _inner_product(config)
    if survivors < inner:
        raise MeshShapeError(
            f"policy {policy!r} cannot form a mesh from {survivors} "
            f"survivor(s): the protected inner axes (pp*ep*sp*tp) need "
            f"{inner} devices per replica group and are never broken")

    initial = config.dp <= 0
    old_total = None if initial else mesh_total(config)
    if not initial and survivors == old_total:
        return ReshapePlan(config=config, policy=policy, direction="none",
                           used=survivors, dropped=0)
    if not initial and policy == "strict":
        raise MeshShapeError(
            f"policy 'strict' refuses to reshape: mesh "
            f"{dataclasses.asdict(config)} needs {old_total} devices but "
            f"{survivors} survive")

    fsdp = max(int(config.fsdp), 1)
    if policy == "degrade":
        new_fsdp = fsdp
        while survivors // (new_fsdp * inner) < 1:
            new_fsdp -= 1   # terminates: survivors >= inner, so fsdp=1 fits
        new_dp = survivors // (new_fsdp * inner)
        used = new_dp * new_fsdp * inner
    else:
        if survivors % inner != 0:
            raise MeshShapeError(
                f"policy {policy!r} cannot reshape to {survivors} "
                f"survivor(s): not divisible by the protected inner-axes "
                f"product {inner} (pp*ep*sp*tp); use policy 'degrade' to "
                f"drop the remainder instead of aborting")
        q = survivors // inner
        if policy == "strict" and q % fsdp != 0:
            raise MeshShapeError(
                f"policy 'strict' cannot resolve dp: {survivors} "
                f"survivor(s) leave {q} inner groups, not divisible by "
                f"fsdp={fsdp}")
        new_fsdp = fsdp if q % fsdp == 0 else max(
            f for f in range(1, fsdp + 1) if q % f == 0)
        new_dp = q // new_fsdp
        used = survivors
    new_config = dataclasses.replace(config, dp=new_dp, fsdp=new_fsdp)
    if initial:
        direction = "none"
    else:
        direction = "down" if used < old_total else "up"
    return ReshapePlan(config=new_config, policy=policy, direction=direction,
                       used=used, dropped=survivors - used)


def replica_groups(world_size: int, dp: int) -> List[List[int]]:
    """Rank groups holding bit-identical parameter replicas.

    With dp outermost (AXIS_ORDER), rank = dp_index * (world/dp) +
    inner_index — so ranks sharing an inner index across dp slices hold
    the same tp/fsdp shard and may be fingerprint-compared; ranks in
    different groups hold *different* shards and must not be.
    """
    if dp <= 0 or world_size <= 0 or world_size % dp != 0:
        raise MeshShapeError(
            f"cannot form replica groups: world size {world_size} not "
            f"divisible into dp={dp} replicas")
    stride = world_size // dp
    return [[g + k * stride for k in range(dp)] for g in range(stride)]


def replica_group_of(rank: int, world_size: int, dp: int) -> int:
    """Index (into :func:`replica_groups`) of the group ``rank`` is in."""
    if dp <= 0 or world_size <= 0 or world_size % dp != 0:
        raise MeshShapeError(
            f"cannot form replica groups: world size {world_size} not "
            f"divisible into dp={dp} replicas")
    return int(rank) % (world_size // dp)


def make_training_mesh(config: MeshConfig = MeshConfig(), device=None):
    """A DeviceMesh over the world with dims ('dp','fsdp','pp','ep','sp',
    'tp'), sizes from ``config`` (dp = -1 absorbs the rest). Axes of size 1
    are kept, so every axis name resolves. Needs ``init()`` first (or any
    initialized default process group); collective over the world. The
    mesh's device type is that of ``device`` (CUDA unless asked)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..basics import resolve_device

    dev = resolve_device(device)
    n = dist.get_world_size()
    sizes = {a: getattr(config, a) for a in AXIS_ORDER}
    fixed = int(np.prod([s for a, s in sizes.items() if a != "dp" and s > 0]))
    if sizes["dp"] == -1:
        if n % fixed != 0:
            raise ValueError(
                f"{n} devices not divisible by non-dp axes product {fixed}")
        sizes["dp"] = n // fixed
    total = int(np.prod(list(sizes.values())))
    if total != n:
        raise ValueError(
            f"mesh sizes {sizes} use {total} devices but {n} are available")
    return init_device_mesh(dev.type, tuple(sizes[a] for a in AXIS_ORDER),
                            mesh_dim_names=AXIS_ORDER)


def axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` on ``mesh`` (``mesh.shape`` by name)."""
    require_axes(mesh, axis)
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


# Logical-axis -> mesh-axis rules for the transformer (the JAX module's
# nn.with_logical_partitioning names, models.transformer.logical_axes
# here). 'embed' stays replicated across tp; params additionally shard
# over fsdp on their embed axis.
TRANSFORMER_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("vocab", "tp"),
    ("heads", "tp"),
    ("mlp", "tp"),
    ("embed", "fsdp"),
    ("kv", None),
)


def require_axes(mesh, *axis_names: str):
    """Fail fast when an axis name is not on ``mesh``: a typo'd axis would
    otherwise pair a collective with the wrong group."""
    declared = tuple(mesh.mesh_dim_names)
    missing = [a for a in axis_names if a and a not in declared]
    if missing:
        raise ValueError(
            f"axis name(s) {missing} not on this mesh (declared axes, "
            f"outermost first: {declared}); pipeline/MoE stages must "
            f"agree on the mesh's axis inventory and order")


def batch_spec(mesh, batch: int, seq: int) -> Tuple[slice, slice]:
    """This rank's block of a global (batch, seq, ...) array: rows of its
    (dp, fsdp) block and columns of its sp block, the counterpart of
    ``NamedSharding(mesh, P(("dp", "fsdp"), "sp"))``. Ranks that differ
    only in pp, ep or tp hold the same block. Both sizes must divide."""
    dp, fsdp, sp = (axis_size(mesh, a) for a in ("dp", "fsdp", "sp"))
    rows, cols = dp * fsdp, sp
    if batch % rows or seq % cols:
        raise ValueError(f"global batch ({batch}, {seq}) does not divide "
                         f"into (dp*fsdp={rows}, sp={cols}) blocks")
    b = mesh.get_local_rank("dp") * fsdp + mesh.get_local_rank("fsdp")
    s = mesh.get_local_rank("sp")
    bs, ss = batch // rows, seq // cols
    return slice(b * bs, (b + 1) * bs), slice(s * ss, (s + 1) * ss)


# ---------------------------------------------------------------------------
# parameter sharding
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """One parameter's layout on the mesh: its global ``shape``, the mesh
    axis each dim shards over (None: whole; the PartitionSpec of the JAX
    package's NamedSharding) and ``index``, this process's block of the
    global array."""
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]
    index: Tuple[slice, ...]

    @property
    def starts(self) -> Tuple[int, ...]:
        return tuple(s.start for s in self.index)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.index)

    def sharded_axes(self, mesh) -> Tuple[str, ...]:
        """The mesh axes of size > 1 that this parameter shards over."""
        return tuple(a for a in AXIS_ORDER
                     if a in self.spec and axis_size(mesh, a) > 1)


def param_spec(name: str, ndim: int, rules=TRANSFORMER_RULES,
               logical: Optional[Callable[[str], Optional[Tuple]]] = None
               ) -> Tuple[Tuple[Optional[str], ...], Tuple]:
    """(the mesh axis of each dim, the logical axes) of parameter
    ``name``: ``logical(name)`` gives its logical axes (default the
    transformer's, :func:`models.transformer.logical_axes`; None for an
    unannotated, replicated parameter), ``rules`` map each to a mesh
    axis."""
    if logical is None:
        from ..models.transformer import logical_axes as logical
    axes = logical(name)
    if axes is None:
        axes = (None,) * ndim
    if len(axes) != ndim:
        raise ValueError(f"parameter {name!r} with {ndim} dims has "
                         f"logical axes {axes}")
    table = dict(rules)
    return tuple(table.get(a) if a is not None else None
                 for a in axes), axes


def param_shardings(mesh, shapes: Mapping[str, Tuple[int, ...]],
                    rules=TRANSFORMER_RULES,
                    logical: Optional[Callable[[str], Optional[Tuple]]]
                    = None) -> Dict[str, ShardSpec]:
    """Per parameter name, its :class:`ShardSpec` on ``mesh`` (the
    counterpart of ``param_shardings``, ``horovod_tpu/parallel/
    mesh_utils.py``), by :func:`param_spec`. A sharded dim must divide by
    its axis's size."""
    out = {}
    for name, shape in shapes.items():
        shape = tuple(int(d) for d in shape)
        spec, axes = param_spec(name, len(shape), rules, logical)
        index = []
        for dim, (size, axis) in enumerate(zip(shape, spec)):
            n = axis_size(mesh, axis) if axis is not None else 1
            if size % n:
                raise ValueError(
                    f"dim {dim} of parameter {name!r} ({size}, logical "
                    f"axis {axes[dim]!r}) is not divisible by mesh axis "
                    f"{axis!r} of size {n}")
            block = size // n
            i = mesh.get_local_rank(axis) if n > 1 else 0
            index.append(slice(i * block, (i + 1) * block))
        out[name] = ShardSpec(shape, spec, tuple(index))
    return out


def fsdp_sharded_leaves(model) -> List:
    """The parameters of a sharded ``model`` that are genuinely
    ZeRO-sharded over 'fsdp', as the JAX package's oracle proves it: the
    local shard is strictly smaller than the global parameter AND its spec
    names 'fsdp'. An unsharded model has none."""
    sharding = getattr(model, "shard", None)
    if sharding is None:
        return []
    return [p for name, p in model.named_parameters()
            if p.numel() < int(np.prod(sharding.specs[name].shape))
            and "fsdp" in sharding.specs[name].spec]


def _coordinate_groups(mesh, axes: Tuple[str, ...]) -> List[List[int]]:
    """The world's ranks partitioned by their index on ``axes``: ranks in
    one group agree on every one of them (and differ on the others)."""
    grid = mesh.mesh.cpu().numpy()
    dims = [mesh.mesh_dim_names.index(a) for a in axes]
    groups = []
    for coords in itertools.product(*(range(grid.shape[d]) for d in dims)):
        sel = [slice(None)] * grid.ndim
        for d, c in zip(dims, coords):
            sel[d] = c
        groups.append(sorted(int(r) for r in grid[tuple(sel)].ravel()))
    return groups


def grad_process_sets(mesh, specs: Mapping[str, ShardSpec]
                      ) -> Dict[str, Tuple[object, float]]:
    """Per parameter, the process set its gradient is summed over and the
    factor applied to the sum, so that the result is the gradient of the
    global mean loss (what the JAX package's one SPMD program computes).

    The set holds the processes with the same block of the parameter (the
    same index on each axis it shards over). Each process's gradient is
    its (dp, fsdp, sp) block's; an fsdp-sharded weight's has already been
    summed over fsdp by its gather's backward (a reduce-scatter). The
    factor is 1 / (world / tp) for a parameter sharded over tp (each tp
    index holds its own block) and 1 / world otherwise. A replicated
    parameter's set is the world (None): the world average, as the
    unsharded step takes it. Collective over the world (every process
    makes every set, in one order)."""
    import torch.distributed as dist

    from ..mesh import WorldMesh
    world = dist.get_world_size()
    me = dist.get_rank()
    made: Dict[Tuple[str, ...], object] = {(): None}
    out = {}
    for name, spec in specs.items():
        axes = spec.sharded_axes(mesh)
        if axes not in made:
            for ranks in _coordinate_groups(mesh, axes):
                group = dist.new_group(ranks)
                if me in ranks:
                    made[axes] = WorldMesh(ranks, group)
        tp = axis_size(mesh, "tp") if "tp" in axes else 1
        out[name] = (made[axes], tp / world)
    return out


class MeshSharding:
    """What the sharded transformer runs with on one process: the
    parameters' :class:`ShardSpec` by name (``specs``), the lowest rank
    holding each one's block (``owners``: the process that writes it to a
    checkpoint), and the collectives around each product:

    * :meth:`gather`: a weight all-gathered over fsdp just before its use
      (a reduce-scatter of its gradient in backward; nothing gathered is
      kept as a parameter);
    * :meth:`tp_in` / :meth:`tp_out`: Megatron's identity-then-sum and
      sum-then-identity around the head- and mlp-sharded products;
    * :meth:`embed` and :meth:`cross_entropy`: the vocab-sharded lookup and
      loss (the logits stay sharded over tp: the max and the sum of the
      softmax are reduced over tp, never the 32000-wide logits).

    Axes of size 1 run no collective."""

    def __init__(self, mesh, specs: Mapping[str, ShardSpec],
                 owners: Optional[Mapping[str, int]] = None):
        self.mesh = mesh
        self.specs = dict(specs)
        self.owners = dict(owners or {})
        self.fsdp = axis_size(mesh, "fsdp")
        self.tp = axis_size(mesh, "tp")
        self.fsdp_group = mesh.get_group("fsdp") if self.fsdp > 1 else None
        self.tp_group = mesh.get_group("tp") if self.tp > 1 else None
        emb = self.specs.get("embedding")
        self.vocab_start = emb.index[0].start if emb is not None else 0
        self._by_id: Dict[int, ShardSpec] = {}

    def bind(self, named_parameters) -> None:
        """Know each parameter object by its name's spec."""
        self._by_id = {id(p): self.specs[n] for n, p in named_parameters}

    def gather(self, p):
        """``p`` whole along its fsdp dim (``p`` itself at fsdp 1)."""
        spec = self._by_id[id(p)]
        if self.fsdp_group is None or "fsdp" not in spec.spec:
            return p
        from .comm import all_gather
        return all_gather(p, spec.spec.index("fsdp"), self.fsdp_group)

    def tp_in(self, x):
        if self.tp_group is None:
            return x
        from .comm import copy_to_group
        return copy_to_group(x, self.tp_group)

    def tp_out(self, x):
        if self.tp_group is None:
            return x
        from .comm import sum_replicated
        return sum_replicated(x, self.tp_group)

    def embed(self, tokens, table):
        """Rows of the vocab-sharded ``table`` (V/tp, E) for ``tokens``:
        each process looks up the tokens in its vocab block, zeros the
        rest, and the blocks are summed over tp (exact: one is nonzero)."""
        if self.tp_group is None:
            return table[tokens]
        local = tokens - self.vocab_start
        inside = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)] \
            * inside[..., None].to(table.dtype)
        return self.tp_out(rows)

    def cross_entropy(self, logits, targets):
        """Mean softmax cross-entropy of vocab-sharded fp32 ``logits``
        (..., V/tp) against integer ``targets`` (...): logsumexp from the
        tp max and the tp sum of the block's exponentials, minus the
        target's logit taken by the block that holds it."""
        import torch
        import torch.nn.functional as F
        if self.tp_group is None:
            return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   targets.reshape(-1).long())
        from .comm import all_reduce_max
        vl = logits.shape[-1]
        m = all_reduce_max(logits.detach().amax(-1, keepdim=True),
                           self.tp_group)
        total = self.tp_out(torch.exp(logits - m).sum(-1, keepdim=True))
        local = targets.long()[..., None] - self.vocab_start
        inside = (local >= 0) & (local < vl)
        picked = logits.gather(-1, local.clamp(0, vl - 1)) * inside
        return (torch.log(total) + m - self.tp_out(picked)).mean()


class _TpBlock:
    """The mesh surface :func:`param_shardings` reads, for block ``t`` of
    ``tp`` on a mesh that is tp alone."""

    mesh_dim_names = AXIS_ORDER

    def __init__(self, t: int, tp: int):
        self.shape = (1,) * (len(AXIS_ORDER) - 1) + (tp,)
        self.t = t

    def get_local_rank(self, axis):
        return self.t if axis == "tp" else 0


class _HeldBlock:
    """MeshSharding's surface for a block held whole on this process: the
    weights are the block's, the collectives are the caller's."""

    @staticmethod
    def gather(p):
        return p

    @staticmethod
    def tp_in(x):
        return x

    @staticmethod
    def tp_out(x):
        return x


def tensor_parallel_blocks(layer, tp: int) -> list:
    """Copies of a transformer ``DecoderLayer``, each holding block t of
    ``tp`` of every weight as :func:`param_shardings` lays it out
    (attention over H/tp heads, the MLP over hidden/tp columns), their
    collectives left to the caller (see :func:`tensor_parallel_local`)."""
    import torch
    shapes = {n: tuple(p.shape) for n, p in layer.named_parameters()}
    blocks = []
    for t in range(tp):
        specs = param_shardings(_TpBlock(t, tp), shapes)
        block = copy.deepcopy(layer)
        for name, p in block.named_parameters():
            p.data = p.data[specs[name].index].clone(
                memory_format=torch.contiguous_format)
        block.attn.shard = block.mlp.shard = _HeldBlock()
        blocks.append(block)
    return blocks


def tensor_parallel_local(layer, blocks, x, mask):
    """``layer`` run as its tp ``blocks`` (:func:`tensor_parallel_blocks`)
    run in turn on this process: every block's attention and MLP, and the
    blocks' partial outputs summed in the activation dtype, as
    ``MeshSharding.tp_out`` sums them over a tp group. The one-process
    counterpart of the layer on a tp mesh (as ``ring_attention_local`` is
    of the sp ring); each block's attention calls ``cfg.attention_fn`` at
    B*H/tp heads."""
    def summed(parts):
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out
    h = layer.ln1(x)
    x = x + summed([b.attn(h, mask) for b in blocks])
    h = layer.ln2(x)
    return x + summed([b.mlp(h) for b in blocks])
