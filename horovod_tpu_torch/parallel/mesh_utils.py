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
"""

import dataclasses
from typing import List, Optional, Tuple

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
# nn.with_logical_partitioning names). 'embed' stays replicated across tp;
# params additionally shard over fsdp on their largest axis. Kept as data:
# the port does not shard parameters over tp or fsdp yet.
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
