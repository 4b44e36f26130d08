"""Parallel training of horovod_tpu_torch (counterpart of
``horovod_tpu/parallel``), over process groups of ``torch.distributed``:

* the training mesh, a DeviceMesh with axes (dp, fsdp, pp, ep, sp, tp)
  (:mod:`.mesh_utils`);
* hierarchical allreduce: reduce-scatter within the inner group, allreduce
  across the outer, allgather back (:mod:`.hierarchical`);
* context parallelism: ring attention, K/V blocks rotating around the sp
  group through the flash kernel (:mod:`.ring_attention`), and Ulysses,
  all-to-alls that trade the sequence axis for the head axis
  (:mod:`.ulysses`);
* pipeline parallelism: the GPipe microbatch schedule over pp
  (:mod:`.pipeline`);
* expert parallelism: top-1 routing and all-to-all token dispatch over ep
  (:mod:`.moe`);
* the training step on a mesh: the batch split over dp, the sequence over
  sp, replicated over pp and ep (:mod:`.train`).

Parameter sharding over tp and fsdp is not ported yet.
"""

from .hierarchical import hierarchical_allreduce, hierarchical_pmean  # noqa: F401
from .mesh_utils import (  # noqa: F401
    AXIS_ORDER, MeshConfig, MeshShapeError, TRANSFORMER_RULES, batch_spec,
    make_training_mesh, plan_reshape, require_axes)
from .moe import MoEMlp, moe_mlp, route_top1  # noqa: F401
from .pipeline import pipeline_apply  # noqa: F401
from .ring_attention import (  # noqa: F401
    make_ring_attention, ring_attention, ring_attention_flash,
    ring_attention_local)
from .train import (  # noqa: F401
    TrainStepBundle, flash_attention_fn, make_transformer_train_step,
    sharded_attention)
from .ulysses import make_ulysses_attention, ulysses_attention  # noqa: F401
