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
* the training step on a mesh: the batch split over (dp, fsdp), the
  sequence over sp, the parameters sharded over tp and fsdp by
  ``TRANSFORMER_RULES``, replicated over pp and ep (:mod:`.train`), and
  the mesh train-state helpers that run, checkpoint and restore it.
"""

from .hierarchical import hierarchical_allreduce, hierarchical_pmean  # noqa: F401
from .mesh_utils import (  # noqa: F401
    AXIS_ORDER, MeshConfig, MeshShapeError, MeshSharding, ShardSpec,
    TRANSFORMER_RULES, batch_spec, fsdp_sharded_leaves, grad_process_sets,
    make_training_mesh, param_shardings, plan_reshape, require_axes)
from .moe import MoEMlp, moe_mlp, route_top1  # noqa: F401
from .pipeline import pipeline_apply  # noqa: F401
from .ring_attention import (  # noqa: F401
    make_ring_attention, ring_attention, ring_attention_flash,
    ring_attention_local)
from .train import (  # noqa: F401
    TrainStepBundle, drain_mesh_train_state, flash_attention_fn,
    make_transformer_train_step, restore_mesh_train_state, run_mesh_step,
    save_mesh_train_state, sharded_attention, train_state_tree)
from .ulysses import make_ulysses_attention, ulysses_attention  # noqa: F401
