"""Sparse (embedding-style) gradient reduction (counterpart of
``horovod_tpu/sparse.py``).

* :func:`allreduce_sparse` allgathers the (indices, values) pairs of every
  process, values pre-divided for Average; duplicate indices are legal
  and sum when densified (TF IndexedSlices semantics; reference:
  tensorflow/__init__.py:87-102);
* :func:`sparse_to_dense` / :func:`allreduce_sparse_as_dense` densify and
  ride the dense allreduce (HOROVOD_SPARSE_AS_DENSE semantics).
"""

from typing import NamedTuple, Optional

import torch

from . import basics as _basics
from . import collectives as _c


class SparseGradient(NamedTuple):
    """``values[i]`` is the gradient row for row ``indices[i]`` of a dense
    tensor of ``dense_shape``."""
    indices: torch.Tensor    # (nnz,) integer
    values: torch.Tensor     # (nnz, ...) rows
    dense_shape: tuple


def allreduce_sparse(sparse: SparseGradient, average: bool = True,
                     name: Optional[str] = None,
                     process_set=None) -> SparseGradient:
    """Allreduce of a sparse gradient by two allgathers; the number of
    rows may differ between processes. Values are scaled by 1/size when
    ``average``."""
    name = name or "horovod_tpu.sparse"
    values = torch.as_tensor(sparse.values)
    if average:
        wm = process_set or _basics.world().world_mesh
        values = values / wm.num_procs
    gathered_values = _c.allgather(values, name=name + ".values",
                                   process_set=process_set)
    gathered_indices = _c.allgather(torch.as_tensor(sparse.indices),
                                    name=name + ".indices",
                                    process_set=process_set)
    return SparseGradient(gathered_indices, gathered_values,
                          sparse.dense_shape)


def sparse_to_dense(sparse: SparseGradient) -> torch.Tensor:
    """Scatter-add the rows into a dense tensor (duplicate indices sum)."""
    values = torch.as_tensor(sparse.values)
    dense = torch.zeros(sparse.dense_shape, dtype=values.dtype,
                        device=values.device)
    return dense.index_add_(0, torch.as_tensor(sparse.indices,
                                               device=values.device).long(),
                            values)


def allreduce_sparse_as_dense(sparse: SparseGradient, average: bool = True,
                              name: Optional[str] = None,
                              process_set=None) -> torch.Tensor:
    """Densify, then dense-allreduce; better when the rows approach the
    dense size."""
    op = _c.Average if average else _c.Sum
    return _c.allreduce(sparse_to_dense(sparse), op=op,
                        name=name or "horovod_tpu.sparse.dense",
                        process_set=process_set)
