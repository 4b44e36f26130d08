"""Parameter and optimizer-state broadcast (counterpart of
``horovod_tpu/functions.py``; reference: horovod/torch/functions.py).

Used to seed every worker with ``root_rank``'s state at start-up. Both
functions broadcast in place, one named broadcast per tensor, in sorted
name order so every process issues the same sequence.
"""

from typing import Iterable, Mapping, Tuple, Union

import torch

from . import collectives as _c


def broadcast_parameters(
        params: Union[Mapping[str, torch.Tensor],
                      Iterable[Tuple[str, torch.Tensor]]],
        root_rank: int = 0) -> None:
    """Broadcast a module's ``state_dict()`` (or ``named_parameters()``)
    from ``root_rank`` into every process's tensors, in place."""
    items = sorted(params.items()) if isinstance(params, Mapping) \
        else sorted(params, key=lambda kv: kv[0])
    for name, p in items:
        _c.broadcast_(p.data if isinstance(p, torch.nn.Parameter) else p,
                      root_rank, name=f"broadcast_parameters.{name}")


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast a ``torch.optim`` optimizer's per-parameter state from
    ``root_rank``, in place. Tensor entries broadcast directly; number
    entries travel as one-element tensors and are written back. A state
    not created yet (no step taken) has nothing to broadcast."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for pi, p in enumerate(params):
        state = optimizer.state.get(p, {})
        for key in sorted(state):
            val = state[key]
            name = f"broadcast_opt_state.{pi}.{key}"
            if isinstance(val, torch.Tensor):
                _c.broadcast_(val, root_rank, name=name)
            elif isinstance(val, (int, float)) and not isinstance(val, bool):
                t = _c.broadcast(torch.tensor([val], dtype=torch.float64),
                                 root_rank, name=name)
                state[key] = type(val)(t.item())
