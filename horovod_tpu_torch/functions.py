"""Parameter, optimizer-state and object broadcast and gather (counterpart
of ``horovod_tpu/functions.py``; reference: horovod/torch/functions.py).

Used to seed every worker with ``root_rank``'s state at start-up. The
tensor functions broadcast in place, one named broadcast per tensor, in
sorted name order so every process issues the same sequence. The object
functions pickle into a uint8 tensor on the world's device (the card
under NCCL), exchange sizes first, then move the payload.
"""

import pickle
from typing import Any, Iterable, List, Mapping, Optional, Tuple, Union

import torch

from . import basics as _basics
from . import collectives as _c


def broadcast_parameters(
        params: Union[Mapping[str, torch.Tensor],
                      Iterable[Tuple[str, torch.Tensor]]],
        root_rank: int = 0, process_set=None) -> None:
    """Broadcast a module's ``state_dict()`` (or ``named_parameters()``)
    from ``root_rank`` into every process's tensors, in place."""
    items = sorted(params.items()) if isinstance(params, Mapping) \
        else sorted(params, key=lambda kv: kv[0])
    for name, p in items:
        _c.broadcast_(p.data if isinstance(p, torch.nn.Parameter) else p,
                      root_rank, name=f"broadcast_parameters.{name}",
                      process_set=process_set)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0, process_set=None) -> None:
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
                _c.broadcast_(val, root_rank, name=name,
                              process_set=process_set)
            elif isinstance(val, (int, float)) and not isinstance(val, bool):
                t = _c.broadcast(torch.tensor([val], dtype=torch.float64),
                                 root_rank, name=name,
                                 process_set=process_set)
                state[key] = type(val)(t.item())


def _payload(obj: Any) -> torch.Tensor:
    """``obj`` pickled into a uint8 tensor on the world's device."""
    raw = bytearray(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    return torch.frombuffer(raw, dtype=torch.uint8).to(_basics.device())


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None, process_set=None) -> Any:
    """Broadcast a picklable object from ``root_rank`` (reference:
    torch/functions.py broadcast_object: the size, then the payload)."""
    name = name or "broadcast_object"
    wm = process_set or _basics.world().world_mesh
    dev = _basics.device()
    buf = _payload(obj) if wm.my_index == root_rank \
        else torch.zeros(0, dtype=torch.uint8, device=dev)
    n = int(_c.broadcast(torch.tensor([buf.numel()], dtype=torch.int64,
                                      device=dev), root_rank,
                         name=f"{name}.size", process_set=process_set))
    if buf.numel() != n:
        buf = torch.zeros(n, dtype=torch.uint8, device=dev)
    out = _c.broadcast(buf, root_rank, name=f"{name}.payload",
                       process_set=process_set)
    return pickle.loads(out.cpu().numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None,
                     process_set=None) -> List[Any]:
    """Gather one picklable object per process into a list in rank order
    (the ragged allgather underneath)."""
    name = name or "allgather_object"
    buf = _payload(obj)
    sizes = _c.allgather(torch.tensor([buf.numel()], dtype=torch.int64,
                                      device=buf.device),
                         name=f"{name}.sizes", process_set=process_set)
    gathered = _c.allgather(buf, name=f"{name}.payload",
                            process_set=process_set).cpu().numpy()
    out, off = [], 0
    for s in sizes.tolist():
        out.append(pickle.loads(gathered[off:off + s].tobytes()))
        off += s
    return out
