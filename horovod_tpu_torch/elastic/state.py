"""Worker-side elastic state: commit / restore / sync.

Counterpart of ``horovod_tpu/elastic/state.py``: :class:`State` and
:class:`ObjectState` are copies (reference: common/elastic.py State:27-108,
ObjectState:111-144). :class:`TorchState` takes the place of the JAX
package's ``JaxState``, as the reference's torch/elastic.py TorchState
does: a module's and an optimizer's ``state_dict()`` snapshotted to host
memory on ``save()`` and written back into the live tensors on
``restore()``.
"""

import copy
import queue
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import faults as _faults
from ..exceptions import HostsUpdatedInterrupt

# Chaos site for the elastic step loop: one hit per State.commit(), so
# ``worker.step:crash:step=N`` hard-kills this worker at its N-th commit
# — the deterministic stand-in for `kill -9` in recovery drills. Fired
# BEFORE save(), so a crash here loses exactly the uncommitted step (the
# same contract as a real mid-step kill). A ``preempt`` rule here instead
# *announces* this worker's host to the driver's graceful-drain path (the
# deterministic stand-in for a fleet reclaim notice) and lets the commit
# proceed — so the notice always post-dates a fresh commit, exactly like
# a real scheduler warning landing between steps.
_FP_STEP = _faults.FaultPoint("worker.step")


def _announce_preemption(grace: float) -> None:
    from .worker import notification_manager
    notification_manager.send_preemption_notice(grace)


def _default_bcast_object(obj, root_rank=0, name=None):
    from ..functions import broadcast_object
    return broadcast_object(obj, root_rank=root_rank, name=name)


def _default_get_rank():
    from .. import basics
    return basics.rank()


class State:
    """Tracks in-memory state that must survive worker membership changes.

    ``commit()`` = ``save()`` + host-update check; a pending host update
    raises :class:`HostsUpdatedInterrupt` *synchronously across ranks* (the
    pending-update timestamp is broadcast from rank 0 before raising, so
    every worker interrupts at the same batch — reference
    common/elastic.py:73-95).
    """

    def __init__(self, bcast_object: Optional[Callable] = None,
                 get_rank: Optional[Callable] = None):
        self._bcast_object = bcast_object or _default_bcast_object
        self._rank = get_rank or _default_get_rank
        self._host_messages: "queue.Queue" = queue.Queue()
        self._last_updated_timestamp = 0
        self._reset_callbacks: List[Callable] = []
        #: (save, durable write) seconds of the last commit()
        self.last_commit_seconds: Optional[tuple] = None

    def register_reset_callbacks(self, callbacks: List[Callable]) -> None:
        """Callbacks run after every reset (e.g. re-scale the LR by the new
        world size)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        self._host_messages = queue.Queue()
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self, timestamp: float) -> None:
        """Called by the worker notification service thread."""
        self._host_messages.put(timestamp)

    def commit(self) -> None:
        _FP_STEP.fire(preempt=_announce_preemption)
        t0 = time.perf_counter()
        self.save()
        t1 = time.perf_counter()
        # Durability on EVERY commit: a worker hard-killed (a crash, or
        # NCCL's watchdog ending the survivors of a peer's death) must
        # still find its last commit on disk when the driver respawns its
        # slot.
        from .run import persist_committed_state
        persist_committed_state(self)
        self.last_commit_seconds = (t1 - t0, time.perf_counter() - t1)
        self.check_host_updates()

    def check_host_updates(self) -> None:
        last = prev = self._last_updated_timestamp
        while not self._host_messages.empty():
            ts = self._host_messages.get()
            last = max(last, ts)
        # Sync across ranks so every worker raises on the same step.
        prev, self._last_updated_timestamp = self._bcast_object(
            (prev, last), name="_hvd_elastic_host_ts")
        if self._last_updated_timestamp > prev:
            raise HostsUpdatedInterrupt()

    # -- to be provided by subclasses ---------------------------------------
    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class ObjectState(State):
    """State for plain Python attribute values (reference
    common/elastic.py:111-144): each kwarg becomes an attribute; ``sync``
    broadcasts the committed dict from rank 0."""

    def __init__(self, bcast_object: Optional[Callable] = None,
                 get_rank: Optional[Callable] = None, **kwargs):
        self._saved_state: Dict[str, Any] = kwargs
        super().__init__(bcast_object=bcast_object, get_rank=get_rank)
        self._apply_saved()

    def save(self) -> None:
        self._saved_state = {k: getattr(self, k) for k in self._saved_state}

    def restore(self) -> None:
        self._apply_saved()

    def sync(self) -> None:
        if self._saved_state:
            self._saved_state = self._bcast_object(
                self._saved_state, name="_hvd_elastic_object_state")
            self._apply_saved()

    def _apply_saved(self) -> None:
        for k, v in self._saved_state.items():
            setattr(self, k, v)


class TorchState(State):
    """Elastic state of a ``torch.nn.Module``, its optimizer and plain
    attribute values (reference: torch/elastic.py TorchState)::

        state = TorchState(model, optimizer, epoch=0, batch=0)

    ``save()`` copies the model's and the optimizer's ``state_dict()`` to
    host memory (pinned when they live on the card; the buffers of the
    previous snapshot are reused when the shapes match), so the snapshot
    pickles for the durable commit and refers to no device memory across
    a reset. ``restore()`` writes it back into the live tensors
    (``load_state_dict``: the module's parameters and buffers by
    ``copy_``, the optimizer's state cast to its parameters' devices),
    never rebinding an attribute, so the optimizer's parameter references
    and ``DistributedOptimizer``'s gradient hooks stay on the tensors the
    model trains. A ``DistributedOptimizer`` also drops the buckets and
    handles of the step a reset abandoned. ``sync()`` broadcasts from
    rank 0: the parameters and buffers in place, the optimizer state (a
    process whose optimizer has taken no step yet, such as a worker that
    just joined, first gets zero state of rank 0's layout, so every
    process issues the same broadcasts), and the attribute values.
    """

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 optimizer=None, bcast_object: Optional[Callable] = None,
                 get_rank: Optional[Callable] = None, **kwargs):
        super().__init__(bcast_object=bcast_object, get_rank=get_rank)
        self.model = model
        self.optimizer = optimizer
        self._scalar_names = tuple(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._saved_state: Dict[str, Any] = {}
        self.save()

    def save(self) -> None:
        prev = self._saved_state
        saved = {k: getattr(self, k) for k in self._scalar_names}
        saved["model"] = None if self.model is None else _to_host(
            self.model.state_dict(), prev.get("model"))
        saved["optimizer"] = None if self.optimizer is None else _to_host(
            self.optimizer.state_dict(), prev.get("optimizer"))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._saved_state = saved

    def restore(self) -> None:
        saved = self._saved_state
        if self.model is not None:
            self.model.load_state_dict(saved["model"])
        if self.optimizer is not None:
            self._abandon_step()
            # load_state_dict keeps the references it is given: hand it a
            # copy so the next step does not write into the snapshot
            self.optimizer.load_state_dict(
                _to_host(saved["optimizer"], None, pin=False))
        for k in self._scalar_names:
            setattr(self, k, saved[k])

    def sync(self) -> None:
        from ..functions import (broadcast_optimizer_state,
                                 broadcast_parameters)
        if self.model is not None:
            broadcast_parameters(self.model.state_dict(), root_rank=0)
        if self.optimizer is not None:
            layout = self._bcast_object(_optimizer_layout(self.optimizer),
                                        name="_hvd_elastic_opt_layout")
            _adopt_layout(self.optimizer, layout)
            broadcast_optimizer_state(self.optimizer, root_rank=0)
        if self._scalar_names:
            values = self._bcast_object(
                {k: getattr(self, k) for k in self._scalar_names},
                name="_hvd_elastic_object_state")
            for k, v in values.items():
                setattr(self, k, v)

    def reset(self) -> None:
        self._abandon_step()

    def _abandon_step(self) -> None:
        from ..optimizer import DistributedOptimizer
        if isinstance(self.optimizer, DistributedOptimizer):
            self.optimizer.abandon_step()


def _to_host(tree, prev, pin: bool = True):
    """``tree`` (nested dicts and lists of tensors and plain values) with
    every tensor copied to host memory, into ``prev``'s tensor at the same
    place when its shape and dtype match; pinned when the source is on the
    card and ``pin``."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if isinstance(prev, torch.Tensor) and prev.shape == t.shape \
                and prev.dtype == t.dtype and prev.device.type == "cpu":
            return prev.copy_(t, non_blocking=t.is_cuda)
        out = torch.empty(t.shape, dtype=t.dtype,
                          pin_memory=pin and t.is_cuda)
        return out.copy_(t, non_blocking=t.is_cuda)
    if isinstance(tree, dict):
        prev = prev if isinstance(prev, dict) else {}
        return {k: _to_host(v, prev.get(k), pin) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        prev = prev if isinstance(prev, type(tree)) and \
            len(prev) == len(tree) else [None] * len(tree)
        return type(tree)(_to_host(v, p, pin) for v, p in zip(tree, prev))
    return copy.deepcopy(tree)


def _optimizer_layout(optimizer) -> Dict[int, Dict[str, Any]]:
    """{parameter index: {state key: (shape, dtype name) of a tensor, or
    the value itself}} of the optimizer's state."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    layout = {}
    for i, p in enumerate(params):
        st = optimizer.state.get(p)
        if st:
            layout[i] = {k: (tuple(v.shape), str(v.dtype), v.device.type)
                         if isinstance(v, torch.Tensor) else v
                         for k, v in st.items()}
    return layout


def _adopt_layout(optimizer, layout) -> None:
    """Give every parameter that has no optimizer state zero state of
    ``layout`` (rank 0's), for broadcast_optimizer_state to fill."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, entry in layout.items():
        p = params[i]
        if optimizer.state.get(p):
            continue
        st = {}
        for k, v in entry.items():
            if isinstance(v, tuple):
                shape, dtype, dev = v
                st[k] = torch.zeros(shape, dtype=getattr(torch, dtype.split(
                    ".")[-1]), device=p.device if dev != "cpu" else "cpu")
            else:
                st[k] = v
        optimizer.state[p] = st
