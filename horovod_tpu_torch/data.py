"""Data feeding: sharding, host-to-device prefetch, static-shape batches
(counterpart of ``horovod_tpu/data.py``).

* :func:`shard_dataset`, :func:`pad_to_size` and :func:`batches` are the
  JAX package's, copied: the shuffle is numpy's RNG, so the batch order
  for a seed is the JAX package's, bit for bit.
* :class:`PrefetchIterator` / :func:`prefetch_to_device`: a daemon thread
  stages the next ``buffer_size`` batches on ``device``. On a CUDA device
  each batch is copied from pinned host memory with ``non_blocking=True``
  on a side stream, and an event is recorded after the copy; the consumer
  makes its current stream wait on that event and ``record_stream``s every
  tensor before handing the batch out. Without the wait a step could read
  a half-copied batch; without ``record_stream`` the allocator could hand
  the batch's memory to the side stream's next copy while the step still
  reads it. The lifecycle is the JAX package's: ``close()`` mid-iteration
  frees the thread, a close racing a producer blocked on a full queue
  returns, and a producer's error surfaces on the consumer (and keeps
  surfacing).
"""

import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch


def shard_dataset(arrays, rank: Optional[int] = None,
                  size: Optional[int] = None):
    """Slice each array to this process's shard: ``a[rank::size]``
    (the reference examples' DistributedSampler semantics: disjoint,
    near-equal shards)."""
    from . import basics
    if rank is None:
        rank = basics.rank() if basics.is_initialized() else 0
    if size is None:
        size = basics.size() if basics.is_initialized() else 1
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(a[rank::size] for a in arrays)
    return arrays[rank::size]


def pad_to_size(arrays, target: int):
    """Zero-pad each array's leading dimension up to ``target`` rows.

    Returns ``(padded, mask)`` where ``mask`` is a ``(target,)`` bool
    array marking the real rows: the pad-to-bucket primitive of
    :func:`batches(pad_remainder=True) <batches>` and of
    ``serving.batcher.BucketedForward``."""
    single = not isinstance(arrays, (list, tuple))
    arrs = [arrays] if single else list(arrays)
    n = len(arrs[0])
    if any(len(a) != n for a in arrs):
        raise ValueError("all arrays must share the first dimension")
    if n > target:
        raise ValueError(f"cannot pad {n} rows down to {target}")
    padded = []
    for a in arrs:
        a = np.asarray(a)
        if n == target:
            padded.append(a)
        else:
            width = [(0, target - n)] + [(0, 0)] * (a.ndim - 1)
            padded.append(np.pad(a, width))
    mask = np.zeros(target, dtype=bool)
    mask[:n] = True
    out = padded[0] if single else type(arrays)(padded)
    return out, mask


def batches(arrays, batch_size: int, shuffle: bool = True,
            seed: int = 0, drop_remainder: bool = True,
            pad_remainder: bool = False) -> Iterator:
    """Yield minibatch tuples from equal-length arrays. The remainder is
    dropped by default (static shapes). ``pad_remainder=True`` keeps the
    tail: every batch carries a trailing ``(batch_size,)`` bool validity
    mask (all-True for full batches), and the final ragged batch is
    zero-padded to ``batch_size``. Overrides ``drop_remainder``."""
    single = not isinstance(arrays, (list, tuple))
    arrs = [arrays] if single else list(arrays)
    n = len(arrs[0])
    if any(len(a) != n for a in arrs):
        raise ValueError("all arrays must share the first dimension")
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    if pad_remainder:
        drop_remainder = False
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for lo in range(0, stop, batch_size):
        sel = idx[lo:lo + batch_size]
        out = tuple(a[sel] for a in arrs)
        if pad_remainder:
            out, mask = pad_to_size(out, batch_size)
            yield out + (mask,)
        else:
            yield out[0] if single else out


def _map(fn, batch):
    """``fn`` over the arrays of a batch (a tuple, list or dict of arrays,
    or one array)."""
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _leaves(batch):
    if isinstance(batch, (list, tuple)):
        return [x for b in batch for x in _leaves(b)]
    if isinstance(batch, dict):
        return [x for v in batch.values() for x in _leaves(v)]
    return [batch]


def _host_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(a))


class PrefetchIterator:
    """Wraps an iterator of host batches; a daemon thread stages up to
    ``buffer_size`` batches on ``device`` ahead of the consumer (see the
    module docstring). ``device`` is the target device: None means the
    initialized world's, or the card when there is none (raising without
    one); pass ``"cpu"`` to stage CPU tensors. ``device_put=False`` hands
    the host batches through unchanged."""

    _END = object()

    def __init__(self, it: Iterable, buffer_size: int = 2, device=None,
                 device_put: bool = True):
        self._device_put = device_put
        self._device = None
        self._stream = None
        if device_put:
            from . import basics
            if device is None and basics.is_initialized():
                device = basics.device()
            self._device = basics.resolve_device(device)
            if self._device.type == "meta":
                raise ValueError("cannot prefetch to the meta device")
            if self._device.type == "cuda":
                self._stream = torch.cuda.Stream(device=self._device)
        self._src = iter(it)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, buffer_size))
        self._err: Optional[BaseException] = None
        self._finished = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, name="hvd_tpu_prefetch", daemon=True)
        self._thread.start()

    def _stage(self, batch):
        """(staged batch, event the consumer waits on or None)."""
        if not self._device_put:
            return batch, None
        if self._stream is None:          # a CPU target
            return _map(_host_tensor, batch), None
        with torch.cuda.stream(self._stream):
            staged = _map(lambda a: _host_tensor(a).pin_memory().to(
                self._device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def _put(self, item) -> bool:
        """Bounded put that aborts on close(); returns False when closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self._src:
                if not self._put(self._stage(batch)):
                    return  # closed: drop staged batches, free the thread
        except BaseException as e:  # surfaced on the consumer thread
            self._err = e
        finally:
            self._put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            # keep raising after exhaustion/error instead of blocking on a
            # queue the worker has already left
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is self._END:
            self._finished = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in _leaves(batch):
                t.record_stream(consumer)
        return batch

    def close(self):
        """Stop the worker and drop buffered batches. Call when abandoning
        the iterator mid-epoch (elastic reset, step budget); otherwise the
        worker thread and up to buffer_size staged batches stay pinned."""
        self._stop.set()
        self._finished = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self._stop.set()
        except Exception:
            pass


def prefetch_to_device(it: Iterable, buffer_size: int = 2,
                       device=None) -> PrefetchIterator:
    """Convenience constructor; see :class:`PrefetchIterator`."""
    return PrefetchIterator(it, buffer_size=buffer_size, device=device)
