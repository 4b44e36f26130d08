"""The checkpoint manager: snapshot-then-persist with a background writer
(the torch counterpart of ``horovod_tpu/checkpointing/manager.py``).

``CheckpointManager.save(step, tree, async_=True)`` does the minimum on
the training thread — copy leaves to host memory (:mod:`.snapshot`) and
enqueue — and a single background writer thread does everything
expensive: serialize shards, checksum, fsync, write the manifest, land
the ``COMMIT`` marker, and run retention GC (:mod:`.gc`). The in-flight
queue is bounded (``HVD_TPU_CHECKPOINT_MAX_INFLIGHT``): a training loop
that outruns storage *blocks in save()* instead of buffering unbounded
host copies of the model.

Failure contract (CheckFreq/Orbax-style):

* writer errors never escape the writer thread at the moment they
  happen; they surface on the **next** ``save()`` or
  ``wait_until_finished()`` — the training loop learns that persistence
  is sick at a point where it can react;
* a save that dies mid-persist leaves a *partial* step directory (no
  ``COMMIT``), which discovery skips and GC eventually sweeps — restore
  can only ever land on a fully committed step;
* ``restore`` verifies every shard's CRC32 against the manifest before
  trusting it; with ``fallback=True`` an integrity failure walks back to
  the previous committed step
  (``hvd_tpu_checkpoint_integrity_failures_total`` +
  ``hvd_tpu_checkpoint_fallbacks_total`` account for the skip).

Chaos sites: ``checkpoint.write`` (per shard file), ``checkpoint.manifest``
(manifest + COMMIT), ``checkpoint.gc`` (each GC pass). A ``crash`` kind at
the write/manifest sites kills the *writer component* mid-persist (the
PR-3 launcher-crash pattern via ``FaultPoint.fire(crash=...)``) — the
abandoned step stays partial and the writer hot-restarts for the next
item, which is exactly the drill
``HVD_TPU_FAULT_SPEC='checkpoint.write:crash:once'`` replays
deterministically.

Who writes (one process is one card here): a tree holding
``snapshot.Shard`` leaves in a world of more than one process takes the
sharded path, the JAX package's multi-host one: every process writes
the blocks it owns and its shard table, process 0 merges the tables into
the manifest and lands the COMMIT, and a synchronous save returns on
every process once the COMMIT is there. Any other tree keeps the eager
contract: process 0 writes everything, and a synchronous save ends in a
barrier. Restore needs no collective: every process reads the shared
directory and takes the blocks its target asks for.
"""

import atexit
import json
import logging
import os
import queue
import shutil
import threading
import time
import weakref
from typing import Any, List, Optional

import torch

from .. import _locks
from .. import config as _config
from .. import faults as _faults
from .. import metrics as _metrics
from ..callbacks import Callback as _CallbackBase
from . import gc as _gc
from . import layout
from . import snapshot as _snapshot
from .layout import IntegrityError

log = logging.getLogger("horovod_tpu_torch.checkpointing")

_M_SAVE_SECONDS = _metrics.histogram(
    "hvd_tpu_checkpoint_save_seconds",
    "Checkpoint save latency split by phase: 'snapshot' is the on-thread "
    "device->host copy (what an async save costs the training loop), "
    "'persist' is the background serialize+checksum+write+commit.",
    labels=("phase",))
_M_BYTES = _metrics.counter(
    "hvd_tpu_checkpoint_bytes_total",
    "Checkpoint payload bytes persisted by this process (shard files, "
    "pre-compression raw array bytes).")
_M_INFLIGHT = _metrics.gauge(
    "hvd_tpu_checkpoint_inflight",
    "Async checkpoint saves snapshotted but not yet committed (queued or "
    "being persisted). Bounded by HVD_TPU_CHECKPOINT_MAX_INFLIGHT.")
_M_GC_REMOVED = _metrics.counter(
    "hvd_tpu_checkpoint_gc_removed_total",
    "Checkpoint steps deleted by the retention GC "
    "(HVD_TPU_CHECKPOINT_KEEP / HVD_TPU_CHECKPOINT_KEEP_PERIOD).")
_M_INTEGRITY = _metrics.counter(
    "hvd_tpu_checkpoint_integrity_failures_total",
    "Checkpoint integrity verification failures: shard checksum mismatch, "
    "torn/unparseable manifest, missing shard file, uncommitted step.")
_M_FALLBACKS = _metrics.counter(
    "hvd_tpu_checkpoint_fallbacks_total",
    "restore(fallback=True) calls that skipped a corrupt/partial/missing "
    "selected step and restored an earlier completed step instead.")

#: storage-plane fault sites; error kind raises OSError (what a sick
#: filesystem looks like), crash kind kills the writer component
_FP_WRITE = _faults.FaultPoint("checkpoint.write", exc=OSError)
_FP_MANIFEST = _faults.FaultPoint("checkpoint.manifest", exc=OSError)
_FP_GC = _faults.FaultPoint("checkpoint.gc", exc=OSError)


class CheckpointWriterCrashed(RuntimeError):
    """An injected ``crash`` fault killed the background writer
    mid-persist. The step being written is abandoned (partial, never
    discoverable); the writer hot-restarts for the next item."""


def _writer_crash() -> None:
    raise CheckpointWriterCrashed(
        "checkpoint writer killed mid-persist (injected crash)")


#: live managers, for end-of-life drains (elastic reset must not re-exec
#: the process image while a committed-looking save is still in flight)
_MANAGERS: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()


def drain_all() -> None:
    """Drain every live manager's in-flight saves (best-effort). Called
    from ``on_train_end`` paths and the elastic reset, so the final
    epoch's checkpoint lands before the process image goes away."""
    for mgr in list(_MANAGERS):
        try:
            mgr.wait_until_finished()
        except Exception:   # noqa: BLE001 — draining is best-effort
            log.warning("checkpoint: error surfaced while draining %r",
                        mgr.directory, exc_info=True)


# The writer is a daemon thread (a hung filesystem must not block
# interpreter exit forever), so a script that never calls
# wait_until_finished() would silently abandon its last async saves at
# teardown — drain at exit, best-effort, before daemon threads die.
atexit.register(drain_all)

_STOP = object()


class _Pending:
    __slots__ = ("step", "snap", "force", "path", "multihost")

    def __init__(self, step: int, snap, force: bool, path: str,
                 multihost: bool):
        self.step = step
        self.snap = snap
        self.force = force
        self.path = path
        self.multihost = multihost


_live_config = _config.live_config


def _process_count() -> int:
    from .. import basics
    return basics.size() if basics.is_initialized() else 1


def _process_index() -> int:
    from .. import basics
    return basics.rank() if basics.is_initialized() else 0


class CheckpointManager:
    """Async sharded checkpointing for one checkpoint root directory.

    Thread-safety: ``save``/``wait_until_finished``/``restore`` are meant
    to be called from the training thread; the background writer is
    internal. One manager per directory — two managers GC'ing the same
    root would race.
    """

    def __init__(self, directory: str, keep: Optional[int] = None,
                 keep_period: Optional[int] = None,
                 max_inflight: Optional[int] = None):
        cfg = _live_config()
        self.directory = directory
        self.keep = int(cfg.get(_config.CHECKPOINT_KEEP)
                        if keep is None else keep)
        self.keep_period = int(cfg.get(_config.CHECKPOINT_KEEP_PERIOD)
                               if keep_period is None else keep_period)
        self.max_inflight = max(1, int(
            cfg.get(_config.CHECKPOINT_MAX_INFLIGHT)
            if max_inflight is None else max_inflight))
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.max_inflight)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = _locks.lock("checkpointing.CheckpointManager._lock")
        self._pending_steps: set = set()
        #: newest step the SDC policy confirmed clean (docs/robustness.md,
        #: SDC section); None until promote_last_good() is called
        self.last_good_step: Optional[int] = None
        _MANAGERS.add(self)

    # -- world plumbing ------------------------------------------------------

    @staticmethod
    def _is_multihost(tree: Any) -> bool:
        """A tree of Shards in a world of more than one process: every
        process writes its own blocks."""
        return _process_count() > 1 and _snapshot.is_sharded(tree)

    def _is_writer(self, multihost: bool) -> bool:
        """Sharded: every process writes its own blocks. Otherwise the
        rank-0 convention, like the reference's examples."""
        return multihost or _process_index() == 0

    def _barrier(self, multihost: bool) -> None:
        if _process_count() > 1 and not multihost:
            from ..collectives import barrier
            barrier()

    # -- error surfacing -----------------------------------------------------

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _record_error(self, err: BaseException) -> None:
        log.error("checkpoint writer failed: %s", err, exc_info=err)
        with self._lock:
            if self._error is None:     # first error wins; later ones logged
                self._error = err

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, async_: bool = True,
             force: bool = False) -> str:
        """Checkpoint ``tree`` for ``step``; returns the step path.

        ``async_=True`` (default): returns after the host snapshot; the
        write happens on the background thread and any failure surfaces
        on the next ``save()``/``wait_until_finished()``. ``async_=False``
        persists before returning (and, in eager multi-process runs,
        barriers so non-root ranks can't race past an unfinished write —
        the facade's historical contract).
        """
        self._raise_pending()
        path = layout.step_dir(self.directory, step)
        # overwrite guard covers committed AND legacy (orbax) dirs — the
        # old facade raised on an existing step too — plus steps still
        # queued for the writer (on disk the duplicate isn't visible
        # yet); only a crashed-save partial is silently overwritable
        with self._lock:
            dup_pending = step in self._pending_steps
        if not force and (dup_pending or (
                os.path.isdir(path)
                and layout.classify(path) != layout.PARTIAL)):
            raise FileExistsError(
                f"checkpoint step {step} already exists under "
                f"{self.directory!r} (pass force=True to overwrite)")
        multihost = self._is_multihost(tree)
        if not self._is_writer(multihost):
            if not async_:
                self._barrier(multihost)
            return path
        t0 = time.perf_counter()
        snap = _snapshot.snapshot_tree(tree, world_size=_process_count())
        _M_SAVE_SECONDS.labels(phase="snapshot").observe(
            time.perf_counter() - t0)
        pending = _Pending(step, snap, force, path, multihost)
        if async_:
            _M_INFLIGHT.inc()
            with self._lock:
                self._pending_steps.add(step)
            try:
                self._ensure_writer()
                self._queue.put(pending)    # blocks when full: backpressure
            except BaseException:
                _M_INFLIGHT.dec()
                with self._lock:
                    self._pending_steps.discard(step)
                raise
        else:
            # drain first: _persist (and its GC pass) must stay
            # single-threaded per manager, or a sync save's GC could
            # sweep a partial step the background writer is mid-writing
            self._queue.join()
            self._raise_pending()
            self._persist(pending)
            self._barrier(multihost)
            if multihost and _process_index() != 0:
                # multi-host sync semantics: "save returned" must mean
                # "step committed" on every process, and only process 0
                # writes the COMMIT — wait for it (no data-plane
                # collective here; the runtime may be mid-teardown)
                self._await_commit(path, step)
        return path

    def _await_commit(self, path: str, step: int) -> None:
        deadline = time.monotonic() + float(
            _live_config().get(_config.INIT_TIMEOUT_SECONDS))
        while layout.classify(path) != layout.COMMITTED:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"step {step} under {self.directory!r} was not "
                    f"committed by process 0 before the deadline")
            time.sleep(0.05)

    def wait_until_finished(self) -> None:
        """Drain every queued/in-progress save, then surface any writer
        error recorded since the last drain."""
        self._queue.join()
        self._raise_pending()

    def drain_for_preemption(self, step: Optional[int] = None,
                             tree: Any = None) -> Optional[int]:
        """Preemption-notice drain: finish every in-flight save, then —
        when the caller supplies its current ``(step, tree)`` and the
        newest committed step is older — force one final *synchronous*
        save, so the grace window is spent persisting progress instead of
        re-running it after the handoff. A save already in flight (or
        committed) for ``step`` is drained, never duplicated: the
        in-flight copy lands via ``wait_until_finished`` and the stale
        check then sees it committed. Returns the newest committed step
        (None when the directory holds none).

        Under sharded (fsdp) training this is the *shard handoff* of a
        graceful drain: the departing host persists its own parameter
        shards here, and the surviving mesh's restore plan reassembles
        them from the checkpoint by recorded global offsets — peers are
        never asked to serve shards they do not hold."""
        self.wait_until_finished()
        if step is not None and tree is not None:
            latest = self.latest_step()
            if latest is None or latest < step:
                try:
                    self.save(step, tree, async_=False)
                except FileExistsError:
                    # landed between the check and the save (another
                    # writer/process): already durable, nothing to do
                    pass
        return self.latest_step()

    def close(self) -> None:
        """Drain and stop the writer thread (managers are reusable after
        close — the next async save restarts the writer)."""
        # take the handle under the lock so close() can't race
        # _ensure_writer replacing self._thread; the blocking put/join
        # happen after the lock is released (the writer's finally block
        # needs this lock to make progress, so a blocking put here while
        # holding it could deadlock on a full queue)
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None and thread.is_alive():
            self._queue.put(_STOP)
            while True:
                thread.join(timeout=0.1)
                if not thread.is_alive():
                    break
                # a save() racing this close() may have started a fresh
                # writer that consumed our sentinel — re-send it so the
                # thread we are joining is guaranteed to see one (a
                # leftover sentinel merely stops a later writer early;
                # _ensure_writer restarts it on the next async save)
                try:
                    self._queue.put_nowait(_STOP)
                except queue.Full:
                    pass
        self._raise_pending()

    # -- background writer ---------------------------------------------------

    def _ensure_writer(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._writer_loop, daemon=True,
                    name="hvd-tpu-ckpt-writer")
                self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                self._queue.task_done()
                return
            try:
                self._persist(item)
            except BaseException as e:  # noqa: BLE001 — surfaced on next save
                # A crash fault "kills" the writer component: the step
                # stays partial (no cleanup — a real dead writer cleans
                # nothing) and the loop hot-restarts for the next item.
                self._record_error(e)
            finally:
                _M_INFLIGHT.dec()
                with self._lock:
                    self._pending_steps.discard(item.step)
                self._queue.task_done()

    def _persist(self, pending: "_Pending") -> None:
        t0 = time.perf_counter()
        path = pending.path
        snap = pending.snap
        multihost = pending.multihost
        reused_dir = os.path.exists(path)
        if reused_dir and not multihost:
            # force re-save or a stale partial from a crashed attempt;
            # multi-host writers share the dir and must not sweep it
            shutil.rmtree(path)
        shards_dir = os.path.join(path, layout.SHARDS_DIR)
        os.makedirs(shards_dir, exist_ok=True)
        if multihost:
            # Re-saving into a shared step dir: demote the step FIRST (a
            # stale COMMIT must never vouch for a mix of old and new
            # shard bytes mid-rewrite) and drop this process's stale
            # shard table so the merge can't consume a previous
            # attempt's checksums.
            for stale in (os.path.join(path, layout.COMMIT_NAME),
                          os.path.join(shards_dir,
                                       f"index.{_process_index()}.json")):
                try:
                    os.unlink(stale)
                except FileNotFoundError:
                    pass
            layout.fsync_dir(path)
        leaf_entries = []
        written = 0
        for leaf in snap.leaves:
            if leaf.local and multihost and _process_index() != 0:
                # leaves with no ownership (python objects, tensors every
                # process holds whole): the rank-0 convention wins — N
                # processes renaming possibly-different bytes onto one
                # file would race
                continue
            entry = {"index": leaf.index, "path": leaf.path,
                     "kind": leaf.kind}
            shard_entries = []
            if leaf.kind == _snapshot.OBJECT:
                fname = f"{leaf.index:05d}.obj.bin"
                shard_entries.append(
                    self._write_shard(shards_dir, fname, leaf.payload))
            else:
                entry["dtype"] = leaf.dtype
                entry["shape"] = list(leaf.shape)
                for shard in leaf.shards:
                    fname = layout.shard_filename(leaf.index, shard.starts)
                    shard_entries.append(self._write_shard(
                        shards_dir, fname, _snapshot.payload(shard.data),
                        starts=list(shard.starts),
                        shape=list(shard.data.shape)))
            written += sum(e["nbytes"] for e in shard_entries)
            entry["shards"] = shard_entries
            leaf_entries.append(entry)
        _M_BYTES.inc(written)
        if multihost:
            self._write_process_index(path, leaf_entries)
            if _process_index() != 0:
                _M_SAVE_SECONDS.labels(phase="persist").observe(
                    time.perf_counter() - t0)
                return
            leaf_entries = self._merge_process_indexes(
                path, snap, verify_bytes=reused_dir)
        _FP_MANIFEST.fire(crash=_writer_crash)
        manifest = {
            "format": layout.FORMAT,
            "step": pending.step,
            "world_size": snap.world_size,
            "process_count": _process_count(),
            "treedef": _snapshot.encode_treedef(snap.treedef),
            "leaves": leaf_entries,
        }
        crc = layout.write_manifest(path, manifest)
        layout.write_commit(path, pending.step, crc)
        _M_SAVE_SECONDS.labels(phase="persist").observe(
            time.perf_counter() - t0)
        log.info("checkpoint: committed step %d under %s (%d bytes)",
                 pending.step, self.directory, written)
        self._collect_garbage()

    def _write_shard(self, shards_dir: str, fname: str, data: bytes,
                     **extra) -> dict:
        _FP_WRITE.fire(crash=_writer_crash)
        layout.atomic_write_bytes(os.path.join(shards_dir, fname), data)
        entry = {"file": f"{layout.SHARDS_DIR}/{fname}",
                 "crc32": layout.crc32(data),
                 "nbytes": memoryview(data).nbytes}
        entry.update(extra)
        return entry

    # -- multi-host manifest merge (shared-filesystem protocol) --------------

    def _write_process_index(self, path: str, leaf_entries: List[dict]
                             ) -> None:
        """Each process publishes its shard table atomically; process 0
        assembles the manifest once every table landed — commit ordering
        without a collective (the data plane may be mid-teardown)."""
        layout.atomic_write_bytes(
            os.path.join(path, layout.SHARDS_DIR,
                         f"index.{_process_index()}.json"),
            json.dumps(leaf_entries).encode())

    def _merge_process_indexes(self, path: str, snap,
                               verify_bytes: bool = False) -> List[dict]:
        count = _process_count()
        deadline = time.monotonic() + float(
            _live_config().get(_config.INIT_TIMEOUT_SECONDS))
        merged = {leaf.index: {"index": leaf.index, "path": leaf.path,
                               "kind": leaf.kind, "shards": []}
                  for leaf in snap.leaves}
        for leaf in snap.leaves:
            if leaf.kind == _snapshot.ARRAY:
                merged[leaf.index]["dtype"] = leaf.dtype
                merged[leaf.index]["shape"] = list(leaf.shape)
        for proc in range(count):
            ipath = os.path.join(path, layout.SHARDS_DIR,
                                 f"index.{proc}.json")
            for entry in self._fresh_index(path, ipath, deadline,
                                           verify_bytes):
                merged[entry["index"]]["shards"].extend(entry["shards"])
        for entry in merged.values():
            entry["shards"].sort(key=lambda s: s["file"])
        return [merged[i] for i in sorted(merged)]

    def _fresh_index(self, path: str, ipath: str, deadline: float,
                     verify_bytes: bool) -> List[dict]:
        """Wait for a peer's shard table. Peers rename every shard into
        place *before* atomically writing their index, so in a fresh
        step directory index-present implies shards-complete and the
        table is trusted as-is. Only a *reused* directory (force
        re-save / retry after a crashed attempt) can hold a stale index
        from the previous attempt — there, ``verify_bytes`` checks every
        referenced shard's checksum against the bytes on disk and
        re-polls until the fresh table lands, so the manifest can never
        be committed against a mix of attempts (worth the extra
        read-back I/O, which the common path never pays)."""
        while True:
            entries = None
            if os.path.exists(ipath):
                try:
                    with open(ipath, "rb") as f:
                        entries = json.loads(f.read())
                except (OSError, ValueError):
                    entries = None
            if entries is not None and (not verify_bytes or all(
                    self._shard_on_disk_matches(path, s)
                    for e in entries for s in e["shards"])):
                return entries
            if time.monotonic() > deadline:
                raise IntegrityError(
                    f"no consistent shard index at {ipath!r} before the "
                    f"merge deadline")
            time.sleep(0.05)

    @staticmethod
    def _shard_on_disk_matches(path: str, shard: dict) -> bool:
        try:
            with open(os.path.join(path, shard["file"]), "rb") as f:
                data = f.read()
        except OSError:
            return False
        return layout.crc32(data) == shard["crc32"]

    # -- retention GC --------------------------------------------------------

    def _collect_garbage(self) -> None:
        if self.keep <= 0 and self.keep_period <= 0:
            return
        if _process_index() != 0:
            return      # one collector per job
        try:
            removed = _gc.collect(self.directory, self.keep,
                                  self.keep_period, fault_point=_FP_GC)
        except Exception:   # noqa: BLE001 — GC must not poison saves
            log.warning("checkpoint gc pass failed under %s",
                        self.directory, exc_info=True)
            return
        if removed:
            _M_GC_REMOVED.inc(len(removed))

    # -- restore -------------------------------------------------------------

    def restore(self, step: Optional[int] = None, target: Any = None,
                sharding=None, fallback: bool = False) -> Any:
        """Restore the tree at ``step`` (default: latest committed); the
        JAX package's signature.

        ``target`` gives the structure, and where each leaf goes: a
        tensor target gets the whole array on its device, a
        ``snapshot.Shard`` target its block of the global array (shards
        are reassembled by their recorded global offsets, so the saving
        and restoring meshes are independent: the elastic
        resume-onto-another-mesh case). Without a target, leaves are
        whole CPU tensors. ``sharding`` keeps the JAX package's place in
        the signature, so a call written for it never binds a sharding to
        ``fallback``; a JAX sharding has no object here, and any value but
        None raises ValueError, naming the route that places blocks: a
        target whose leaves are ``Shard`` objects. ``fallback=True`` walks
        back past corrupt/partial/missing steps (counted); without it the
        first failure surfaces.
        """
        if sharding is not None:
            raise ValueError(
                f"restore(sharding={sharding!r}): this package places "
                f"restored leaves by target=; to restore blocks onto a "
                f"mesh, pass a target whose leaves are checkpointing.Shard "
                f"(parallel.train_state_tree builds one)")
        if step is None:
            candidates = layout.completed_steps(self.directory)
            if not candidates:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory!r}")
        elif fallback:
            candidates = [s for s in layout.completed_steps(self.directory)
                          if s <= step]
            if not candidates:
                raise FileNotFoundError(
                    f"no checkpoints at or before step {step} under "
                    f"{self.directory!r}")
        else:
            # The requested step must at least exist on disk; the shard
            # reader would otherwise surface an internal error for what
            # is a plain usage mistake.
            if not os.path.isdir(layout.step_dir(self.directory, step)):
                raise FileNotFoundError(
                    f"no checkpoint for step {step} under "
                    f"{self.directory!r}")
            candidates = [step]
        if not fallback:
            candidates = candidates[:1]
        fell_back = step is not None and fallback and candidates[0] != step
        if fell_back:
            log.warning(
                "checkpoint: step %d does not exist under %s; falling back "
                "to step %d", step, self.directory, candidates[0])
            if layout.classify(layout.step_dir(self.directory, step)) \
                    == layout.PARTIAL:
                # the requested step is a crashed save (no COMMIT) —
                # that's an integrity event, not a never-written step
                _M_INTEGRITY.inc()
        for i, cand in enumerate(candidates):
            try:
                tree = self._restore_step(cand, target)
            except Exception as e:  # noqa: BLE001 — any failure walks back
                if isinstance(e, IntegrityError):
                    _M_INTEGRITY.inc()
                if i + 1 >= len(candidates):
                    raise
                log.warning(
                    "checkpoint: step %d under %s is corrupt or partial "
                    "(%s); falling back to step %d", cand, self.directory,
                    e, candidates[i + 1])
                if isinstance(e, IntegrityError):
                    # checksum-proven corruption: demote the step so
                    # discovery/GC stop counting it — otherwise a resumed
                    # run's fresh commits rank below the stale corrupt
                    # steps and retention GC deletes new progress while
                    # protecting garbage
                    self._demote(cand)
                fell_back = True
                continue
            if fell_back:
                _M_FALLBACKS.inc()
            if fallback:
                # One summary line on EVERY fallback restore that did not
                # land on the newest step directory — including the quiet
                # case where newer steps are PARTIAL (crashed saves) and
                # so never even entered `candidates`. Operators must be
                # able to see from the log alone that progress was lost.
                skipped = [s for s in layout.all_step_dirs(self.directory)
                           if s > cand]
                if skipped:
                    log.warning(
                        "checkpoint: restored step %d from %s; skipped "
                        "newer step(s) %s (partial or corrupt)", cand,
                        self.directory,
                        ", ".join(str(s) for s in skipped))
            return tree

    # -- last-good (SDC rollback target) -------------------------------------

    def promote_last_good(self, step: int) -> None:
        """Mark ``step`` as the newest checkpoint that survived the SDC
        guard for HVD_TPU_SDC_CONFIRM_STEPS subsequent steps — the only
        step ``restore_last_good`` will consider newest-first from."""
        self.last_good_step = int(step)

    def restore_last_good(self, target: Any = None, sharding=None) -> Any:
        """Restore the last-good step (``restore`` with fallback past
        anything that rotted on disk since the promotion). Raises
        RuntimeError when nothing was ever promoted — rollback without a
        confirmed-good target would just reload suspect state."""
        if self.last_good_step is None:
            raise RuntimeError(
                "no last-good checkpoint promoted yet; cannot roll back "
                f"under {self.directory!r}")
        return self.restore(step=self.last_good_step, target=target,
                            sharding=sharding, fallback=True)

    def _demote(self, step: int) -> None:
        """Atomically un-commit a corrupt step (idempotent across
        processes); the partial dir left behind is swept by GC."""
        path = layout.step_dir(self.directory, step)
        try:
            os.unlink(os.path.join(path, layout.COMMIT_NAME))
            layout.fsync_dir(path)
            log.warning("checkpoint: demoted corrupt step %d under %s "
                        "(COMMIT removed)", step, self.directory)
        except OSError:
            pass        # legacy dir, already demoted, or read-only fs

    def _restore_step(self, step: int, target: Any = None) -> Any:
        path = layout.step_dir(self.directory, step)
        state = layout.classify(path)
        if state == layout.PARTIAL:
            raise IntegrityError(
                f"step {step} under {self.directory!r} was never committed "
                f"(crashed save)")
        if state == layout.LEGACY:
            raise IntegrityError(
                f"step {step} under {self.directory!r} is a legacy (orbax) "
                f"checkpoint, which only the JAX package restores")
        manifest = layout.read_manifest(path)

        def read_shard(entry: dict) -> bytes:
            fpath = os.path.join(path, entry["file"])
            try:
                with open(fpath, "rb") as f:
                    data = f.read()
            except FileNotFoundError as e:
                raise IntegrityError(
                    f"manifest references missing shard {entry['file']!r} "
                    f"under {path!r}") from e
            if layout.crc32(data) != entry["crc32"]:
                raise IntegrityError(
                    f"checksum mismatch for shard {entry['file']!r} under "
                    f"{path!r}")
            return data

        leaves = []
        for leaf_m in manifest["leaves"]:
            if leaf_m["kind"] == _snapshot.OBJECT:
                leaves.append(_snapshot.assemble_object(
                    read_shard(leaf_m["shards"][0])))
            else:
                leaves.append(_snapshot.assemble_array(leaf_m, read_shard))
        if target is not None:
            # honor the facade's "target provides structure" contract:
            # rebuild with the caller's structure (also how a checkpoint
            # of the JAX package, whose treedef is a pickled PyTreeDef,
            # restores here)
            t_flat, t_def = _snapshot.tree_flatten(target)
            if len(t_flat) != len(leaves):
                raise IntegrityError(
                    f"target structure has {len(t_flat)} leaves, "
                    f"checkpoint step {step} has {len(leaves)}")
            return _snapshot.tree_unflatten(t_def, [
                _place(leaf, want) for leaf, (_, want) in
                zip(leaves, t_flat)])
        try:
            treedef = _snapshot.decode_treedef(manifest["treedef"])
        except ValueError:
            return _snapshot.tree_from_paths(
                [m["path"] for m in manifest["leaves"]], leaves)
        return _snapshot.tree_unflatten(treedef, leaves)

    # -- discovery -----------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        return layout.latest_step(self.directory)

    def all_steps(self) -> List[int]:
        """Committed/restorable steps, newest first."""
        return layout.completed_steps(self.directory)


def _place(leaf: Any, want: Any) -> Any:
    """A restored leaf where the target's leaf lives: a Shard target gets
    its block (on its device), a tensor target the whole array on its
    device; anything else the restored value as it is."""
    if isinstance(want, _snapshot.Shard) and isinstance(leaf, torch.Tensor):
        if tuple(leaf.shape) != want.shape:
            raise IntegrityError(
                f"target shard of a {want.shape} array, checkpoint leaf "
                f"is {tuple(leaf.shape)}")
        block = leaf[want.index()].to(want.data.device)
        return _snapshot.Shard(block, want.shape, want.starts, want.owner)
    if isinstance(want, torch.Tensor) and isinstance(leaf, torch.Tensor):
        return leaf.to(want.device)
    return leaf


class CheckpointCallback(_CallbackBase):
    """Save ``run.params`` every ``epochs_per_save`` epochs through a
    :class:`CheckpointManager` (rank-0 convention of the reference
    examples; a tree of Shards is written by every process).

    ``async_=True`` overlaps persistence with the next epoch; the
    in-flight saves are drained in ``on_train_end`` (and by the elastic
    reset via :func:`drain_all`), so the final epoch's checkpoint is
    never lost to process teardown. Each save records its step in
    ``logs["checkpoint_step"]``.
    """

    def __init__(self, directory: str, epochs_per_save: int = 1,
                 force: bool = True, async_: bool = False,
                 keep: Optional[int] = None,
                 keep_period: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 manager: Optional[CheckpointManager] = None):
        self.directory = directory
        self.epochs_per_save = epochs_per_save
        # force=True: an elastic resume re-saves epochs that already exist
        # on disk; refusing to overwrite would kill the resumed run
        self.force = force
        self.async_ = async_
        self.manager = manager or CheckpointManager(
            directory, keep=keep, keep_period=keep_period,
            max_inflight=max_inflight)
        self._last_saved: Optional[int] = None

    def on_epoch_end(self, epoch, logs=None):
        if (epoch + 1) % self.epochs_per_save == 0:
            self.manager.save(epoch, self.run.params, async_=self.async_,
                              force=self.force)
            self._last_saved = epoch
            if logs is not None:
                logs["checkpoint_step"] = epoch

    def on_train_end(self, logs=None):
        self.manager.wait_until_finished()
        if logs is not None and self._last_saved is not None:
            logs["checkpoint_step"] = self._last_saved
