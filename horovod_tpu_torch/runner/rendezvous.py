"""HTTP KV rendezvous store.

Reference: horovod/runner/http/http_server.py (threaded KV
store serving PUT/GET ``/scope/key``; RendezvousServer publishing slot info;
ElasticRendezvousHandler serving live ``rank_and_size`` lookups;
KVStoreServer carrying run()-function results) and the worker-side client in
common/gloo/http_store.{h,cc} (set/get/wait over HTTP).

A copy of ``horovod_tpu/runner/rendezvous.py``, on the same wire (plain
HTTP, value = raw bytes, the same epoch header), so either package's
client talks to either package's server: the launcher owns the store;
workers and the elastic driver read/write scoped keys. The torch.distributed
TCP store rank 0 hosts is the *data-plane* rendezvous; this store is the
*host-plane* side channel.

**Crash survivability.** The reference keeps all rendezvous state in the
launcher's memory, making the coordinator a single point of failure. Here the
store optionally journals every put/delete to a write-ahead log under
``HVD_TPU_RENDEZVOUS_DIR`` (fsync'd appends, periodic snapshot compaction)
and ``restore()``s snapshot+journal on start, so a restarted coordinator
comes back with the slot plan, worker addresses, blacklist and elastic state
intact. Every HTTP response carries a monotonically-bumped *coordinator
epoch* header; clients that observe a bump know the server restarted and
re-register their scoped keys instead of wedging on stale state
(docs/robustness.md has the walkthrough).
"""

import base64
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple
from urllib.request import Request, urlopen
from urllib.error import HTTPError, URLError

from .. import _http
from .. import _locks
from .. import config as _config
from .. import faults as _faults
from .. import metrics as _metrics
from .. import retry as _retry

log = logging.getLogger("horovod_tpu_torch.runner")

#: every response is stamped with the server's epoch so one round-trip is
#: enough for a worker to learn the coordinator restarted
EPOCH_HEADER = "X-HVD-TPU-Coordinator-Epoch"

_JOURNAL_NAME = "journal.log"
_SNAPSHOT_NAME = "snapshot.json"
_EPOCH_NAME = "epoch"
_PORT_NAME = "port"

#: Coordinator liveness as metrics: the epoch gauge moving is the operator
#: signal that the host plane restarted; the replay counter says how much
#: state it came back with.
_M_EPOCH = _metrics.gauge(
    "hvd_tpu_coordinator_epoch",
    "Monotonic epoch of the rendezvous coordinator; bumps on every "
    "(re)start of the KV store, including journal hot-restarts.")
_M_REPLAYED = _metrics.counter(
    "hvd_tpu_journal_replay_entries_total",
    "KV entries replayed from the rendezvous snapshot+journal on "
    "coordinator (re)start.")


class _KVHandler(_http.QuietHandler):
    def _split(self) -> Tuple[str, str]:
        parts = self.path.strip("/").split("/", 1)
        scope = parts[0] if parts else ""
        key = parts[1] if len(parts) > 1 else ""
        return scope, key

    def _gate(self) -> bool:
        """Run the server-side fault gate. Returns True when the request
        may proceed; False when it was consumed by an injected fault (a
        503 for ``error`` faults, a dropped connection for ``crash``)."""
        verdict = self.server.owner._fault_gate()
        if verdict is None:
            return True
        if verdict == "crash":
            # A crashed process sends nothing: drop the connection so the
            # client sees the same truncated exchange a real coordinator
            # death produces (transient -> retried).
            self.close_connection = True
            return False
        self._respond(503)
        return False

    def _respond(self, code: int, body: Optional[bytes] = None) -> None:
        try:
            self.send_response(code)
            self.send_header(EPOCH_HEADER,
                             str(self.server.owner.epoch))
            self.send_header("Content-Length",
                             str(len(body)) if body else "0")
            self.end_headers()
            if body:
                self.wfile.write(body)
        except OSError:
            # connection torn down mid-response (e.g. a simulated crash
            # raced this handler) — the client retries, nothing to do
            self.close_connection = True

    def do_PUT(self):
        if not self._gate():
            return
        scope, key = self._split()
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        self.server.store_put(scope, key, value)
        self._respond(200)

    def do_GET(self):
        if not self._gate():
            return
        scope, key = self._split()
        value = self.server.store_get(scope, key)
        if value is None:
            self._respond(404)
            return
        self._respond(200, value)

    def do_DELETE(self):
        if not self._gate():
            return
        scope, key = self._split()
        self.server.store_delete(scope, key)
        self._respond(200)


class _KVServer(_http.AsyncHTTPServer):
    """Shared quiet/async/selector server base (_http.py); the KV store
    owns its own bind/restart lifecycle, so only the server class is
    reused here, not start_server()."""


#: launcher-side fault site: an ``error`` makes the store answer 503 (a
#: sick-but-alive coordinator), a ``crash`` simulates the coordinator
#: process dying — the store drops its socket AND its memory and the
#: supervisor hot-restarts it from the journal.
_FP_SERVER = _faults.FaultPoint("rendezvous.server",
                                exc=_faults.InjectedTransientFault)

#: seconds the supervisor lets a simulated crash "smolder" before the
#: hot-restart — long enough that clients observe the dead socket
_RESTART_DELAY = 0.2


class KVStoreServer:
    """Launcher-side threaded KV store (reference http_server.py:42-170).

    ``handlers``: optional dict mapping a scope name to a callable
    ``(key) -> Optional[bytes]`` consulted on GET before the static store —
    this is how the elastic driver serves live ``rank_and_size`` lookups
    (reference runner/elastic/rendezvous.py:29-60).

    ``journal_dir`` (default: ``HVD_TPU_RENDEZVOUS_DIR``): when set, every
    put/delete is appended (fsync'd) to a write-ahead journal and
    ``start()`` restores snapshot+journal before serving, bumping the
    persistent coordinator epoch. An injected ``rendezvous.server:crash``
    fault exercises exactly this path in-process: the store dies, the
    supervisor rebinds the same port and restores purely from disk.
    """

    def __init__(self, port: int = 0, verbose: bool = False,
                 handlers: Optional[Dict[str, Callable]] = None,
                 journal_dir: Optional[str] = None,
                 snapshot_every: Optional[int] = None):
        self._data: Dict[Tuple[str, str], bytes] = {}
        self._lock = _locks.lock("rendezvous.KVStoreServer._lock")
        self._requested_port = port
        self._verbose = verbose
        self._httpd: Optional[_KVServer] = None
        self._handlers = dict(handlers or {})
        self._put_handlers: Dict[str, Callable] = {}
        self._thread: Optional[threading.Thread] = None
        #: scopes excluded from the journal: high-frequency liveness data
        #: (heartbeats) whose value is precisely that it does NOT survive
        #: a restart — journaling it would fsync per beat and resurrect
        #: stale liveness after recovery. The collective schedule ledger
        #: (scope 'schedule', _schedule.py) is ephemeral for the same
        #: reason: per-generation sequence state published at up to
        #: 5 Hz/rank, and replaying a dead generation's ledgers after a
        #: coordinator restart would fabricate divergence diagnostics.
        self.ephemeral_scopes: set = {"schedule"}

        cfg = _config.Config()
        if journal_dir is None:
            journal_dir = cfg.get(_config.RENDEZVOUS_DIR) or None
        self._journal_dir = journal_dir
        self._snapshot_every = (
            snapshot_every if snapshot_every is not None
            else cfg.get(_config.RENDEZVOUS_SNAPSHOT_EVERY))
        self._journal_file = None
        self._appends = 0
        self._epoch = 0
        self._replayed = 0
        self._last_port: Optional[int] = None

        self._stop_lock = _locks.lock("rendezvous.KVStoreServer._stop_lock")
        self._stopping = False
        self._crashed = threading.Event()
        self._supervisor: Optional[threading.Thread] = None

    # -- server lifecycle ---------------------------------------------------
    @property
    def port(self) -> int:
        httpd = self._httpd
        if httpd is not None:
            return httpd.server_address[1]
        if self._last_port is not None:
            # after stop() (or mid hot-restart) the last bound port stays
            # queryable — the hot-restart path rebinds it, and launcher
            # teardown code can still report where the store lived
            return self._last_port
        raise RuntimeError("KVStoreServer not started")

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def replayed_entries(self) -> int:
        """Entries restored from snapshot+journal at the last (re)start."""
        return self._replayed

    def start(self) -> int:
        # Socket is bound here, not in __init__, so constructing a server is
        # side-effect free and a failed run can retry the same fixed port.
        with self._stop_lock:
            # under the stop lock: a start() racing a concurrent stop()
            # must not un-set the flag/wake-event between stop()'s two
            # steps, or the supervisor would miss its exit signal
            self._stopping = False
            self._crashed.clear()   # stop() sets it to wake the supervisor
        self._restore_and_bump_epoch()
        port = self._requested_port
        persisted = self._persisted_port() if port == 0 else None
        if persisted:
            # A journal dir implies restart-in-place: workers froze this
            # incarnation's addr:port at spawn, so a restarted launcher
            # must come back where they are looking.
            try:
                self._bind(persisted)
            except OSError:
                log.warning(
                    "rendezvous: could not rebind persisted port %d; "
                    "binding an ephemeral port — workers of the previous "
                    "incarnation will not reach this store", persisted)
                self._bind(0)
        else:
            self._bind(port)
        if self._supervisor is None or not self._supervisor.is_alive():
            self._supervisor = threading.Thread(
                target=self._supervise, name="hvd-kvstore-supervisor",
                daemon=True)
            self._supervisor.start()
        return self.port

    def stop(self):
        # Idempotent under concurrent callers: exactly one caller tears the
        # server down; the rest observe the already-cleared handle.
        with self._stop_lock:
            if self._stopping and self._httpd is None:
                return
            self._stopping = True
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        self._crashed.set()   # wake the supervisor so it can exit
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread:
            thread.join(timeout=5)
        with self._lock:
            self._close_journal_locked()
        sup = self._supervisor
        if sup is not None and sup is not threading.current_thread():
            sup.join(timeout=5)

    def add_handler(self, scope: str, fn: Callable):
        with self._lock:
            self._handlers[scope] = fn

    def add_put_handler(self, scope: str, fn: Callable):
        """Register ``fn(key, value)`` observing PUTs to ``scope`` — how the
        elastic driver learns worker notification addresses (reference
        runner/elastic/rendezvous.py:46-54 _put_worker_addresses)."""
        with self._lock:
            self._put_handlers[scope] = fn

    # -- durability ---------------------------------------------------------
    def _paths(self):
        d = self._journal_dir
        return (os.path.join(d, _JOURNAL_NAME),
                os.path.join(d, _SNAPSHOT_NAME),
                os.path.join(d, _EPOCH_NAME))

    def _persisted_port(self) -> Optional[int]:
        """The port the previous incarnation served on, persisted next to
        the journal so a restarted launcher rebinds where workers look."""
        if not self._journal_dir:
            return None
        try:
            with open(os.path.join(self._journal_dir, _PORT_NAME),
                      encoding="utf-8") as f:
                return int(f.read().strip() or 0) or None
        except (FileNotFoundError, ValueError, OSError):
            return None

    def _restore_and_bump_epoch(self) -> None:
        """Rebuild the store from snapshot+journal (if journaling) and bump
        the persistent coordinator epoch. Memory is cleared first: a
        hot-restart must prove the journal's completeness, not paper over
        gaps with surviving in-process state."""
        with self._lock:
            self._data.clear()
            self._replayed = 0
            persisted_epoch = self._epoch
            if self._journal_dir:
                os.makedirs(self._journal_dir, exist_ok=True)
                journal_path, snapshot_path, epoch_path = self._paths()
                try:
                    with open(epoch_path, encoding="utf-8") as f:
                        persisted_epoch = max(persisted_epoch,
                                              int(f.read().strip() or 0))
                except (FileNotFoundError, ValueError):
                    pass
                self._replayed += self._load_snapshot_locked(snapshot_path)
                self._replayed += self._replay_journal_locked(journal_path)
            self._epoch = persisted_epoch + 1
            if self._journal_dir:
                self._write_small_file(epoch_path, str(self._epoch))
                # reopen the journal; compact immediately when we replayed
                # anything so replay time stays bounded across restarts
                self._close_journal_locked()
                if self._replayed:
                    self._write_snapshot_locked()
                self._journal_file = open(journal_path, "a",
                                          encoding="utf-8")
        _M_EPOCH.set(self._epoch)
        if self._replayed:
            _M_REPLAYED.inc(self._replayed)
            log.warning(
                "rendezvous: restored %d KV entr%s from %s (coordinator "
                "epoch now %d)", self._replayed,
                "y" if self._replayed == 1 else "ies",
                self._journal_dir, self._epoch)

    def _load_snapshot_locked(self, path: str) -> int:
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except FileNotFoundError:
            return 0
        except (json.JSONDecodeError, OSError):
            log.warning("rendezvous: unreadable snapshot %s; relying on "
                        "the journal alone", path, exc_info=True)
            return 0
        count = 0
        for scope, key, v64 in doc.get("data", ()):
            self._data[(scope, key)] = base64.b64decode(v64)
            count += 1
        return count

    def _replay_journal_locked(self, path: str) -> int:
        count = 0
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        # torn final append (crash mid-write): everything
                        # before it is intact, everything after is gone
                        log.warning("rendezvous: journal %s ends in a torn "
                                    "record; stopping replay", path)
                        break
                    if rec.get("op") == "put":
                        self._data[(rec["scope"], rec["key"])] = \
                            base64.b64decode(rec["value"])
                    elif rec.get("op") == "delete":
                        self._data.pop((rec["scope"], rec["key"]), None)
                    count += 1
        except FileNotFoundError:
            return 0
        return count

    @staticmethod
    def _write_small_file(path: str, content: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # fsync the DIRECTORY so the rename is durable before anything
        # that depends on it (journal truncation after a snapshot): a
        # host crash must never durably truncate the journal while the
        # snapshot's directory entry is still in flight
        try:
            dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass   # non-POSIX/odd filesystems: keep best-effort semantics

    def _write_snapshot_locked(self) -> None:
        journal_path, snapshot_path, _ = self._paths()
        doc = {"epoch": self._epoch,
               "data": [[s, k, base64.b64encode(v).decode("ascii")]
                        for (s, k), v in sorted(self._data.items())
                        if s not in self.ephemeral_scopes]}
        self._write_small_file(snapshot_path, json.dumps(doc))
        # the snapshot now owns everything the journal said: truncate it
        was_open = self._journal_file is not None
        self._close_journal_locked()
        with open(journal_path, "w", encoding="utf-8") as f:
            f.flush()
            os.fsync(f.fileno())
        if was_open:
            self._journal_file = open(journal_path, "a", encoding="utf-8")
        self._appends = 0

    def _journal_append_locked(self, op: str, scope: str, key: str,
                               value: Optional[bytes]) -> None:
        if self._journal_file is None:
            return
        rec = {"op": op, "scope": scope, "key": key}
        if value is not None:
            rec["value"] = base64.b64encode(value).decode("ascii")
        try:
            self._journal_file.write(json.dumps(rec) + "\n")
            self._journal_file.flush()
            os.fsync(self._journal_file.fileno())
        except OSError:
            # durability is best-effort once the dir goes bad (full disk,
            # unmounted shared storage); serving must not stop
            log.warning("rendezvous: journal append failed; store stays "
                        "serving without durability", exc_info=True)
            self._close_journal_locked()
            return
        self._appends += 1
        if self._snapshot_every and self._appends >= self._snapshot_every:
            try:
                self._write_snapshot_locked()
            except OSError:
                log.warning("rendezvous: snapshot compaction failed",
                            exc_info=True)

    def _close_journal_locked(self) -> None:
        if self._journal_file is not None:
            try:
                self._journal_file.close()
            except OSError:
                pass
            self._journal_file = None

    # -- crash simulation + supervision -------------------------------------
    def _fault_gate(self) -> Optional[str]:
        """Per-request server fault site. None = serve normally; "error" =
        answer 503; "crash" = drop the connection (store is dying)."""
        if self._crashed.is_set():
            return "crash"   # late handler racing the simulated death
        try:
            _FP_SERVER.fire(crash=self._simulate_crash)
        except Exception:
            return "error"
        return "crash" if self._crashed.is_set() else None

    def _simulate_crash(self) -> None:
        """What a ``rendezvous.server:crash`` fault does: the KV store dies
        exactly as hard as a killed coordinator — socket gone, memory gone,
        journal file abandoned — and the supervisor hot-restarts it from
        disk. Runs on a handler thread."""
        with self._stop_lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
            if httpd is None:
                return   # concurrent crash already took it down
        log.warning("rendezvous: injected coordinator crash — KV store "
                    "dying; supervisor will hot-restart from %s",
                    self._journal_dir or "an empty store")
        with self._lock:
            self._close_journal_locked()
            self._data.clear()
        httpd.shutdown()
        httpd.server_close()
        self._crashed.set()

    def _supervise(self) -> None:
        while True:
            self._crashed.wait()
            if self._stopping:
                return
            time.sleep(_RESTART_DELAY)
            if self._stopping:
                return
            try:
                self._restore_and_bump_epoch()
                self._bind(self._last_port or self._requested_port)
            except Exception:
                log.exception("rendezvous: hot-restart failed; retrying")
                time.sleep(1.0)
                continue
            with self._stop_lock:
                if not self._stopping:
                    self._crashed.clear()
                    stopped = False
                else:
                    # stop() raced the restart: _bind already discarded
                    # the new httpd; clearing the flag here would erase
                    # stop()'s wake-up and wedge this thread in wait()
                    stopped = True
            if stopped:
                with self._lock:
                    self._close_journal_locked()
                return
            log.warning("rendezvous: hot-restarted KV store on port %d "
                        "(epoch %d, %d entries restored)", self.port,
                        self._epoch, self._replayed)

    def _bind(self, port: int) -> None:
        last_err = None
        for _ in range(20):
            try:
                httpd = _KVServer(("0.0.0.0", port), _KVHandler)
                break
            except OSError as e:
                # the just-died listener can linger briefly; the restarted
                # store must come back on the SAME port workers know
                last_err = e
                time.sleep(0.1)
        else:
            raise last_err
        httpd.verbose = self._verbose
        httpd.owner = self
        httpd.store_put = self._put
        httpd.store_get = self._get
        httpd.store_delete = self._delete
        with self._stop_lock:
            if self._stopping:
                httpd.server_close()
                return
            self._httpd = httpd
            self._last_port = httpd.server_address[1]
            if self._journal_dir:
                try:
                    self._write_small_file(
                        os.path.join(self._journal_dir, _PORT_NAME),
                        str(self._last_port))
                except OSError:
                    log.warning("rendezvous: could not persist bound port",
                                exc_info=True)
            self._thread = threading.Thread(
                # tight poll so shutdown() (stop, crash simulation, tests)
                # costs ~50ms instead of serve_forever's default 0.5s
                target=lambda: httpd.serve_forever(poll_interval=0.05),
                name="hvd-kvstore", daemon=True)
            self._thread.start()

    # -- store --------------------------------------------------------------
    def _put(self, scope, key, value):
        with self._lock:
            self._data[(scope, key)] = value
            if scope not in self.ephemeral_scopes:
                self._journal_append_locked("put", scope, key, value)
            handler = self._put_handlers.get(scope)
        if handler is not None:
            try:
                handler(key, value)
            except Exception:
                # The value is already stored; an observer failure (e.g.
                # driver mid-shutdown) must not fail the worker's PUT.
                log.exception("put handler for scope %r failed", scope)

    def _get(self, scope, key):
        with self._lock:
            handler = self._handlers.get(scope)
        if handler is not None:
            out = handler(key)
            if out is not None:
                return out
        with self._lock:
            return self._data.get((scope, key))

    def _delete(self, scope, key):
        with self._lock:
            self._data.pop((scope, key), None)
            if scope not in self.ephemeral_scopes:
                self._journal_append_locked("delete", scope, key, None)

    # convenience for in-process use (launcher side)
    def put(self, scope: str, key: str, value: bytes):
        self._put(scope, key, value)

    def get(self, scope: str, key: str) -> Optional[bytes]:
        return self._get(scope, key)

    def delete(self, scope: str, key: str):
        self._delete(scope, key)

    def items(self, scope: str) -> Dict[str, bytes]:
        """Static entries under ``scope`` — how a restarted driver re-seeds
        its worker registry and blacklist from the journal-restored store."""
        with self._lock:
            return {k: v for (s, k), v in self._data.items() if s == scope}


class RendezvousServer(KVStoreServer):
    """KV store that additionally publishes the slot plan
    (reference http_server.py:175-242 RendezvousServer.init)."""

    def init(self, slot_infos) -> int:
        """Publish per-slot rank info under the ``rank_and_size`` scope keyed
        by ``hostname:local_rank`` (the lookup the reference's elastic workers
        do, gloo/gloo_context.cc:157-170)."""
        for s in slot_infos:
            payload = (f"{s.rank},{s.size},{s.local_rank},{s.local_size},"
                       f"{s.cross_rank},{s.cross_size}").encode()
            self.put("rank_and_size", f"{s.hostname}:{s.local_rank}", payload)
        return self.port


#: Fault points are module-level so every client in the process shares one
#: deterministic injection schedule per site (the point a chaos spec like
#: ``rendezvous.get:error:rate=0.3`` addresses). A rendezvous fault looks
#: like what it simulates: a transient socket error.
_FP_PUT = _faults.FaultPoint("rendezvous.put",
                             exc=_faults.InjectedTransientFault)
_FP_GET = _faults.FaultPoint("rendezvous.get",
                             exc=_faults.InjectedTransientFault)
_FP_DELETE = _faults.FaultPoint("rendezvous.delete",
                                exc=_faults.InjectedTransientFault)


class KVStoreClient:
    """Worker-side client (reference common/gloo/http_store.h:34-75:
    set / get / wait semantics over HTTP).

    Every op runs under the shared retry policy (retry.py): the KV store
    is the first hop of every elastic recovery, so a single congested-
    coordinator blip must be a backoff, not a dead rendezvous. 404s stay
    a non-error (``get`` returns None) and are never retried.

    Every response carries the coordinator epoch; the client tracks the
    highest epoch it has seen and invokes ``on_epoch_bump(old, new)``
    when it grows — the hook workers use to re-register scoped keys
    (notification addresses, heartbeats) after a coordinator restart
    instead of wedging on state the old incarnation lost.
    """

    def __init__(self, addr: str, port: int, timeout: float = 30.0,
                 retry: Optional[_retry.RetryPolicy] = None,
                 on_epoch_bump: Optional[Callable[[int, int], None]] = None):
        self._base = f"http://{addr}:{port}"
        self._timeout = timeout
        self._retry = retry or _retry.RetryPolicy.from_config()
        self.on_epoch_bump = on_epoch_bump
        self._epoch_lock = _locks.lock("rendezvous.KVStoreClient._epoch_lock")
        self._epoch_seen = 0
        self._in_bump = threading.local()

    @property
    def epoch_seen(self) -> int:
        return self._epoch_seen

    def _observe_epoch(self, headers) -> None:
        raw = headers.get(EPOCH_HEADER) if headers is not None else None
        if raw is None:
            return
        try:
            epoch = int(raw)
        except ValueError:
            return
        with self._epoch_lock:
            prev = self._epoch_seen
            if epoch <= prev:
                return
            self._epoch_seen = epoch
        cb = self.on_epoch_bump
        # prev == 0 is the first contact, not a restart; and a callback
        # that itself uses this client must not recurse into itself
        if cb is None or prev == 0 or getattr(self._in_bump, "on", False):
            return
        self._in_bump.on = True
        try:
            cb(prev, epoch)
        except Exception:
            log.warning("rendezvous: epoch-bump callback failed; will "
                        "retry on the next response", exc_info=True)
            # roll the view back so the NEXT op re-fires the callback — a
            # failed re-registration must not be silently final (the
            # worker would look alive via heartbeats yet be unreachable
            # for notifications)
            with self._epoch_lock:
                if self._epoch_seen == epoch:
                    self._epoch_seen = prev
        finally:
            self._in_bump.on = False

    def put(self, scope: str, key: str, value: bytes):
        def attempt():
            _FP_PUT.fire()
            req = Request(f"{self._base}/{scope}/{key}", data=value,
                          method="PUT")
            with urlopen(req, timeout=self._timeout) as resp:
                self._observe_epoch(resp.headers)
        self._retry.call(attempt, site="rendezvous.put")

    def get(self, scope: str, key: str, timeout: Optional[float] = None,
            deadline: Optional[float] = None) -> Optional[bytes]:
        """GET one key. ``timeout`` overrides the per-request HTTP timeout
        and ``deadline`` caps the retry budget — ``wait()`` uses both so
        its own deadline binds a hung coordinator."""
        http_timeout = self._timeout if timeout is None else timeout

        def attempt():
            _FP_GET.fire()
            try:
                with urlopen(f"{self._base}/{scope}/{key}",
                             timeout=http_timeout) as resp:
                    self._observe_epoch(resp.headers)
                    return resp.read()
            except HTTPError as e:
                self._observe_epoch(e.headers)
                if e.code == 404:
                    return None
                raise
        policy = self._retry
        if deadline is not None and deadline < policy.deadline:
            policy = _retry.RetryPolicy(
                max_attempts=policy.max_attempts,
                initial_backoff=policy.initial_backoff,
                max_backoff=policy.max_backoff, deadline=deadline)
        return policy.call(attempt, site="rendezvous.get")

    def wait(self, scope: str, key: str, timeout: float = 60.0,
             poll_interval: float = 0.1) -> bytes:
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"timed out waiting for {scope}/{key} on {self._base}")
            try:
                # Cap BOTH the HTTP timeout and the retry budget by the
                # remaining wait deadline: a hung coordinator must bound
                # wait(timeout=60) at ~60s, not 30s x retries past it.
                value = self.get(
                    scope, key,
                    timeout=min(self._timeout, max(remaining, 0.05)),
                    deadline=remaining)
            except (URLError, ConnectionError, TimeoutError, OSError):
                # even after get()'s own retries, wait() keeps polling
                # until ITS deadline — pre-hardening behavior, kept
                value = None
            if value is not None:
                return value
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"timed out waiting for {scope}/{key} on {self._base}")
            time.sleep(poll_interval)

    def delete(self, scope: str, key: str):
        def attempt():
            _FP_DELETE.fire()
            req = Request(f"{self._base}/{scope}/{key}", method="DELETE")
            with urlopen(req, timeout=self._timeout) as resp:
                self._observe_epoch(resp.headers)
        self._retry.call(attempt, site="rendezvous.delete")
