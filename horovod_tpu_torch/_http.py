"""Shared HTTP-server plumbing: one async front-end for every endpoint
(a copy of ``horovod_tpu/_http.py``).

In the JAX package four subsystems front themselves with the same server
idiom — the rendezvous KV store (``runner/rendezvous.py``), the
Prometheus metrics endpoint (``metrics.py``), the inference serving
front-end and the fleet router; the port has the first two so far. The original implementation was a
``ThreadingHTTPServer``: one OS thread per *connection*, which makes the
connection ceiling the thread ceiling — a fleet front-end holding tens
of thousands of keep-alive clients would hold tens of thousands of
stacks for connections that are idle almost all the time.

:class:`AsyncHTTPServer` replaces it with a selectors-based reactor:

* **idle** connections (keep-alive between requests) live in a
  ``selectors.DefaultSelector`` and cost one file descriptor each —
  no thread, no stack;
* an **active** connection (readable: a request has started arriving)
  is handed to a short-lived worker thread that drives the existing
  ``BaseHTTPRequestHandler`` subclass for one request/response cycle
  (so handlers may still block in ``engine.infer()`` or a KV
  long-poll), then parks the connection back in the selector;
* every accepted socket carries a **read deadline**
  (``HVD_TPU_HTTP_READ_TIMEOUT``): a slow-loris client that starts a
  request and stalls is timed out and closed instead of pinning a
  worker forever.

The server keeps the ``socketserver`` surface its consumers already
use — ``AsyncHTTPServer((addr, port), HandlerClass)``,
``server_address``, ``serve_forever(poll_interval=...)``,
``shutdown()``, ``server_close()``, owner state attached directly on
the server object (``httpd.owner`` and friends) — so handlers stay
plain ``BaseHTTPRequestHandler`` subclasses and the KV store's own
bind/hot-restart lifecycle works unchanged.

:func:`start_server` / :func:`stop_server` keep their contract: bind,
serve on a named daemon thread, and an **idempotent** stop that
survives concurrent callers.
"""

import logging
import selectors
import socket
import threading
from http.server import BaseHTTPRequestHandler
from typing import Optional

from . import config as _config

log = logging.getLogger("horovod_tpu_torch.http")


class QuietHandler(BaseHTTPRequestHandler):
    """Handler base: HTTP/1.1 keep-alive, logging gated on the server's
    ``verbose`` flag (a scrape or an inference request is not a log
    event)."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)


class _Conn:
    """One accepted connection: the socket plus its handler instance.

    The handler is constructed once per connection (``setup()`` builds
    ``rfile``/``wfile``) and re-driven for every request the connection
    carries, so keep-alive costs no per-request setup.
    """

    __slots__ = ("sock", "fd", "handler")

    def __init__(self, sock, handler):
        self.sock = sock
        self.fd = sock.fileno()
        self.handler = handler


class AsyncHTTPServer:
    """Selectors-based non-blocking HTTP server (see module docstring).

    The reactor thread (whoever calls :meth:`serve_forever`) only ever
    accepts, selects, and dispatches; request handling — including
    anything that blocks, like a serving forward or a KV long-poll —
    happens on per-activation worker threads. Idle connections are pure
    selector entries, so the concurrent-connection ceiling is file
    descriptors, not threads.
    """

    #: handlers and ``handle_error`` consult this; set by start_server()
    verbose = False

    def __init__(self, server_address, RequestHandlerClass):
        self.RequestHandlerClass = RequestHandlerClass
        #: per-socket read deadline (seconds): bounds a stalled client's
        #: hold on a worker (slow-loris) and a wedged client's reads of
        #: our response writes. 0/negative disables the deadline.
        self.read_timeout: float = float(
            _config.Config().get(_config.HTTP_READ_TIMEOUT))
        self.socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.socket.bind(server_address)
            self.socket.listen(1024)
        except Exception:
            self.socket.close()
            raise
        self.socket.setblocking(False)
        self.server_address = self.socket.getsockname()
        self._selector = selectors.DefaultSelector()
        #: self-waker: shutdown()/worker re-registrations nudge the
        #: reactor out of its select() immediately instead of waiting out
        #: the poll interval
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self._waker_w.setblocking(False)
        self._lock = threading.Lock()
        #: fd -> _Conn for every live connection (idle or active); writes
        #: guarded by ``_lock``
        self._conns = {}
        self._shutdown_request = False
        self._started = threading.Event()
        self._stopped = threading.Event()
        self._closed = False

    # -- socketserver-compatible lifecycle -----------------------------------

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self._started.set()
        self._selector.register(self.socket, selectors.EVENT_READ,
                                "listener")
        self._selector.register(self._waker_r, selectors.EVENT_READ,
                                "waker")
        try:
            while not self._shutdown_request:
                try:
                    events = self._selector.select(poll_interval)
                except OSError:
                    # selector torn down under us (server_close raced a
                    # crash simulation); nothing left to serve
                    break
                for key, _mask in events:
                    if self._shutdown_request:
                        break
                    if key.data == "listener":
                        self._accept()
                    elif key.data == "waker":
                        self._drain_waker()
                    else:
                        self._activate(key.data)
        finally:
            self._close_idle()
            for sock in (self.socket, self._waker_r):
                try:
                    self._selector.unregister(sock)
                except (KeyError, ValueError, OSError):
                    pass
            self._stopped.set()

    def shutdown(self) -> None:
        """Stop the serve loop; blocks (bounded) until it has exited.
        Safe to call from worker threads and before/without
        :meth:`serve_forever` ever running."""
        self._shutdown_request = True
        self._wake()
        if self._started.is_set():
            self._stopped.wait(timeout=5.0)

    def server_close(self) -> None:
        self._closed = True
        for sock in (self.socket, self._waker_r, self._waker_w):
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._selector.close()
        except (OSError, RuntimeError):
            pass

    # -- reactor internals ---------------------------------------------------

    def _wake(self) -> None:
        try:
            self._waker_w.send(b"\0")
        except OSError:
            pass

    def _drain_waker(self) -> None:
        try:
            while self._waker_r.recv(4096):
                pass
        except OSError:
            pass

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self.socket.accept()
            except OSError:
                # includes BlockingIOError: accept queue drained
                return
            if self.read_timeout > 0:
                sock.settimeout(self.read_timeout)
            try:
                handler = self.RequestHandlerClass.__new__(
                    self.RequestHandlerClass)
                handler.request = sock
                handler.client_address = addr
                handler.server = self
                handler.setup()
            except Exception:
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            conn = _Conn(sock, handler)
            dropped = False
            with self._lock:
                if self._shutdown_request or self._closed:
                    dropped = True
                else:
                    self._conns[conn.fd] = conn
                    try:
                        self._selector.register(sock, selectors.EVENT_READ,
                                                conn)
                    except (KeyError, ValueError, OSError):
                        self._conns.pop(conn.fd, None)
                        dropped = True
            if dropped:
                self._close_conn(conn)

    def _activate(self, conn: _Conn) -> None:
        """A parked connection became readable: pull it out of the
        selector and hand it to a worker thread for one request cycle."""
        with self._lock:
            if conn.fd not in self._conns:
                return
            try:
                self._selector.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                return
        threading.Thread(target=self._drive, args=(conn,),
                         name="hvd-http-worker", daemon=True).start()

    def _drive(self, conn: _Conn) -> None:
        """Worker: serve requests on this connection until it would
        block again (or closes), then park it back in the selector."""
        handler = conn.handler
        try:
            while True:
                handler.handle_one_request()
                if handler.close_connection:
                    self._discard(conn)
                    return
                if not self._pipelined(conn):
                    break
        except Exception as e:  # noqa: BLE001 — dropped conns are expected
            if self.verbose:
                log.warning("http: connection from %s failed: %s",
                            handler.client_address, e, exc_info=True)
            self._discard(conn)
            return
        drop = False
        with self._lock:
            if self._shutdown_request or self._closed \
                    or conn.fd not in self._conns:
                drop = True
            else:
                try:
                    self._selector.register(conn.sock, selectors.EVENT_READ,
                                            conn)
                except (KeyError, ValueError, OSError):
                    drop = True
        if drop:
            self._discard(conn)
        else:
            self._wake()

    def _pipelined(self, conn: _Conn) -> bool:
        """True when the next request's bytes are already buffered in the
        handler's ``rfile`` — the selector would never fire for those, so
        the worker must keep serving instead of parking the connection."""
        try:
            conn.sock.settimeout(0.0)
            try:
                pending = bool(conn.handler.rfile.peek(1))
            except (OSError, ValueError):
                pending = False
            return pending
        finally:
            try:
                conn.sock.settimeout(
                    self.read_timeout if self.read_timeout > 0 else None)
            except OSError:
                pass

    def _discard(self, conn: _Conn) -> None:
        with self._lock:
            present = self._conns.pop(conn.fd, None) is not None
            if present:
                try:
                    self._selector.unregister(conn.sock)
                except (KeyError, ValueError, OSError):
                    pass
        self._close_conn(conn)

    def _close_idle(self) -> None:
        """Serve-loop exit: close every parked connection. Connections a
        worker is actively driving are not in the selector; their workers
        finish the in-flight response and discard on the re-park attempt
        (``_shutdown_request`` is already up)."""
        idle = []
        with self._lock:
            try:
                keys = list(self._selector.get_map().values())
            except (OSError, RuntimeError):
                keys = []
            for key in keys:
                if isinstance(key.data, _Conn):
                    try:
                        self._selector.unregister(key.fileobj)
                    except (KeyError, ValueError, OSError):
                        pass
                    self._conns.pop(key.data.fd, None)
                    idle.append(key.data)
        for conn in idle:
            self._close_conn(conn)

    @staticmethod
    def _close_conn(conn: _Conn) -> None:
        for f in (getattr(conn.handler, "wfile", None),
                  getattr(conn.handler, "rfile", None), conn.sock):
            try:
                if f is not None:
                    f.close()
            except (OSError, ValueError):
                pass


def start_server(handler_cls, port: int = 0, addr: str = "0.0.0.0",
                 name: str = "hvd-tpu-http", verbose: bool = False,
                 poll_interval: float = 0.05,
                 server_cls=AsyncHTTPServer):
    """Bind ``addr:port`` (0 = ephemeral), serve ``handler_cls`` on a
    daemon thread, and return the server object. The bound port is
    ``server.server_address[1]``; tear down with :func:`stop_server`."""
    httpd = server_cls((addr, int(port)), handler_cls)
    httpd.verbose = verbose
    thread = threading.Thread(
        target=lambda: httpd.serve_forever(poll_interval=poll_interval),
        name=name, daemon=True)
    httpd._hvd_thread = thread
    httpd._hvd_stop_lock = threading.Lock()
    httpd._hvd_stopped = False
    thread.start()
    return httpd


def stop_server(httpd, timeout: Optional[float] = 5.0) -> None:
    """Idempotent teardown: exactly one caller (of any number, from any
    thread) shuts the server down and joins the serving thread; the rest
    — including repeat calls — return immediately. ``None`` is accepted
    so owners can stop an endpoint that never started."""
    if httpd is None:
        return
    lock = getattr(httpd, "_hvd_stop_lock", None)
    if lock is None:                  # not started via start_server()
        try:
            httpd.shutdown()
            httpd.server_close()
        except Exception:
            pass
        return
    with lock:
        if httpd._hvd_stopped:
            return
        httpd._hvd_stopped = True
    try:
        httpd.shutdown()
        httpd.server_close()
    except Exception:
        pass
    thread = getattr(httpd, "_hvd_thread", None)
    if thread is not None and thread is not threading.current_thread():
        thread.join(timeout=timeout)
