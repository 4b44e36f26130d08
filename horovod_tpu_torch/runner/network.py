"""HMAC-authenticated TCP request/response services.

A copy of ``horovod_tpu/runner/network.py`` (same wire format and service
names), the equivalent of the reference's driver/task service plumbing
(horovod/runner/common/util/network.py: pickled
request/response protocol over TCP with an HMAC secret, BasicService /
BasicClient; secret.py make_secret_key). Used by the elastic worker
notification channel (driver -> rank-0 worker) and by host-side services
that must not accept unauthenticated commands.

Wire format per message: ``u32 length | 32-byte HMAC-SHA256(payload) |
payload`` where payload is a pickled object. The HMAC covers the payload
only; a message with a bad digest is dropped and the connection closed.
"""

import hmac
import hashlib
import os
import pickle
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

DIGEST_LEN = hashlib.sha256().digest_size
MAX_MESSAGE_BYTES = 64 * 1024 * 1024


def make_secret_key() -> bytes:
    """Random per-job secret (reference runner/common/util/secret.py)."""
    return os.urandom(32)


class AckResponse:
    """Generic acknowledgement."""


class PingRequest:
    """Connectivity probe (reference network.py PingRequest)."""


class PingResponse:
    def __init__(self, service_name: str, source_address: str):
        self.service_name = service_name
        self.source_address = source_address


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection mid-message")
        buf += chunk
    return buf


def _send_message(sock: socket.socket, obj: Any, key: bytes) -> None:
    payload = pickle.dumps(obj)
    digest = hmac.new(key, payload, hashlib.sha256).digest()
    sock.sendall(struct.pack("!I", len(payload)) + digest + payload)


def _recv_message(sock: socket.socket, key: bytes) -> Any:
    (length,) = struct.unpack("!I", _recv_exact(sock, 4))
    if length > MAX_MESSAGE_BYTES:
        raise ConnectionError(f"message too large: {length}")
    digest = _recv_exact(sock, DIGEST_LEN)
    payload = _recv_exact(sock, length)
    if not hmac.compare_digest(
            digest, hmac.new(key, payload, hashlib.sha256).digest()):
        raise PermissionError("HMAC verification failed")
    return pickle.loads(payload)


def local_addresses() -> Dict[str, List[Tuple[str, int]]]:
    """Best-effort map of interface-ish name -> [(ip, 0)].

    The reference enumerates NICs with psutil (network.py get_local_host_
    addresses) to let the driver pick a mutually-routable interface; here we
    report the hostname-resolved and outbound-probe addresses, which covers
    the one-NIC-that-matters case without a psutil dependency.
    """
    addrs: Dict[str, List[Tuple[str, int]]] = {}
    try:
        host_ip = socket.gethostbyname(socket.gethostname())
        addrs["host"] = [(host_ip, 0)]
    except OSError:
        pass
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            addrs["outbound"] = [(s.getsockname()[0], 0)]
    except OSError:
        pass
    addrs.setdefault("lo", [("127.0.0.1", 0)])
    return addrs


class BasicService:
    """Threaded TCP service dispatching pickled requests to ``_handle``.

    Reference: runner/common/util/network.py BasicService — a listener
    thread accepts connections; each connection is served on its own
    thread; ``addresses()`` reports every candidate (ip, port) so clients
    can probe which one routes.
    """

    def __init__(self, name: str, key: bytes, port: int = 0):
        self._name = name
        self._key = key
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", port))
        self._listener.listen(64)
        self._port = self._listener.getsockname()[1]
        self._shutdown = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name=f"{name}-listener", daemon=True)
        self._thread.start()

    @property
    def name(self) -> str:
        return self._name

    @property
    def port(self) -> int:
        return self._port

    def addresses(self) -> Dict[str, List[Tuple[str, int]]]:
        return {intf: [(ip, self._port) for ip, _ in addrs]
                for intf, addrs in local_addresses().items()}

    def _serve(self):
        while not self._shutdown.is_set():
            try:
                conn, addr = self._listener.accept()
            except OSError:
                break
            t = threading.Thread(target=self._serve_one, args=(conn, addr),
                                 daemon=True)
            t.start()

    def _serve_one(self, conn: socket.socket, addr):
        with conn:
            try:
                req = _recv_message(conn, self._key)
                resp = self._handle(req, addr)
                _send_message(conn, resp, self._key)
            except (ConnectionError, PermissionError, EOFError, OSError):
                return

    def _handle(self, req: Any, client_address) -> Any:
        if isinstance(req, PingRequest):
            return PingResponse(self._name, client_address[0])
        raise NotImplementedError(
            f"{self._name}: unhandled request type {type(req).__name__}")

    def shutdown(self):
        self._shutdown.set()
        try:
            # close() alone does not wake an accept() blocked in another
            # thread: the join would wait out its timeout
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass   # never listened, or already shut
        try:
            self._listener.close()
        except OSError:
            pass
        self._thread.join(timeout=5)


class BasicClient:
    """Client probing a service's advertised addresses
    (reference network.py BasicClient: tries every (intf, ip, port))."""

    def __init__(self, service_name: str,
                 addresses: Dict[str, List[Tuple[str, int]]],
                 key: bytes, timeout: float = 10.0):
        self._service_name = service_name
        self._key = key
        self._timeout = timeout
        self._candidates: List[Tuple[str, int]] = [
            a for addrs in addresses.values() for a in addrs]
        if not self._candidates:
            raise ValueError(f"no addresses given for {service_name}")
        self._good: Optional[Tuple[str, int]] = None

    def _send(self, req: Any) -> Any:
        errors = []
        order: Sequence[Tuple[str, int]] = (
            [self._good] + [c for c in self._candidates if c != self._good]
            if self._good else self._candidates)
        for ip, port in order:
            try:
                with socket.create_connection(
                        (ip, port), timeout=self._timeout) as sock:
                    _send_message(sock, req, self._key)
                    resp = _recv_message(sock, self._key)
                self._good = (ip, port)
                return resp
            except (OSError, ConnectionError, PermissionError) as e:
                errors.append((ip, port, str(e)))
        raise ConnectionError(
            f"could not reach {self._service_name} at any of "
            f"{self._candidates}: {errors}")

    def ping(self) -> PingResponse:
        return self._send(PingRequest())
