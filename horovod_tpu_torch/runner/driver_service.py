"""Driver and task services with network-interface intersection (a copy
of ``horovod_tpu/runner/driver_service.py``, on the port's
:mod:`.network`; reference: horovod/runner/driver/driver_service.py:48-204
and runner/common/service/{driver,task}_service.py).

The launcher runs a task service on every host; each registers its
candidate (interface -> addresses) map with the driver; the driver then
has each task PROBE its ring neighbour's addresses and intersects the
interfaces that routed, which gives the NICs every host can reach every
other host on (a multi-NIC host must not hand a management-only
interface to the rendezvous). The protocol rides the HMAC-authenticated
service layer; the request classes are
pickled by module path, so the port's services answer the port's
clients, not the JAX package's.
"""

import threading
from typing import Dict, List, Optional, Set, Tuple

from .network import AckResponse, BasicClient, BasicService

Addresses = Dict[str, List[Tuple[str, int]]]


class RegisterTaskRequest:
    def __init__(self, index: int, addresses: Addresses):
        self.index = index
        self.addresses = addresses


class AllTasksRegisteredRequest:
    pass


class AllTasksRegisteredResponse:
    def __init__(self, done: bool):
        self.done = done


class TaskAddressesRequest:
    def __init__(self, index: int):
        self.index = index


class TaskAddressesResponse:
    def __init__(self, addresses: Optional[Addresses]):
        self.addresses = addresses


class ProbeNeighborRequest:
    """Ask a task server to probe which of a neighbor's interfaces route
    from its host (reference: task-to-task address checks,
    driver_service.py:135-204)."""

    def __init__(self, addresses: Addresses, key: bytes,
                 timeout: float = 3.0):
        self.addresses = addresses
        self.key = key
        self.timeout = timeout


class ProbeNeighborResponse:
    def __init__(self, reachable_interfaces: Set[str]):
        self.reachable_interfaces = reachable_interfaces


class TaskService(BasicService):
    """Per-host service: answers pings (liveness) and neighbor probes
    (reachability per interface)."""

    NAME_FMT = "hvd-tpu task service {index}"

    def __init__(self, index: int, key: bytes, port: int = 0):
        self.index = index
        super().__init__(self.NAME_FMT.format(index=index), key, port=port)

    def _handle(self, req, client_address):
        if isinstance(req, ProbeNeighborRequest):
            reachable: Set[str] = set()
            for intf, addrs in req.addresses.items():
                try:
                    client = BasicClient("neighbor", {intf: addrs}, req.key,
                                         timeout=req.timeout)
                    client.ping()
                    reachable.add(intf)
                except (ConnectionError, ValueError, OSError):
                    continue
            return ProbeNeighborResponse(reachable)
        return super()._handle(req, client_address)


class TaskClient(BasicClient):
    def __init__(self, index: int, addresses: Addresses, key: bytes,
                 timeout: float = 10.0):
        super().__init__(TaskService.NAME_FMT.format(index=index),
                         addresses, key, timeout=timeout)

    def probe_neighbor(self, addresses: Addresses, key: bytes,
                       probe_timeout: float = 3.0) -> Set[str]:
        resp = self._send(ProbeNeighborRequest(addresses, key,
                                               probe_timeout))
        return resp.reachable_interfaces


class DriverService(BasicService):
    """Launcher-side registry of task servers (reference:
    runner/common/service/driver_service.py BasicDriverService)."""

    NAME = "hvd-tpu driver service"

    def __init__(self, num_tasks: int, key: bytes, port: int = 0):
        self._num_tasks = num_tasks
        self._task_addresses: Dict[int, Addresses] = {}
        self._all_registered = threading.Event()
        self._reg_lock = threading.Lock()
        super().__init__(self.NAME, key, port=port)

    def _handle(self, req, client_address):
        if isinstance(req, RegisterTaskRequest):
            with self._reg_lock:
                self._task_addresses[req.index] = req.addresses
                if len(self._task_addresses) == self._num_tasks:
                    self._all_registered.set()
            return AckResponse()
        if isinstance(req, AllTasksRegisteredRequest):
            return AllTasksRegisteredResponse(self._all_registered.is_set())
        if isinstance(req, TaskAddressesRequest):
            return TaskAddressesResponse(
                self._task_addresses.get(req.index))
        return super()._handle(req, client_address)

    def task_addresses(self, index: int) -> Optional[Addresses]:
        return self._task_addresses.get(index)

    def wait_for_all(self, timeout: Optional[float] = None) -> bool:
        return self._all_registered.wait(timeout)


class DriverClient(BasicClient):
    def __init__(self, addresses: Addresses, key: bytes,
                 timeout: float = 10.0):
        super().__init__(DriverService.NAME, addresses, key, timeout=timeout)

    def register(self, index: int, addresses: Addresses) -> None:
        self._send(RegisterTaskRequest(index, addresses))

    def all_registered(self) -> bool:
        return self._send(AllTasksRegisteredRequest()).done

    def task_addresses(self, index: int) -> Optional[Addresses]:
        return self._send(TaskAddressesRequest(index)).addresses


def get_common_interfaces(driver: DriverService, task_key: bytes,
                          probe_timeout: float = 3.0
                          ) -> Tuple[Set[str], Dict[int, Addresses]]:
    """Ring-probe every task's reachability of its neighbor and intersect
    the interfaces that routed (reference: driver_service.py:135-204
    _run_probe + intersection).

    Returns ``(common_interfaces, filtered_addresses_per_task)`` where the
    filtered map keeps only addresses on common interfaces — the addresses
    safe to hand to the rendezvous/coordinator.
    """
    n = len(driver._task_addresses)
    if n == 0:
        return set(), {}
    common: Optional[Set[str]] = None
    for i in sorted(driver._task_addresses):
        nxt = (i + 1) % n if n > 1 else i
        neighbor_addrs = driver.task_addresses(nxt)
        client = TaskClient(i, driver.task_addresses(i), task_key,
                            timeout=probe_timeout + 7.0)
        reachable = client.probe_neighbor(neighbor_addrs, task_key,
                                          probe_timeout)
        common = reachable if common is None else (common & reachable)
    common = common or set()
    filtered = {
        i: {intf: addrs for intf, addrs in a.items() if intf in common}
        for i, a in driver._task_addresses.items()}
    return common, filtered
