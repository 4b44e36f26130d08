"""Host discovery and availability tracking for elastic jobs.

Reference: horovod/runner/elastic/discovery.py —
HostDiscoveryScript polls a user script printing ``host[:slots]`` lines
(:131-151), HostManager tracks the discovered set, blacklists failing
hosts, and keeps a *stable* assignment order so surviving hosts keep their
low ranks across membership changes (:79-124).
"""

import subprocess
import threading
from typing import Dict, List, Optional

from .. import faults as _faults

# Chaos site for host discovery: an injected ``error`` behaves exactly
# like a failing discovery script (RuntimeError) — fatal on the first
# poll, logged-and-retried on later ones (driver._discover_hosts).
_FP_DISCOVERY = _faults.FaultPoint("elastic.discovery", exc=RuntimeError)


class HostState:
    """Per-host liveness: an event that fires when the host changes or is
    blacklisted (workers started on that host watch it), plus the blacklist
    flag (reference discovery.py:25-46) and a *draining* flag.

    Draining is deliberately NOT blacklisting: a draining host is excluded
    from new assignments (so the next generation forms without it) but its
    in-flight worker must still be treated as healthy — the registry
    barrier skips blacklisted hosts' READY records, so conflating the two
    would hang the old generation's barrier, and a drained host must stay
    re-admittable once capacity returns."""

    def __init__(self):
        self._event = threading.Event()
        self._blacklisted = False
        self._draining = False

    def get_event(self) -> threading.Event:
        if self._event.is_set():
            # Hand out a fresh event once the old one has fired so a new
            # worker generation can watch this host again.
            self._event = threading.Event()
        return self._event

    def set_event(self) -> None:
        self._event.set()

    def blacklist(self) -> None:
        self._blacklisted = True
        self._event.set()

    def is_blacklisted(self) -> bool:
        return self._blacklisted

    def mark_draining(self) -> None:
        # no set_event(): the draining worker keeps running through its
        # grace window; the re-rendezvous (not a kill) retires it
        self._draining = True

    def clear_draining(self) -> None:
        self._draining = False

    def is_draining(self) -> bool:
        return self._draining


class DiscoveredHosts:
    """Immutable-ish snapshot of the discovered cluster
    (reference discovery.py:49-77)."""

    def __init__(self, host_slots: Dict[str, int],
                 host_assignment_order: List[str]):
        self.host_slots = dict(host_slots)
        self.host_assignment_order = list(host_assignment_order)

    @property
    def available_hosts(self):
        return set(self.host_assignment_order)

    def get_slots(self, host: str) -> int:
        return self.host_slots.get(host, 0)

    def count_available_slots(self) -> int:
        return sum(self.get_slots(h) for h in self.host_assignment_order)

    def drop_blacklisted(self, states: Dict[str, HostState]
                         ) -> "DiscoveredHosts":
        # Draining hosts are dropped alongside blacklisted ones: both are
        # excluded from slot counts and new assignments — but a draining
        # host's state flag is cleared once its drain completes, so it
        # reappears here on the next discovery poll (re-admission).
        self.host_assignment_order = [
            h for h in self.host_assignment_order
            if not (h in states and (states[h].is_blacklisted()
                                     or states[h].is_draining()))]
        return self


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        """Return {hostname: slots} for every currently usable host."""
        raise NotImplementedError

    def find_preempted_hosts(self) -> Dict[str, float]:
        """Return {hostname: grace_seconds} for hosts the fleet scheduler
        has announced it will reclaim. Polled by the driver's discovery
        loop each cycle; notices are routed into the same graceful-drain
        path as the ``preempt`` scope and fault kind. Default: none —
        subclasses with a cloud-metadata or scheduler API override this."""
        return {}


class HostDiscoveryScript(HostDiscovery):
    """Runs a user-supplied executable that prints one ``host`` or
    ``host:slots`` per line (reference discovery.py:131-151;
    ``--host-discovery-script``)."""

    def __init__(self, discovery_script: str, default_slots: int = 1):
        self._script = discovery_script
        self._default_slots = default_slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        _FP_DISCOVERY.fire()
        proc = subprocess.run(
            self._script, shell=True, capture_output=True, text=True,
            timeout=60)
        if proc.returncode != 0:
            raise RuntimeError(
                f"host discovery script {self._script!r} failed with exit "
                f"code {proc.returncode}: {proc.stderr.strip()}")
        host_slots: Dict[str, int] = {}
        for line in set(proc.stdout.strip().splitlines()):
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                host, slots = line.rsplit(":", 1)
                host_slots[host] = int(slots)
            else:
                host_slots[line] = self._default_slots
        return host_slots


class FixedHosts(HostDiscovery):
    """A mutable fixed host set — the unit-test double the reference uses to
    simulate membership changes without processes
    (reference discovery.py:155-163)."""

    def __init__(self, host_slots: Optional[Dict[str, int]] = None):
        self._host_slots = dict(host_slots or {})

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._host_slots)

    def set(self, host_slots: Dict[str, int]) -> None:
        self._host_slots = dict(host_slots)


class HostManager:
    """Tracks the discovered host set across polls
    (reference discovery.py:79-124)."""

    def __init__(self, discovery: HostDiscovery):
        self._discovery = discovery
        self._states: Dict[str, HostState] = {}
        self._current = DiscoveredHosts({}, [])

    def _state(self, host: str) -> HostState:
        if host not in self._states:
            self._states[host] = HostState()
        return self._states[host]

    def update_available_hosts(self) -> bool:
        """Poll discovery; returns True when the host set changed. Hosts
        keep their relative order (oldest first) so rank assignments stay
        stable (reference order_available_hosts:113-121)."""
        new_slots = self._discovery.find_available_hosts_and_slots()
        if new_slots == self._current.host_slots:
            return False
        available = [h for h in new_slots
                     if not self._state(h).is_blacklisted()]
        order = [h for h in self._current.host_assignment_order
                 if h in available]
        known = set(order)
        for h in available:
            if h not in known:
                order.append(h)
        # Fire change events for hosts that disappeared.
        for h in self._current.host_slots:
            if h not in new_slots:
                self._state(h).set_event()
        self._current = DiscoveredHosts(new_slots, order)
        return True

    @property
    def current_hosts(self) -> DiscoveredHosts:
        # Filter a fresh snapshot, not the stored one: drop_blacklisted
        # mutates host_assignment_order in place, and a draining host must
        # reappear in the order (same discovery data) once its drain
        # completes and clear_draining runs — an in-place drop would make
        # the exclusion permanent until the host set itself changed.
        snapshot = DiscoveredHosts(self._current.host_slots,
                                   self._current.host_assignment_order)
        return snapshot.drop_blacklisted(self._states)

    def blacklist(self, host: str) -> None:
        self._state(host).blacklist()

    def mark_draining(self, host: str) -> None:
        """Exclude ``host`` from new assignments without blacklisting it
        (graceful preemption drain — see :class:`HostState`)."""
        self._state(host).mark_draining()

    def clear_draining(self, host: str) -> None:
        """Drain finished (or cancelled): the host is re-admittable on the
        next ``current_hosts`` access if discovery still reports it."""
        self._state(host).clear_draining()

    def is_draining(self, host: str) -> bool:
        return host in self._states and self._states[host].is_draining()

    def draining_hosts(self) -> List[str]:
        return [h for h, s in self._states.items() if s.is_draining()]

    def fire_host_event(self, host: str) -> None:
        """Fire the host's change event WITHOUT blacklisting it — how the
        heartbeat monitor kills a silently-wedged worker so its exit flows
        through the normal FAILURE -> blacklist path (a pre-kill blacklist
        would make the registry skip the exit record and hang the
        generation barrier)."""
        self._state(host).set_event()

    def is_blacklisted(self, host: str) -> bool:
        return host in self._states and self._states[host].is_blacklisted()

    def blacklisted_count(self) -> int:
        return sum(1 for s in self._states.values() if s.is_blacklisted())

    def get_host_event(self, host: str) -> threading.Event:
        return self._state(host).get_event()
