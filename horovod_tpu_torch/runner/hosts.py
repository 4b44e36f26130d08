"""Host list parsing and rank/slot assignment.

Reference: horovod/runner/common/util/hosts.py (HostInfo,
SlotInfo, get_host_assignments:106-155) and hostfile parsing in launch.py.

Semantics match the reference: ranks are assigned host-major (all slots of the
first host get the lowest ranks), ``local_rank`` counts within a host,
``cross_rank`` indexes hosts among those that *have* that local_rank — the
GLOBAL/LOCAL/CROSS triple that hierarchical algorithms key on
(reference common.h:111, mpi_context.cc:147-156; here: ICI vs DCN mesh axes).
"""

import dataclasses
import re
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(text: str) -> "HostInfo":
        m = re.match(r"^\s*([^:\s]+)(?::(\d+))?\s*$", text)
        if not m:
            raise ValueError(f"bad host spec {text!r}; expected host[:slots]")
        return HostInfo(m.group(1), int(m.group(2) or 1))


@dataclasses.dataclass(frozen=True)
class SlotInfo:
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """Parse ``h1:4,h2:4`` (reference -H flag format, launch.py)."""
    return [HostInfo.from_string(part)
            for part in hosts_string.split(",") if part.strip()]


def parse_hostfile(path: str) -> List[HostInfo]:
    """Parse a hostfile: one ``hostname [slots=N]`` or ``hostname[:N]`` per
    line; '#' comments (reference --hostfile, launch.py parse_host_files)."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r"^(\S+)\s+slots\s*=\s*(\d+)$", line)
            if m:
                hosts.append(HostInfo(m.group(1), int(m.group(2))))
            else:
                hosts.append(HostInfo.from_string(line))
    return hosts


def get_host_assignments(hosts: List[HostInfo], min_np: int,
                         max_np: Optional[int] = None
                         ) -> Tuple[List[SlotInfo], int]:
    """Assign ranks to host slots (reference hosts.py:106-155).

    Returns (slot_infos ordered by rank, world size). Uses every available
    slot up to ``max_np`` (or exactly the available total if smaller);
    raises if fewer than ``min_np`` slots exist.
    """
    total = sum(h.slots for h in hosts)
    if total < min_np:
        raise ValueError(
            f"requested at least {min_np} processes but hosts "
            f"{[h.hostname for h in hosts]} provide only {total} slots")
    size = min(total, max_np) if max_np else total

    # host-major rank assignment
    placements: List[Tuple[str, int]] = []       # (hostname, local_rank)
    per_host_count = {}
    for h in hosts:
        for lr in range(h.slots):
            if len(placements) == size:
                break
            placements.append((h.hostname, lr))
            per_host_count[h.hostname] = per_host_count.get(h.hostname, 0) + 1

    slots: List[SlotInfo] = []
    for rank, (hostname, lr) in enumerate(placements):
        cross_hosts = [h.hostname for h in hosts
                       if per_host_count.get(h.hostname, 0) > lr]
        slots.append(SlotInfo(
            hostname=hostname,
            rank=rank,
            local_rank=lr,
            cross_rank=cross_hosts.index(hostname),
            size=size,
            local_size=per_host_count[hostname],
            cross_size=len(cross_hosts),
        ))
    return slots, size
