"""The SDC fingerprints' KV channel (counterpart of the SDC section of
``horovod_tpu/_schedule.py``, copied; the keys and payloads are the JAX
package's, byte for byte).

The parameter fingerprints of ``sdc/fingerprint.py`` ride the schedule
ledger's rendezvous KV scope (``schedule``) under their own key prefix,
so the stall/divergence plane is where a "rank N disagrees" diagnostic
lives. The collective schedule ledger itself (the rest of the JAX
module: every eager submission hashed into a per-process ledger and
diffed on a stall) waits for the port's telemetry (ROADMAP A4).
"""

import json
from typing import Dict, List, Optional, Tuple

_sdc_client = None
_sdc_client_resolved = False


def _sdc_kv_client():
    """A single-attempt, short-timeout client: a fingerprint publish runs
    inside the training step cadence, so a dead KV server must cost one
    bounded probe, never a retry chain. None without a rendezvous."""
    global _sdc_client, _sdc_client_resolved
    if not _sdc_client_resolved:
        from . import config as _config
        from . import retry as _retry
        cfg = _config.live_config()
        addr = cfg.get(_config.RENDEZVOUS_ADDR)
        port = cfg.get(_config.RENDEZVOUS_PORT)
        if addr and port and int(port) > 0:
            from .runner.rendezvous import KVStoreClient
            _sdc_client = KVStoreClient(
                addr, int(port), timeout=2.0,
                retry=_retry.RetryPolicy(
                    max_attempts=1, initial_backoff=0.05,
                    max_backoff=0.1, deadline=2.0))
        _sdc_client_resolved = True
    return _sdc_client


def _env_rank() -> int:
    from . import basics
    if basics.is_initialized():
        return basics.rank()
    import os
    try:
        return int(os.environ.get("HVD_TPU_RANK") or 0)
    except ValueError:
        return 0


def _fp_key(rank: int, group: Optional[int] = None) -> str:
    """KV key for one rank's fingerprint: flat (``sdc.fp.rank<r>``) for
    the whole-world compare, ``sdc.fp.g<g>.rank<r>`` when scoped to a
    replica group, so a tp/fsdp shard-holder never reads a different
    shard's fingerprint as its peer's."""
    if group is None:
        return f"sdc.fp.rank{rank}"
    return f"sdc.fp.g{int(group)}.rank{rank}"


def publish_sdc_fingerprint(step: int, fp: int,
                            rank: Optional[int] = None,
                            group: Optional[int] = None,
                            leaf_fps: Optional[Dict[int, int]] = None
                            ) -> int:
    """Best-effort PUT of this rank's parameter fingerprint to the
    ``schedule`` scope (key :func:`_fp_key`). Returns the rank used.
    ``leaf_fps`` (leaf index -> per-leaf checksum) rides along when
    given, so a divergence can name the offending leaf."""
    if rank is None:
        rank = _env_rank()
    client = _sdc_kv_client()
    if client is not None:
        payload = {"step": int(step), "fp": int(fp), "rank": int(rank)}
        if group is not None:
            payload["group"] = int(group)
        if leaf_fps:
            payload["leaves"] = {str(i): int(v)
                                 for i, v in leaf_fps.items()}
        try:
            client.put("schedule", _fp_key(rank, group),
                       json.dumps(payload).encode())
        except Exception:
            pass
    return rank


def fetch_sdc_fingerprints(world_size: Optional[int] = None,
                           group: Optional[int] = None,
                           ranks: Optional[List[int]] = None
                           ) -> Dict[int, dict]:
    """Fingerprint payloads by rank: ``ranks`` restricts the fetch to a
    replica group's members (``group`` selecting the scoped keys);
    otherwise every rank in ``range(world_size)`` on the flat keys."""
    client = _sdc_kv_client()
    if client is None:
        return {}
    if ranks is None:
        ranks = list(range(int(world_size or 0)))
    out: Dict[int, dict] = {}
    for r in ranks:
        try:
            raw = client.get("schedule", _fp_key(r, group))
        except Exception:
            raw = None
        if raw:
            try:
                out[r] = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                pass
    return out


def diff_sdc_fingerprints(peers: Dict[int, dict],
                          step: Optional[int] = None,
                          group: Optional[int] = None
                          ) -> Optional[Tuple[List[int], str]]:
    """Name the diverging rank(s) among published fingerprints by
    majority vote: ``(diverging_ranks, one-line diagnostic)``, or None
    when the replicas agree. Only entries for ``step`` are compared."""
    at_step = {r: p for r, p in peers.items()
               if isinstance(p, dict) and "fp" in p
               and (step is None or p.get("step") == step)}
    if len(at_step) < 2:
        return None
    by_fp: Dict[int, List[int]] = {}
    for r, p in at_step.items():
        try:
            by_fp.setdefault(int(p["fp"]), []).append(r)
        except (TypeError, ValueError):
            pass
    if len(by_fp) <= 1:
        return None
    majority_fp = max(by_fp, key=lambda fp: (len(by_fp[fp]),
                                             -min(by_fp[fp])))
    diverging = sorted(r for fp, ranks in by_fp.items()
                       if fp != majority_fp for r in ranks)
    at = f" at step {step}" if step is not None else ""
    msg = (
        f"parameter fingerprint divergence{at}: rank(s) "
        f"{', '.join(map(str, diverging))} disagree with the majority "
        f"fingerprint 0x{majority_fp:08x} held by "
        f"{len(by_fp[majority_fp])} rank(s)")
    if group is not None:
        msg += f" within replica group {group}"
    leaves = _diverging_leaves(at_step, by_fp[majority_fp], diverging)
    if leaves:
        msg += f"; diverging leaf index(es): {', '.join(map(str, leaves))}"
    return diverging, msg


def _diverging_leaves(at_step: Dict[int, dict], majority_ranks: List[int],
                      diverging: List[int]) -> List[int]:
    """Leaf indices whose per-leaf checksums differ between the lowest
    majority rank and any diverging rank (empty without per-leaf data)."""
    ref = at_step.get(min(majority_ranks), {}).get("leaves")
    if not isinstance(ref, dict):
        return []
    bad = set()
    for r in diverging:
        theirs = at_step.get(r, {}).get("leaves")
        if not isinstance(theirs, dict):
            continue
        for key in set(ref) | set(theirs):
            if ref.get(key) != theirs.get(key):
                try:
                    bad.add(int(key))
                except (TypeError, ValueError):
                    pass
    return sorted(bad)
