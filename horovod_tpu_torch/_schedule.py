"""Opt-in runtime collective schedule ledger, and the SDC fingerprints'
KV channel (counterpart of ``horovod_tpu/_schedule.py``, copied; the KV
keys, payloads, digests and messages are the JAX package's, byte for
byte).

With ``HVD_TPU_SCHEDULE_CHECK=1`` every eager collective submission is
fingerprinted into a per-process **ledger**:

* a monotonically growing sequence number and rolling hash over (verb,
  name, dtype, rank-invariant shape, op, process_set): the fields every
  rank must agree on (a ragged allgather's first dim and alltoall's
  splits are per-rank data and are left out);
* a bounded window of recent entries, published (rate-limited) through
  the rendezvous KV store under scope ``schedule`` when the launcher's KV
  server is reachable (``HVD_TPU_RENDEZVOUS_ADDR`` / ``_PORT``).

On a stall-inspector deadline (stall.py) the inspector calls
:func:`divergence_hint`: the per-rank ledgers are fetched and diffed, and
the first mismatched call site is named in one line —

    rank 1 submitted allreduce('dense_2') where rank 0 submitted
    allreduce('dense_1') (collective #2)

— instead of a silent hang. With the knob off (the default)
:func:`record` is one global load and an ``is None`` test.

The parameter fingerprints of ``sdc/fingerprint.py`` ride the same KV
scope under their own key prefix, independent of the knob.
"""

import collections
import hashlib
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import _locks
from . import metrics as _metrics

__all__ = ["record", "ledger", "reset", "divergence_hint",
           "diff_ledgers", "flush_local", "note_divergence",
           "ScheduleLedger", "publish_sdc_fingerprint",
           "fetch_sdc_fingerprints", "diff_sdc_fingerprints"]

_M_DIVERGENCES = _metrics.counter(
    "hvd_tpu_schedule_divergences_total",
    "Cross-rank collective schedule divergences diagnosed by the "
    "schedule ledger (HVD_TPU_SCHEDULE_CHECK).")

#: entries retained per process; divergence older than this window is
#: still detected (rolling hashes differ) but not named
_DEPTH = 256
#: minimum seconds between KV publishes (a stalled diff flushes anyway)
_PUBLISH_INTERVAL = 0.2

_LEDGER: Optional["ScheduleLedger"] = None
_RESOLVED = False
_RESOLVE_LOCK = threading.Lock()


def ledger() -> Optional["ScheduleLedger"]:
    """The process ledger when ``HVD_TPU_SCHEDULE_CHECK`` is on, else
    None. Resolved once; :func:`reset` re-reads the knob."""
    global _LEDGER, _RESOLVED
    if not _RESOLVED:
        with _RESOLVE_LOCK:
            if not _RESOLVED:
                from . import config as _config
                on = bool(_config.live_config().get(_config.SCHEDULE_CHECK))
                _LEDGER = ScheduleLedger() if on else None
                _RESOLVED = True
    return _LEDGER


def record(entry: tuple, pset=None) -> None:
    """Fingerprint one collective submission (called from
    ``collectives._record_round``). ``entry`` is the round-log tuple
    (kind, name, ...); ``pset`` the raw ``process_set`` argument. A
    no-op when the ledger is off."""
    led = _LEDGER if _RESOLVED else ledger()
    if led is not None:
        led.record(entry, pset)


def reset() -> None:
    """Withdraw this rank's published ledger and drop the local one,
    re-reading the knob — called from ``basics.shutdown()`` so an
    elastic reset starts its new generation at sequence 0 on every
    rank. The KV key is *deleted*, not flushed: a dead generation's
    ledger left behind would be diffed against the new generation's
    young ledgers and fabricate a divergence diagnostic. (A rank that
    crashes without running shutdown leaves its key until its respawn's
    first publish overwrites it — the stall warn deadline is far longer
    than that window.)"""
    global _LEDGER, _RESOLVED
    led = _LEDGER
    if led is not None:
        try:
            led.withdraw()
        except Exception:
            pass
    with _RESOLVE_LOCK:
        _LEDGER = None
        _RESOLVED = False
    # the SDC fingerprint client shares the teardown: a new generation
    # (possibly a new coordinator) must re-resolve the KV endpoint
    global _sdc_client, _sdc_client_resolved
    _sdc_client = None
    _sdc_client_resolved = False


def _rank_invariant_fields(entry: tuple) -> tuple:
    """The slice of a round-log entry every rank must agree on.
    Per-rank-legitimate fields are excluded: a ragged allgather's first
    dim and alltoallv's splits are *data*, not schedule."""
    kind = entry[0]
    if kind == "allgather":
        _, _name, shape, dtype = entry
        return (tuple(shape[1:]), dtype)
    if kind == "alltoall":
        _, _name, shape, dtype, _splits = entry
        return (tuple(shape[1:]), dtype)
    return tuple(entry[2:])


class ScheduleLedger:
    """Per-process rolling fingerprint of the submitted collective
    sequence, published through the rendezvous KV store."""

    def __init__(self):
        self._lock = _locks.lock("_schedule.ScheduleLedger._lock")
        self._seq = 0
        self._hash = hashlib.sha1(b"hvd-tpu-schedule").hexdigest()
        self._entries: "collections.deque" = collections.deque(
            maxlen=_DEPTH)
        self._last_publish = 0.0
        self._dirty = False
        self._client = None
        self._client_resolved = False

    # -- recording -----------------------------------------------------------
    def record(self, entry: tuple, pset=None) -> None:
        kind, name = entry[0], entry[1]
        pset_key = None if pset is None else getattr(
            pset, "cache_key", repr(pset))
        digest = hashlib.sha1(
            f"{kind}|{name}|{_rank_invariant_fields(entry)!r}|{pset_key!r}"
            .encode()).hexdigest()
        summary = f"{kind}({name!r})"
        with self._lock:
            self._seq += 1
            self._hash = hashlib.sha1(
                (self._hash + digest).encode()).hexdigest()
            self._entries.append((self._seq, summary, digest))
            self._dirty = True
            due = (time.monotonic() - self._last_publish
                   >= _PUBLISH_INTERVAL)
        if due:
            self.flush()

    def snapshot(self) -> dict:
        with self._lock:
            return {"n": self._seq, "hash": self._hash,
                    "entries": [list(e) for e in self._entries]}

    # -- KV publication ------------------------------------------------------
    def _kv_client(self):
        """A rendezvous KV client when the launcher's server is
        reachable from config, else None (single-process / no-launcher
        runs keep a local-only ledger)."""
        if not self._client_resolved:
            from . import config as _config
            from . import retry as _retry
            cfg = _config.live_config()
            addr = cfg.get(_config.RENDEZVOUS_ADDR)
            port = cfg.get(_config.RENDEZVOUS_PORT)
            if addr and port and int(port) > 0:
                from .runner.rendezvous import KVStoreClient
                # single attempt, short timeout — NOT the shared retry
                # policy (5 attempts x backoff): publishes run on the
                # collective submit path and diagnosis runs inside the
                # stall deadline, so a dead KV server must cost one
                # bounded probe, never a retry chain
                self._client = KVStoreClient(
                    addr, int(port), timeout=2.0,
                    retry=_retry.RetryPolicy(
                        max_attempts=1, initial_backoff=0.05,
                        max_backoff=0.1, deadline=2.0))
            self._client_resolved = True
        return self._client

    def _my_rank(self) -> int:
        return _env_rank()

    def flush(self, only_if_dirty: bool = False) -> None:
        """Publish the current snapshot (best-effort: a dead KV server
        must never fail a collective). ``only_if_dirty`` skips the PUT
        when nothing was recorded since the last publish — the stall
        inspector's periodic flush uses it so an idle rank stays
        silent."""
        client = self._kv_client()
        if client is None:
            return
        if only_if_dirty and not self._dirty:
            return
        snap = self.snapshot()
        snap["rank"] = self._my_rank()
        try:
            client.put("schedule", f"rank{snap['rank']}",
                       json.dumps(snap).encode())
            with self._lock:
                self._last_publish = time.monotonic()
                self._dirty = False
        except Exception:
            with self._lock:
                # back off: don't retry on every submission while the
                # server is unreachable (still dirty — the next window
                # or the stall-path flush tries again)
                self._last_publish = time.monotonic()

    def withdraw(self) -> None:
        """Delete this rank's published ledger (generation teardown)."""
        client = self._kv_client()
        if client is None:
            return
        try:
            client.delete("schedule", f"rank{self._my_rank()}")
        except Exception:
            pass

    def fetch_peers(self, world_size: int) -> Dict[int, dict]:
        client = self._kv_client()
        if client is None:
            return {}
        out: Dict[int, dict] = {}
        for r in range(world_size):
            try:
                raw = client.get("schedule", f"rank{r}")
            except Exception:
                raw = None
            if raw:
                try:
                    out[r] = json.loads(raw.decode())
                except (ValueError, UnicodeDecodeError):
                    pass
        return out


def diff_ledgers(ledgers: Dict[int, dict]) -> Optional[str]:
    """One-line diagnostic naming the first mismatched call site across
    per-rank ledgers, or None when the schedules agree."""
    if len(ledgers) < 2:
        return None
    ranks = sorted(ledgers)
    if len({(l.get("n"), l.get("hash")) for l in ledgers.values()}) == 1:
        return None
    by_seq: Dict[int, Dict[int, Tuple[str, str]]] = {}
    for r in ranks:
        by_seq[r] = {int(seq): (summary, digest)
                     for seq, summary, digest in
                     ledgers[r].get("entries", [])}
    max_n = max(int(l.get("n", 0)) for l in ledgers.values())
    for seq in range(1, max_n + 1):
        present = {r: by_seq[r][seq] for r in ranks if seq in by_seq[r]}
        if len({d for _s, d in present.values()}) > 1:
            a = min(present)
            sa, da = present[a]
            b = min(r for r in present if present[r][1] != da)
            sb = present[b][0]
            if sb == sa:
                return (f"collective schedule divergence at collective "
                        f"#{seq}: rank {b} submitted {sb} with different "
                        f"metadata (shape/dtype/op/process_set) than "
                        f"rank {a}")
            return (f"collective schedule divergence at collective "
                    f"#{seq}: rank {b} submitted {sb} where rank {a} "
                    f"submitted {sa}")
        ended = [r for r in ranks if int(ledgers[r].get("n", 0)) < seq]
        if ended and present:
            a = min(present)
            b = min(ended)
            return (f"collective schedule divergence: rank {b} stopped "
                    f"after {int(ledgers[b].get('n', 0))} collective(s); "
                    f"rank {a} submitted {present[a][0]} (collective "
                    f"#{seq}) with no counterpart on rank {b}")
    return ("collective schedule divergence before the retained ledger "
            "window (per-rank totals "
            + repr({r: int(ledgers[r].get("n", 0)) for r in ranks})
            + ") — enable the ledger earlier or raise its depth")


def divergence_hint(world=None) -> str:
    """Best-effort cross-rank diagnosis for the stall inspector: flush
    this rank's ledger, fetch every peer's, and name the first
    mismatched call site. Returns '' when the ledger is off, the KV
    store is unreachable, or the schedules agree. Never raises."""
    led = ledger()
    if led is None:
        return ""
    try:
        if world is None:
            from . import basics
            world = basics.world() if basics.is_initialized() else None
        size = world.size if world is not None else 0
        if size < 2:
            return ""
        led.flush()
        peers = led.fetch_peers(size)
        return diff_ledgers(peers) or ""
    except Exception:
        return ""


def flush_local() -> None:
    """Publish this rank's ledger when it has unpublished entries. The
    stall inspector calls this every poll, so a rank *blocked inside* a
    collective (whose rate-limited publish skipped the tail) becomes
    visible to its peers' diffs within one poll interval — otherwise a
    plain network stall would read as a false 'rank N stopped after M
    collective(s)' divergence."""
    led = _LEDGER if _RESOLVED else ledger()
    if led is not None:
        try:
            led.flush(only_if_dirty=True)
        except Exception:
            pass


def note_divergence() -> None:
    """Count one diagnosed divergence. Called by the stall inspector
    when a hint transitions from empty to set — NOT per hint refresh,
    so a stall persisting many warn windows still counts one event."""
    _M_DIVERGENCES.inc()


# ---------------------------------------------------------------------------
# SDC parameter fingerprints (sdc/fingerprint.py) ride the same KV scope as
# the collective ledger, under their own key prefix.
# ---------------------------------------------------------------------------

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
