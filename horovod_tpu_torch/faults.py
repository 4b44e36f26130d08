"""Deterministic fault injection for horovod_tpu_torch (a copy of
``horovod_tpu/faults.py``: the same sites, spec grammar, messages and
exit code, so one ``HVD_TPU_FAULT_SPEC`` drives both packages).

The elastic recovery machinery (stall shutdown -> blacklist ->
re-rendezvous, reference horovod/common/elastic.py:147-168 +
stall_inspector.cc:31-90) only earns trust if its failure paths can be
exercised on demand, repeatably, without actually pulling network cables.
This module is a process-wide registry of *named injection sites*
(:class:`FaultPoint`) driven by one environment knob:

    HVD_TPU_FAULT_SPEC="rendezvous.get:error:rate=0.3;worker.step:crash:step=12"
    HVD_TPU_FAULT_SEED=7

Grammar — ``;``-separated entries, each ``site:field[:field...]``:

* **site** matches a fault point exactly, or as a dot-boundary prefix
  (``rendezvous`` matches ``rendezvous.get`` and ``rendezvous.put``;
  ``collective`` matches every verb).
* one field names the **kind**:
  - ``error``      raise the site's characteristic exception (a transient
                   socket-shaped error at host-plane I/O sites, an
                   internal error at collective sites);
  - ``neterror``   always raise :class:`InjectedTransientFault`
                   (exercises retry paths regardless of the site default);
  - ``delay=S``    sleep ``S`` seconds (latency / congestion);
  - ``hang[=S]``   sleep ``S`` (default effectively forever) — what the
                   stall inspector exists to catch;
  - ``crash``      ``os._exit`` — a hard worker kill, the elastic
                   driver's recovery scenario.
  - ``bitflip``    XOR one mantissa/exponent bit in one tensor leaf —
                   silent data corruption, delivered through the site's
                   ``corrupt`` handler (data-carrying sites only);
  - ``nan``        overwrite one element of one leaf with NaN — the
                   soft-SDC variant of ``bitflip``, same delivery.
* remaining ``k=v`` fields scope the rule:
  - ``rate=P``     fire with probability P per hit (default 1.0);
  - ``after=N``    ignore the first N hits of the point;
  - ``step=N``     fire exactly on hit N (1-based) — e.g. crash on the
                   12th ``worker.step`` (one hit per ``State.commit()``),
                   or ``worker.mesh:crash:step=N:rank=R`` to hard-kill
                   rank R mid-sharded-step (one hit per
                   ``parallel.train.run_mesh_step``) — the mesh-aware
                   recovery drill (docs/elastic.md);
  - ``times=N`` / ``once``  cap total injections for the rule;
  - ``rank=R``     only inject on the process whose rank is R.

**Determinism.** Every probabilistic decision comes from a
``random.Random`` seeded by ``(HVD_TPU_FAULT_SEED, rule text, site)`` —
string-seeded, so it is stable across processes and runs (Python's
``hash()`` salting never enters). Given the same seed and the same
sequence of hits at a site, the same faults fire. Each
:class:`FaultPoint` owns a private copy of each matching rule's counters
and RNG, so two points matched by one prefix rule cannot perturb each
other's schedules.

**Zero overhead when off.** With no spec configured, ``fire()`` is one
module-global load and one ``is None`` test. Nothing is parsed, no RNG
exists, no lock is taken.

Tests (and only tests) reconfigure in-process via :func:`configure`;
production processes parse the env exactly once, on the first hit of any
fault point, and a re-exec'd elastic worker re-parses naturally in its
fresh interpreter.
"""

import logging
import os
import random
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from . import config as _config
from . import metrics as _metrics

log = logging.getLogger("horovod_tpu_torch.faults")

_M_INJECTED = _metrics.counter(
    "hvd_tpu_faults_injected_total",
    "Faults injected by the HVD_TPU_FAULT_SPEC harness, by site and kind.",
    labels=("site", "kind"))

#: exit code used by ``crash`` faults — distinct from common exit codes so
#: a chaos harness can tell an injected kill from an organic failure.
CRASH_EXIT_CODE = 29

_KINDS = ("error", "neterror", "delay", "hang", "crash", "preempt",
          "bitflip", "nan")


class InjectedFault(RuntimeError):
    """Generic injected failure (collective/internal sites). RuntimeError,
    so the dispatcher classifies it fatal and surfaces it as
    HorovodInternalError — the elastic retry loop's recovery trigger."""


class InjectedTransientFault(ConnectionError):
    """Injected transient failure (host-plane I/O sites). ConnectionError,
    so a retry layer (the JAX package's ``retry``) classifies it
    transient and the hardened call sites absorb it."""


class FaultSpecError(ValueError):
    """HVD_TPU_FAULT_SPEC could not be parsed."""


class _Rule:
    """One parsed spec entry (site prefix + kind + scoping params)."""

    __slots__ = ("site", "kind", "seconds", "rate", "after", "step",
                 "times", "rank", "grace", "text", "index")

    def __init__(self, site: str, kind: str, seconds: float, rate: float,
                 after: int, step: Optional[int], times: Optional[int],
                 rank: Optional[int], grace: float, text: str, index: int):
        self.site = site
        self.kind = kind
        self.seconds = seconds
        self.rate = rate
        self.after = after
        self.step = step
        self.times = times
        self.rank = rank
        self.grace = grace
        self.text = text
        self.index = index

    def matches(self, site: str) -> bool:
        return site == self.site or site.startswith(self.site + ".")


class _BoundRule:
    """A rule bound to ONE fault point: private hit/injection counters and
    a private deterministic RNG, so prefix rules matched by several points
    keep independent, reproducible schedules."""

    __slots__ = ("rule", "hits", "injected", "rng")

    def __init__(self, rule: _Rule, seed: int, site: str):
        self.rule = rule
        self.hits = 0
        self.injected = 0
        # string seeding goes through SHA-512 in CPython — stable across
        # processes and runs, unlike object hash()
        self.rng = random.Random(f"{seed}|{rule.index}|{rule.text}|{site}")

    def decide(self) -> bool:
        r = self.rule
        self.hits += 1
        if r.times is not None and self.injected >= r.times:
            return False
        if r.rank is not None and _current_rank() != r.rank:
            return False
        if r.step is not None:
            fire = self.hits == r.step
        else:
            if self.hits <= r.after:
                return False
            fire = r.rate >= 1.0 or self.rng.random() < r.rate
        if fire:
            self.injected += 1
        return fire


def _parse_entry(entry: str, index: int) -> _Rule:
    fields = [f.strip() for f in entry.split(":")]
    if len(fields) < 2 or not fields[0]:
        raise FaultSpecError(
            f"fault spec entry {entry!r}: want site:kind[:param=value...]")
    site = fields[0]
    kind = None
    seconds = 0.0
    rate = 1.0
    after = 0
    grace = 0.0
    step = times = rank = None
    for field in fields[1:]:
        key, eq, value = field.partition("=")
        if not eq:
            if key == "once":
                times = 1
            elif key in ("error", "neterror", "crash", "preempt",
                         "bitflip", "nan"):
                kind = key
            elif key == "hang":
                kind, seconds = "hang", 1e9
            else:
                raise FaultSpecError(
                    f"fault spec entry {entry!r}: unknown field {field!r}")
            continue
        try:
            if key in ("delay", "hang"):
                kind, seconds = key, float(value)
            elif key == "rate":
                rate = float(value)
            elif key == "after":
                after = int(value)
            elif key == "step":
                step = int(value)
            elif key == "times":
                times = int(value)
            elif key == "rank":
                rank = int(value)
            elif key == "grace":
                grace = float(value)
            else:
                raise FaultSpecError(
                    f"fault spec entry {entry!r}: unknown param {key!r}")
        except ValueError as e:
            if isinstance(e, FaultSpecError):
                raise
            raise FaultSpecError(
                f"fault spec entry {entry!r}: bad value for {key!r}") from e
    if kind is None:
        raise FaultSpecError(
            f"fault spec entry {entry!r}: no kind among {_KINDS}")
    return _Rule(site, kind, seconds, rate, after, step, times, rank,
                 grace, entry, index)


def parse_spec(spec: str) -> List[_Rule]:
    return [_parse_entry(e.strip(), i)
            for i, e in enumerate(spec.split(";")) if e.strip()]


class _FaultRegistry:
    #: gen rides ON the registry (not a separate module global) so a
    #: FaultPoint reading one _ACTIVE reference always sees a consistent
    #: (rules, seed, gen) triple — two separate globals could be observed
    #: mid-configure and bind an old spec under a new generation number.
    __slots__ = ("rules", "seed", "gen")

    def __init__(self, rules: Sequence[_Rule], seed: int, gen: int):
        self.rules = tuple(rules)
        self.seed = seed
        self.gen = gen


_lock = threading.Lock()
#: None = injection off. Checked unlocked on the hot path; configure()
#: publishes a fully built registry in one reference assignment.
_ACTIVE: Optional[_FaultRegistry] = None
#: bumped on every configure(); FaultPoints cache bound rules per generation
_GEN = 0
_configured = False


def configure(spec: Optional[str] = None, seed: Optional[int] = None) -> None:
    """(Re)build the process-wide registry. With no arguments, reads
    ``HVD_TPU_FAULT_SPEC`` / ``HVD_TPU_FAULT_SEED`` through the knob
    registry. An empty spec disables injection entirely."""
    global _ACTIVE, _GEN, _configured
    cfg = _config.Config()
    if spec is None:
        spec = cfg.get(_config.FAULT_SPEC)
    if seed is None:
        seed = cfg.get(_config.FAULT_SEED)
    rules = parse_spec(spec or "")
    with _lock:
        _GEN += 1
        _ACTIVE = _FaultRegistry(rules, int(seed), _GEN) if rules else None
        _configured = True
    if rules:
        log.warning("fault injection ACTIVE (%d rule(s), seed=%s): %s",
                    len(rules), seed, spec)


def ensure_configured() -> None:
    """Parse the env spec once — called from ``basics.init()`` so a
    malformed ``HVD_TPU_FAULT_SPEC`` fails fast as a startup
    :class:`FaultSpecError` instead of surfacing at the first fault
    point mid-training (where the elastic loop would classify it
    recoverable and spin restore->fail forever). Deliberately does NOT
    rebuild an already-configured registry: an in-process elastic reset
    (``shutdown(); init()``) must keep the hit counters, or ``once``
    faults would re-fire every generation."""
    if not _configured:
        configure()


def enabled() -> bool:
    ensure_configured()
    return _ACTIVE is not None


def _current_rank() -> int:
    from . import basics
    if basics.is_initialized():
        return basics.rank()
    try:
        return int(os.environ.get("HVD_TPU_RANK") or -1)
    except ValueError:
        return -1


class FaultPoint:
    """One named injection site. Construct once (module/instance scope) and
    call :meth:`fire` on the guarded path; :meth:`check` is the no-raise
    variant for owners that map an ``error`` fault onto a domain-specific
    failure (e.g. the stall inspector's deadline flag).

    ``exc``: exception class raised for ``error`` faults at this site —
    the site owner declares what a fault *looks like* there (a rendezvous
    fault is a socket error; a collective fault is an internal error).
    """

    __slots__ = ("site", "_exc", "_bound", "_gen", "_lock")

    def __init__(self, site: str, exc: Callable[[str], BaseException] =
                 InjectedFault):
        self.site = site
        self._exc = exc
        self._bound: Tuple[_BoundRule, ...] = ()
        self._gen = -1
        self._lock = threading.Lock()

    def _resolve(self, reg: _FaultRegistry) -> Tuple[_BoundRule, ...]:
        if self._gen != reg.gen:
            with self._lock:
                if self._gen != reg.gen:
                    self._bound = tuple(
                        _BoundRule(r, reg.seed, self.site)
                        for r in reg.rules if r.matches(self.site))
                    self._gen = reg.gen
        return self._bound

    def fire(self, crash: Optional[Callable[[], None]] = None,
             preempt: Optional[Callable[[float], None]] = None,
             corrupt: Optional[Callable[[str, random.Random], None]] = None
             ) -> None:
        """Inject any matching faults; raises / sleeps / exits per kind.

        ``crash``: optional site-owned substitute for ``os._exit`` on
        ``crash`` faults. A worker-side site has nothing gentler than a
        hard process kill, but a *launcher*-side site (the rendezvous
        server) must simulate its component dying without taking the
        whole job control plane down with it — the owner passes the
        simulation (e.g. ``KVStoreServer._simulate_crash``) here.

        ``preempt``: site-owned delivery of a preemption *notice* on
        ``preempt`` faults — called with the rule's ``grace`` seconds.
        Unlike every other kind this one doesn't fail anything: it
        simulates the fleet scheduler announcing a reclaim, and the
        owner forwards it into the graceful-drain path. A site without
        a handler ignores the rule (notice kinds only mean something
        where a notice channel exists).

        ``corrupt``: site-owned delivery of silent data corruption on
        ``bitflip``/``nan`` faults — called with the kind and the bound
        rule's deterministic RNG so the owner picks the leaf/bit/element
        reproducibly. Like ``preempt`` this doesn't raise: SDC is by
        definition silent, the poisoned value flows onward until a guard
        catches it. A site without a handler ignores the rule (only
        data-carrying sites can be corrupted).
        """
        if _ACTIVE is None and _configured:
            return  # hot path: injection off
        err = self._evaluate(crash=crash, preempt=preempt, corrupt=corrupt)
        if err is not None:
            raise err

    def check(self) -> bool:
        """Like :meth:`fire`, but an ``error``/``neterror`` fault is
        *returned* as True instead of raised — for sites that translate an
        injected fault into their own failure mode."""
        if _ACTIVE is None and _configured:
            return False
        return self._evaluate() is not None

    def _evaluate(self, crash: Optional[Callable[[], None]] = None,
                  preempt: Optional[Callable[[float], None]] = None,
                  corrupt: Optional[Callable[[str, random.Random], None]]
                  = None) -> Optional[BaseException]:
        if not _configured:
            configure()
        reg = _ACTIVE   # one read: rules + seed + gen stay consistent
        if reg is None:
            return None
        err: Optional[BaseException] = None
        for bound in self._resolve(reg):
            with self._lock:
                fire = bound.decide()
            if not fire:
                continue
            rule = bound.rule
            _M_INJECTED.labels(site=self.site, kind=rule.kind).inc()
            log.warning("fault injected: site=%s kind=%s (rule %r, hit %d)",
                        self.site, rule.kind, rule.text, bound.hits)
            if rule.kind in ("delay", "hang"):
                time.sleep(rule.seconds)
            elif rule.kind == "preempt":
                if preempt is not None:
                    preempt(rule.grace)
                else:
                    log.warning(
                        "preempt fault matched site %s but the site has "
                        "no notice handler; ignoring", self.site)
            elif rule.kind in ("bitflip", "nan"):
                if corrupt is not None:
                    corrupt(rule.kind, bound.rng)
                else:
                    log.warning(
                        "%s fault matched site %s but the site has no "
                        "corrupt handler; ignoring", rule.kind, self.site)
            elif rule.kind == "crash":
                if crash is not None:
                    crash()
                    continue
                import sys
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(CRASH_EXIT_CODE)
            elif rule.kind == "neterror":
                err = InjectedTransientFault(
                    f"injected transient fault at {self.site} "
                    f"(rule {rule.text!r})")
            else:  # error
                err = self._exc(
                    f"injected fault at {self.site} (rule {rule.text!r})")
        return err
