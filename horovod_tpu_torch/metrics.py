"""Metrics registry of horovod_tpu_torch (counterpart of the registry in
``horovod_tpu/metrics.py``).

A thread-safe registry of counters, gauges and fixed-bucket histograms,
with the JAX package's family names, labels, text exposition and
snapshot form, so both packages export the same series. Only the
registry is here, in the pure-Python form (the JAX package's cells may be
backed by its native runtime, which the port does not have); the HTTP
exporter and the cross-rank summary come with the port's serving plane.

Read paths: :func:`snapshot` (a plain dict of every series, sorted) and
:func:`render_prometheus` (text format 0.0.4). The registry is
process-global and survives ``shutdown()``/``init()`` cycles.
"""

import bisect
from typing import Dict, Iterable, Optional, Sequence, Tuple

from . import _locks

#: Default latency buckets in seconds: 100us .. 10s, roughly logarithmic
#: (Prometheus client default buckets).
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    """Prometheus number formatting: integral values without the '.0'."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


class _Cell:
    """One scalar sample (counter or gauge): a float under a mutex."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = _locks.lock("metrics._Cell._lock")
        self._v = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    def get(self) -> float:
        with self._lock:
            return self._v


class Counter:
    """Monotonic counter child. ``inc(n)`` only; negative increments raise
    (Prometheus counter semantics)."""

    __slots__ = ("_cell", "_registry")

    def __init__(self, registry: "Registry"):
        self._registry = registry
        self._cell = _Cell()

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        if amount < 0:
            raise ValueError("counters can only increase; use a gauge")
        self._cell.inc(amount)

    def get(self) -> float:
        return self._cell.get()


class Gauge:
    """Settable gauge child."""

    __slots__ = ("_cell", "_registry")

    def __init__(self, registry: "Registry"):
        self._registry = registry
        self._cell = _Cell()

    def set(self, value: float) -> None:
        if not self._registry.enabled:
            return
        self._cell.set(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        self._cell.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def get(self) -> float:
        return self._cell.get()


class Histogram:
    """Fixed-bucket histogram child. Buckets are upper bounds (``le``);
    an implicit ``+Inf`` bucket closes the distribution."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count",
                 "_registry", "_exemplar")

    def __init__(self, registry: "Registry", buckets: Sequence[float]):
        self._registry = registry
        self._bounds = tuple(sorted(float(b) for b in buckets))
        if not self._bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = _locks.lock("metrics.Histogram._lock")
        self._counts = [0] * (len(self._bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._exemplar = None

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        if not self._registry.enabled:
            return
        v = float(value)
        if exemplar:
            # the most recent traced observation (a debugging handle; the
            # text exposition stays 0.0.4)
            self._exemplar = (str(exemplar), v)
        idx = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def exemplar(self) -> Optional[Tuple[str, float]]:
        """(trace id, observed value) of the most recent observation
        that carried one, or None."""
        return self._exemplar

    def read(self) -> Tuple[Tuple[int, ...], float, int]:
        """(per-bucket counts incl. +Inf, sum, count) — non-cumulative."""
        with self._lock:
            return tuple(self._counts), self._sum, self._count

    @property
    def buckets(self) -> Tuple[float, ...]:
        return self._bounds

    def value(self) -> dict:
        """Snapshot form: cumulative Prometheus-style buckets."""
        counts, total_sum, total = self.read()
        acc = 0
        buckets = {}
        for b, c in zip(self._bounds, counts):
            acc += c
            buckets[_fmt(b)] = acc
        buckets["+Inf"] = total
        return {"buckets": buckets, "sum": total_sum, "count": total}


class Family:
    """A named metric family: one Prometheus name + help + type, with
    children per label-value combination (no labels = one anonymous
    child). ``labels()`` caches children, so steady-state lookups are one
    dict hit."""

    def __init__(self, registry: "Registry", name: str, help: str,
                 kind: str, labelnames: Tuple[str, ...] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.kind = kind            # "counter" | "gauge" | "histogram"
        self.labelnames = labelnames
        self._buckets = tuple(sorted(float(b) for b in buckets)) if buckets \
            else (DEFAULT_LATENCY_BUCKETS if kind == "histogram" else None)
        self._registry = registry
        self._lock = _locks.lock("metrics.Family._lock")
        self._children: Dict[Tuple[str, ...], object] = {}
        if not labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        if self.kind == "counter":
            return Counter(self._registry)
        if self.kind == "gauge":
            return Gauge(self._registry)
        return Histogram(self._registry, self._buckets)

    def labels(self, **labelvalues: str):
        """Child for one label-value combination (created on first use)."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} takes labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._children[key] = self._make_child()
        return child

    # unlabeled convenience: family behaves as its single child --------------
    def inc(self, amount: float = 1.0) -> None:
        self._children[()].inc(amount)

    def set(self, value: float) -> None:
        self._children[()].set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._children[()].dec(amount)

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        self._children[()].observe(value, exemplar=exemplar)

    def get(self):
        return self._children[()].get()

    def children(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    def series_name(self, key: Tuple[str, ...]) -> str:
        if not key:
            return self.name
        inner = ",".join(
            f'{n}="{_escape_label(v)}"'
            for n, v in zip(self.labelnames, key))
        return f"{self.name}{{{inner}}}"


class Registry:
    """Thread-safe collection of metric families.

    ``enabled`` gates every write: a disabled registry
    costs one attribute check per instrumentation point. Registration is
    idempotent by name — re-registering returns the existing family, so
    module reloads and repeated ``init()`` cycles share one set of cells
    (the reference keeps its timeline/stall state process-global the same
    way)."""

    def __init__(self):
        self.enabled = True
        self._lock = _locks.lock("metrics.Registry._lock")
        self._families: Dict[str, Family] = {}

    def _register(self, name: str, help: str, kind: str,
                  labels: Tuple[str, ...], buckets=None) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}")
                if kind == "histogram":
                    want = tuple(sorted(float(b) for b in buckets)) \
                        if buckets else DEFAULT_LATENCY_BUCKETS
                    if want != fam._buckets:
                        # silently returning the old layout would file
                        # the caller's observations into wrong buckets
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"buckets {fam._buckets}, not {want}")
                return fam
            fam = Family(self, name, help, kind, tuple(labels),
                         buckets=buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._register(name, help, "counter", tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._register(name, help, "gauge", tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Family:
        return self._register(name, help, "histogram", tuple(labels),
                              buckets=buckets)

    def families(self) -> Iterable[Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def snapshot(self) -> Dict[str, object]:
        """Plain dict of every series: scalar floats for counters/gauges,
        ``{"buckets": {le: cumulative}, "sum": s, "count": n}`` for
        histograms. Keys are full series names (labels rendered
        Prometheus-style) in deterministic sorted order."""
        out: Dict[str, object] = {}
        for fam in self.families():
            for key, child in fam.children():
                name = fam.series_name(key)
                if fam.kind == "histogram":
                    out[name] = child.value()
                else:
                    out[name] = child.get()
        return dict(sorted(out.items()))

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.children():
                labelpairs = list(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    counts, total_sum, total = child.read()
                    acc = 0
                    for b, c in zip(child.buckets, counts):
                        acc += c
                        le = labelpairs + [("le", _fmt(b))]
                        inner = ",".join(
                            f'{n}="{_escape_label(str(v))}"'
                            for n, v in le)
                        lines.append(
                            f"{fam.name}_bucket{{{inner}}} {acc}")
                    inner = ",".join(
                        f'{n}="{_escape_label(str(v))}"'
                        for n, v in labelpairs + [("le", "+Inf")])
                    lines.append(f"{fam.name}_bucket{{{inner}}} {total}")
                    suffix = ""
                    if labelpairs:
                        suffix = "{" + ",".join(
                            f'{n}="{_escape_label(str(v))}"'
                            for n, v in labelpairs) + "}"
                    lines.append(f"{fam.name}_sum{suffix} {_fmt(total_sum)}")
                    lines.append(f"{fam.name}_count{suffix} {total}")
                else:
                    lines.append(
                        f"{fam.series_name(key)} {_fmt(child.get())}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every family (tests only — production counters are
        monotonic for the life of the process)."""
        with self._lock:
            self._families.clear()


#: The process-global default registry every subsystem instruments.
REGISTRY = Registry()


def counter(name: str, help: str = "", labels: Sequence[str] = ()) -> Family:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Family:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> Family:
    return REGISTRY.histogram(name, help, labels, buckets=buckets)


def snapshot() -> Dict[str, object]:
    """Every series of the default registry as a plain dict."""
    return REGISTRY.snapshot()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()
