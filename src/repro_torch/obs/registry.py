# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The metrics registry: counters, gauges and histograms with labels
(port of ``repro/obs/registry.py``).

Design constraints, in order:

  * **hot-path overhead ~ 0** — the serving stack records at *host-sync
    boundaries only* (end of a ``pipeline.run`` call, an autoscaler
    signals tick, a handoff edge — see ``repro_torch.obs.drain``), never
    per item and never inside the ingest step.  A single record is one
    dict lookup plus one uncontended lock'd add;
  * **lock-free snapshot reads** — ``snapshot()`` never takes the
    writer locks: it reads the child values under the GIL's load
    atomicity, so a scrape can run concurrently with producer threads
    without ever stalling the ingest loop;
  * **no dependencies** — Prometheus-style text exposition and a JSON
    snapshot are written by hand; the registry must work on the bare
    interpreter the benches run on.

The surface is deliberately a small subset of prometheus_client:
``registry.counter(name, help, labels)`` returns a *family*;
``family.labels(pod="3")`` returns the child you ``inc``/``set``/
``observe`` on.  Families are idempotent to re-register with the same
signature (modules instrument independently and meet in the default
registry) and a *conflicting* re-registration raises — two meanings for
one name is how dashboards lie.

``NullRegistry`` is the disabled form: the same surface, every
operation a no-op — the "bare" arm of ``benchmarks/obs_bench.py`` and
the escape hatch for perf-paranoid callers.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.concurrency import make_lock

# Prometheus' default duration buckets, in seconds — control-plane spans
# (admits, handoffs, checkpoint writes) land mid-range by design.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, float("inf"))

KINDS = ("counter", "gauge", "histogram")


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]
               ) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared labelnames "
            f"{sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Child:
    """One labeled series.  Writes take the family's lock (uncontended
    in practice — recording happens at control-plane cadence); reads
    (``value``/snapshot) never do."""

    __slots__ = ("_family", "_value")

    def __init__(self, family: "MetricFamily"):
        self._family = family
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    # counter / gauge ------------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        if self._family.kind == "counter" and amount < 0:
            raise ValueError(f"counter {self._family.name} cannot decrease "
                             f"(inc by {amount})")
        with self._family._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self._family.kind != "gauge":
            raise ValueError(f"{self._family.kind} {self._family.name} "
                             "cannot dec()")
        with self._family._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        if self._family.kind != "gauge":
            raise ValueError(f"{self._family.kind} {self._family.name} "
                             "cannot set()")
        with self._family._lock:
            self._value = float(value)


class _HistChild:
    """One labeled histogram series: bucket counts + sum + count."""

    __slots__ = ("_family", "counts", "sum", "count")

    def __init__(self, family: "MetricFamily"):
        self._family = family
        self.counts = [0] * len(family.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._family._lock:
            for i, bound in enumerate(self._family.buckets):
                if value <= bound:
                    self.counts[i] += 1
                    break
            self.sum += float(value)
            self.count += 1


class MetricFamily:
    """A named metric with fixed label names; children per label tuple."""

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        if kind not in KINDS:
            raise ValueError(f"kind {kind!r} not one of {KINDS}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if kind == "histogram" else ()
        self._lock = make_lock("MetricFamily._lock")
        self._children: Dict[Tuple[str, ...], object] = {}

    def signature(self) -> Tuple:
        return (self.kind, self.labelnames, self.buckets)

    def labels(self, **labels: str):
        key = _label_key(self.labelnames, labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = (_HistChild(self) if self.kind == "histogram"
                             else _Child(self))
                    self._children[key] = child
        return child

    # unlabeled convenience: family.inc() == family.labels().inc()
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def series(self) -> Iterator[Tuple[Tuple[str, ...], object]]:
        # snapshot of the key set; values read without the lock (GIL)
        for key in list(self._children):
            yield key, self._children[key]


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    """A point-in-time copy of every series — plain data, JSON-stable.

    ``families`` is a list of dicts::

        {"name", "kind", "help", "labelnames", "buckets"?, "series":
         [{"labels": {..}, "value": f}                      # counter/gauge
          {"labels": {..}, "sum": f, "count": n, "counts": [..]}]}  # hist
    """

    families: List[dict]

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps({"families": self.families}, indent=indent,
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "MetricsSnapshot":
        return cls(families=json.loads(text)["families"])

    def get(self, name: str, /, **labels) -> Optional[float]:
        """Value of one counter/gauge series (None when absent).
        (``name`` is positional-only: span metrics label on ``name=``.)"""
        for fam in self.families:
            if fam["name"] != name:
                continue
            for s in fam["series"]:
                if s["labels"] == {k: str(v) for k, v in labels.items()}:
                    return s.get("value", s.get("sum"))
        return None

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        out: List[str] = []
        for fam in self.families:
            name, kind = fam["name"], fam["kind"]
            if fam["help"]:
                out.append(f"# HELP {name} {fam['help']}")
            out.append(f"# TYPE {name} {kind}")
            for s in fam["series"]:
                lbl = _fmt_labels(s["labels"])
                if kind == "histogram":
                    acc = 0
                    for bound, c in zip(fam["buckets"], s["counts"]):
                        acc += c
                        # snapshots store +inf as 1e308 (strict JSON)
                        le = "+Inf" if bound >= 1e308 else repr(bound)
                        out.append(f"{name}_bucket"
                                   f"{_fmt_labels(s['labels'], le=le)} {acc}")
                    out.append(f"{name}_sum{lbl} {_fmt_num(s['sum'])}")
                    out.append(f"{name}_count{lbl} {s['count']}")
                else:
                    out.append(f"{name}{lbl} {_fmt_num(s['value'])}")
        return "\n".join(out) + "\n"


def _fmt_num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _fmt_labels(labels: Dict[str, str], **extra: str) -> str:
    items = {**labels, **extra}
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items.items())
    return "{" + body + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


class MetricsRegistry:
    """Create-or-get metric families; snapshot them without blocking."""

    def __init__(self):
        self._families: Dict[str, MetricFamily] = {}
        self._lock = make_lock("MetricsRegistry._lock")
        # cumulative-counter drain baselines (repro_torch.obs.drain) live on
        # the registry so a fresh registry starts with fresh baselines
        self.drain_baselines: Dict[Tuple, float] = {}

    @property
    def enabled(self) -> bool:
        return True

    def _family(self, name: str, kind: str, help: str,
                labelnames: Sequence[str],
                buckets: Sequence[float] = DEFAULT_BUCKETS) -> MetricFamily:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = MetricFamily(name, kind, help, labelnames, buckets)
                    self._families[name] = fam
                    return fam
        want = (kind, tuple(labelnames),
                tuple(buckets) if kind == "histogram" else ())
        if fam.signature() != want:
            raise ValueError(
                f"metric {name!r} already registered as {fam.signature()}, "
                f"requested {want}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> MetricFamily:
        return self._family(name, "histogram", help, labels, buckets)

    # ---------------------------------------------------------------- reads
    def snapshot(self) -> MetricsSnapshot:
        """Copy every series; takes NO lock — safe to call from a scrape
        thread while producers record."""
        fams = []
        for name in sorted(self._families):
            fam = self._families[name]
            series = []
            for key, child in fam.series():
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    series.append({"labels": labels, "sum": child.sum,
                                   "count": child.count,
                                   "counts": list(child.counts)})
                else:
                    series.append({"labels": labels, "value": child.value})
            series.sort(key=lambda s: sorted(s["labels"].items()))
            entry = {"name": fam.name, "kind": fam.kind, "help": fam.help,
                     "labelnames": list(fam.labelnames), "series": series}
            if fam.kind == "histogram":
                entry["buckets"] = [b if b != float("inf") else 1e308
                                    for b in fam.buckets]
            fams.append(entry)
        return MetricsSnapshot(families=fams)

    def to_prometheus(self) -> str:
        return self.snapshot().to_prometheus()


class _NullSeries:
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def labels(self, **labels) -> "_NullSeries":
        return self

    value = 0.0


class NullRegistry:
    """Same surface as :class:`MetricsRegistry`; records nothing.

    Pass this (``repro_torch.obs.NULL``) as the ``metrics``/``registry``
    argument to switch a component's telemetry off entirely — the
    "bare" arm of the overhead bench.
    """

    _series = _NullSeries()

    enabled = False
    drain_baselines: Dict[Tuple, float] = {}

    def counter(self, name, help="", labels=()):
        return self._series

    def gauge(self, name, help="", labels=()):
        return self._series

    def histogram(self, name, help="", labels=(), buckets=DEFAULT_BUCKETS):
        return self._series

    def snapshot(self) -> MetricsSnapshot:
        return MetricsSnapshot(families=[])

    def to_prometheus(self) -> str:
        return ""


NULL = NullRegistry()

_DEFAULT = MetricsRegistry()


def get_registry(registry=None):
    """Resolve ``None`` to the process-default registry."""
    return _DEFAULT if registry is None else registry


def reset_default_registry() -> MetricsRegistry:
    """Swap in a fresh default registry (tests/benches isolation)."""
    global _DEFAULT
    _DEFAULT = MetricsRegistry()
    return _DEFAULT
