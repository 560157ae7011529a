"""Process-wide metrics registry with Prometheus text exposition (mirror
of ``megatron_llm_tpu/obs/registry.py``).

A deliberately small, stdlib-only subset of the Prometheus client model:

- ``Counter`` / ``Gauge`` / ``Histogram`` primitives with optional labels
  (one child per label-value tuple), created get-or-create by name so
  call sites can say ``REGISTRY.counter("x_total").inc()`` without
  module-level wiring.
- ``register_collector(name, fn)`` for subsystems that already keep
  their own lock-guarded state (``ServingMetrics``, ``EventCounters``):
  ``fn`` is called at scrape time and returns ``MetricFamily`` rows.
  Registration replaces any previous collector under the same name —
  tests and benches construct fresh ``ServingMetrics`` freely, and the
  newest instance is the one that should be scraped.
- ``prometheus_text()`` renders the 0.0.4 text exposition format
  (``# HELP`` / ``# TYPE`` + samples).  Reservoir histograms from
  ``serving/metrics.py`` export as *summaries* (``{quantile="0.5"}``
  samples plus ``_sum`` / ``_count``) since their percentiles are
  computed host-side over a bounded window; the ``Histogram`` primitive
  here exports classic cumulative ``_bucket{le=...}`` rows.

The global ``REGISTRY`` is what ``GET /metrics?format=prometheus``
serves.  The pre-existing JSON ``/metrics`` shape is untouched.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..analysis.sanitizers import make_lock

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

_DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


@dataclass
class Sample:
    """One exposition row: ``<family.name><suffix>{labels} value``."""

    suffix: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    value: float = 0.0


@dataclass
class MetricFamily:
    """A named metric with its type, help string, and sample rows."""

    name: str
    mtype: str  # "counter" | "gauge" | "histogram" | "summary" | "untyped"
    help: str = ""
    samples: List[Sample] = field(default_factory=list)

    def add(self, value: float, suffix: str = "",
            labels: Optional[Dict[str, str]] = None) -> "MetricFamily":
        self.samples.append(Sample(suffix, dict(labels or {}), value))
        return self


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name: {name!r}")
    return name


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]
               ) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared label names "
            f"{sorted(labelnames)}")
    return tuple(str(labels[k]) for k in labelnames)


class _Metric:
    """Shared machinery: per-label-tuple children behind one lock."""

    mtype = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = _check_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name: {ln!r}")
        self._lock = make_lock("obs.metric")
        self._children: Dict[Tuple[str, ...], object] = {}

    def _child(self, labels: Dict[str, str]):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def labels(self, **labels: str):
        return self._child(labels)

    def _rows(self) -> List[Tuple[Dict[str, str], object]]:
        with self._lock:
            if not self.labelnames and not self._children:
                # an unlabeled metric that was never touched still exports
                # its zero value (Prometheus best practice for counters)
                self._children[()] = self._new_child()
            return [(dict(zip(self.labelnames, key)), child)
                    for key, child in sorted(self._children.items())]

    def _new_child(self):
        raise NotImplementedError


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = make_lock("obs.metric.child")
        self._value = 0.0

    def inc(self, by: float = 1.0) -> None:
        if by < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Metric):
    """Monotonically increasing value; name should end in ``_total``."""

    mtype = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, by: float = 1.0, **labels: str) -> None:
        self._child(labels).inc(by)

    def value(self, **labels: str) -> float:
        return self._child(labels).value

    def collect(self) -> MetricFamily:
        fam = MetricFamily(self.name, self.mtype, self.help)
        for labels, child in self._rows():
            fam.add(child.value, labels=labels)
        return fam


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = make_lock("obs.metric.child")
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += by

    def dec(self, by: float = 1.0) -> None:
        self.inc(-by)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    """A value that can go up and down."""

    mtype = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float, **labels: str) -> None:
        self._child(labels).set(value)

    def inc(self, by: float = 1.0, **labels: str) -> None:
        self._child(labels).inc(by)

    def dec(self, by: float = 1.0, **labels: str) -> None:
        self._child(labels).dec(by)

    def value(self, **labels: str) -> float:
        return self._child(labels).value

    def collect(self) -> MetricFamily:
        fam = MetricFamily(self.name, self.mtype, self.help)
        for labels, child in self._rows():
            fam.add(child.value, labels=labels)
        return fam


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Tuple[float, ...]):
        self._lock = make_lock("obs.metric.child")
        self._buckets = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            # per-bucket counts; collect() cumulates at export time
            for i, ub in enumerate(self._buckets):
                if value <= ub:
                    self._counts[i] += 1
                    break

    def state(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count


class Histogram(_Metric):
    """Classic cumulative-bucket histogram (``_bucket{le=...}`` rows)."""

    mtype = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float, **labels: str) -> None:
        self._child(labels).observe(value)

    def collect(self) -> MetricFamily:
        fam = MetricFamily(self.name, self.mtype, self.help)
        for labels, child in self._rows():
            counts, total, count = child.state()
            cum = 0
            for ub, c in zip(self.buckets, counts):
                cum += c
                fam.add(cum, "_bucket", {**labels, "le": _fmt_float(ub)})
            fam.add(count, "_bucket", {**labels, "le": "+Inf"})
            fam.add(total, "_sum", labels)
            fam.add(count, "_count", labels)
        return fam


def summary_family(name: str, help: str, *, count: int, total: float,
                   quantiles: Dict[float, float],
                   labels: Optional[Dict[str, str]] = None) -> MetricFamily:
    """Build a summary-style family from pre-computed percentiles.

    The serving reservoir histograms compute nearest-rank percentiles
    host-side over a bounded window; Prometheus models exactly that as a
    *summary* (client-computed quantiles), not a histogram."""
    fam = MetricFamily(_check_name(name), "summary", help)
    base = dict(labels or {})
    for q, v in sorted(quantiles.items()):
        fam.add(v, "", {**base, "quantile": _fmt_float(q)})
    fam.add(total, "_sum", base)
    fam.add(count, "_count", base)
    return fam


def _fmt_float(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _render_family(fam: MetricFamily, lines: List[str]) -> None:
    if fam.help:
        lines.append(f"# HELP {fam.name} " +
                     fam.help.replace("\\", r"\\").replace("\n", r"\n"))
    lines.append(f"# TYPE {fam.name} {fam.mtype}")
    for s in fam.samples:
        label_str = ""
        if s.labels:
            inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                             for k, v in s.labels.items())
            label_str = "{" + inner + "}"
        lines.append(f"{fam.name}{s.suffix}{label_str} {_fmt_float(s.value)}")


class MetricsRegistry:
    """Named metrics + scrape-time collectors, one lock, one text dump."""

    def __init__(self):
        self._lock = make_lock("obs.registry")
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: Dict[str, Callable[[], Iterable[MetricFamily]]] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.mtype}")
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def register_collector(self, name: str,
                           fn: Callable[[], Iterable[MetricFamily]]) -> None:
        """Install (or replace) the scrape-time collector ``name``."""
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def collect(self) -> List[MetricFamily]:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors.items())
        fams = [m.collect() for m in metrics]
        for cname, fn in collectors:
            try:
                fams.extend(fn())
            except Exception as e:  # a broken collector must not kill scrape
                fams.append(MetricFamily(
                    "obs_collector_errors", "gauge",
                    "collectors that raised during scrape").add(
                        1.0, labels={"collector": cname,
                                     "error": type(e).__name__}))
        return fams

    def prometheus_text(self) -> str:
        """Full scrape in Prometheus 0.0.4 text exposition format."""
        lines: List[str] = []
        for fam in sorted(self.collect(), key=lambda f: f.name):
            _render_family(fam, lines)
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every metric and collector (test isolation helper)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


#: The process-global registry every subsystem reports through.
REGISTRY = MetricsRegistry()
