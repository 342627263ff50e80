"""Metrics registry: counters, gauges, histograms, and boundary-sampled
time series (a copy of ``repro.obs.metrics``).

``ServeStats`` is built from a per-run ``MetricsRegistry``. The registry is
plain Python over plain floats, with no locks: the engine loop is
single-threaded. ``RunObs`` carries the run's (possibly null) event
tracer beside it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple


class Counter:
    """Monotonic accumulator (float: wall-second totals share the type)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-value (or high-watermark, via ``hi``) instantaneous metric."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def hi(self, v: float) -> None:
        """High-watermark update: keep the max ever seen."""
        if v > self.value:
            self.value = float(v)


class Histogram:
    """Value distribution with exact percentiles (stride-decimated past
    ``max_samples``, so the kept set stays an unbiased subsample)."""
    __slots__ = ("name", "values", "count", "total", "vmin", "vmax",
                 "max_samples", "_stride", "_skip")

    def __init__(self, name: str, max_samples: int = 65536):
        self.name = name
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.max_samples = int(max_samples)
        self._stride = 1
        self._skip = 0

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if self._skip:
            self._skip -= 1
            return
        self._skip = self._stride - 1
        if len(self.values) >= self.max_samples:
            self.values = self.values[::2]
            self._stride *= 2
            self._skip = self._stride - 1
        self.values.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile (numpy.percentile's default
        method) over the retained samples; 0.0 when empty."""
        if not self.values:
            return 0.0
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q={q} outside [0, 100]")
        xs = sorted(self.values)
        pos = (len(xs) - 1) * q / 100.0
        lo = math.floor(pos)
        hi = math.ceil(pos)
        if lo == hi:
            return xs[int(pos)]
        return xs[lo] * (hi - pos) + xs[hi] * (pos - lo)


class MetricsRegistry:
    """Named counters/gauges/histograms plus boundary-sampled series:
    ``sample(step)`` snapshots every gauge and counter into
    ``series[name]`` as ``(step, value)`` pairs."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.series: Dict[str, List[Tuple[float, float]]] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    def inc(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def hi(self, name: str, v: float) -> None:
        self.gauge(name).hi(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).record(v)

    def value(self, name: str, default: float = 0.0) -> float:
        """Current value of a counter or gauge (counters win a name tie)."""
        if name in self.counters:
            return self.counters[name].value
        if name in self.gauges:
            return self.gauges[name].value
        return default

    def sample(self, step: float) -> None:
        """Snapshot every gauge and counter into its series at ``step``."""
        for name, g in self.gauges.items():
            self.series.setdefault(name, []).append((float(step), g.value))
        for name, c in self.counters.items():
            self.series.setdefault(name, []).append((float(step), c.value))

    def series_stats(self, name: str) -> Tuple[float, float]:
        """(mean, max) over a sampled series; falls back to the live
        gauge/counter value when the series is empty."""
        pts = self.series.get(name)
        if not pts:
            v = self.value(name)
            return v, v
        vals = [v for _, v in pts]
        return sum(vals) / len(vals), max(vals)


class RunObs:
    """Per-run observability context: the metrics registry every run keeps
    (``ServeStats`` is built from it), the possibly null event tracer, the
    peak block report and the count of decode boundaries seen (the
    sampling cadence)."""
    __slots__ = ("metrics", "tracer", "block_report", "boundaries")

    def __init__(self, tracer=None):
        from repro_torch.obs.events import NULL_TRACER
        self.metrics = MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.block_report: Optional[dict] = None
        self.boundaries = 0

    def inc(self, name: str, n: float = 1.0) -> None:
        self.metrics.inc(name, n)

    def hi(self, name: str, v: float) -> None:
        self.metrics.hi(name, v)

    def value(self, name: str, default: float = 0.0) -> float:
        return self.metrics.value(name, default)
