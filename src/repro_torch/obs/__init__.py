"""Observability for the port's serve engine (a copy of ``repro.obs``):
the event tracer (``events``), the metrics registry (``metrics``), the
Chrome trace export (``chrome``) and the dispatch profiler with its
profile store (``prof``). ``launch/trace_report.py`` analyses dumped
traces."""
from repro_torch.obs.chrome import to_chrome_trace, write_chrome_trace
from repro_torch.obs.events import (EVENT_SCHEMA, NULL_TRACER, SPAN_EVENTS,
                                    NullTracer, Tracer, load_trace,
                                    read_trace, validate_events)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, RunObs)
from repro_torch.obs.prof import (NULL_PROFILER, DispatchProfiler,
                                  NullDispatchProfiler, ProfileStore)

__all__ = [
    "Counter", "DispatchProfiler", "EVENT_SCHEMA", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_PROFILER", "NULL_TRACER", "NullDispatchProfiler",
    "NullTracer", "ProfileStore", "RunObs", "SPAN_EVENTS", "Tracer",
    "load_trace", "read_trace", "to_chrome_trace", "validate_events",
    "write_chrome_trace",
]
