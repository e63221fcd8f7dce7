"""Telemetry of the port: metrics registry, per-request tracing, exporters.

Copies of ``repro/obs/{metrics,trace,gate,httpd}.py`` (standard library
and numpy); ``python -m repro_torch.obs.gate`` checks a snapshot.
Host-side only (DESIGN.md §9): hooks run between device calls, so
telemetry never changes served tokens, and disabling it leaves one
branch on the hot path.
"""
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      enabled, flatten_snapshot, get_registry, set_enabled,
                      write_snapshot)
from .trace import (Span, TraceBuffer, Tracer, export_jsonl,
                    export_trace_event, read_jsonl)

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "enabled", "set_enabled", "get_registry", "flatten_snapshot",
    "write_snapshot", "Span", "TraceBuffer", "Tracer", "export_jsonl",
    "read_jsonl", "export_trace_event",
]
