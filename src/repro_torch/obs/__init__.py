"""Unified observability layer of the port: spans, metrics, exporters.

One clock, one timeline: the ``Tracer`` records per-request spans through
every executor (lock-step, staged, elastic), the ``MetricsRegistry`` absorbs
the previously-fragmented telemetry (monitor gauges, ``StageStats``,
``GenStats``, ``ScaleEvent``s), and the exporters render both as
Chrome/Perfetto ``trace_event`` JSON or JSONL.  Clocks are injected: live
runs use the wall clock, the deterministic simulator records spans in
virtual time — bit-identical across replays.
"""
from repro_torch.obs.decompose import (STAGE_ORDER, decomposition_summary,
                                       request_components)
from repro_torch.obs.export import (chrome_trace_doc, validate_chrome_trace,
                                    write_chrome_trace, write_jsonl)
from repro_torch.obs.metrics import MetricPoint, MetricsRegistry
from repro_torch.obs.tracer import (Span, Tracer, VirtualClock, WallClock,
                                    attach_pipeline)

__all__ = [
    "Span", "Tracer", "WallClock", "VirtualClock", "attach_pipeline",
    "MetricPoint", "MetricsRegistry",
    "chrome_trace_doc", "write_chrome_trace", "write_jsonl",
    "validate_chrome_trace",
    "STAGE_ORDER", "request_components", "decomposition_summary",
]
