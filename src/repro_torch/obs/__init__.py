"""Unified observability layer of the port: spans, metrics, exporters.

One clock, one timeline: the ``Tracer`` records per-request spans through
every executor (lock-step, staged, elastic), the ``MetricsRegistry`` absorbs
the previously-fragmented telemetry (monitor gauges, ``StageStats``,
``GenStats``, ``ScaleEvent``s), and the exporters render both as
Chrome/Perfetto ``trace_event`` JSON or JSONL.  Clocks are injected: live
runs use the wall clock, the deterministic simulator records spans in
virtual time — bit-identical across replays — and code that holds no
tracer records on ``PROCESS_TRACER``, on the profiler's epoch clock, while
a ``torch.profiler`` session runs (``active_tracer``).
"""
from repro_torch.obs.decompose import (STAGE_ORDER, decomposition_summary,
                                       request_components)
from repro_torch.obs.export import (chrome_trace_doc, validate_chrome_trace,
                                    write_chrome_trace, write_jsonl)
from repro_torch.obs.metrics import MetricPoint, MetricsRegistry
from repro_torch.obs.tracer import (PROCESS_TRACER, EpochClock, Phases, Span,
                                    Tracer, VirtualClock, WallClock,
                                    active_tracer, attach_pipeline,
                                    self_times)

__all__ = [
    "Span", "Tracer", "WallClock", "VirtualClock", "EpochClock",
    "PROCESS_TRACER", "active_tracer", "Phases", "self_times",
    "attach_pipeline",
    "MetricPoint", "MetricsRegistry",
    "chrome_trace_doc", "write_chrome_trace", "write_jsonl",
    "validate_chrome_trace",
    "STAGE_ORDER", "request_components", "decomposition_summary",
]
