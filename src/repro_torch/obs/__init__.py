"""Observability for the planning stack: spans, metrics, exporters.

Import discipline mirrors ``repro_torch.analysis.registry``: this package is
stdlib-only so the hot core modules (``plan_broker``,
``planning_backend``, ``selinger``) can bind the singletons at import
time with zero added dependencies.  A copy of the reference's
``repro.obs``; its README (src/repro/obs/README.md) describes the span
model and the overhead contract.
"""
import time

from repro_torch.obs.exporters import (attribution_md, wave_summary,
                                 write_attribution, write_chrome_trace)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               get_metrics)
from repro_torch.obs.tracer import NULL_SPAN, Span, Tracer, get_tracer, \
    trace_enabled

__all__ = [
    "NULL_SPAN", "Span", "Tracer", "get_tracer", "trace_enabled",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_metrics",
    "attribution_md", "wave_summary", "write_attribution",
    "write_chrome_trace", "record_program",
]


def record_program(backend_name: str, kind: str, reused: bool,
                   start_ns=None, devices=None) -> None:
    """Compile-event capture for the backend program memos: called on
    every ``_program`` lookup when tracing is enabled.  Emits an instant
    event (built events carry the build duration) and bumps the
    built/reused counters the recompile audit cross-checks."""
    tracer = get_tracer()
    metrics = get_metrics()
    if reused:
        metrics.counter("backend.programs_reused").inc()
        metrics.counter(f"backend.reused.{backend_name}.{kind}").inc()
        tracer.instant("backend.program", cat="compile",
                       backend=backend_name, kind=kind, event="reused")
        return
    metrics.counter("backend.programs_built").inc()
    metrics.counter(f"backend.built.{backend_name}.{kind}").inc()
    args = {"backend": backend_name, "kind": kind, "event": "built"}
    if devices is not None:
        args["devices"] = devices
    if start_ns is not None:
        tracer.complete("backend.program_build", start_ns, cat="compile",
                        **args)
        metrics.histogram("backend.build_s").observe(
            (time.perf_counter_ns() - start_ns) / 1e9)
    else:
        tracer.instant("backend.program", cat="compile", **args)
