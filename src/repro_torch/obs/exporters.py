"""Exporters: Chrome trace-event JSON + per-query attribution tables.

Two output formats, both fed from the tracer/metrics singletons:

* ``write_chrome_trace(path)`` dumps the tracer's event buffer as Chrome
  trace-event JSON (the ``{"traceEvents": [...]}`` object format) —
  load it in Perfetto (ui.perfetto.dev) or chrome://tracing.  Wave
  lifetimes are async ``b``/``e`` pairs so double-buffered waves render
  as overlapping tracks above the host-side complete spans.

* ``attribution_md(joint_plans)`` renders the human-readable per-query
  attribution table: for each planned query, where its planning effort
  went (requests, dedup/cache hits, configs explored) next to the
  broker-level latency percentiles and the wave assembly/execute/commit
  split from the histogram registry.

``wave_summary()`` is the JSON-friendly digest both the telemetry bench
and the reconciliation tests consume: wave count/sizes recovered from
the ``broker.wave`` spans (cross-checkable against
``PlanBroker.counters_snapshot``) plus p50/p99 from the registry.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.obs.metrics import MetricsRegistry, get_metrics
from repro_torch.obs.tracer import Tracer, get_tracer


def write_chrome_trace(path, tracer: Optional[Tracer] = None) -> Path:
    """Write the tracer's events as Perfetto-loadable Chrome trace JSON."""
    tracer = tracer or get_tracer()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(tracer.chrome_trace(), indent=1) + "\n")
    return path


def _hist_stats(metrics: MetricsRegistry, name: str) -> dict:
    h = metrics.histogram(name)
    if h.count == 0:
        return {"count": 0}
    return {"count": h.count, "mean_s": h.mean(),
            "p50_s": h.percentile(50), "p99_s": h.percentile(99)}


def wave_summary(tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None) -> dict:
    """Digest of wave geometry (from spans) + latency percentiles (from
    histograms).  ``wave_sizes`` comes from the ``broker.wave`` span
    args, so tests can reconcile it exactly against
    ``counters_snapshot()['wave_sizes']``."""
    tracer = tracer or get_tracer()
    metrics = metrics or get_metrics()
    waves = sorted(tracer.spans("broker.wave"),
                   key=lambda e: e["args"].get("wave", 0))
    sizes = [e["args"].get("size", 0) for e in waves]
    out = {
        "waves": len(waves),
        "wave_sizes": sizes,
        "max_wave": max(sizes) if sizes else 0,
        "mean_wave": round(sum(sizes) / len(sizes), 3) if sizes else 0.0,
        "request": _hist_stats(metrics, "broker.request_s"),
        "wave_assembly": _hist_stats(metrics, "broker.wave_assembly_s"),
        "wave_execute": _hist_stats(metrics, "broker.wave_execute_s"),
        "wave_commit": _hist_stats(metrics, "broker.wave_commit_s"),
        "programs_built": metrics.counter("backend.programs_built").value,
        "programs_reused": metrics.counter("backend.programs_reused").value,
    }
    return out


def _fmt_s(v) -> str:
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return "-"
    if v < 1e-3:
        return f"{v * 1e6:.1f}us"
    if v < 1.0:
        return f"{v * 1e3:.2f}ms"
    return f"{v:.3f}s"


def attribution_md(joint_plans: Sequence,
                   tracer: Optional[Tracer] = None,
                   metrics: Optional[MetricsRegistry] = None) -> str:
    """Markdown per-query attribution table + broker-level summary.

    ``joint_plans`` are ``RAQO.plan_queries`` results (anything with
    ``.plan`` / ``.planner_seconds`` / ``.stats`` works).
    """
    summary = wave_summary(tracer, metrics)
    lines: List[str] = [
        "# Planner attribution", "",
        "| query | tables | planner | requests | dedup | cache hits "
        "| cache misses | configs explored |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for i, jp in enumerate(joint_plans):
        st = jp.stats
        n_tables = len(getattr(jp.plan, "tables", ()) or ())
        lines.append(
            f"| {i} | {n_tables} | {_fmt_s(jp.planner_seconds)} "
            f"| {st.broker_requests} | {st.broker_dedup_hits} "
            f"| {st.cache_hits} | {st.cache_misses} "
            f"| {st.configs_explored} |")
    req = summary["request"]
    lines += [
        "", "## Broker critical path", "",
        "| stage | count | mean | p50 | p99 |", "|---|---|---|---|---|",
    ]
    for label, key in (("request (submit->resolve)", "request"),
                       ("wave assembly (dedup+dispatch)", "wave_assembly"),
                       ("wave execute (host sync)", "wave_execute"),
                       ("wave commit (float64+fan-out)", "wave_commit")):
        s = summary[key]
        lines.append(f"| {label} | {s.get('count', 0)} "
                     f"| {_fmt_s(s.get('mean_s'))} "
                     f"| {_fmt_s(s.get('p50_s'))} "
                     f"| {_fmt_s(s.get('p99_s'))} |")
    lines += [
        "", f"Waves: {summary['waves']} "
        f"(sizes {summary['wave_sizes']}, mean {summary['mean_wave']}, "
        f"max {summary['max_wave']}); "
        f"programs built {summary['programs_built']}, "
        f"reused {summary['programs_reused']}; "
        f"request p50 {_fmt_s(req.get('p50_s'))} / "
        f"p99 {_fmt_s(req.get('p99_s'))}.", "",
    ]
    return "\n".join(lines)


def write_attribution(path, joint_plans: Sequence,
                      tracer: Optional[Tracer] = None,
                      metrics: Optional[MetricsRegistry] = None) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(attribution_md(joint_plans, tracer, metrics))
    return path
