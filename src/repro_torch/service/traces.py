"""Arrival traces for the streaming planner service (the port of
``repro.service.traces``: the same generators drawing the same
``numpy.random.default_rng(seed)`` stream, so each seed gives the
reference's arrivals field for field).

A trace is a sorted tuple of ``Arrival`` events — (arrival time in
seconds since trace start, tenant id, the query's table list) — drawn
from the same ``random_query`` workload generator the lockstep benches
use, so streaming throughput numbers are directly comparable with the
static-batch speedup tables.  Three arrival processes cover the shapes
the paper's §I cloud-workload premise cares about:

- ``poisson_trace``: homogeneous Poisson at ``rate`` arrivals/second
  (exponential inter-arrival gaps) — the steady-state baseline.
- ``bursty_trace``: a Poisson process of *bursts*; each burst drops
  ``burst`` back-to-back queries (BI dashboards refreshing, a scheduled
  ETL fan-out).  Mean rate still ``rate``.
- ``diurnal_trace``: non-homogeneous Poisson with a sinusoidal intensity
  (period ``period`` seconds, trough-to-peak ``swing``), generated by
  Lewis-Shedler thinning — the day/night load curve compressed to bench
  scale.

Every generator is a pure function of its arguments — one
``numpy.random.default_rng(seed)`` stream, no wall clock — so traces are
bit-reproducible across runs, platforms, and backends; tests and the CI
latency gate rely on that.  Times are *offsets*: the service's open-loop
runner maps them onto its own clock, and its closed-loop runner ignores
them (admission is completion-driven there), using only the query mix.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.schema import Schema, random_query


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One query arrival: ``t`` seconds after trace start, a tenant id
    (sessions are per-tenant in the service's bookkeeping), and the
    tables to join."""
    t: float
    tenant: int
    tables: Tuple[str, ...]


def _queries(schema: Schema, n: int, rng: np.random.Generator,
             tables_range: Tuple[int, int]) -> list:
    lo, hi = tables_range
    sizes = rng.integers(lo, hi + 1, size=n)
    seeds = rng.integers(0, 2**31 - 1, size=n)
    return [tuple(random_query(schema, int(k), int(s)))
            for k, s in zip(sizes, seeds)]


def _assemble(times: Sequence[float], tenants: Sequence[int],
              queries: Sequence[Tuple[str, ...]]) -> Tuple[Arrival, ...]:
    out = [Arrival(t=float(t), tenant=int(ten), tables=q)
           for t, ten, q in zip(times, tenants, queries)]
    out.sort(key=lambda a: a.t)
    return tuple(out)


def poisson_trace(schema: Schema, n: int, rate: float, seed: int = 0, *,
                  tenants: int = 16,
                  tables_range: Tuple[int, int] = (2, 6)
                  ) -> Tuple[Arrival, ...]:
    """``n`` arrivals from a homogeneous Poisson process at ``rate``
    arrivals/second; each query joins ``tables_range`` random connected
    tables of ``schema``.  Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate, size=n))
    tens = rng.integers(0, tenants, size=n)
    return _assemble(times, tens, _queries(schema, n, rng, tables_range))


def bursty_trace(schema: Schema, n: int, rate: float, seed: int = 0, *,
                 burst: int = 8, tenants: int = 16,
                 tables_range: Tuple[int, int] = (2, 6)
                 ) -> Tuple[Arrival, ...]:
    """``n`` arrivals in bursts of ``burst`` simultaneous queries; burst
    epochs are Poisson at ``rate / burst`` so the long-run arrival rate
    matches ``poisson_trace(rate)``.  Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    n_bursts = (n + burst - 1) // burst
    epochs = np.cumsum(rng.exponential(burst / rate, size=n_bursts))
    times = np.repeat(epochs, burst)[:n]
    tens = rng.integers(0, tenants, size=n)
    return _assemble(times, tens, _queries(schema, n, rng, tables_range))


def diurnal_trace(schema: Schema, n: int, rate: float, seed: int = 0, *,
                  period: float = 60.0, swing: float = 0.8,
                  tenants: int = 16,
                  tables_range: Tuple[int, int] = (2, 6)
                  ) -> Tuple[Arrival, ...]:
    """``n`` arrivals from a non-homogeneous Poisson process whose
    intensity swings sinusoidally around ``rate``:
    ``lambda(t) = rate * (1 + swing * sin(2 pi t / period))`` with
    ``swing`` in [0, 1).  Lewis-Shedler thinning against the peak rate
    keeps the process exact and the rng stream deterministic."""
    if not 0.0 <= swing < 1.0:
        raise ValueError(f"swing must be in [0, 1), got {swing}")
    rng = np.random.default_rng(seed)
    peak = rate * (1.0 + swing)
    times = []
    t = 0.0
    while len(times) < n:
        t += float(rng.exponential(1.0 / peak))
        lam = rate * (1.0 + swing * math.sin(2.0 * math.pi * t / period))
        if float(rng.random()) * peak <= lam:
            times.append(t)
    tens = rng.integers(0, tenants, size=n)
    return _assemble(times, tens, _queries(schema, n, rng, tables_range))
