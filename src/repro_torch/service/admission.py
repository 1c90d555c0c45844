"""Streaming planner service: continuous admission into a live lockstep
(the port of ``repro.service.admission``).

The static entry point (``RAQO.plan_queries``) hands the broker a closed
batch; this module keeps the lockstep RUNNING and admits queries as they
arrive — the paper's §I setting, where cloud queries stream in over
shared resources, and the ROADMAP's "millions of users" throughput gap.
The serving shape follows ``repro_torch.launch.serve`` (continuous
batching: finished slots are refilled between steps without draining the
batch), and the service reacts between waves, never mid-wave.

One ``StreamingPlannerService`` owns one session ``PlanBroker`` and one
``LockstepDriver`` (repro_torch.core.selinger).  ``submit()`` wraps a
query in a ``SelingerSession`` + per-query costing and joins the driver at
the next wave, starting at DP level 2 while incumbent queries continue at
their own levels; each ``step()`` is ONE shared ``flush_async`` wave
stacking every live query's current level.  Admission is therefore
wave-granular — a query arriving during a wave's device execution is
admitted at the next wave boundary, exactly like a serve.py slot refill.

Identity guarantee (tested on the port's backends, and against the
reference service, in tests/test_torch_streaming.py):
an admitted query's plan, cost, and resource assignments are
bit-identical to planning the same query SOLO on a fresh broker.  The
argument is the selinger module docstring's ADMISSION section: each
session's level-L requests are pure functions of its own table sets,
queued in its solo order within the wave, and the broker's dedup /
replay semantics are defined to equal "search once, then hit".

Measurement rides the observability spine (``repro_torch.obs``):
per-request latency lands in the ``broker.request_s`` histogram, wave
stage splits in ``broker.wave_*_s``, and the service samples
``PlanFuture.critical_path()`` for the queue/execute/commit breakdown —
all gated on ``get_tracer().enabled`` so an untraced service adds two
clock reads per query (the submit/resolve ticket stamps) and nothing
else.  ``report()`` summarizes plans/sec and exact p50/p99
submit->resolve latency from the tickets themselves, so the headline
numbers exist even with tracing off.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.registry import hot_path
from repro_torch.core.plan_broker import PlanBroker
from repro_torch.core.selinger import LockstepDriver, SelingerSession
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.service.traces import Arrival

_obs = get_tracer()
_metrics = get_metrics()

MAX_CP_SAMPLES = 1024          # bound on stored critical-path samples
CP_SAMPLE_PER_WAVE = 64        # futures sampled per wave (first N live)


@dataclasses.dataclass
class QueryTicket:
    """One submitted query's lifecycle: submit/resolve stamps
    (``perf_counter_ns``), the wave interval it occupied, and the
    resulting ``JointPlan``.  ``resolve_ns`` is None while in flight."""
    tenant: int
    tables: Tuple[str, ...]
    submit_ns: int
    admit_wave: int
    resolve_ns: Optional[int] = None
    final_wave: Optional[int] = None
    joint: Optional[object] = None      # repro_torch.core.raqo.JointPlan

    @property
    def done(self) -> bool:
        return self.resolve_ns is not None

    @property
    def latency_s(self) -> Optional[float]:
        if self.resolve_ns is None:
            return None
        return (self.resolve_ns - self.submit_ns) / 1e9


def _pct(sorted_vals: Sequence[float], p: float) -> Optional[float]:
    """Exact interpolated percentile of an already-sorted sample."""
    if not sorted_vals:
        return None
    k = (len(sorted_vals) - 1) * (p / 100.0)
    lo = math.floor(k)
    hi = math.ceil(k)
    if lo == hi:
        return float(sorted_vals[lo])
    return float(sorted_vals[lo] + (k - lo) *
                 (sorted_vals[hi] - sorted_vals[lo]))


class StreamingPlannerService:
    """Admission-controlled lockstep planning over one session broker.

    ``raqo`` supplies the schema, cost models, cache, and backend; the
    service creates (or adopts) the session broker (on the default
    backend, ``"cuda"``, that raises without a GPU) and builds one
    costing per submitted query via ``raqo._costing`` — so compiled
    search programs (``_grid_fn_shared``) and the resource-plan cache
    are shared across every tenant exactly as in the static batch path.
    """

    def __init__(self, raqo, objective: str = "time"):
        self.raqo = raqo
        self.objective = objective
        self.broker: PlanBroker = raqo.broker if raqo.broker is not None \
            else PlanBroker(backend=raqo.backend)
        self.driver = LockstepDriver(self.broker)
        self.waves = 0                 # completed service steps
        self.tickets: List[QueryTicket] = []
        self.critical_paths: List[dict] = []
        # (ticket, session, costing, t0 perf_counter seconds)
        self._active: List[tuple] = []

    # ------------------------------------------------------------------ #
    @property
    def active(self) -> int:
        """Queries currently in flight (occupying a lockstep slot)."""
        return len(self._active)

    def submit(self, tables: Sequence[str], tenant: int = 0) -> QueryTicket:
        """Admit one query at the next wave boundary.  Trivial queries
        (a single table) resolve immediately — they never ride a wave,
        mirroring their short-circuit in ``SelingerSession``."""
        if not tables:
            raise ValueError("cannot submit an empty query")
        ticket = QueryTicket(tenant=tenant, tables=tuple(tables),
                             submit_ns=time.perf_counter_ns(),
                             admit_wave=self.waves)
        self.tickets.append(ticket)
        t0 = time.perf_counter()
        costing = self.raqo._costing(self.objective, broker=self.broker)
        session = SelingerSession(self.raqo.schema, tables, costing)
        if session.done:
            self._finalize(ticket, session, costing, t0)
        else:
            self.driver.admit(session)
            self._active.append((ticket, session, costing, t0))
        if _obs.enabled:
            _obs.instant("service.submit", cat="service", tenant=tenant,
                         tables=len(ticket.tables), wave=self.waves)
        return ticket

    @hot_path("one shared flush wave advancing every live tenant's DP "
              "level; admissions join between waves", folds=1)
    def step(self) -> int:
        """Drive ONE lockstep wave and retire finished queries.
        Returns the number of queries completed by this wave."""
        sampled = None
        if _obs.enabled and len(self.critical_paths) < MAX_CP_SAMPLES:
            sampled = []
            for _, _, costing, _ in self._active:
                sampled.extend(costing.pending_futures())
                if len(sampled) >= CP_SAMPLE_PER_WAVE:
                    break
        self.driver.step()
        self.waves += 1
        finished = 0
        if any(s.done for _, s, _, _ in self._active):
            still = []
            for entry in self._active:
                ticket, session, costing, t0 = entry
                if session.done:
                    self._finalize(ticket, session, costing, t0)
                    finished += 1
                else:
                    still.append(entry)
            self._active = still
        if sampled:
            room = MAX_CP_SAMPLES - len(self.critical_paths)
            for fut in sampled[:room * 2]:
                if fut.done and room > 0:
                    cp = fut.critical_path()
                    if cp is not None:
                        self.critical_paths.append(cp)
                        room -= 1
        return finished

    def drain(self) -> None:
        """Run waves (no further admissions) until nothing is in flight."""
        while self._active:
            self.step()

    def _finalize(self, ticket: QueryTicket, session: SelingerSession,
                  costing, t0: float) -> None:
        ticket.joint = self.raqo._wrap(session.result, t0, costing)
        ticket.resolve_ns = time.perf_counter_ns()
        ticket.final_wave = self.waves
        if _obs.enabled:
            lat = (ticket.resolve_ns - ticket.submit_ns) / 1e9
            _metrics.histogram("service.query_s").observe(lat)
            _obs.instant("service.resolve", cat="service",
                         tenant=ticket.tenant, wave=self.waves,
                         latency_us=int(lat * 1e6))

    # ------------------------------------------------------------------ #
    def run_closed_loop(self, queries: Sequence[Tuple[int, Sequence[str]]],
                        concurrency: int) -> List[QueryTicket]:
        """Closed-loop load: keep ``concurrency`` queries in flight,
        submitting the next (tenant, tables) pair the moment a slot
        frees, until ``queries`` is exhausted; then drain.  Admission
        order is completion-driven and fully deterministic (no wall
        clock in any control decision)."""
        tickets: List[QueryTicket] = []
        i = 0
        while i < len(queries) or self._active:
            while i < len(queries) and len(self._active) < concurrency:
                tenant, tables = queries[i]
                tickets.append(self.submit(tables, tenant))
                i += 1
            if self._active:
                self.step()
        return tickets

    def run_open_loop(self, arrivals: Sequence[Arrival], *,
                      time_scale: float = 1.0,
                      max_idle_s: float = 0.05) -> List[QueryTicket]:
        """Open-loop load: replay ``arrivals`` against the wall clock
        (trace offsets scaled by ``time_scale``), admitting every
        arrival whose time has passed before each wave.  Arrivals keep
        coming whether or not the planner keeps up — queueing delay
        shows up in the tickets' submit->resolve latency, which is the
        point of an open-loop measurement."""
        tickets: List[QueryTicket] = []
        start = time.perf_counter()
        i = 0
        n = len(arrivals)
        while i < n or self._active:
            now = time.perf_counter() - start
            while i < n and arrivals[i].t * time_scale <= now:
                a = arrivals[i]
                tickets.append(self.submit(a.tables, a.tenant))
                i += 1
            if self._active:
                self.step()
            elif i < n:
                wait = arrivals[i].t * time_scale - now
                if wait > 0:
                    time.sleep(min(wait, max_idle_s))
        return tickets

    # ------------------------------------------------------------------ #
    def report(self, elapsed_s: Optional[float] = None) -> dict:
        """JSON-friendly service summary: plans/sec, exact p50/p99
        submit->resolve latency over completed tickets, broker wave
        geometry, and — when tracing is enabled — the (process-wide)
        ``broker.request_s`` histogram plus the mean critical-path
        queue/execute/commit split from the sampled futures."""
        done = [t for t in self.tickets if t.resolve_ns is not None]
        lats = sorted(t.latency_s for t in done)
        out: dict = {
            "submitted": len(self.tickets),
            "completed": len(done),
            "in_flight": len(self._active),
            "waves": self.waves,
            "query_p50_s": _pct(lats, 50),
            "query_p99_s": _pct(lats, 99),
            "query_mean_s": (sum(lats) / len(lats)) if lats else None,
            "broker": self.broker.counters_snapshot(),
        }
        if elapsed_s:
            out["elapsed_s"] = elapsed_s
            out["plans_per_s"] = len(done) / elapsed_s
        if _obs.enabled:
            h = _metrics.histogram("broker.request_s")
            if h.count:
                out["request"] = {"count": h.count,
                                  "p50_s": h.percentile(50),
                                  "p99_s": h.percentile(99)}
            if self.critical_paths:
                split = {}
                for k in ("queue_s", "execute_s", "commit_s", "total_s"):
                    vals = [cp[k] for cp in self.critical_paths if k in cp]
                    if vals:
                        split[f"mean_{k}"] = sum(vals) / len(vals)
                split["samples"] = len(self.critical_paths)
                out["critical_path"] = split
        return out
