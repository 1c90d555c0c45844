"""System-R (Selinger) bottom-up left-deep join ordering [13], extended with
per-operator resource planning via OperatorCosting (paper §VI-C: "we
extended the getPlanCost method of our cost model to first perform the
resource planning and then return the sub-plan cost").

With a double-buffered broker (``PlanBroker.flush_async``) the DP levels
*pipeline*: level N's stacked planning programs run on device while this
driver enumerates level N+1's candidates.  That is possible because the
planning inputs of a candidate join depend only on the table SETS being
joined, not on which plan won the subset: a join's cardinality applies
every internal edge's selectivity exactly once whatever the join tree,
so ``rows``/``row_bytes`` (hence ``ss``/``ls``) of any subset are
split-independent and a static cardinality stand-in enumerated one level
ahead queues byte-identical requests.  Level existence matches too —
``has_edge`` sees only table sets — so the prefetched wave is exactly
the wave the sequential driver would have flushed, in the same order.

The same argument extends across QUERIES (``drive_lockstep``, used by
``RAQO.plan_queries``): because every query's level-L requests are pure
functions of its own table sets, advancing all in-flight queries one DP
level per shared flush wave queues, query-major, exactly the requests
each query's solo run would have queued at that level — so each wave is
one stacked (ΣQ_L, P) program per (cost-fn, grid) group instead of Q
small ones.  Byte-identity with per-query sequential planning holds
piecewise:

- *Leader selection.*  Within a wave, requests are deduplicated in
  submission order, and the lockstep driver queues queries in their
  ``plan_queries`` order — so the first occurrence of any signature in
  a wave belongs to the earliest query that would have searched it
  sequentially, and the search itself (a deterministic function of
  (cost-fn, params, grid, mode, seed)) is the one sequential planning
  would have run.
- *Within-wave cross-query duplicates.*  A later query's same-key
  request rides the broker's per-request stage-3 replay (cache-backed
  keys) or leader/follower collapse (cache-less, session-memo
  semantics); both are defined to equal "search once, then hit" — which
  is literally what sequential per-query planning does, since query
  Q's run would find query P's insert (P < Q) already in the shared
  cache/memo.  Cache contents, hit/miss/insert counters, and broker
  traffic therefore match the sequential loop exactly.
- *Cross-level recurrence.*  An operator recurring at different levels
  (or different queries' levels) hits whatever the earlier wave
  inserted; lockstep reorders only requests with *different* signatures
  relative to sequential, and searches are pure, so no reordering can
  change any value — only which query's stats record a given hit or
  miss (aggregates are invariant).  The one aliasing corner: two
  requests sharing a cache key ``(impl, objective:ls-bucket,
  round(ss, 6))`` with *different* exact params would make "who
  searches first" observable through the shared cache.  The bucketed
  key makes this measure-zero (params equal to 6 decimals within a
  bucket), and it affects lockstep exactly as it affects any warm-cache
  reuse in the sequential loop.

Queries retire ragged: a k-way join leaves the lockstep at level k,
single-table and empty queries short-circuit at construction, and a
disconnected query's cross-join fallback runs inside its final consume
(synchronously — one lost overlap step, same submission order).

ADMISSION (``LockstepDriver``, used by the streaming planner service in
repro.service): the same argument extends to queries that JOIN a running
lockstep mid-flight.  A newly admitted session starts at level 2 while
the incumbents continue at their own levels, so a single wave stacks
mixed levels — session A's level-5 candidates next to session B's
level-2 — and because every session's level-L requests are pure
functions of its own table sets, queued in the same per-query order its
solo run would queue them, each admitted query's plan is bit-identical
to planning it alone on a fresh broker.  Within-wave cross-query
duplicates take the same per-request replay / leader-follower collapse
as the static batch; only *which* query's stats record a given hit may
differ, never any value.
"""
from __future__ import annotations

import itertools
from typing import Dict, FrozenSet, Optional, Sequence

from repro_torch.analysis.registry import hot_path
from repro_torch.core.plans import (IMPLS, OperatorCosting, PlanNode, has_edge,
                              join_cardinality, leaf)
from repro_torch.core.schema import Schema
from repro_torch.obs import get_tracer

_obs = get_tracer()


def _queue_level(schema: Schema, tables: Sequence[str],
                 costing: OperatorCosting, impls: Sequence[str],
                 standin: Dict[FrozenSet[str], PlanNode],
                 size: int) -> None:
    """Queue every candidate costing of DP level ``size`` on the broker,
    using cardinality stand-in nodes so the level can be enumerated
    before the previous level's plans resolve (see module docstring).
    Extends ``standin`` with this level's realizable subsets."""
    new: Dict[FrozenSet[str], PlanNode] = {}
    for combo in itertools.combinations(tables, size):
        s = frozenset(combo)
        for t in combo:
            sub = standin.get(s - {t})
            if sub is None:
                continue
            tleaf = standin[frozenset({t})]
            if not has_edge(schema, sub, tleaf):
                continue
            costing.prefetch_join(schema, sub, tleaf, impls)
            if s not in new:
                rows, rb = join_cardinality(schema, sub, tleaf)
                new[s] = PlanNode(tables=s, rows=rows, row_bytes=rb)
    standin.update(new)


class SelingerSession:
    """One query's Selinger DP as a resumable per-level driver.

    ``queue_level(L)`` enqueues level L's candidate costings on the
    costing's broker (stand-in cardinalities, so it can run before
    level L-1 resolves); ``consume_level(L)`` resolves level L's best
    sub-plans.  ``selinger_plan`` drives one session to completion;
    ``drive_lockstep`` advances many sessions level-by-level against a
    shared broker so each flush wave stacks every query's level.

    ``done``/``result`` expose completion: trivial queries (zero or one
    table) finish at construction; a k-way join finishes inside
    ``consume_level(k)`` (including the one-cross-join fallback for
    disconnected queries).
    """

    def __init__(self, schema: Schema, tables: Sequence[str],
                 costing: OperatorCosting,
                 impls: Sequence[str] = IMPLS):
        self.schema = schema
        self.tables = tuple(tables)
        self.costing = costing
        self.impls = tuple(impls)
        costing.begin_query()    # fresh per-query resource-plan memo
        self.n = len(self.tables)
        self.best: Dict[FrozenSet[str], PlanNode] = {
            frozenset({t}): leaf(schema, t) for t in self.tables}
        self.done = False
        self.result: Optional[PlanNode] = None
        if self.n <= 1:
            if self.n == 1:
                self.result = self.best[frozenset(self.tables)]
            self.done = True
            return
        self.standin: Dict[FrozenSet[str], PlanNode] = dict(self.best)

    def queue_level(self, size: int) -> None:
        """Enqueue level ``size``'s candidate costings (stand-in
        cardinalities; safe one level ahead of ``consume_level``).
        No-op once done or outside [2, n] — ragged lockstep callers
        need not special-case retiring queries."""
        if self.done or size < 2 or size > self.n:
            return
        _queue_level(self.schema, self.tables, self.costing, self.impls,
                     self.standin, size)

    def prefetch_level_resolved(self, size: int) -> None:
        """Legacy (non-double-buffered broker) prefetch: enumerate level
        ``size`` from the RESOLVED ``best`` table (level size-1 already
        consumed) and queue its costings, so one flush still covers the
        whole level."""
        if self.done or size < 2 or size > self.n:
            return
        for combo in itertools.combinations(self.tables, size):
            s = frozenset(combo)
            for t in combo:
                sub = self.best.get(s - {t})
                if sub is None:
                    continue
                tleaf = self.best[frozenset({t})]
                if has_edge(self.schema, sub, tleaf):
                    self.costing.prefetch_join(self.schema, sub, tleaf,
                                               self.impls)

    def consume_level(self, size: int) -> None:
        """Resolve level ``size``: pick each subset's best (plan, split)
        from the already-planned costings.  At the final level, finish
        the session (cross-join fallback included)."""
        if self.done or size < 2 or size > self.n:
            return
        for combo in itertools.combinations(self.tables, size):
            s = frozenset(combo)
            cand: Optional[PlanNode] = None
            for t in combo:
                sub = self.best.get(s - {t})
                if sub is None:
                    continue
                tleaf = self.best[frozenset({t})]
                if not has_edge(self.schema, sub, tleaf):
                    continue                      # avoid cross joins
                plan = self.costing.best_join(self.schema, sub, tleaf,
                                              self.impls)
                if cand is None or plan.total_cost < cand.total_cost:
                    cand = plan
            if cand is not None:
                self.best[s] = cand
        if size == self.n:
            self._finish()

    def _finish(self) -> None:
        full = frozenset(self.tables)
        if full in self.best:
            self.result = self.best[full]
        else:
            # fall back: allow one cross join level for disconnected
            # queries (synchronous costing — the request misses every
            # prefetch, so its future resolves through a full flush)
            for t in self.tables:
                rest = full - {t}
                if rest in self.best:
                    self.result = self.costing.best_join(
                        self.schema, self.best[rest],
                        self.best[frozenset({t})], self.impls)
                    break
        self.done = True


def selinger_plan(schema: Schema, tables: Sequence[str],
                  costing: OperatorCosting,
                  impls: Sequence[str] = IMPLS,
                  backend=None) -> Optional[PlanNode]:
    """Optimal left-deep plan under the (resource-aware) cost model.

    ``backend`` (optional) overrides the array-search backend used for
    per-operator resource planning for this optimization run — the same
    engine (repro_torch.core.planning_backend) the TPU sharding planner uses.
    """
    if backend is not None:
        saved = costing.backend
        costing.backend = backend
        try:
            return selinger_plan(schema, tables, costing, impls)
        finally:
            costing.backend = saved
    sess = SelingerSession(schema, tables, costing, impls)
    if sess.done:
        return sess.result

    # double-buffered pipeline: with flush_async, level N's programs run
    # on device while level N+1 enumerates (cardinality stand-ins make
    # the one-level lookahead exact — module docstring); otherwise keep
    # the historical queue-then-flush-per-level behavior
    broker = costing.broker
    pipelined = broker is not None and hasattr(broker, "flush_async")
    if pipelined:
        sess.queue_level(2)
        broker.flush_async()                # dispatch level 2
    for size in range(2, sess.n + 1):
        if pipelined:
            sess.queue_level(size + 1)      # enumerate the NEXT level
            # commit level ``size`` (in flight until now), dispatch the
            # next one; consume_level then reads resolved futures
            broker.flush_async()
        elif broker is not None:
            # batch the whole enumeration level: queue every candidate
            # join's costings (both operator implementations) on the
            # session broker, so the first resolve below flushes the
            # entire level as stacked array programs instead of planning
            # one operator per program call (paper §VI-B at §VII-C scale)
            sess.prefetch_level_resolved(size)
        sess.consume_level(size)
    return sess.result


class _Slot:
    """One session's position in a running lockstep.  ``inflight`` is
    the DP level whose requests the most recent flush dispatched (None
    until the session's first wave); it is consumed one flush later,
    when that wave commits."""

    __slots__ = ("session", "inflight")

    def __init__(self, session: SelingerSession):
        self.session = session
        self.inflight: Optional[int] = None


class LockstepDriver:
    """Admission-capable lockstep: advance any mix of in-flight Selinger
    sessions one DP level per shared flush wave, admitting new sessions
    between waves.

    Each ``step()`` queues, for every live slot, the level after the one
    currently in flight (level 2 for a freshly admitted slot), issues
    ONE shared ``flush_async`` — which commits every slot's in-flight
    wave and dispatches the just-queued one — then consumes the
    now-committed levels and retires finished sessions.  A static batch
    admitted up front and ``drain()``-ed reproduces the historical
    ``drive_lockstep`` broker-op sequence exactly (queue 2 / flush,
    then queue L+1 / flush / consume L per wave); mid-run admissions
    simply stack their lower levels into the same waves the incumbents
    were going to flush anyway (module docstring: ADMISSION).

    Against a single-buffered broker (no ``flush_async``) each step
    runs the legacy resolved-prefetch path: queue from resolved plans,
    ``flush()``, consume the same level in one step.  With no broker at
    all, consume costs synchronously.
    """

    def __init__(self, broker):
        self.broker = broker
        self.pipelined = broker is not None and hasattr(broker,
                                                        "flush_async")
        self._slots: list = []

    def admit(self, session: SelingerSession) -> None:
        """Join the lockstep at the next wave.  Trivial sessions (done
        at construction) never occupy a slot."""
        if not session.done:
            self._slots.append(_Slot(session))

    @property
    def live(self) -> int:
        return len(self._slots)

    @hot_path("advances every live query's DP one level per flush wave; "
              "mid-run admissions join at level 2", folds=1)
    def step(self) -> None:
        """One shared wave: queue each slot's next level, flush, consume
        each slot's committed level, retire finished sessions."""
        if not self._slots:
            return
        if self.pipelined:
            # this enumeration runs while the previous wave's programs
            # execute — its span lands inside that wave's async interval
            with _obs.span("lockstep.queue", cat="driver") as sp:
                qmax = 0
                for slot in self._slots:
                    q = 2 if slot.inflight is None else slot.inflight + 1
                    slot.session.queue_level(q)
                    qmax = max(qmax, q)
                if sp:
                    sp.set(level=qmax, queries=len(self._slots))
            self.broker.flush_async()       # commit in-flight, dispatch
            ready = [s for s in self._slots if s.inflight is not None]
            if ready:
                with _obs.span("lockstep.consume", cat="driver") as sp:
                    for slot in ready:
                        slot.session.consume_level(slot.inflight)
                    if sp:
                        sp.set(level=max(s.inflight for s in ready),
                               queries=len(ready))
            for slot in self._slots:
                slot.inflight = (2 if slot.inflight is None
                                 else slot.inflight + 1)
        else:
            for slot in self._slots:
                q = 2 if slot.inflight is None else slot.inflight + 1
                slot.session.prefetch_level_resolved(q)
                slot.inflight = q
            if self.broker is not None:
                self.broker.flush()         # one wave for every level
            with _obs.span("lockstep.consume", cat="driver") as sp:
                for slot in self._slots:
                    slot.session.consume_level(slot.inflight)
                if sp:
                    sp.set(level=max(s.inflight for s in self._slots),
                           queries=len(self._slots))
        self._slots = [s for s in self._slots if not s.session.done]

    def drain(self) -> None:
        """Run waves (no further admissions) until every slot retires."""
        while self._slots:
            self.step()


def drive_lockstep(sessions: Sequence[SelingerSession],
                   broker) -> None:
    """Advance many Selinger sessions in lockstep against one shared
    broker: for each DP level L, every live query's level-L candidates
    are queued (query-major, in ``sessions`` order) before ONE shared
    flush, so each wave is a single stacked (ΣQ_L, P) program per
    (cost-fn, grid) group instead of Q small ones.  Ragged by design:
    a session past its last level no-ops its queue/consume calls and
    drops out of the live set.  Plans, cache contents/counters, and
    broker traffic are bit-identical to driving each session alone
    (module docstring).  Static-batch front-end over ``LockstepDriver``
    — the streaming service admits into a live driver instead."""
    driver = LockstepDriver(broker)
    for s in sessions:
        driver.admit(s)
    driver.drain()


def exhaustive_left_deep(schema: Schema, tables: Sequence[str],
                         costing: OperatorCosting,
                         impls: Sequence[str] = IMPLS) -> Optional[PlanNode]:
    """All n! left-deep orders — oracle used by tests to validate Selinger."""
    costing.begin_query()
    best = None
    for perm in itertools.permutations(tables):
        plan = leaf(schema, perm[0])
        ok = True
        for t in perm[1:]:
            tl = leaf(schema, t)
            if not has_edge(schema, plan, tl):
                ok = False
                break
            plan = costing.best_join(schema, plan, tl, impls)
        if ok and (best is None or plan.total_cost < best.total_cost):
            best = plan
    return best
