"""Fast randomized multi-objective query planner, re-implemented after
Trummer & Koch, "A Fast Randomized Algorithm for Multi-Objective Query
Optimization" (SIGMOD'16) [14], with the associativity and exchange
mutations of Steinbrunn et al. [36].

The planner keeps an approximate Pareto frontier over cost vectors
(execution time, monetary cost) with target approximation precision
``eps``: a plan is kept only if no archived plan (1+eps)-dominates it.
RAQO integration is identical to Selinger's — every join operator is costed
through OperatorCosting, which performs resource planning per §VI-C.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.registry import hot_path
from repro_torch.core.plans import (IMPLS, OperatorCosting, PlanNode, has_edge,
                              join_cardinality, leaf)
from repro_torch.core.schema import Schema
from repro_torch.obs import get_tracer

_obs = get_tracer()

CostVec = Tuple[float, float]     # (time s, money $)


def cost_vec(p: PlanNode) -> CostVec:
    return (p.total_cost, p.total_money)


def dominates(a: CostVec, b: CostVec, eps: float = 0.0) -> bool:
    """a (1+eps)-dominates b."""
    return all(x <= (1 + eps) * y for x, y in zip(a, b)) and a != b


@dataclasses.dataclass
class ParetoArchive:
    eps: float = 0.05
    plans: List[PlanNode] = dataclasses.field(default_factory=list)

    def offer(self, p: PlanNode) -> bool:
        v = cost_vec(p)
        for q in self.plans:
            if dominates(cost_vec(q), v, self.eps):
                return False
        self.plans = [q for q in self.plans
                      if not dominates(v, cost_vec(q), 0.0)]
        self.plans.append(p)
        return True

    def best(self, objective: int = 0) -> Optional[PlanNode]:
        if not self.plans:
            return None
        return min(self.plans, key=lambda p: cost_vec(p)[objective])


# ------------------------- random plan generation -------------------------- #

def random_bushy_plan(schema: Schema, tables: Sequence[str],
                      costing: OperatorCosting, rng: random.Random,
                      impls: Sequence[str] = IMPLS) -> Optional[PlanNode]:
    forest = [leaf(schema, t) for t in tables]
    guard = 0
    while len(forest) > 1:
        guard += 1
        if guard > 10_000:
            return None
        i, j = rng.sample(range(len(forest)), 2)
        if not has_edge(schema, forest[i], forest[j]):
            continue
        a = forest.pop(max(i, j))
        b = forest.pop(min(i, j))
        forest.append(costing.best_join(schema, a, b, impls))
    return forest[0]


# ------------------------------ mutations ---------------------------------- #

def _collect_joins(p: PlanNode, acc: List[PlanNode]) -> None:
    if not p.is_leaf:
        acc.append(p)
        _collect_joins(p.left, acc)
        _collect_joins(p.right, acc)


def _rebuild(schema: Schema, node: PlanNode, costing: OperatorCosting,
             target: PlanNode, replacement: Optional[PlanNode],
             impls: Sequence[str]) -> Optional[PlanNode]:
    """Rebuild the tree bottom-up, swapping ``target`` for ``replacement``."""
    if node is target:
        return replacement
    if node.is_leaf:
        return node
    l = _rebuild(schema, node.left, costing, target, replacement, impls)
    r = _rebuild(schema, node.right, costing, target, replacement, impls)
    if l is None or r is None:
        return None
    if l is node.left and r is node.right:
        return node                      # untouched subtree: keep costs
    return costing.best_join(schema, l, r, impls)


def _choose_mutation(plan: PlanNode, rng: random.Random
                     ) -> Optional[Tuple[PlanNode, str]]:
    """Draw the (node, kind) of one mutation — pure RNG, no costing, so
    a whole population's choices can be made before any planning (the
    draw order matches the historical ``mutate``, keeping seeded runs
    reproducible)."""
    joins: List[PlanNode] = []
    _collect_joins(plan, joins)
    if not joins:
        return None
    node = rng.choice(joins)
    kind = rng.choice(("commute", "assoc", "exchange"))
    return node, kind


def _prefetch_mutation(schema: Schema, node: PlanNode, kind: str,
                       costing: OperatorCosting,
                       impls: Sequence[str]) -> None:
    """Queue the candidate costings a mutation will need on the session
    broker.  Join cardinalities are pure schema math, so both stages of
    assoc/exchange are known before any planning resolves — the whole
    population's mutations land in one broker flush."""
    if kind == "commute":
        costing.prefetch_join(schema, node.right, node.left, impls)
    elif kind in ("assoc", "exchange") and not node.left.is_leaf:
        a, b, c = node.left.left, node.left.right, node.right
        first, second = ((b, c), a) if kind == "assoc" else ((a, c), b)
        l, r = first
        if not has_edge(schema, l, r):
            return
        costing.prefetch_join(schema, l, r, impls)
        rows, rb = join_cardinality(schema, l, r)
        mid = PlanNode(tables=l.tables | r.tables, rows=rows, row_bytes=rb)
        if kind == "assoc" and has_edge(schema, second, mid):
            costing.prefetch_join(schema, second, mid, impls)
        elif kind == "exchange" and has_edge(schema, mid, second):
            costing.prefetch_join(schema, mid, second, impls)


def _apply_mutation(schema: Schema, plan: PlanNode,
                    costing: OperatorCosting, node: PlanNode, kind: str,
                    impls: Sequence[str]) -> Optional[PlanNode]:
    repl: Optional[PlanNode] = None
    if kind == "commute":
        repl = costing.best_join(schema, node.right, node.left, impls)
    elif kind == "assoc" and not node.left.is_leaf:
        # (A |><| B) |><| C  ->  A |><| (B |><| C)
        a, b, c = node.left.left, node.left.right, node.right
        if has_edge(schema, b, c):
            bc = costing.best_join(schema, b, c, impls)
            if has_edge(schema, a, bc):
                repl = costing.best_join(schema, a, bc, impls)
    elif kind == "exchange" and not node.left.is_leaf:
        # (A |><| B) |><| C  ->  (A |><| C) |><| B
        a, b, c = node.left.left, node.left.right, node.right
        if has_edge(schema, a, c):
            ac = costing.best_join(schema, a, c, impls)
            if has_edge(schema, ac, b):
                repl = costing.best_join(schema, ac, b, impls)
    if repl is None:
        return None
    return _rebuild(schema, plan, costing, node, repl, impls)


def mutate(schema: Schema, plan: PlanNode, costing: OperatorCosting,
           rng: random.Random, impls: Sequence[str] = IMPLS
           ) -> Optional[PlanNode]:
    """One random mutation: commutativity, associativity, or exchange."""
    choice = _choose_mutation(plan, rng)
    if choice is None:
        return None
    return _apply_mutation(schema, plan, costing, choice[0], choice[1],
                           impls)


# ------------------------------ the planner -------------------------------- #

class FastRandomizedSession:
    """One query's randomized search as a resumable per-round driver.

    ``queue_round()`` draws the whole population's mutations (RNG only)
    and queues their candidate costings on the broker;
    ``consume_round()`` applies them.  Each session owns its
    ``random.Random(seed)``, consumed in the same per-query order as a
    solo ``fast_randomized_plan`` run — population seeding at
    construction, then one draw pair per plan per round — so lockstep
    interleaving across queries (``drive_fast_randomized``) leaves every
    stream, hence every plan and archive, bit-identical."""

    def __init__(self, schema: Schema, tables: Sequence[str],
                 costing: OperatorCosting, *,
                 iterations: int = 10, population: int = 4,
                 eps: float = 0.05, seed: int = 0,
                 impls: Sequence[str] = IMPLS):
        self.schema = schema
        self.costing = costing
        self.impls = tuple(impls)
        costing.begin_query()    # fresh per-query resource-plan memo
        self.rng = random.Random(seed)
        self.archive = ParetoArchive(eps=eps)
        self.pop: List[PlanNode] = []
        for _ in range(population * 3):
            p = random_bushy_plan(schema, tables, costing, self.rng, impls)
            if p is not None:
                self.pop.append(p)
                self.archive.offer(p)
            if len(self.pop) >= population:
                break
        self.rounds_left = iterations if self.pop else 0
        self._chosen: Optional[List] = None

    @property
    def done(self) -> bool:
        return self.rounds_left <= 0

    def queue_round(self) -> None:
        """Draw this round's mutations (the RNG consumption must happen
        whether or not a broker exists) and queue their costings."""
        if self.done:
            return
        # draw the whole population's mutations first (same RNG stream as
        # mutating inline: each draw consumes exactly two choices) ...
        self._chosen = [(p, _choose_mutation(p, self.rng))
                        for p in self.pop]
        if self.costing.broker is not None:
            # ... so every plan's candidate costings can be queued on the
            # session broker before anything resolves
            for p, ch in self._chosen:
                if ch is not None:
                    _prefetch_mutation(self.schema, ch[0], ch[1],
                                       self.costing, self.impls)

    def consume_round(self) -> None:
        if self.done or self._chosen is None:
            return
        nxt: List[PlanNode] = []
        for p, ch in self._chosen:
            q = None if ch is None else \
                _apply_mutation(self.schema, p, self.costing, ch[0],
                                ch[1], self.impls)
            if q is not None:
                self.archive.offer(q)
                # hill-climb move on scalar objective, keep diversity via archive
                nxt.append(q if q.total_cost < p.total_cost else p)
            else:
                nxt.append(p)
        self.pop = nxt
        self._chosen = None
        self.rounds_left -= 1

    def result(self) -> Tuple[Optional[PlanNode], ParetoArchive]:
        return self.archive.best(0), self.archive


@hot_path("advances every concurrent query's mutation round per flush wave",
          folds=1)
def drive_fast_randomized(sessions: Sequence[FastRandomizedSession],
                          broker) -> None:
    """Advance many randomized-search sessions in lockstep: every live
    query's round-R mutation prefetches ride ONE shared flush wave
    (round-interleaved), then each session applies its round.  Sessions
    with fewer remaining rounds retire early; plans/archives stay
    bit-identical to solo runs (each session owns its RNG stream)."""
    live = [s for s in sessions if not s.done]
    pipelined = broker is not None and hasattr(broker, "flush_async")
    rnd = 0
    while live:
        with _obs.span("randomized.queue", cat="driver") as sp:
            for s in live:
                s.queue_round()
            if sp:
                sp.set(round=rnd, queries=len(live))
        rnd += 1
        if pipelined:
            # dispatch the cross-query wave; programs run on device while
            # the apply loops below do their tree surgery
            broker.flush_async()
        elif broker is not None:
            broker.flush()
        for s in live:
            s.consume_round()
        live = [s for s in live if not s.done]


def fast_randomized_plan(schema: Schema, tables: Sequence[str],
                         costing: OperatorCosting, *,
                         iterations: int = 10, population: int = 4,
                         eps: float = 0.05, seed: int = 0,
                         impls: Sequence[str] = IMPLS,
                         backend=None
                         ) -> Tuple[Optional[PlanNode], ParetoArchive]:
    """Returns (best-time plan, Pareto archive over (time, money)).

    ``backend`` (optional) overrides the array-search backend used for
    per-operator resource planning for this run (planning_backend)."""
    if backend is not None:
        saved = costing.backend
        costing.backend = backend
        try:
            return fast_randomized_plan(
                schema, tables, costing, iterations=iterations,
                population=population, eps=eps, seed=seed, impls=impls)
        finally:
            costing.backend = saved
    sess = FastRandomizedSession(
        schema, tables, costing, iterations=iterations,
        population=population, eps=eps, seed=seed, impls=impls)
    while not sess.done:
        sess.queue_round()
        if costing.broker is not None and \
                hasattr(costing.broker, "flush_async"):
            # double-buffered broker: dispatch the generation's wave
            # now, so its programs run on device while the mutation
            # loop does its tree surgery; the first result() commits
            # the wave in submission order
            costing.broker.flush_async()
        sess.consume_round()
    return sess.result()
