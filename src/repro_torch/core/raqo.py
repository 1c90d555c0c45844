"""RAQO facade (paper §IV): the four optimizer modes.

    r => p       plan_for_resources   : best plan for a fixed resource budget
    p => (r, c)  resources_for_plan   : cheapest resources meeting a target
    => (p, r)    joint                : best joint query+resource plan
    c => (p, r)  for_budget           : best performance under a $ budget

Multi-tenant sessions: ``plan_queries([...])`` optimizes several
concurrent queries against ONE session planning broker
(repro_torch.core.plan_broker) — every query's base-level candidate costings
are queued before any query resolves, so the first flush plans the whole
batch's shared operators as stacked array programs and the broker's
session memo / the resource-plan cache dedup the rest.  With the
double-buffered broker (the default) those base costings ride the first
``flush_async`` wave of the leading query's Selinger run automatically:
each DP level executes on device while the next level enumerates (see
repro_torch.core.selinger), no RAQO-level changes needed.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cluster import ClusterConditions, PlanningStats, paper_cluster
from repro_torch.core.cost_model import (RegressionModel, Surface,
                                         monetary_cost, paper_models)
from repro_torch.core.fast_randomized import (FastRandomizedSession,
                                        drive_fast_randomized,
                                        fast_randomized_plan)
from repro_torch.core.plan_broker import PlanBroker
from repro_torch.core.plan_cache import ResourcePlanCache
from repro_torch.core.planning_backend import PlanBackend, get_backend
from repro_torch.core.plans import IMPLS, OperatorCosting, PlanNode, has_edge, leaf
from repro_torch.core.schema import Schema
from repro_torch.core.selinger import (SelingerSession, drive_lockstep,
                                 selinger_plan)
from repro_torch.obs import get_tracer

_obs = get_tracer()


@dataclasses.dataclass
class JointPlan:
    plan: PlanNode
    exec_time: float
    money: float
    planner_seconds: float
    stats: PlanningStats

    def operator_resources(self):
        out = []

        def walk(n: PlanNode):
            if n.is_leaf:
                return
            out.append((n.impl, n.resources, n.op_cost))
            walk(n.left)
            walk(n.right)
        walk(self.plan)
        return out


@dataclasses.dataclass
class RAQO:
    schema: Schema
    models: Dict[str, RegressionModel] = dataclasses.field(
        default_factory=paper_models)
    cluster: ClusterConditions = dataclasses.field(
        default_factory=paper_cluster)
    planner: str = "selinger"                 # selinger | fastrandomized
    # hillclimb | hillclimb_batched | ensemble | brute | batched | fixed
    resource_planning: str = "hillclimb"
    cache: Optional[ResourcePlanCache] = None
    seed: int = 0
    # array-search backend (planning_backend): None/"cuda" (the CUDA
    # kernels; raises without a GPU) | "torch" (exact, float64 on the CPU)
    backend: Union[str, PlanBackend, None] = None
    # session planning broker shared by every costing this RAQO creates;
    # plan_queries constructs one on demand when unset
    broker: Optional[PlanBroker] = None
    # param-style SLA cost fns per impl (one fn object across walks)
    _sla_fn_cache: Dict = dataclasses.field(default_factory=dict,
                                            repr=False)
    # shared across the OperatorCosting instances this RAQO creates: the
    # batch-cost fns close over (model, objective) only, so one fn object
    # per surface serves every query and the broker stacks their requests
    _grid_fn_shared: Dict = dataclasses.field(default_factory=dict,
                                              repr=False)

    def _costing(self, objective: str = "time",
                 fixed: Optional[Tuple[int, ...]] = None,
                 broker: Optional[PlanBroker] = None) -> OperatorCosting:
        return OperatorCosting(
            models=self.models, cluster=self.cluster,
            resource_planning="fixed" if fixed else self.resource_planning,
            fixed_resources=fixed or (10, 4), cache=self.cache,
            objective=objective, backend=self.backend,
            broker=broker if broker is not None else self.broker,
            _grid_fn_cache=self._grid_fn_shared)

    def _plan(self, tables: Sequence[str], costing: OperatorCosting
              ) -> Optional[PlanNode]:
        if self.planner == "selinger":
            return selinger_plan(self.schema, tables, costing)
        best, _ = fast_randomized_plan(self.schema, tables, costing,
                                       seed=self.seed)
        return best

    def predicted_exec_seconds(self, plan: PlanNode) -> float:
        """Predicted wall-clock of a plan under the cost models, whatever
        objective it was optimized for (a money-costed PlanNode accumulates
        dollars in total_cost, not seconds)."""
        total = 0.0

        def walk(n: PlanNode):
            nonlocal total
            if n.is_leaf:
                return
            walk(n.left)
            walk(n.right)
            ss = min(n.left.size_gb, n.right.size_gb)
            ls = max(n.left.size_gb, n.right.size_gb)
            nc, cs = n.resources
            t = self.models[n.impl].cost(ss, cs, nc, ls=ls)
            total += t if math.isfinite(t) else math.inf
        walk(plan)
        return total

    def _wrap(self, plan: PlanNode, t0: float,
              costing: OperatorCosting) -> JointPlan:
        exec_time = plan.total_cost if costing.objective == "time" \
            else self.predicted_exec_seconds(plan)
        return JointPlan(plan=plan, exec_time=exec_time,
                         money=plan.total_money,
                         planner_seconds=time.perf_counter() - t0,
                         stats=costing.stats)

    # --------------------------- the four modes ------------------------- #
    def joint(self, tables: Sequence[str], objective: str = "time"
              ) -> JointPlan:
        """=> (p, r)"""
        t0 = time.perf_counter()
        costing = self._costing(objective)
        plan = self._plan(tables, costing)
        return self._wrap(plan, t0, costing)

    def plan_queries(self, queries: Sequence[Sequence[str]],
                     objective: str = "time", *,
                     lockstep: bool = True) -> List[JointPlan]:
        """=> [(p, r), ...] for several concurrent (multi-tenant) queries
        sharing ONE session broker.

        Every query gets its own costing/stats (per-query memo isolation
        unchanged), but all of them defer resource planning to one
        ``PlanBroker``.  With ``lockstep=True`` (default) the queries
        advance in LOCKSTEP — every in-flight query's DP level L (or
        FastRandomized mutation round R) is queued before one shared
        flush, so each wave is a single stacked (ΣQ_L, P) program per
        (cost-fn, grid) group instead of Q small ones, and identical
        base-table candidates submit once with the future fanned out
        across queries.  Operators recurring across queries (the
        paper's §V recurring-job story) dedup through the broker's
        session memo or the shared resource-plan cache instead of
        re-searching; plans, cache contents/counters, and broker
        traffic are bit-identical to per-query planning (see
        repro_torch.core.selinger).  ``lockstep=False`` keeps the per-query
        double-buffered pipeline (each query drives its own waves after
        an upfront base-candidate prefetch) — the bench baseline."""
        broker = self.broker if self.broker is not None \
            else PlanBroker(backend=self.backend)
        costings = [self._costing(objective, broker=broker)
                    for _ in queries]
        _obs.instant("raqo.plan_queries", cat="driver",
                     queries=len(queries), lockstep=lockstep,
                     planner=self.planner)
        if not lockstep:
            for tables, costing in zip(queries, costings):
                leaves = {t: leaf(self.schema, t) for t in tables}
                for a, b in itertools.combinations(tables, 2):
                    if has_edge(self.schema, leaves[a], leaves[b]):
                        costing.prefetch_join(self.schema, leaves[a],
                                              leaves[b])
            out: List[JointPlan] = []
            for tables, costing in zip(queries, costings):
                t0 = time.perf_counter()
                plan = self._plan(tables, costing)
                out.append(self._wrap(plan, t0, costing))
            return out
        t0 = time.perf_counter()
        if self.planner == "selinger":
            # sessions FIRST (constructors run begin_query, which clears
            # costing pendings), THEN the fanned-out base prefetch, so
            # level 2 consumes the shared futures instead of resubmitting
            sessions = [SelingerSession(self.schema, tables, costing)
                        for tables, costing in zip(queries, costings)]
            self._prefetch_base(queries, costings)
            drive_lockstep(sessions, broker)
            plans = [s.result for s in sessions]
        else:
            sessions = [FastRandomizedSession(self.schema, tables, costing,
                                              seed=self.seed)
                        for tables, costing in zip(queries, costings)]
            drive_fast_randomized(sessions, broker)
            plans = [s.result()[0] for s in sessions]
        out = [self._wrap(p, t0, c) for p, c in zip(plans, costings)]
        if _obs.enabled:
            for i, jp in enumerate(out):
                _obs.instant("raqo.query", cat="driver", query=i,
                             requests=jp.stats.broker_requests,
                             dedup=jp.stats.broker_dedup_hits,
                             explored=jp.stats.configs_explored)
        return out

    def _prefetch_base(self, queries: Sequence[Sequence[str]],
                       costings: Sequence[OperatorCosting]) -> None:
        """Queue every query's base-table join candidates, submitting
        each distinct (impl, ss, ls, objective) ONCE and fanning its
        broker future out to every other costing that needs it ("queue
        once, fan the future out").  Cache-backed costings skip the
        fan-out: their sequential runs count a cache hit per duplicate
        lookup, and adoption would skip exactly that lookup — submitting
        per query keeps cache counters sequential-identical (the broker
        replays same-key requests per-request anyway)."""
        shared: Dict[Tuple, object] = {}
        for tables, costing in zip(queries, costings):
            leaves = {t: leaf(self.schema, t) for t in tables}
            for a, b in itertools.combinations(tables, 2):
                la, lb = leaves[a], leaves[b]
                if not has_edge(self.schema, la, lb):
                    continue
                if costing.cache is not None:
                    costing.prefetch_join(self.schema, la, lb)
                    continue
                ss = min(la.size_gb, lb.size_gb)
                ls = max(la.size_gb, lb.size_gb)
                for impl in IMPLS:
                    key = (impl, ss, ls, costing.objective)
                    fut = shared.get(key)
                    if fut is None:
                        costing.prefetch(impl, ss, ls)
                        got = costing.share_pending(impl, ss, ls)
                        if got is not None:
                            shared[key] = got
                    else:
                        costing.adopt_future(impl, ss, ls, fut)

    def plan_for_resources(self, tables: Sequence[str],
                           resources: Tuple[int, ...]) -> JointPlan:
        """r => p : resources fixed (e.g. tenant quota), optimize the plan."""
        t0 = time.perf_counter()
        costing = self._costing("time", fixed=resources)
        plan = self._plan(tables, costing)
        return self._wrap(plan, t0, costing)

    def resources_for_plan(self, plan: PlanNode, target_time: float
                           ) -> Tuple[Optional[Tuple[int, ...]], float]:
        """p => (r, c) : cheapest money whose predicted time <= target.
        Resources are re-planned per operator minimizing $ subject to the
        SLA; returns (per-op resources of the root op, total money).

        Uses the batched costing backend (one vectorized scan of the grid
        per operator, SLA constraint folded into the cost surface as inf)
        when the model exposes ``cost_grid``; scalar loop otherwise.  The
        scan runs on the selected ``PlanBackend`` with (ss, ls, target)
        as params, one SLA cost fn (and ``Surface``) per impl."""
        total_money = 0.0
        root_res = None
        backend = get_backend(self.backend)

        def _sla_fn(impl: str, be):
            fn = self._sla_fn_cache.get((impl, be.name))
            if fn is None:
                surface = Surface(self.models[impl], "sla")

                def fn(cfgs, params):
                    return surface(cfgs, params)

                fn.surface = surface
                self._sla_fn_cache[(impl, be.name)] = fn
            return fn

        def cheapest_under_sla(impl: str, ss: float, ls: float):
            model = self.models[impl]
            params = np.asarray([ss, ls, target_time])
            if hasattr(model, "cost_grid"):
                res, m = backend.argmin_grid(_sla_fn(impl, backend),
                                             self.cluster, params=params)
                if res is not None and not getattr(backend, "exact", False):
                    # re-evaluate the winner in float64; if float32
                    # rounding let an SLA-violating config win, redo the
                    # scan on the exact (still vectorized) torch backend
                    nc, cs = res
                    t = model.cost(ss, cs, nc, ls=ls)
                    if not (math.isfinite(t) and t <= target_time):
                        np_be = get_backend("torch")
                        res, m = np_be.argmin_grid(_sla_fn(impl, np_be),
                                                   self.cluster,
                                                   params=params)
                if res is None:
                    return None
                nc, cs = res
                t = model.cost(ss, cs, nc, ls=ls)
                if math.isfinite(t) and t <= target_time:
                    m = monetary_cost(t, cs, nc)
                return res, m
            best = None
            for res in self.cluster.all_configs():
                nc, cs = res
                t = model.cost(ss, cs, nc, ls=ls)
                if t <= target_time:
                    m = monetary_cost(t, cs, nc)
                    if best is None or m < best[1]:
                        best = (res, m)
            return best

        def walk(n: PlanNode):
            nonlocal total_money, root_res
            if n.is_leaf:
                return
            walk(n.left)
            walk(n.right)
            ss = min(n.left.size_gb, n.right.size_gb)
            ls = max(n.left.size_gb, n.right.size_gb)
            best = cheapest_under_sla(n.impl, ss, ls)
            if best is not None:
                total_money += best[1]
                root_res = best[0]
        walk(plan)
        return root_res, total_money

    def for_budget(self, tables: Sequence[str], budget: float) -> JointPlan:
        """c => (p, r) : best time among joint plans within a $ budget.
        Optimize for money first; if under budget, re-optimize for time and
        take the better feasible plan."""
        t0 = time.perf_counter()
        costing_m = self._costing("money")
        plan_m = self._plan(tables, costing_m)
        costing_t = self._costing("time")
        plan_t = self._plan(tables, costing_t)
        pick, pick_costing, pick_secs = None, None, math.inf
        for p, c in ((plan_t, costing_t), (plan_m, costing_m)):
            if p is not None and p.total_money <= budget:
                # compare predicted *seconds* for both candidates — a
                # money-costed plan's total_cost is dollars, numerically
                # incomparable with the time plan's seconds
                secs = self.predicted_exec_seconds(p)
                if pick is None or secs < pick_secs:
                    pick, pick_costing, pick_secs = p, c, secs
        if pick is None:                     # over budget: cheapest available
            pick, pick_costing = plan_m, costing_m
        # attribute stats to the costing that actually produced the picked
        # plan (previously money-costing stats were reported even when the
        # time-optimized plan won)
        return self._wrap(pick, t0, pick_costing)
