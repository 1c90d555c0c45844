"""Query-plan trees, cardinality estimation, and joint operator costing.

``OperatorCosting`` is the §VI-C integration point: ``op_cost`` extends the
query planner's getPlanCost with per-operator *resource planning* (brute
force, Algorithm-1 hill climbing, or a fixed configuration), optionally
backed by the resource-plan cache.  Each join operator plans its resources
independently (paper §VI-B assumption: operators sit at shuffle
boundaries).

Batched costing: when the cost model exposes ``cost_grid`` (all the models
in cost_model.py do), resource planning runs as an array program — brute
force evaluates the whole grid in chunked vectorized calls, and
``hillclimb_batched`` costs all ±1 neighbors of all starts per iteration
as one batch.  Results of full-grid planning are memoized per
(impl, ss, ls, objective) across the operators of one query
(``begin_query`` resets the memo), independently of the cross-query
resource-plan cache.

Backend selection (repro_torch.core.planning_backend): ``backend=None``
or ``"cuda"`` (the default) runs every search on the hand-written CUDA
scan and neighbor-step kernels of repro_torch.kernels.plan_scan (config
decode, cost evaluation and the argmin in one kernel — no materialized
cost vector), and raises without a GPU; ``backend="torch"`` is the exact
float64 CPU backend, bit-identical with the scalar loops and with the
reference's numpy backend, which keeps the historical scalar/batched
paths below.  The per-operator data characteristics (ss, ls) travel as
params, and ``_grid_fn`` returns one cost fn per (impl, objective) that
carries a ``.surface`` descriptor — what the CUDA kernels evaluate.
``resource_planning="ensemble"`` climbs a vectorized multi-start
ensemble (min/max corners + ``ensemble_starts`` random grid starts,
every ±1 neighbor of every start costed as one batch per iteration).

Deferred planning (repro_torch.core.plan_broker): with ``broker=PlanBroker(...)``
resource planning becomes request/resolve — ``plan_resources_async`` /
``prefetch`` queue requests on the session broker and the first
``result()`` flushes *everything* pending (every operator of every query
sharing the broker) as stacked array programs.  ``plan_resources`` keeps
its synchronous signature (submit + resolve) and, with an exact-mode (or
no) cache, returns bit-identical plans and costs to the per-operator
loop.  The per-query memo and ``begin_query()`` isolation are unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cluster import ClusterConditions, PlanningStats
from repro_torch.core.cost_model import (HiveSimulator, RegressionModel,
                                         Surface, _split_configs,
                                         monetary_cost)
from repro_torch.core.hillclimb import brute_force, hill_climb, hill_climb_multi
from repro_torch.core.plan_broker import PlanBroker, PlanRequest
from repro_torch.core.plan_cache import ResourcePlanCache
from repro_torch.core.planning_backend import PlanBackend, get_backend
from repro_torch.core.schema import Schema

GB = 1 << 30
IMPLS = ("SMJ", "BHJ")


# ------------------------------- plan trees -------------------------------- #

@dataclasses.dataclass(frozen=True)
class PlanNode:
    tables: FrozenSet[str]
    rows: float
    row_bytes: float
    # join-only fields
    left: Optional["PlanNode"] = None
    right: Optional["PlanNode"] = None
    impl: Optional[str] = None
    resources: Optional[Tuple[int, ...]] = None
    op_cost: float = 0.0
    total_cost: float = 0.0           # sum of op costs in the subtree
    total_money: float = 0.0

    @property
    def size_gb(self) -> float:
        return self.rows * self.row_bytes / GB

    @property
    def is_leaf(self) -> bool:
        return self.left is None

    def describe(self, indent: int = 0) -> str:
        pad = "  " * indent
        if self.is_leaf:
            return f"{pad}{next(iter(self.tables))} ({self.size_gb:.3f} GB)"
        r = f" r={self.resources}" if self.resources else ""
        s = (f"{pad}{self.impl}{r} cost={self.op_cost:.2f}s "
             f"total={self.total_cost:.2f}s out={self.size_gb:.3f}GB\n")
        return s + self.left.describe(indent + 1) + "\n" + \
            self.right.describe(indent + 1)


def leaf(schema: Schema, table: str) -> PlanNode:
    r = schema.relations[table]
    return PlanNode(tables=frozenset({table}), rows=float(r.rows),
                    row_bytes=float(r.row_bytes))


def join_cardinality(schema: Schema, l: PlanNode, r: PlanNode
                     ) -> Tuple[float, float]:
    """Rows/row_bytes of l |><| r: product of crossing-edge selectivities."""
    em = schema.edge_map()
    sel = 1.0
    found = False
    for a in l.tables:
        for b in r.tables:
            s = em.get(frozenset((a, b)))
            if s is not None:
                sel *= s
                found = True
    if not found:
        sel = 1.0          # cross join (planners avoid these when possible)
    return l.rows * r.rows * sel, l.row_bytes + r.row_bytes


def has_edge(schema: Schema, l: PlanNode, r: PlanNode) -> bool:
    em = schema.edge_map()
    return any(frozenset((a, b)) in em for a in l.tables for b in r.tables)


# ------------------------------ costing ------------------------------------ #

class _Resolved:
    """Already-resolved plan future (non-broker and memo-hit paths)."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class _CostingFuture:
    """Broker future that lands in the costing's per-query memo when
    resolved, so later same-operator calls stay memo-cheap."""

    __slots__ = ("_costing", "_mkey", "_fut")

    def __init__(self, costing, mkey, fut):
        self._costing = costing
        self._mkey = mkey
        self._fut = fut

    def result(self):
        out = self._fut.result()
        self._costing._plan_memo[self._mkey] = out
        self._costing._pending.pop(self._mkey, None)
        return out


@dataclasses.dataclass
class OperatorCosting:
    """Joint query+resource costing of a single join operator."""
    models: Dict[str, RegressionModel]
    cluster: ClusterConditions
    # hillclimb | hillclimb_batched | ensemble | brute | batched | fixed
    resource_planning: str = "hillclimb"
    fixed_resources: Tuple[int, ...] = (10, 4)
    cache: Optional[ResourcePlanCache] = None
    cache_key_round: float = 0.01            # GB rounding of data-char key
    objective: str = "time"                  # time | money
    stats: PlanningStats = dataclasses.field(default_factory=PlanningStats)
    backend: Union[str, PlanBackend, None] = None      # None -> "cuda"
    ensemble_starts: int = 24                # random starts for "ensemble"
    seed: int = 0
    # session planning broker (plan_broker): when set, resource planning
    # defers to it — every operator of every query sharing this broker
    # is planned in stacked flushes instead of one program per request
    broker: Optional[PlanBroker] = None
    # per-query memo of planned resources, keyed (impl, ss, ls, objective)
    _plan_memo: Dict[Tuple, Tuple[Tuple[int, ...], float]] = \
        dataclasses.field(default_factory=dict, repr=False)
    # per-(impl, objective) batch-cost fns fn(configs, [ss, ls]): one fn
    # object across operators, so the broker groups their requests into
    # one stacked search
    _grid_fn_cache: Dict = dataclasses.field(default_factory=dict,
                                             repr=False)
    # in-flight broker futures of the current query, keyed like the memo
    _pending: Dict[Tuple, "_CostingFuture"] = \
        dataclasses.field(default_factory=dict, repr=False)

    def begin_query(self) -> None:
        """Reset the per-query resource-plan memo and any not-yet-resolved
        broker prefetches (planners call this once per optimized query;
        the cross-query cache and the session broker survive)."""
        self._plan_memo.clear()
        self._pending.clear()

    def _op_cost_at(self, impl: str, ss: float, ls: float,
                    res: Tuple[int, ...]) -> float:
        nc, cs = res
        t = self.models[impl].cost(ss, cs, nc, ls=ls)
        self.stats.cost_calls += 1
        if not math.isfinite(t):
            return math.inf
        if self.objective == "money":
            return monetary_cost(t, cs, nc)
        return t

    def _op_cost_grid(self, impl: str, ss: float, ls: float,
                      configs) -> torch.Tensor:
        """Vectorized `_op_cost_at` over an (N, 2) array of (nc, cs)."""
        configs = torch.as_tensor(configs)
        t = self.models[impl].cost_grid(ss, ls, configs)
        self.stats.cost_calls += len(configs)
        if self.objective == "money":
            nc, cs = _split_configs(configs)
            return torch.where(torch.isfinite(t), monetary_cost(t, cs, nc),
                               math.inf)
        return t

    def _batch_fn(self, impl: str, ss: float, ls: float):
        if hasattr(self.models[impl], "cost_grid"):
            return lambda cfgs: self._op_cost_grid(impl, ss, ls, cfgs)
        return None

    def _grid_fn(self, impl: str, backend: PlanBackend):
        """Param-style batch cost surface fn(configs, params) with
        params = [ss, ls]; one fn per (impl, objective) serves every
        operator.  The fn carries its ``Surface`` descriptor as
        ``fn.surface``, which the CUDA backend evaluates in-kernel."""
        key = (impl, self.objective, backend.name)
        fn = self._grid_fn_cache.get(key)
        if fn is not None:
            return fn
        model = self.models[impl]
        if not hasattr(model, "cost_grid"):
            return None
        surface = Surface(model, self.objective)

        def fn(cfgs, params):
            return surface(cfgs, params)

        fn.surface = surface
        self._grid_fn_cache[key] = fn
        return fn

    def _cache_kind(self, ls: float) -> str:
        """Sub-plan kind for the resource-plan cache.  Includes the
        objective (a time-optimal config is not a money-optimal one) and a
        coarse log2 bucket of the large-side size, so nearest-neighbor
        interpolation only happens between operators with comparable
        probe-side data."""
        bucket = int(round(math.log2(max(ls, 1e-3))))
        return f"join:{self.objective}:ls{bucket}"

    def _broker_mode(self, impl: str) -> Optional[Tuple[str, int]]:
        """(broker search mode, n_random) when this request can defer to
        the session broker; None keeps the synchronous per-operator path
        (so broker and non-broker costings stay behavior-identical)."""
        if self.broker is None or self.resource_planning == "fixed":
            return None
        if not hasattr(self.models[impl], "cost_grid"):
            return None
        mode = self.resource_planning
        if mode in ("brute", "batched"):
            return ("grid", 0)
        if mode == "ensemble":
            return ("ensemble", self.ensemble_starts)
        if mode == "hillclimb_batched":
            return ("ensemble", 0)
        if mode == "hillclimb" and self.broker.backend.name != "torch":
            # on the exact torch backend this mode is the scalar Algorithm
            # 1 (single min-corner start) — not a broker shape; others
            # already route it through the 2-corner ensemble
            return ("ensemble", 0)
        return None

    def plan_resources_async(self, impl: str, ss: float, ls: float):
        """Deferred resource planning: submit to the session broker and
        return a future; ``result()`` flushes every pending request of
        every caller sharing the broker.  Falls back to an immediately
        resolved future when no broker (or an unsupported mode) is
        configured."""
        mkey = (impl, ss, ls, self.objective)
        memo = self._plan_memo.get(mkey)
        if memo is not None:
            return _Resolved(memo)
        pend = self._pending.get(mkey)
        if pend is not None:
            return pend
        mode = self._broker_mode(impl)
        if mode is None:
            return _Resolved(self.plan_resources(impl, ss, ls))
        backend = self.broker.backend
        grid_fn = self._grid_fn(impl, backend)
        if grid_fn is None:
            return _Resolved(self.plan_resources(impl, ss, ls))
        fallback = None if getattr(backend, "exact", False) \
            else self._grid_fn(impl, get_backend("torch"))
        req = PlanRequest(
            fn=grid_fn, cluster=self.cluster,
            params=np.asarray([ss, ls], dtype=np.float64),
            commit_fn=lambda res: self._op_cost_at(impl, ss, ls,
                                                   tuple(res)),
            mode=mode[0], n_random=mode[1], seed=self.seed,
            fallback_fn=fallback, cache=self.cache,
            cache_key=(impl, self._cache_kind(ls), round(ss, 6)),
            stats=self.stats)
        wrapper = _CostingFuture(self, mkey, self.broker.submit(req))
        self._pending[mkey] = wrapper
        return wrapper

    def prefetch(self, impl: str, ss: float, ls: float) -> None:
        """Queue one operator's resource planning on the broker without
        resolving it (no-op without a broker)."""
        if self.broker is not None:
            self.plan_resources_async(impl, ss, ls)

    def share_pending(self, impl: str, ss: float, ls: float):
        """The raw broker future of an in-flight prefetch for this
        operator, or None.  Lockstep multi-query planning
        (``RAQO.plan_queries``) hands it to sibling costings via
        ``adopt_future`` so identical base-table candidates submit to
        the broker once — "queue once, fan the future out"."""
        wrapper = self._pending.get((impl, ss, ls, self.objective))
        return None if wrapper is None else wrapper._fut

    def pending_futures(self) -> list:
        """Raw broker futures of every in-flight prefetch of this costing
        (read-only peek).  The streaming planner service samples their
        ``PlanFuture.critical_path()`` after each wave instead of growing
        its own per-request timers."""
        return [w._fut for w in self._pending.values()]

    def adopt_future(self, impl: str, ss: float, ls: float, fut) -> None:
        """Adopt a sibling costing's broker future as this operator's
        pending prefetch.  The broker resolves one search; each adopter
        lands the identical (resources, cost) in its own per-query memo
        — the same number its own submission would have produced, since
        the cost is a pure function of (impl, ss, ls, objective) under
        shared models/cluster.  No-op when this costing already memoized
        or queued the operator itself."""
        mkey = (impl, ss, ls, self.objective)
        if mkey not in self._plan_memo and mkey not in self._pending:
            self._pending[mkey] = _CostingFuture(self, mkey, fut)

    def prefetch_join(self, schema: Schema, l: PlanNode, r: PlanNode,
                      impls: Sequence[str] = IMPLS) -> None:
        """Queue the candidate costings of joining l and r (both operator
        implementations) — planners call this for a whole enumeration
        level before resolving, so one flush plans the level."""
        if self.broker is None:
            return
        ss = min(l.size_gb, r.size_gb)
        ls = max(l.size_gb, r.size_gb)
        for impl in impls:
            self.prefetch(impl, ss, ls)

    def plan_resources(self, impl: str, ss: float, ls: float
                       ) -> Tuple[Tuple[int, ...], float]:
        """Resource planning for one operator (memo -> cache -> search)."""
        if self._broker_mode(impl) is not None:
            return self.plan_resources_async(impl, ss, ls).result()
        # exact floats on purpose: the memo must be behavior-preserving
        # (same (ss, ls) -> same plan and cost); approximate reuse is the
        # cross-query cache's job, not the memo's
        mkey = (impl, ss, ls, self.objective)
        memo = self._plan_memo.get(mkey)
        if memo is not None:
            return memo
        key = round(ss, 6)
        kind = self._cache_kind(ls)
        if self.cache is not None:
            hit = self.cache.lookup(impl, kind, key, self.cluster,
                                    self.stats)
            if hit is not None:
                out = hit, self._op_cost_at(impl, ss, ls, hit)
                self._plan_memo[mkey] = out
                return out
        fn = lambda res: self._op_cost_at(impl, ss, ls, res)   # noqa: E731
        mode = self.resource_planning
        backend = get_backend(self.backend)
        # a non-exact backend takes over every search mode (on "torch" the
        # historical scalar/batched paths below are already the backend)
        grid_fn = self._grid_fn(impl, backend) \
            if (mode == "ensemble" or backend.name != "torch") \
            and mode != "fixed" else None
        if mode == "fixed":
            res, cost = self.fixed_resources, fn(self.fixed_resources)
            self.stats.configs_explored += 1
        elif grid_fn is not None:
            # unified backend path: ss/ls travel as params, one cost fn
            # per (impl, objective)
            params = np.asarray([ss, ls], dtype=np.float64)
            before = self.stats.configs_explored
            if mode in ("brute", "batched"):
                res, cost = backend.argmin_grid(grid_fn, self.cluster,
                                                self.stats, params=params)
            else:            # ensemble | hillclimb | hillclimb_batched
                n_random = self.ensemble_starts if mode == "ensemble" else 0
                res, cost = backend.hill_climb_ensemble(
                    grid_fn, self.cluster, stats=self.stats, params=params,
                    n_random=n_random, seed=self.seed)
            self.stats.cost_calls += self.stats.configs_explored - before
            if res is not None:
                # commit through the scalar float64 path (guards the
                # float32 CUDA backend; exact no-op on "torch")
                raw = cost
                cost = fn(res)
                if not math.isfinite(cost) and backend.name != "torch":
                    if getattr(backend, "exact", False):
                        # x64-scoped jit: selection is exact, so search
                        # and commit must agree on feasibility — the
                        # float64 redo shrinks to a parity assertion
                        assert not math.isfinite(raw), (
                            f"exact backend {backend.name} selected {res} "
                            f"with finite search cost {raw} but infinite "
                            f"float64 commit")
                    else:
                        # float32 rounding let an infeasible-in-float64
                        # winner through: redo exactly on the float64
                        # torch path so a feasible config is never
                        # reported (or memoized) as infeasible
                        res, cost = brute_force(
                            fn, self.cluster, self.stats,
                            batch_cost_fn=self._batch_fn(impl, ss, ls),
                            backend="torch")
        elif mode in ("brute", "batched"):
            # the batched backend scans the same grid with identical
            # arithmetic and tie-breaking; scalar loop is the fallback for
            # models without cost_grid
            res, cost = brute_force(fn, self.cluster, self.stats,
                                    batch_cost_fn=self._batch_fn(impl, ss,
                                                                 ls),
                                    backend="torch")
        elif mode in ("hillclimb_batched", "ensemble"):
            # ensemble lands here only for models without cost_grid: keep
            # at least the scalar multi-start (corner) climbs
            res, cost = hill_climb_multi(fn, self.cluster, stats=self.stats,
                                         batch_cost_fn=self._batch_fn(
                                             impl, ss, ls),
                                         backend="torch")
        else:
            res, cost = hill_climb(fn, self.cluster, stats=self.stats)
        if self.cache is not None and math.isfinite(cost):
            self.cache.insert(impl, kind, key, res, stats=self.stats)
        self._plan_memo[mkey] = (res, cost)
        return res, cost

    def best_join(self, schema: Schema, l: PlanNode, r: PlanNode,
                  impls: Sequence[str] = IMPLS) -> PlanNode:
        """Join l and r with the best (impl, resources) pair."""
        rows, rb = join_cardinality(schema, l, r)
        ss = min(l.size_gb, r.size_gb)
        ls = max(l.size_gb, r.size_gb)
        # submit every implementation's planning before resolving any, so
        # one broker flush covers the whole candidate set
        futs = [(impl, self.plan_resources_async(impl, ss, ls))
                for impl in impls] if self.broker is not None else \
               [(impl, None) for impl in impls]
        best = None
        for impl, fut in futs:
            res, cost = fut.result() if fut is not None \
                else self.plan_resources(impl, ss, ls)
            if best is None or cost < best[1]:
                best = (impl, cost, res)
        impl, cost, res = best
        nc, cs = res
        t = self.models[impl].cost(ss, cs, nc, ls=ls)
        money = monetary_cost(t, cs, nc) if math.isfinite(t) else math.inf
        return PlanNode(
            tables=l.tables | r.tables, rows=rows, row_bytes=rb,
            left=l, right=r, impl=impl, resources=res, op_cost=cost,
            total_cost=l.total_cost + r.total_cost + cost,
            total_money=l.total_money + r.total_money + money)
