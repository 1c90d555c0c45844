"""RAQO-for-TPU: joint (parallelism plan x mesh resources) optimization.

The port's copy of ``repro.core.sharding_planner``.  It differs in four
places: the default backend is ``"cuda"`` (the CUDA scan and
neighbor-step kernels, raising without a GPU) and ``"torch"`` is the
exact float64 backend; each per-choice cost fn is a roofline
``cost_model.Surface`` (``RooflineCost`` with this planner's objective
and masks), which the CUDA kernels evaluate in-kernel; the float64
re-search after a float32 winner fails its commit runs on
``get_backend("torch")`` where the reference used numpy; and the fns do
not depend on the backend, whose dtype reaches them through the params.

This is the paper's architecture (Fig 8b) transplanted: the "query" is an
(architecture x input shape x objective), the "query plan" is the discrete
parallelism plan (attention schedule, weight mode, remat, FSDP — the
analog of {BHJ, SMJ} operator implementations), the "resource plan" is
(pods, dp, tp, microbatch), and the cost model is the three-term roofline.

Resource planning runs on the shared array-planning engine
(repro_torch.core.planning_backend) — the *same* search code paths as the
DB-domain reproduction: the whole resource grid is costed through the
vectorized ``terms_grid`` roofline (no per-config Python ``terms_for``
calls inside the search loop), either as an exhaustive scan (§VI-B1) or
as a multi-start ensemble climb (Algorithm 1, §VI-B2).  Per-request
scalars (chip budget, degraded-cluster cap) are params, so
``for_budget`` and adaptive ``replan`` evaluate the same surface.

Use-cases mirror §IV:
    r => p : best plan for a fixed chip budget       (plan_for_resources)
    => (p,r): best joint plan                        (joint)
    c => (p,r): best time within a chip-seconds $$   (for_budget)
Adaptive RAQO (§VIII): ``replan`` re-optimizes for degraded cluster
conditions (lost pods/chips) — used by the elastic restart path.

Session broker: with ``broker=PlanBroker(...)`` the per-choice searches
of ``joint`` / ``for_budget`` / ``replan`` defer to the same session
broker the DB-domain planners use — all plan choices (and any other
tenant's requests in flight, TPU or DB) are submitted before any
resolves, so one flush plans them as stacked array programs, fronted by
the resource-plan cache with current-cluster validation.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cluster import (ClusterConditions, PlanningStats,
                                      ResourceDim)
from repro_torch.core.cost_model import Surface
from repro_torch.core.plan_broker import PlanBroker, PlanRequest
from repro_torch.core.plan_cache import ResourcePlanCache
from repro_torch.core.planning_backend import PlanBackend, get_backend
from repro_torch.core.roofline import (HW, Resources, RooflineCost,
                                       RooflineTerms, chip_seconds, terms_for)
from repro_torch.obs import get_tracer

_obs = get_tracer()


def _pows2(lo: int, hi: int) -> Tuple[int, ...]:
    out = []
    v = lo
    while v <= hi:
        out.append(v)
        v *= 2
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class TpuCluster:
    """Current cluster condition (the RM view): available slices."""
    max_pods: int = 2
    max_dp: int = 16
    max_tp: int = 16
    hbm_per_chip: float = HW["hbm_bytes"]
    max_chips: Optional[int] = None          # degraded clusters (elastic)

    def dims(self, shape: ShapeConfig) -> ClusterConditions:
        max_mb = 8 if shape.kind == "train" else 1
        return ClusterConditions(dims=(
            ResourceDim("pods", 1, self.max_pods,
                        values=_pows2(1, self.max_pods)),
            ResourceDim("dp", 1, self.max_dp, values=_pows2(1, self.max_dp)),
            ResourceDim("tp", 1, self.max_tp, values=_pows2(1, self.max_tp)),
            ResourceDim("microbatch", 1, max_mb, values=_pows2(1, max_mb)),
        ))


# "operator implementations" per shape kind — the BHJ/SMJ analog
PLAN_CHOICES: Dict[str, List[Dict]] = {
    "train": [
        {"schedule": "dense", "remat": True, "fsdp": True, "seq_shard": True},
        {"schedule": "causal_skip", "remat": True, "fsdp": True,
         "seq_shard": True},
        {"schedule": "causal_skip", "remat": False, "fsdp": True,
         "seq_shard": True},
        {"schedule": "causal_skip", "remat": True, "fsdp": False,
         "seq_shard": True},
    ],
    "prefill": [
        {"schedule": "dense"},
        {"schedule": "causal_skip"},
    ],
    "decode": [
        {"weight_mode": "stationary"},
        {"weight_mode": "gathered"},
    ],
}


@dataclasses.dataclass
class ShardingDecision:
    arch: str
    shape: str
    resources: Resources
    plan_choice: Dict
    terms: RooflineTerms
    objective_value: float
    planner_seconds: float
    stats: PlanningStats

    def describe(self) -> str:
        r, t = self.resources, self.terms
        return (f"{self.arch} x {self.shape}: pods={r.pods} dp={r.dp} "
                f"tp={r.tp} mb={r.microbatch} ({r.chips} chips)  "
                f"plan={self.plan_choice}  step={t.step_s*1e3:.2f} ms  "
                f"[compute {t.compute_s*1e3:.2f} | memory {t.memory_s*1e3:.2f}"
                f" | collective {t.collective_s*1e3:.2f}] "
                f"bottleneck={t.bottleneck} hbm={t.hbm_per_chip/1e9:.1f}GB")


@dataclasses.dataclass
class ShardingPlanner:
    cluster: TpuCluster = dataclasses.field(default_factory=TpuCluster)
    # hillclimb (2-corner vectorized climb) | ensemble (corners + random
    # starts, all climbed as one batch) | brute (full-grid scan)
    resource_planning: str = "hillclimb"
    cache: Optional[ResourcePlanCache] = None
    objective: str = "time"                    # time | chip_seconds
    # cuda (the kernels; raises without a GPU) | torch (float64, exact)
    backend: Union[str, PlanBackend, None] = "cuda"
    ensemble_starts: int = 24                  # random starts for "ensemble"
    seed: int = 0
    # session planning broker shared with other planners (DB and TPU
    # domains batch through the same flushes); None keeps the inline path
    broker: Optional[PlanBroker] = None
    # per-(cfg, shape, choice) batch-cost fns: reusing the same fn object
    # lets the broker stack requests on one surface
    _grid_fn_cache: Dict = dataclasses.field(default_factory=dict,
                                             repr=False)

    def _objective(self, t: RooflineTerms, r: Resources) -> float:
        if not t.feasible:
            return math.inf
        if self.objective == "chip_seconds":
            return chip_seconds(t, r)
        return t.step_s

    def _hw(self) -> Dict[str, float]:
        return {**HW, "hbm_bytes": self.cluster.hbm_per_chip}

    def _cost_fn(self, cfg: ModelConfig, shape: ShapeConfig, choice: Dict,
                 budget: Optional[int]):
        """Scalar cost of ONE configuration — used to validate cached hits
        and to re-evaluate the search winner through float64, never inside
        the (vectorized) search loop."""
        def fn(res_tuple: Tuple[int, ...]) -> float:
            r = Resources(*res_tuple)
            if budget is not None and r.chips > budget:
                return math.inf
            if self.cluster.max_chips is not None and \
                    r.chips > self.cluster.max_chips:
                return math.inf
            # batch divisibility feasibility
            if shape.kind == "train" and \
                    shape.global_batch % (r.pods * r.dp * r.microbatch):
                return math.inf
            t = terms_for(cfg, shape, r, **{**choice, "hw": self._hw()})
            return self._objective(t, r)
        return fn

    def _grid_fn(self, cfg: ModelConfig, shape: ShapeConfig, choice: Dict,
                 backend: PlanBackend):
        """Batched cost surface fn(configs, params) over (N, 4) resource
        arrays; params = [chip_budget, max_chips] so budget/degraded-
        cluster variants share one surface.  The fn carries its roofline
        ``Surface`` (objective and masks: ``Surface._roofline``) as
        ``fn.surface``, which the CUDA backend evaluates in-kernel."""
        key = (backend.name, cfg, shape, tuple(sorted(choice.items())),
               self.objective, self.cluster.hbm_per_chip)
        fn = self._grid_fn_cache.get(key)
        if fn is not None:
            return fn
        surface = Surface(RooflineCost(cfg, shape, dict(choice), self._hw()),
                          self.objective)

        def fn(cfgs, params):
            return surface(cfgs, params)

        fn.surface = surface
        self._grid_fn_cache[key] = fn
        return fn

    def _params(self, budget: Optional[int]) -> np.ndarray:
        return np.asarray(
            [budget if budget is not None else math.inf,
             self.cluster.max_chips if self.cluster.max_chips is not None
             else math.inf], dtype=np.float64)

    def _data_key(self, cfg: ModelConfig, shape: ShapeConfig) -> float:
        """Data characteristics for the plan cache: active-GB x tokens."""
        toks = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
        return cfg.active_param_count() / 1e9 * 1e6 + toks / 1e3

    def _applicable_choices(self, cfg: ModelConfig, shape: ShapeConfig):
        for choice in PLAN_CHOICES[shape.kind]:
            # inapplicable choices (e.g. causal_skip for attention-free)
            if cfg.family == "ssm" and choice.get("schedule") == "causal_skip":
                continue
            yield choice

    def _joint_broker(self, cfg: ModelConfig, shape: ShapeConfig,
                      arch: str, chip_budget: Optional[int],
                      t0: float) -> ShardingDecision:
        """joint() through the session broker: submit every plan choice's
        resource search (cache-fronted, current-cluster-validated), then
        resolve — the first resolve flushes everything pending on the
        broker, this planner's choices and any other tenant's requests
        alike, as stacked array programs."""
        broker = self.broker
        backend = broker.backend
        stats = PlanningStats()
        dims = self.cluster.dims(shape)
        params = self._params(chip_budget)
        key = self._data_key(cfg, shape)
        mode = "grid" if self.resource_planning == "brute" else "ensemble"
        n_random = self.ensemble_starts \
            if self.resource_planning == "ensemble" else 0
        futs = []
        with _obs.span("sharding.joint.submit", cat="driver") as sp:
            for choice in self._applicable_choices(cfg, shape):
                model_id = f"{shape.kind}:{sorted(choice.items())}"
                scalar_fn = self._cost_fn(cfg, shape, choice, chip_budget)
                fallback = None if getattr(backend, "exact", False) else \
                    self._grid_fn(cfg, shape, choice, get_backend("torch"))
                req = PlanRequest(
                    fn=self._grid_fn(cfg, shape, choice, backend),
                    cluster=dims,
                    params=params, commit_fn=scalar_fn, mode=mode,
                    n_random=n_random, seed=self.seed,
                    scan_fallback=(mode == "ensemble"), fallback_fn=fallback,
                    cache=self.cache, cache_key=(model_id, cfg.family, key),
                    validate_hit=True, stats=stats)
                futs.append((choice, scalar_fn, broker.submit(req)))
            if sp:
                sp.set(shape=shape.name, choices=len(futs))
        best = None
        for choice, scalar_fn, fut in futs:
            res, cost = fut.result()
            if res is None or not math.isfinite(cost):
                continue
            r = Resources(*res)
            t = terms_for(cfg, shape, r, **{**choice, "hw": self._hw()})
            if best is None or cost < best.objective_value:
                best = ShardingDecision(
                    arch=arch or cfg.name, shape=shape.name, resources=r,
                    plan_choice=choice, terms=t, objective_value=cost,
                    planner_seconds=0.0, stats=stats)
        if best is None:
            raise RuntimeError(
                f"no feasible (plan, resources) for {cfg.name} x {shape.name}"
                f" under {self.cluster}")
        best.planner_seconds = time.perf_counter() - t0
        return best

    def joint(self, cfg: ModelConfig, shape: ShapeConfig, arch: str = "",
              chip_budget: Optional[int] = None) -> ShardingDecision:
        """=> (p, r): enumerate plan choices (operator implementations),
        search resources per choice on the array backend — the paper's
        §VI loop with the inner search fully vectorized.  With a session
        broker configured, all choices are planned in one flush."""
        t0 = time.perf_counter()
        if self.broker is not None:
            return self._joint_broker(cfg, shape, arch, chip_budget, t0)
        stats = PlanningStats()
        dims = self.cluster.dims(shape)
        backend = get_backend(self.backend)
        params = self._params(chip_budget)
        best = None
        for choice in PLAN_CHOICES[shape.kind]:
            # inapplicable choices (e.g. causal_skip for attention-free)
            if cfg.family == "ssm" and choice.get("schedule") == "causal_skip":
                continue
            key = self._data_key(cfg, shape)
            model_id = f"{shape.kind}:{sorted(choice.items())}"
            scalar_fn = self._cost_fn(cfg, shape, choice, chip_budget)
            grid_fn = self._grid_fn(cfg, shape, choice, backend)
            res = None
            if self.cache is not None:
                hit = self.cache.lookup(model_id, cfg.family, key,
                                        dims, stats)
                if hit is not None:
                    # validate under *current* cluster conditions — a cached
                    # plan from a healthier cluster may be infeasible now
                    # (adaptive RAQO, paper §VIII)
                    if math.isfinite(scalar_fn(hit)):
                        res = hit
            searched = res is None
            if res is None:
                if self.resource_planning == "brute":
                    res, cost = backend.argmin_grid(grid_fn, dims, stats,
                                                    params=params)
                else:
                    n_random = self.ensemble_starts \
                        if self.resource_planning == "ensemble" else 0
                    res, cost = backend.hill_climb_ensemble(
                        grid_fn, dims, stats=stats, params=params,
                        n_random=n_random, seed=self.seed)
                    if not math.isfinite(cost):
                        # all starts stranded on an infeasible plateau
                        # (OOM below / budget above): exhaustive scan —
                        # still one array program over the (small) grid
                        res, cost = backend.argmin_grid(grid_fn, dims,
                                                        stats, params=params)
            if res is None:
                continue
            # commit through the scalar float64 path (guards the float32
            # CUDA backend; exact no-op for the torch backend)
            raw = cost if searched else math.inf
            cost = scalar_fn(tuple(res))
            if not math.isfinite(cost) and backend.name != "torch":
                if getattr(backend, "exact", False):
                    # an exact backend: search and commit must agree on
                    # feasibility (parity assertion replaces the redo)
                    assert not (searched and math.isfinite(raw)), (
                        f"exact backend {backend.name} selected {res} with "
                        f"finite search cost {raw} but infinite commit")
                else:
                    # float32 rounding let an infeasible-in-float64 winner
                    # through: redo this choice on the exact torch backend
                    np_backend = get_backend("torch")
                    np_fn = self._grid_fn(cfg, shape, choice, np_backend)
                    res, _ = np_backend.argmin_grid(np_fn, dims, stats,
                                                    params=params)
                    if res is None:
                        continue
                    cost = scalar_fn(tuple(res))
            if not math.isfinite(cost):
                continue
            # persist to the cross-query cache only after the float64
            # commit accepted the plan (never cache float32-only winners)
            if searched and self.cache is not None:
                self.cache.insert(model_id, cfg.family, key, res,
                                  stats=stats)
            r = Resources(*res)
            # decision terms under the planner's own hardware view, like
            # the search itself (matters for non-default hbm_per_chip)
            t = terms_for(cfg, shape, r, **{**choice, "hw": self._hw()})
            if best is None or cost < best.objective_value:
                best = ShardingDecision(
                    arch=arch or cfg.name, shape=shape.name, resources=r,
                    plan_choice=choice, terms=t, objective_value=cost,
                    planner_seconds=0.0, stats=stats)
        if best is None:
            raise RuntimeError(
                f"no feasible (plan, resources) for {cfg.name} x {shape.name}"
                f" under {self.cluster}")
        best.planner_seconds = time.perf_counter() - t0
        return best

    def plan_for_resources(self, cfg: ModelConfig, shape: ShapeConfig,
                           resources: Resources) -> ShardingDecision:
        """r => p: fixed chips (tenant quota), pick the best plan choice."""
        t0 = time.perf_counter()
        best = None
        for choice in PLAN_CHOICES[shape.kind]:
            if cfg.family == "ssm" and choice.get("schedule") == "causal_skip":
                continue
            t = terms_for(cfg, shape, resources,
                          **{**choice, "hw": self._hw()})
            val = self._objective(t, resources)
            if best is None or val < best.objective_value:
                best = ShardingDecision(
                    arch=cfg.name, shape=shape.name, resources=resources,
                    plan_choice=choice, terms=t, objective_value=val,
                    planner_seconds=0.0, stats=PlanningStats())
        best.planner_seconds = time.perf_counter() - t0
        return best

    def for_budget(self, cfg: ModelConfig, shape: ShapeConfig,
                   chip_budget: int) -> ShardingDecision:
        """c => (p, r): best step time using at most ``chip_budget`` chips.
        The budget travels in ``params``, so the joint search's surfaces
        serve it unchanged."""
        return self.joint(cfg, shape, chip_budget=chip_budget)

    def replan(self, cfg: ModelConfig, shape: ShapeConfig,
               lost_chips: int) -> ShardingDecision:
        """Adaptive RAQO: cluster degraded (node failures) — re-optimize.
        Only ``max_chips`` changes (a param), so the degraded planner
        evaluates the healthy planner's surfaces."""
        degraded = dataclasses.replace(
            self.cluster,
            max_chips=(self.cluster.max_pods * self.cluster.max_dp *
                       self.cluster.max_tp - lost_chips))
        planner = dataclasses.replace(self, cluster=degraded)
        return planner.joint(cfg, shape)
