"""Algorithm 1 (paper §VI-B2): hill-climbing resource planning — verbatim —
plus the batched/vectorized search backends (§VII-C scale).

Generic over resource dimensions: the paper climbs (num_containers,
container_gb); the TPU sharding planner climbs (model degree, data degree,
pods, microbatch) with the *same* function.

The pseudocode's ``best = i`` on line 17 is a typo for ``best = j`` (the
candidate index); we implement the corrected version.  ``candidate`` is
[-1, +1]: one backward and one forward step per dimension, exactly as
initialized on line 2 of the paper's listing.

Batched backends
----------------
The vectorized search primitives live in ``repro_torch.core.planning_backend``
(the backend-agnostic array-planning layer shared by the DB and TPU
domains); this module keeps the scalar Algorithm 1 and thin wrappers that
delegate batched work to a ``PlanBackend``.

``brute_force`` accepts an optional ``batch_cost_fn`` that evaluates an
``(N, n_dims)`` array of configurations in one vectorized call; the grid is
then scanned in bounded-memory chunks (``argmin_grid``) instead of one
Python call per configuration — the paper's "16x overhead reduction"
enabling trick, which makes ``scaled_cluster(100_000, 100)`` (10M-point)
grids tractable.  Ties break identically to the scalar loop (first minimum
in ``all_configs`` order), so scalar and batched search return the same
configuration whenever the cost function is evaluated with identical
arithmetic (see cost_model.cost_grid).

``hill_climb_multi`` runs several climbs at once; with a ``batch_cost_fn``
every ±1 neighbor of every active start is costed per iteration as a single
batch (steepest-descent variant — it terminates at the same "no better ±1
neighbor" invariant as Algorithm 1).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import ClusterConditions, PlanningStats
from repro_torch.core.plan_cache import snap_to_grid
from repro_torch.core.planning_backend import (DEFAULT_CHUNK, BatchCostFn,
                                         enumerate_configs, get_backend,
                                         grid_arrays)

__all__ = ["hill_climb", "hill_climb_multi", "brute_force", "argmin_grid",
           "enumerate_configs", "grid_arrays", "get_discrete_steps",
           "BatchCostFn", "CANDIDATE_STEPS"]

CANDIDATE_STEPS = (-1, 1)


def get_discrete_steps(cluster: ClusterConditions) -> List[int]:
    """GetDiscreteSteps(clusterCond): one grid step per dimension."""
    return [d.step if not d.values else 1 for d in cluster.dims]


def _apply_step(dim, value: int, direction: int) -> Optional[int]:
    """Step one unit along a dim; for explicit-grid dims move to the
    neighboring grid entry."""
    if dim.values:
        idx = dim.values.index(value) + direction
        if 0 <= idx < len(dim.values):
            return dim.values[idx]
        return None
    v = value + direction * dim.step
    if dim.lo <= v <= dim.hi:
        return v
    return None


def hill_climb(cost_fn: Callable[[Tuple[int, ...]], float],
               cluster: ClusterConditions,
               start: Optional[Sequence[int]] = None,
               stats: Optional[PlanningStats] = None,
               max_iters: int = 100_000
               ) -> Tuple[Tuple[int, ...], float]:
    """HillClimbResourcePlanning(m, p, start, clusterCond).

    Starts from the smallest resource configuration (paper: "users want to
    minimize the resources used ... start from the smallest resource
    configuration and climb") unless ``start`` is given.  An off-grid
    ``start`` (e.g. interpolated by the weighted-average plan cache) is
    snapped to the nearest grid point first.  Returns (resources, cost)."""
    stats = stats if stats is not None else PlanningStats()
    if start is not None:
        curr = list(snap_to_grid(tuple(start), cluster))
    else:
        curr = list(cluster.min_config())

    def cost(cfg) -> float:
        stats.configs_explored += 1
        return cost_fn(tuple(cfg))

    for _ in range(max_iters):
        curr_cost = cost(curr)
        best_cost = curr_cost
        for i, dim in enumerate(cluster.dims):               # each resource dim
            best_j = -1
            saved = curr[i]
            for j, cand in enumerate(CANDIDATE_STEPS):
                stepped = _apply_step(dim, saved, cand)
                if stepped is None:                          # exceeds cluster
                    continue
                curr[i] = stepped
                temp = cost(curr)
                curr[i] = saved                              # backtrack
                if temp < best_cost:
                    best_cost = temp
                    best_j = j
            if best_j != -1:                                 # re-apply best step
                curr[i] = _apply_step(dim, saved, CANDIDATE_STEPS[best_j])
        if best_cost >= curr_cost:
            # no better neighbors exist -> local optimum
            return tuple(curr), curr_cost
    return tuple(curr), cost(curr)


# ------------------------- batched grid machinery -------------------------- #
# The implementations live in planning_backend (TorchPlanBackend) and
# kernels/plan_scan (CudaPlanBackend); these wrappers keep the historical
# hillclimb API and thread a backend selection through it (None -> "cuda").

def argmin_grid(batch_cost_fn: BatchCostFn, cluster: ClusterConditions,
                stats: Optional[PlanningStats] = None,
                chunk_size: int = DEFAULT_CHUNK, *,
                backend=None, params=None
                ) -> Tuple[Optional[Tuple[int, ...]], float]:
    """Exhaustive vectorized scan of the grid in bounded-memory chunks.
    Returns the first (in ``all_configs`` order) strict minimum, matching
    the scalar ``brute_force`` tie-breaking; (None, inf) if every
    configuration costs inf."""
    return get_backend(backend).argmin_grid(
        batch_cost_fn, cluster, stats, params=params, chunk_size=chunk_size)


def brute_force(cost_fn: Callable[[Tuple[int, ...]], float],
                cluster: ClusterConditions,
                stats: Optional[PlanningStats] = None,
                *,
                batch_cost_fn: Optional[BatchCostFn] = None,
                chunk_size: int = DEFAULT_CHUNK,
                backend=None, params=None
                ) -> Tuple[Optional[Tuple[int, ...]], float]:
    """Exhaustive search over the resource grid (paper §VI-B1).

    With ``batch_cost_fn`` the whole grid is evaluated as an array program
    (one vectorized call per ``chunk_size`` configurations) instead of one
    Python call per configuration; results are identical."""
    stats = stats if stats is not None else PlanningStats()
    if batch_cost_fn is not None:
        return argmin_grid(batch_cost_fn, cluster, stats, chunk_size,
                           backend=backend, params=params)
    best, best_cost = None, float("inf")
    for cfg in cluster.all_configs():
        stats.configs_explored += 1
        c = cost_fn(cfg)
        if c < best_cost:
            best, best_cost = cfg, c
    return best, best_cost


def hill_climb_multi(cost_fn: Callable[[Tuple[int, ...]], float],
                     cluster: ClusterConditions,
                     starts: Optional[Sequence[Sequence[int]]] = None,
                     stats: Optional[PlanningStats] = None,
                     *,
                     batch_cost_fn: Optional[BatchCostFn] = None,
                     max_iters: int = 100_000,
                     backend=None, params=None,
                     n_random: int = 0, seed: int = 0
                     ) -> Tuple[Tuple[int, ...], float]:
    """Multi-start hill climbing; returns the best local optimum found.

    Default starts are the smallest and largest configurations (the two
    corners that bracket 1/x-shaped cost surfaces), plus ``n_random``
    uniform grid starts (the vectorized multi-start *ensemble*).  Without
    a batch backend this runs Algorithm 1 once per start; with one, the
    selected ``PlanBackend`` costs all ±1 neighbors of all still-active
    starts per iteration as a single vectorized batch.
    """
    stats = stats if stats is not None else PlanningStats()

    if batch_cost_fn is None:
        if starts is None:
            starts = (cluster.min_config(), cluster.max_config())
        best, best_cost = None, math.inf
        for s in starts:
            res, cost = hill_climb(cost_fn, cluster, start=s, stats=stats,
                                   max_iters=max_iters)
            # keep a config even on an all-inf plateau (single-start
            # hill_climb returns its start config with inf cost; so do we)
            if best is None or cost < best_cost:
                best, best_cost = res, cost
        return best, best_cost

    return get_backend(backend).hill_climb_ensemble(
        batch_cost_fn, cluster, starts, stats, params=params,
        n_random=n_random, seed=seed, max_iters=max_iters)
