"""Array-planning layer of the port: grid helpers, the plain torch
``TorchPlanBackend`` and backend selection.

The counterpart of ``repro.core.planning_backend``.  Three primitives
search a discrete resource grid (``ClusterConditions``):

    enumerate_configs   row [lo, hi) slices of the full grid, in
                        ``all_configs`` order (the tie-breaking contract)
    argmin_grid         exhaustive scan in bounded-memory chunks (§VI-B1)
    hill_climb_ensemble multi-start steepest descent, every ±1 neighbor of
                        every active start costed as one batch (§VI-B2)

plus their stacked forms ``argmin_grid_many`` / ``hill_climb_ensemble_many``
over a ``(Q, P)`` params array (each request's scalars enter the cost fn
as ``(Q, 1)`` columns), and the ``*_async`` dispatch/finalize split the
broker's double-buffered waves use.

Backends (``get_backend``):

* ``"torch"`` — ``TorchPlanBackend(device="cpu", dtype=torch.float64)``,
  ``exact=True``: the counterpart of the reference's numpy backend, bit
  for bit (same chunking, same strict-< first-minimum fold, float64 torch
  elementwise arithmetic).  The broker's float64 re-search runs here.
* ``"cuda"`` (also ``None``) — ``repro_torch.kernels.plan_scan.
  CudaPlanBackend``: the hand-written CUDA scan and neighbor-step kernels,
  float32, ``exact=False`` (the counterpart of the reference's pallas
  backend).  Without a GPU it raises; it never drifts to the CPU.
* ``TorchPlanBackend(device="cuda", dtype=torch.float32)`` is the plain
  version of the CUDA backend on the card.

Batch-cost-fn contract: ``fn(configs)`` or ``fn(configs, params)`` ->
costs, where ``configs`` is an ``(N, n_dims)`` int64 tensor on the
backend's device and ``params`` a tensor of the backend's dtype;
infeasible configurations cost ``inf``.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cluster import ClusterConditions, PlanningStats
from repro_torch.core.plan_cache import snap_to_grid

BatchCostFn = Callable[..., torch.Tensor]
Result = Tuple[Optional[Tuple[int, ...]], float]

DEFAULT_CHUNK = 1 << 20

# Stacked-scan chunk sizing (see _many_chunk): chunks never shrink below
# MIN_SHARD_ROWS rows, and the live cost block (Q, chunk) never exceeds
# MAX_LIVE_ELEMENTS elements.
MIN_SHARD_ROWS = 512
MAX_LIVE_ELEMENTS = 1 << 22


# ----------------------------- grid helpers -------------------------------- #

def grid_arrays(cluster: ClusterConditions) -> List[np.ndarray]:
    """Per-dimension value grids as int64 arrays."""
    return [np.asarray(d.grid(), dtype=np.int64) for d in cluster.dims]


def enumerate_configs(cluster: ClusterConditions, lo: int = 0,
                      hi: Optional[int] = None) -> np.ndarray:
    """Rows [lo, hi) of the full resource grid as an (M, n_dims) int64
    array, in the exact order ``cluster.all_configs()`` yields tuples
    (row-major: first dimension slowest)."""
    grids = grid_arrays(cluster)
    shape = tuple(len(g) for g in grids)
    total = int(np.prod(shape)) if shape else 0
    hi = total if hi is None else min(hi, total)
    flat = np.arange(lo, hi, dtype=np.int64)
    idx = np.unravel_index(flat, shape)
    return np.stack([g[i] for g, i in zip(grids, idx)], axis=1)


def start_indices(cluster: ClusterConditions,
                  starts: Optional[Sequence[Sequence[int]]],
                  n_random: int, seed: int) -> np.ndarray:
    """Ensemble start points as grid *indices* (S, n_dims): the min+max
    corners (or explicit ``starts``, snapped to the grid) plus
    ``n_random`` uniform grid points drawn from the same seeded numpy
    generator as the reference, so ensembles start from the same points."""
    grids = grid_arrays(cluster)
    if starts is None:
        base = [cluster.min_config(), cluster.max_config()]
    else:
        base = [tuple(s) for s in starts]
    idx = [_snap_to_indices(s, cluster, grids) for s in base]
    if n_random > 0:
        rng = np.random.default_rng(seed)
        rand = np.stack([rng.integers(0, len(g), size=n_random)
                         for g in grids], axis=1)
        idx.extend(rand.tolist())
    # dedupe while preserving order (corners first)
    seen, uniq = set(), []
    for row in idx:
        t = tuple(int(v) for v in row)
        if t not in seen:
            seen.add(t)
            uniq.append(t)
    return np.asarray(uniq, dtype=np.int64)


def _snap_to_indices(cfg: Sequence[int], cluster: ClusterConditions,
                     grids: List[np.ndarray]) -> List[int]:
    snapped = snap_to_grid(tuple(cfg), cluster)
    return [int(np.argmin(np.abs(g - v))) for g, v in zip(grids, snapped)]


def _decode_flat(grids: List[np.ndarray], shape: Tuple[int, ...],
                 flat: int) -> Tuple[int, ...]:
    idx = np.unravel_index(int(flat), shape)
    return tuple(int(g[i]) for g, i in zip(grids, idx))


def _many_chunk(total: int, q: int, chunk_size: int) -> int:
    """Rows per chunk of a stacked Q-request grid scan: ``chunk_size // q``
    floored at ``MIN_SHARD_ROWS``, capped so the live ``(q, chunk)`` cost
    block stays within ``MAX_LIVE_ELEMENTS``, and clipped to the grid (the
    reference's single-device geometry).  The argmin is invariant to
    chunking (strict-< fold), so this changes geometry, never results."""
    q = max(1, q)
    chunk = max(chunk_size // q, MIN_SHARD_ROWS)
    chunk = min(chunk, max(1, MAX_LIVE_ELEMENTS // q))
    return int(min(chunk, total))


def _neighbor_offsets(n_dims: int) -> np.ndarray:
    """(2*n_dims, n_dims) index offsets: one -1 and one +1 step per dim,
    exactly the candidate set initialised on line 2 of Algorithm 1."""
    offs = np.zeros((2 * n_dims, n_dims), dtype=np.int64)
    for d in range(n_dims):
        offs[2 * d, d] = -1
        offs[2 * d + 1, d] = 1
    return offs


def resolve_device(device) -> torch.device:
    """``torch.device`` for a backend; a CUDA device without a GPU raises
    instead of running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA planning backend requested but no CUDA GPU is available; "
            "pass device='cpu' (or backend='torch') to plan on the CPU")
    return dev


# ------------------------------ torch backend ------------------------------ #

class TorchPlanBackend:
    """Chunked torch search: the reference numpy backend's algorithm with
    torch arithmetic.  In float64 on the CPU (``get_backend("torch")``) it
    is bit-identical with the reference numpy backend; in float32 on the
    card it is the plain version of ``CudaPlanBackend``."""

    def __init__(self, device="cpu", dtype: torch.dtype = torch.float64):
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"unsupported dtype {dtype}")
        self.dtype = dtype
        self.exact = dtype == torch.float64
        self.name = "torch" if self.exact else "torch_f32"

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _call(self, fn: BatchCostFn, cfgs: np.ndarray, params) -> torch.Tensor:
        c = torch.as_tensor(cfgs, device=self.device)
        out = fn(c) if params is None else fn(c, self._tensor(params))
        return torch.as_tensor(out, dtype=self.dtype)

    def argmin_grid(self, batch_cost_fn: BatchCostFn,
                    cluster: ClusterConditions,
                    stats: Optional[PlanningStats] = None, *,
                    params=None, chunk_size: int = DEFAULT_CHUNK) -> Result:
        """Exhaustive scan in bounded-memory chunks.  Returns the first (in
        ``all_configs`` order) strict minimum; (None, inf) if every
        configuration costs inf.  Chunk winners stay on the device until
        one host copy folds them."""
        stats = stats if stats is not None else PlanningStats()
        total = cluster.grid_size()
        costs, flats = [], []
        for lo in range(0, total, chunk_size):
            cfgs = enumerate_configs(cluster, lo, lo + chunk_size)
            c = self._call(batch_cost_fn, cfgs, params)
            stats.configs_explored += len(cfgs)
            i = torch.argmin(c)
            costs.append(c[i])
            flats.append(i + lo)
        if not costs:
            return None, math.inf
        costs = torch.stack(costs).cpu().numpy().astype(np.float64)
        flats = torch.stack(flats).cpu().numpy()
        k = int(np.argmin(costs))           # first min: lowest-lo chunk
        if not costs[k] < math.inf:
            return None, math.inf
        grids = grid_arrays(cluster)
        shape = tuple(len(g) for g in grids)
        return _decode_flat(grids, shape, flats[k]), float(costs[k])

    def hill_climb_ensemble(self, batch_cost_fn: BatchCostFn,
                            cluster: ClusterConditions,
                            starts: Optional[Sequence[Sequence[int]]] = None,
                            stats: Optional[PlanningStats] = None, *,
                            params=None, n_random: int = 0, seed: int = 0,
                            max_iters: int = 100_000) -> Result:
        """Batched multi-start steepest-descent climbing: every iteration
        costs all ±1 neighbors of all still-active starts as one batch; a
        start deactivates when no neighbor improves it.  Returns the best
        local optimum over the ensemble."""
        stats = stats if stats is not None else PlanningStats()
        grids = grid_arrays(cluster)
        sizes = np.array([len(g) for g in grids], dtype=np.int64)
        n_dims = len(grids)

        def values_of(idx: np.ndarray) -> np.ndarray:
            return np.stack([grids[d][idx[:, d]] for d in range(n_dims)],
                            axis=1)

        def cost_of(idx: np.ndarray) -> np.ndarray:
            out = self._call(batch_cost_fn, values_of(idx), params)
            return out.cpu().numpy().astype(np.float64)

        cur = start_indices(cluster, starts, n_random, seed)
        cur_cost = cost_of(cur)
        stats.configs_explored += len(cur)
        active = np.ones(len(cur), dtype=bool)
        offs = _neighbor_offsets(n_dims)

        for _ in range(max_iters):
            act = np.flatnonzero(active)
            if act.size == 0:
                break
            nbr = cur[act][:, None, :] + offs[None, :, :]
            flat = nbr.reshape(-1, n_dims)
            valid = ((flat >= 0) & (flat < sizes)).all(axis=1)
            costs = np.full(len(flat), np.inf)
            if valid.any():
                costs[valid] = cost_of(flat[valid])
                stats.configs_explored += int(valid.sum())
            costs = costs.reshape(act.size, 2 * n_dims)
            best_j = np.argmin(costs, axis=1)
            best_c = costs[np.arange(act.size), best_j]
            improved = best_c < cur_cost[act]
            moved = act[improved]
            cur[moved] = nbr[improved, best_j[improved]]
            cur_cost[moved] = best_c[improved]
            active[:] = False
            active[moved] = True

        i = int(np.argmin(cur_cost))
        res = tuple(int(v) for v in values_of(cur[i:i + 1])[0])
        return res, float(cur_cost[i])

    # -- stacked many-request search ----------------------------------------- #
    def argmin_grid_many_async(self, batch_cost_fn: BatchCostFn,
                               cluster: ClusterConditions,
                               params_many, *,
                               stats: Optional[PlanningStats] = None,
                               chunk_size: int = DEFAULT_CHUNK
                               ) -> Callable[[], List[Result]]:
        """Exhaustive scan for Q requests sharing one cost fn and grid:
        params enter the fn as ``(Q, 1)`` columns broadcasting against the
        ``(M,)`` config columns, so every request sees the arithmetic of
        its own scan.  Chunk winners stay on the device; the returned
        ``finalize`` does the one host copy and the first-minimum fold."""
        stats = stats if stats is not None else PlanningStats()
        pm = np.asarray(params_many, dtype=np.float64)
        Q = pm.shape[0]
        if Q == 0:
            return lambda: []
        total = cluster.grid_size()
        p = self._tensor(pm.T[:, :, None])        # params[k] -> (Q, 1)
        chunk = _many_chunk(total, Q, chunk_size)
        costs, flats = [], []
        for lo in range(0, total, chunk):
            cfgs = torch.as_tensor(enumerate_configs(cluster, lo, lo + chunk),
                                   device=self.device)
            out = torch.as_tensor(batch_cost_fn(cfgs, p), dtype=self.dtype)
            c = out.broadcast_to((Q, len(cfgs)))
            stats.configs_explored += Q * len(cfgs)
            j = torch.argmin(c, dim=1)
            costs.append(c.gather(1, j[:, None])[:, 0])
            flats.append(j + lo)
        grids = grid_arrays(cluster)
        shape = tuple(len(g) for g in grids)

        def finalize() -> List[Result]:
            if not costs:
                return [(None, math.inf)] * Q
            cs = torch.stack(costs).cpu().numpy().astype(np.float64)
            fs = torch.stack(flats).cpu().numpy()            # (C, Q)
            k = np.argmin(cs, axis=0)      # first min: lowest-lo chunk
            return [(None, math.inf) if not cs[k[q], q] < math.inf else
                    (_decode_flat(grids, shape, fs[k[q], q]),
                     float(cs[k[q], q])) for q in range(Q)]
        return finalize

    def argmin_grid_many(self, *args, **kwargs) -> List[Result]:
        return self.argmin_grid_many_async(*args, **kwargs)()

    def hill_climb_ensemble_many(self, batch_cost_fn: BatchCostFn,
                                 cluster: ClusterConditions,
                                 params_many, *,
                                 starts=None,
                                 stats: Optional[PlanningStats] = None,
                                 n_random: int = 0, seed: int = 0,
                                 max_iters: int = 100_000) -> List[Result]:
        """One ensemble climb per request (trivially identical with the
        per-request path)."""
        pm = np.asarray(params_many, dtype=np.float64)
        return [self.hill_climb_ensemble(
            batch_cost_fn, cluster, starts, stats, params=pm[q],
            n_random=n_random, seed=seed, max_iters=max_iters)
            for q in range(pm.shape[0])]

    def hill_climb_ensemble_many_async(self, *args, **kwargs):
        res = self.hill_climb_ensemble_many(*args, **kwargs)
        return lambda: res


PlanBackend = TorchPlanBackend

_SINGLETONS = {}


def get_backend(spec: Union[str, "PlanBackend", None] = None):
    """Resolve a backend selection: ``None``/"cuda" (the CUDA kernels;
    raises without a GPU), "torch" (float64 on the CPU, exact), or an
    already-constructed backend instance.  String selections return
    process-wide singletons."""
    if spec is None:
        spec = "cuda"
    if not isinstance(spec, str):
        return spec
    if spec not in _SINGLETONS:
        if spec == "torch":
            _SINGLETONS[spec] = TorchPlanBackend()
        elif spec == "cuda":
            # deferred import: plan_scan imports this module's helpers
            from repro_torch.kernels.plan_scan import CudaPlanBackend
            _SINGLETONS[spec] = CudaPlanBackend()
        else:
            raise ValueError(f"unknown plan backend {spec!r} (expected "
                             "'cuda' or 'torch')")
    return _SINGLETONS[spec]
