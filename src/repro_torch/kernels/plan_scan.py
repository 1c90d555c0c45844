"""Fused cost-scan + argmin kernels for RAQO resource planning on Hopper,
their plain torch versions, and the ``CudaPlanBackend`` that wraps them.

The counterpart of ``repro.kernels.plan_scan``.  Two hand-written CUDA
kernels (``csrc/plan_scan.cu``, built by ``kernels/build.py``):

* ``scan_argmin`` replaces the Pallas ``_scan_kernel`` (K1, one request or
  a ``(query, block)`` grid of stacked requests) and
  ``_scan_many_unrolled_kernel`` (K2, decode a block once and loop its
  queries).  It decodes flat row ids of the resource grid in-kernel,
  evaluates the request's cost surface and keeps the first strict minimum
  per request; no configuration array or cost vector reaches device
  memory.  ``q_per_block`` sets the launch geometry: 1 is K1's grid, up
  to ``UNROLL_Q`` is K2's.  ``CudaPlanBackend`` picks K1 for a single
  request and K2 for a stack (``q_per_block = min(Q, UNROLL_Q)``).
* ``neighbor_step`` replaces ``_neighbor_kernel`` (K3): one ensemble
  hill-climb step, one thread per start.

Each wrapper takes the plain version (``scan_argmin_ref`` /
``neighbor_step_ref``, same module) only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  Each keeps a plain integer
launch counter (``scan_argmin.launches``, ``neighbor_step.launches``),
bumped where the kernel launches and nowhere else.

Cost surfaces: a CUDA kernel cannot run an arbitrary Python cost fn (the
reference pre-traced any jax fn to a jaxpr).  The kernels carry one
``__device__`` function per shipped surface — ``RegressionModel``,
``HiveSimulator`` SMJ and BHJ, with the money and SLA wraps — selected by
the ``Surface`` descriptor that the port's cost fns carry as ``.surface``
(``repro_torch.core.cost_model``); ``CudaPlanBackend`` raises on a fn
without one.

Bounds: flat row ids are int64 on the host and the kernel's packed
argmin key holds a 32-bit id, so grids past 2**32 rows raise
``ValueError`` (the reference's ``MAX_FLAT`` fallback has no
counterpart).  The §VII-C grid ``scaled_cluster(100_000, 100)`` has 1e7.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.registry import hot_path
from repro_torch.core.cluster import ClusterConditions, PlanningStats
from repro_torch.core.cost_model import OBJECTIVES, SURFACE_KINDS, Surface
from repro_torch.core.planning_backend import (
    DEFAULT_CHUNK, BatchCostFn, Result, _decode_flat, _many_chunk,
    _neighbor_offsets, grid_arrays, resolve_device, start_indices)
from repro_torch.kernels.build import (check_launch, load_library, on_cuda,
                                       stream)

MAX_FLAT = 1 << 32          # the packed argmin key holds a 32-bit flat id
UNROLL_Q = 64               # requests per block in the decode-once geometry
MAX_CONSTS = 12
MAX_GRID_Y = 65535          # CUDA's bound on gridDim.y


# ------------------------------- grid decode -------------------------------- #

@dataclasses.dataclass(frozen=True, eq=False)
class GridDim:
    """One grid dimension's decode recipe (the reference's ``_dim_meta``):
    value = lo + step * idx, or ``values[idx]`` for an explicit grid."""
    lo: int
    step: int
    size: int
    values: Optional[torch.Tensor] = None        # int64, on the device


def grid_dims(cluster: ClusterConditions, device) -> Tuple[GridDim, ...]:
    dims = []
    for d in cluster.dims:
        if d.values:
            dims.append(GridDim(int(d.values[0]), 0, len(d.values),
                                torch.as_tensor(d.values, dtype=torch.int64,
                                                device=device)))
        else:
            dims.append(GridDim(int(d.lo), int(d.step),
                                len(range(d.lo, d.hi + 1, d.step))))
    return tuple(dims)


def _values(dim: GridDim, idx: torch.Tensor) -> torch.Tensor:
    if dim.values is not None:
        return dim.values[idx]
    return dim.lo + dim.step * idx


def decode_rows(dims: Sequence[GridDim], flat: torch.Tensor) -> torch.Tensor:
    """(N,) int64 flat row ids -> (N, 2) int64 configurations in
    ``enumerate_configs`` order (row-major, first dim slowest)."""
    i0 = torch.div(flat, dims[1].size, rounding_mode="floor")
    i1 = flat - i0 * dims[1].size
    return torch.stack([_values(dims[0], i0), _values(dims[1], i1)], dim=1)


def _check(surface: Surface, dims: Sequence[GridDim],
           params: torch.Tensor) -> int:
    """Validate a kernel call; returns the grid's row count."""
    if not isinstance(surface, Surface):
        raise TypeError(f"expected a Surface descriptor, got {surface!r}")
    if len(dims) != 2:
        raise ValueError(f"the plan-scan kernels take 2-D (nc, cs) grids, "
                         f"got {len(dims)} dims")
    total = dims[0].size * dims[1].size
    if total >= MAX_FLAT:
        raise ValueError(f"grid of {total} rows exceeds the kernels' 32-bit "
                         f"flat ids (< {MAX_FLAT})")
    if params.dtype != torch.float32 or params.ndim != 2 or \
            params.shape[1] != surface.n_params:
        raise ValueError(f"params must be (Q, {surface.n_params}) float32, "
                         f"got {tuple(params.shape)} {params.dtype}")
    return total


# ------------------------------ plain versions ------------------------------ #

def scan_argmin_ref(surface: Surface, dims: Sequence[GridDim],
                    params: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ``scan_argmin``: chunked decode, the
    surface's torch expression with each request's params as ``(Q, 1)``
    columns, ``argmin`` per chunk and a strict-< fold across chunks.
    Returns ((Q,) float32 best cost, (Q,) int64 flat id), with (inf, -1)
    where every configuration costs inf."""
    total = _check(surface, dims, params)
    Q = params.shape[0]
    p = params.t()[:, :, None]                       # params[k] -> (Q, 1)
    best = torch.full((Q,), math.inf, dtype=params.dtype,
                      device=params.device)
    flat = torch.full((Q,), -1, dtype=torch.int64, device=params.device)
    chunk = _many_chunk(total, Q, DEFAULT_CHUNK)
    for lo in range(0, total, chunk):
        rows = torch.arange(lo, min(lo + chunk, total), device=params.device)
        c = surface(decode_rows(dims, rows), p).broadcast_to((Q, len(rows)))
        j = torch.argmin(c, dim=1)
        cj = c.gather(1, j[:, None])[:, 0]
        upd = cj < best                              # strict <: first min
        best = torch.where(upd, cj, best)
        flat = torch.where(upd, j + lo, flat)
    return best, flat


def neighbor_step_ref(surface: Surface, dims: Sequence[GridDim],
                      cur: torch.Tensor, params: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of ``neighbor_step``: cost the S centres and
    their 2*D ±1 neighbours in one evaluation, off-grid neighbours inf,
    first minimum per start in ``_neighbor_offsets`` order.  Returns
    ((S,) centre cost, (S,) best neighbour cost, (S,) int32 slot)."""
    _check(surface, dims, params)
    S = cur.shape[0]
    offs = torch.as_tensor(_neighbor_offsets(2), device=cur.device)
    sizes = torch.as_tensor([d.size for d in dims], device=cur.device)
    nbr = cur[:, None, :] + offs[None, :, :]                 # (S, 4, 2)
    valid = ((nbr >= 0) & (nbr < sizes)).all(-1)
    safe = torch.minimum(torch.clamp_min(nbr, 0), sizes - 1)
    idx = torch.cat([cur, safe.reshape(-1, 2)])
    cfgs = torch.stack([_values(dims[0], idx[:, 0]),
                        _values(dims[1], idx[:, 1])], dim=1)
    costs = surface(cfgs, params[0])
    ncosts = torch.where(valid, costs[S:].reshape(S, 4), math.inf)
    j = torch.argmin(ncosts, dim=1)
    return (costs[:S], ncosts.gather(1, j[:, None])[:, 0],
            j.to(torch.int32))


# ------------------------------- the kernels -------------------------------- #

class _Dim(ctypes.Structure):
    _fields_ = [("lo", ctypes.c_int64), ("step", ctypes.c_int64),
                ("size", ctypes.c_int64), ("values", ctypes.c_void_p)]


class _Surface(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("objective", ctypes.c_int),
                ("oom", ctypes.c_int), ("n_params", ctypes.c_int),
                ("c", ctypes.c_float * MAX_CONSTS)]


class _ScanArgs(ctypes.Structure):
    _fields_ = [("dim", _Dim * 2), ("s", _Surface),
                ("total", ctypes.c_int64), ("n_queries", ctypes.c_int64),
                ("q_per_block", ctypes.c_int)]


class _NeighborArgs(ctypes.Structure):
    _fields_ = [("dim", _Dim * 2), ("s", _Surface),
                ("n_starts", ctypes.c_int64)]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (build.load_library)."""
    vp = ctypes.c_void_p
    lib.scan_argmin.argtypes = [vp, vp, vp, vp]
    lib.scan_argmin.restype = ctypes.c_int
    lib.neighbor_step.argtypes = [vp] * 7
    lib.neighbor_step.restype = ctypes.c_int
    return lib


# memoized per (dims, surface) object: the climb launches the same pair
# every iteration, and building the ctypes structs costs more than the
# launch (the cache holds strong refs, so ids stay valid)
@functools.lru_cache(maxsize=64)
def _c_dims(dims: Tuple[GridDim, ...]):
    return (_Dim * 2)(*[_Dim(d.lo, d.step, d.size,
                             None if d.values is None else d.values.data_ptr())
                        for d in dims])


@functools.lru_cache(maxsize=64)
def _c_surface(surface: Surface) -> _Surface:
    consts = surface.consts()
    return _Surface(SURFACE_KINDS[surface.kind],
                    OBJECTIVES[surface.objective], int(surface.oom),
                    surface.n_params, (ctypes.c_float * MAX_CONSTS)(*consts))


def _on_cuda(*tensors: torch.Tensor) -> bool:
    if not on_cuda("plan-scan", *tensors):
        return False
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("plan-scan kernels take contiguous tensors")
    return True


def _decode_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed (order-preserving cost bits << 32 | flat id) keys -> (cost,
    flat); the untouched all-ones key means every row cost inf."""
    hi = (keys >> 32) & 0xFFFFFFFF
    u = torch.where(hi >= 0x80000000, hi - 0x80000000, 0xFFFFFFFF - hi)
    u = torch.where(u >= 0x80000000, u - (1 << 32), u).to(torch.int32)
    none = keys == -1
    cost = torch.where(none, math.inf, u.view(torch.float32))
    flat = torch.where(none, -1, keys & 0xFFFFFFFF)
    return cost, flat


def scan_argmin(surface: Surface, dims: Sequence[GridDim],
                params: torch.Tensor, q_per_block: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First strict minimum of ``surface`` over the grid ``dims`` for each
    request row of ``params`` ((Q, P) float32).  Returns ((Q,) float32
    cost, (Q,) int64 flat id), (inf, -1) where every row costs inf.  CUDA
    tensors launch the kernel on the current stream without syncing; CPU
    tensors take ``scan_argmin_ref``."""
    total = _check(surface, dims, params)
    if not _on_cuda(params, *[d.values for d in dims
                              if d.values is not None]):
        return scan_argmin_ref(surface, dims, params)
    Q = params.shape[0]
    if not 1 <= q_per_block <= UNROLL_Q or -(-Q // q_per_block) > MAX_GRID_Y:
        raise ValueError(f"q_per_block={q_per_block} for Q={Q} is outside "
                         f"the kernel's launch geometry")
    lib = load_library("plan_scan")
    # all ones: the largest uint64 key, which every feasible row beats
    keys = torch.full((Q,), -1, dtype=torch.int64, device=params.device)
    args = _ScanArgs(_c_dims(tuple(dims)), _c_surface(surface), total, Q,
                     q_per_block)
    check_launch(lib.scan_argmin(ctypes.addressof(args), params.data_ptr(),
                                 keys.data_ptr(), stream(params.device)),
                 "scan_argmin")
    scan_argmin.launches += 1
    return _decode_keys(keys)


scan_argmin.launches = 0


def neighbor_step(surface: Surface, dims: Sequence[GridDim],
                  cur: torch.Tensor, params: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ensemble hill-climb step over the (S, 2) int64 grid indices
    ``cur`` for one request (``params`` (1, P) float32): ((S,) centre
    cost, (S,) best neighbour cost, (S,) int32 slot in
    ``_neighbor_offsets`` order).  CUDA tensors launch the kernel; CPU
    tensors take ``neighbor_step_ref``."""
    _check(surface, dims, params)
    if params.shape[0] != 1 or cur.dtype != torch.int64 or cur.ndim != 2 \
            or cur.shape[1] != 2:
        raise ValueError("neighbor_step takes (S, 2) int64 indices and "
                         "(1, P) params")
    if not _on_cuda(cur, params, *[d.values for d in dims
                                   if d.values is not None]):
        return neighbor_step_ref(surface, dims, cur, params)
    lib = load_library("plan_scan")
    S = cur.shape[0]
    center = torch.empty(S, dtype=torch.float32, device=cur.device)
    best = torch.empty(S, dtype=torch.float32, device=cur.device)
    slot = torch.empty(S, dtype=torch.int32, device=cur.device)
    args = _NeighborArgs(_c_dims(tuple(dims)), _c_surface(surface), S)
    check_launch(lib.neighbor_step(
        ctypes.addressof(args), cur.data_ptr(), params.data_ptr(),
        center.data_ptr(), best.data_ptr(), slot.data_ptr(),
        stream(cur.device)), "neighbor_step")
    neighbor_step.launches += 1
    return center, best, slot


neighbor_step.launches = 0


def reset_launch_counts() -> None:
    scan_argmin.launches = 0
    neighbor_step.launches = 0


# ------------------------------ the backend --------------------------------- #

def _surface_of(fn: BatchCostFn) -> Surface:
    surface = getattr(fn, "surface", None)
    if not isinstance(surface, Surface):
        raise TypeError(
            f"CudaPlanBackend evaluates cost fns that carry a .surface "
            f"descriptor (repro_torch.core.cost_model.Surface); {fn!r} has "
            f"none")
    return surface


class CudaPlanBackend:
    """``PlanBackend`` over the CUDA scan and neighbor-step kernels
    (``get_backend("cuda")``), float32 like the reference's pallas
    backend: ``exact = False``, so the broker re-commits every winner in
    float64 and re-searches on the exact ``"torch"`` backend when float32
    rounding let an infeasible configuration win.

    ``device="cpu"`` runs the same wrappers on CPU tensors, which take the
    plain versions — the tests reach the kernel path without a card.  Scans
    launch on the current stream; ``finalize`` does the one device->host
    copy.  The hill climb is the reference's host loop: one neighbor-step
    launch and one sync per iteration."""

    name = "cuda"
    exact = False
    dtype = torch.float32

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._grids = {}
        # largest request stack one scan launch served (chip_smoke.py
        # times the kernels at that shape)
        self.max_stack = 0

    def _dims(self, cluster: ClusterConditions) -> Tuple[GridDim, ...]:
        dims = self._grids.get(cluster.dims)
        if dims is None:
            dims = self._grids[cluster.dims] = grid_dims(cluster, self.device)
        return dims

    def _params32(self, surface: Surface, params) -> torch.Tensor:
        """(Q, P) float32 params: the search runs on float32-rounded
        request scalars, as the reference's ``_params32``."""
        pm = np.atleast_2d(np.asarray(params, dtype=np.float64))
        if pm.shape[1] < surface.n_params:
            raise ValueError(f"{surface.objective} surface needs "
                             f"{surface.n_params} params, got {pm.shape[1]}")
        return torch.as_tensor(pm[:, :surface.n_params].astype(np.float32),
                               device=self.device)

    @staticmethod
    def _result(cluster: ClusterConditions, flat: int, cost: float) -> Result:
        if flat < 0 or math.isinf(cost):
            return None, math.inf
        grids = grid_arrays(cluster)
        return _decode_flat(grids, tuple(len(g) for g in grids), flat), cost

    @staticmethod
    def q_per_block(Q: int) -> int:
        """The fixed geometry rule: K1's (query, block) grid for a single
        request, K2's decode-once blocks of up to UNROLL_Q for a stack."""
        return 1 if Q == 1 else min(Q, UNROLL_Q)

    # -- fused grid scan ------------------------------------------------------ #

    @hot_path("dispatches the stacked scan kernel per flush group", folds=1)
    def argmin_grid_many_async(self, batch_cost_fn: BatchCostFn,
                               cluster: ClusterConditions,
                               params_many, *,
                               stats: Optional[PlanningStats] = None,
                               chunk_size: int = DEFAULT_CHUNK):
        """One ``scan_argmin`` launch for Q requests sharing one cost fn
        and grid; per-request results identical to Q ``argmin_grid``
        calls.  Returns the zero-arg finalize that copies the winners to
        the host and decodes them."""
        stats = stats if stats is not None else PlanningStats()
        surface = _surface_of(batch_cost_fn)
        pm = np.asarray(params_many, dtype=np.float64)
        Q = pm.shape[0]
        if Q == 0:
            return lambda: []
        total = cluster.grid_size()
        if total == 0:
            res = [(None, math.inf)] * Q
            return lambda: res
        p = self._params32(surface, pm)
        cost, flat = scan_argmin(surface, self._dims(cluster), p,
                                 self.q_per_block(Q))
        stats.configs_explored += Q * total
        self.max_stack = max(self.max_stack, Q)

        def finalize() -> List[Result]:
            out = torch.stack([cost.to(torch.float64),
                               flat.to(torch.float64)]).cpu().numpy()
            return [self._result(cluster, int(out[1, q]), float(out[0, q]))
                    for q in range(Q)]
        return finalize

    def argmin_grid_many(self, *args, **kwargs) -> List[Result]:
        return self.argmin_grid_many_async(*args, **kwargs)()

    def argmin_grid(self, batch_cost_fn: BatchCostFn,
                    cluster: ClusterConditions,
                    stats: Optional[PlanningStats] = None, *,
                    params=None, chunk_size: int = DEFAULT_CHUNK) -> Result:
        """Exhaustive scan as one kernel launch; first strict minimum in
        ``enumerate_configs`` order, (None, inf) when every configuration
        costs inf."""
        if params is None:
            raise ValueError("kernel surfaces take per-request params")
        return self.argmin_grid_many(batch_cost_fn, cluster,
                                     np.asarray(params)[None, :],
                                     stats=stats, chunk_size=chunk_size)[0]

    # -- ensemble climb on the neighbor step ---------------------------------- #

    @hot_path("runs the neighbor-step kernel once per climb iteration")
    def hill_climb_ensemble(self, batch_cost_fn: BatchCostFn,
                            cluster: ClusterConditions,
                            starts: Optional[Sequence[Sequence[int]]] = None,
                            stats: Optional[PlanningStats] = None, *,
                            params=None, n_random: int = 0, seed: int = 0,
                            max_iters: int = 100_000) -> Result:
        """Multi-start steepest descent, the reference pallas backend's
        host loop: each iteration launches one neighbor step and syncs
        once; moves and termination mirror the numpy backend, so
        trajectories are identical on the same float32 costs."""
        stats = stats if stats is not None else PlanningStats()
        surface = _surface_of(batch_cost_fn)
        if params is None:
            raise ValueError("kernel surfaces take per-request params")
        dims = self._dims(cluster)
        grids_np = grid_arrays(cluster)
        n_dims = len(grids_np)
        sizes = np.asarray([len(g) for g in grids_np], dtype=np.int64)
        cur = np.asarray(start_indices(cluster, starts, n_random, seed))
        S = len(cur)
        offs = _neighbor_offsets(n_dims)
        p = self._params32(surface, params)

        cur_cost = np.full(S, np.inf)
        for _ in range(max_iters):
            center, best_c, best_j = neighbor_step(
                surface, dims, torch.as_tensor(cur, device=self.device), p)
            # plan-lint: allow(host-sync): the climb is host-driven — each neighbor step must land before the move/stop decision
            out = torch.stack([center, best_c,
                               best_j.to(torch.float32)]).cpu().numpy()
            center = out[0].astype(np.float64)
            best_c = out[1].astype(np.float64)
            best_j = out[2].astype(np.int64)
            nbr = cur[:, None, :] + offs[None, :, :]
            valid = ((nbr >= 0) & (nbr < sizes)).all(-1)
            stats.configs_explored += S + int(valid.sum())
            cur_cost = center
            improved = best_c < center        # strict <: Algorithm 1 stop
            if not improved.any():
                break
            step = np.take_along_axis(
                nbr, best_j[:, None, None], 1)[:, 0, :]
            cur[improved] = step[improved]
            cur_cost[improved] = best_c[improved]

        i = int(np.argmin(cur_cost))
        res = tuple(int(grids_np[d][cur[i, d]]) for d in range(n_dims))
        return res, float(cur_cost[i])

    def hill_climb_ensemble_many(self, batch_cost_fn: BatchCostFn,
                                 cluster: ClusterConditions,
                                 params_many, *,
                                 starts=None,
                                 stats: Optional[PlanningStats] = None,
                                 n_random: int = 0, seed: int = 0,
                                 max_iters: int = 100_000) -> List[Result]:
        """One host climb per stacked request."""
        pm = np.asarray(params_many, dtype=np.float64)
        return [self.hill_climb_ensemble(
            batch_cost_fn, cluster, starts, stats, params=pm[q],
            n_random=n_random, seed=seed, max_iters=max_iters)
            for q in range(pm.shape[0])]

    def hill_climb_ensemble_many_async(self, *args, **kwargs):
        """The climb syncs every iteration, so nothing is left in flight:
        run eagerly and return the results as a finalized closure."""
        res = self.hill_climb_ensemble_many(*args, **kwargs)
        return lambda: res
