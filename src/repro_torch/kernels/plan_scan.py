"""Fused cost-scan + argmin kernels for RAQO resource planning on Hopper,
their plain torch versions, and the ``CudaPlanBackend`` that wraps them.

The counterpart of ``repro.kernels.plan_scan``.  Two hand-written CUDA
kernels (``csrc/plan_scan.cu``, built by ``kernels/build.py``):

* ``scan_argmin`` replaces the Pallas ``_scan_kernel`` (K1, one request or
  a ``(query, block)`` grid of stacked requests) and
  ``_scan_many_unrolled_kernel`` (K2, decode a block once and loop its
  queries).  It evaluates the request's cost surface on every
  configuration of the resource grid in-kernel and keeps the first strict
  minimum per request; no configuration array or cost vector reaches
  device memory.  The DB surfaces run a block over a tile of whole values
  of the first grid dimension and hoist every term that does not depend
  on the row out of the row loop (bit-equal costs; see the source's
  note).  ``q_per_block`` sets the launch geometry: 1 is K1's grid, up to
  ``UNROLL_Q`` is K2's.  ``CudaPlanBackend`` picks K1 for a single
  request and K2 for a stack (``q_per_block = min(Q, UNROLL_Q)``).
* ``scan_argmin_sharded`` replaces ``_scan_kernel_dyn`` (K4, built by
  ``build_scan_sharded``): the same kernel launched once per shard over a
  run-time row range, so one compiled kernel serves every shard.  The
  grid is cut into contiguous ascending spans of ``ceil(total / D)`` rows
  rounded up to whole tiles, span i runs on ``devices[i]`` (a device that
  repeats gets one stream per shard, joined with events), and the
  per-shard keys are folded on ``devices[0]`` by a min.
* ``neighbor_step`` replaces ``_neighbor_kernel`` (K3): one ensemble
  hill-climb step, one thread per start.
* ``ensemble_climb`` is K3's whole climb on the device: Q requests x S
  starts, each to convergence (or ``max_iters``) in one launch, one group
  of lanes per (request, start) evaluating its neighbour slots in
  parallel.  It costs a slot through the same ``__device__`` function as
  ``neighbor_step``, so its trajectories are the neighbour step's.
  ``CudaPlanBackend`` climbs through it: one launch per stacked climb
  group (one a plan device when sharded), no host sync inside the climb.

Grids have 1..``MAX_DIMS`` dimensions, decoded row-major with the first
dimension slowest (``enumerate_configs`` order), like the reference's.

Each wrapper takes the plain version (``scan_argmin_ref``,
``scan_argmin_sharded_ref``, ``neighbor_step_ref``, ``ensemble_climb_ref``,
same module) only for CPU tensors; for CUDA tensors it launches the kernel
or raises.  Each keeps a plain integer launch counter
(``scan_argmin.launches``, ``scan_argmin_sharded.launches`` — one a shard
—, ``neighbor_step.launches``, ``ensemble_climb.launches``), bumped where
the kernel launches and nowhere else.

Cost surfaces: a CUDA kernel cannot run an arbitrary Python cost fn (the
reference pre-traced any jax fn to a jaxpr).  The kernels carry one
``__device__`` function per shipped surface — ``RegressionModel``,
``HiveSimulator`` SMJ and BHJ with the money and SLA wraps over (nc, cs),
the train / prefill / decode rooflines over (pods, dp, tp, microbatch)
with the sharding planner's objective and masks, and a ``CostTable`` over
any grid — selected by the ``Surface`` descriptor that the port's cost
fns carry as ``.surface`` (``repro_torch.core.cost_model``);
``CudaPlanBackend`` raises on a fn without one.

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
from typing import List, Optional, Sequence, Tuple, Union

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
from repro_torch.launch.mesh import plan_device_count, plan_devices

MAX_FLAT = 1 << 32          # the packed argmin key holds a 32-bit flat id
MAX_DIMS = 8                # csrc/plan_scan.cu instantiates 1..MAX_DIMS
UNROLL_Q = 64               # requests per block in the decode-once geometry
MAX_CONSTS = 16
MAX_GRID_Y = 65535          # CUDA's bound on gridDim.y
TILE_ROWS = 256 * 8         # rows a scan block covers at most
                            # (SCAN_THREADS x ROWS_PER_THREAD)
_SIGN = -(1 << 63)          # flips a packed key's unsigned order to signed


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


@functools.lru_cache(maxsize=64)
def _dims_on(dims: Tuple[GridDim, ...], device: torch.device
             ) -> Tuple[GridDim, ...]:
    """``dims`` with their value tables on ``device`` (kept per device)."""
    return tuple(d if d.values is None or d.values.device == device else
                 dataclasses.replace(d, values=d.values.to(device))
                 for d in dims)


def _values(dim: GridDim, idx: torch.Tensor) -> torch.Tensor:
    if dim.values is not None:
        return dim.values[idx]
    return dim.lo + dim.step * idx


def decode_rows(dims: Sequence[GridDim], flat: torch.Tensor) -> torch.Tensor:
    """(N,) int64 flat row ids -> (N, n_dims) int64 configurations in
    ``enumerate_configs`` order (row-major, first dim slowest)."""
    cols = [None] * len(dims)
    rem = flat
    for d in range(len(dims) - 1, 0, -1):
        q = torch.div(rem, dims[d].size, rounding_mode="floor")
        cols[d] = _values(dims[d], rem - q * dims[d].size)
        rem = q
    cols[0] = _values(dims[0], rem)
    return torch.stack(cols, dim=1)


def _check(surface: Surface, dims: Sequence[GridDim],
           params: torch.Tensor) -> int:
    """Validate a kernel call; returns the grid's row count."""
    if not isinstance(surface, Surface):
        raise TypeError(f"expected a Surface descriptor, got {surface!r}")
    if not 1 <= len(dims) <= MAX_DIMS:
        raise ValueError(f"the plan-scan kernels take grids of 1 to "
                         f"{MAX_DIMS} dims, got {len(dims)} dims")
    if surface.n_dims is not None and surface.n_dims != len(dims):
        raise ValueError(f"a {surface.kind} surface evaluates "
                         f"{surface.n_dims}-dim grids, got {len(dims)} dims")
    if surface.kind == "table" and \
            surface.model.costs.shape != tuple(d.size for d in dims):
        raise ValueError(f"a table of {surface.model.costs.shape} costs for "
                         f"a grid of {tuple(d.size for d in dims)}")
    total = math.prod(d.size for d in dims)
    if total >= MAX_FLAT:
        raise ValueError(f"grid of {total} rows exceeds the kernels' 32-bit "
                         f"flat ids (< {MAX_FLAT})")
    if params.dtype != torch.float32 or params.ndim != 2 or \
            params.shape[1] != surface.n_params:
        raise ValueError(f"params must be (Q, {surface.n_params}) float32, "
                         f"got {tuple(params.shape)} {params.dtype}")
    return total


def _check_starts(dims: Sequence[GridDim], starts: torch.Tensor) -> None:
    if starts.dtype != torch.int64 or starts.ndim != 2 or \
            starts.shape[1] != len(dims):
        raise ValueError(f"climb starts must be (S, {len(dims)}) int64 grid "
                         f"indices, got {tuple(starts.shape)} {starts.dtype}")


def shard_spans(total: int, n_shards: int) -> List[Tuple[int, int]]:
    """K4's geometry: ``n_shards`` contiguous ascending ``(row0, nrows)``
    spans of ``ceil(total / n_shards)`` rows rounded up to whole tiles;
    the last non-empty span is ragged and spans past the grid are
    empty."""
    per = -(-total // n_shards)                      # ceil(total / D)
    span = -(-per // TILE_ROWS) * TILE_ROWS          # in whole tiles
    return [(min(i * span, total),
             max(0, min(span, total - i * span))) for i in range(n_shards)]


# ------------------------------ plain versions ------------------------------ #

def scan_argmin_ref(surface: Surface, dims: Sequence[GridDim],
                    params: torch.Tensor, row0: int = 0,
                    nrows: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ``scan_argmin`` over rows [row0, row0 +
    nrows) (the whole grid by default): chunked decode, the surface's
    torch expression with each request's params as ``(Q, 1)`` columns,
    ``argmin`` per chunk and a strict-< fold across chunks.  Returns
    ((Q,) float32 best cost, (Q,) int64 global flat id), with (inf, -1)
    where every row of the range costs inf."""
    total = _check(surface, dims, params)
    end = total if nrows is None else min(total, row0 + nrows)
    Q = params.shape[0]
    p = params.t()[:, :, None]                       # params[k] -> (Q, 1)
    best = torch.full((Q,), math.inf, dtype=params.dtype,
                      device=params.device)
    flat = torch.full((Q,), -1, dtype=torch.int64, device=params.device)
    chunk = _many_chunk(total, Q, DEFAULT_CHUNK)
    for lo in range(row0, end, chunk):
        rows = torch.arange(lo, min(lo + chunk, end), device=params.device)
        c = surface(decode_rows(dims, rows), p).broadcast_to((Q, len(rows)))
        j = torch.argmin(c, dim=1)
        cj = c.gather(1, j[:, None])[:, 0]
        upd = cj < best                              # strict <: first min
        best = torch.where(upd, cj, best)
        flat = torch.where(upd, j + lo, flat)
    return best, flat


def _fold_shards(costs: Sequence[torch.Tensor], flats: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First minimum over the shards' (cost, flat) bests: shard spans are
    ascending, so the lowest shard on a tie is the lowest flat id."""
    c, f = torch.stack(list(costs)), torch.stack(list(flats))
    k = torch.argmin(c, dim=0, keepdim=True)
    return c.gather(0, k)[0], f.gather(0, k)[0]


def scan_argmin_sharded_ref(surface: Surface, dims: Sequence[GridDim],
                            params: torch.Tensor, n_shards: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ``scan_argmin_sharded``: ``scan_argmin_ref``
    over each of the ``n_shards`` spans of ``shard_spans`` and the same
    first-minimum fold."""
    total = _check(surface, dims, params)
    outs = [scan_argmin_ref(surface, dims, params, row0, nrows)
            for row0, nrows in shard_spans(total, n_shards)]
    return _fold_shards([c for c, _ in outs], [f for _, f in outs])


def neighbor_step_ref(surface: Surface, dims: Sequence[GridDim],
                      cur: torch.Tensor, params: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of ``neighbor_step``: cost the S centres and
    their 2*D ±1 neighbours in one evaluation, off-grid neighbours inf,
    first minimum per start in ``_neighbor_offsets`` order.  Returns
    ((S,) centre cost, (S,) best neighbour cost, (S,) int32 slot)."""
    _check(surface, dims, params)
    S, D = cur.shape
    offs = torch.as_tensor(_neighbor_offsets(D), device=cur.device)
    sizes = torch.as_tensor([d.size for d in dims], device=cur.device)
    nbr = cur[:, None, :] + offs[None, :, :]                 # (S, 2D, D)
    valid = ((nbr >= 0) & (nbr < sizes)).all(-1)
    safe = torch.minimum(torch.clamp_min(nbr, 0), sizes - 1)
    idx = torch.cat([cur, safe.reshape(-1, D)])
    cfgs = torch.stack([_values(dims[d], idx[:, d]) for d in range(D)],
                       dim=1)
    costs = surface(cfgs, params[0])
    ncosts = torch.where(valid, costs[S:].reshape(S, 2 * D), math.inf)
    j = torch.argmin(ncosts, dim=1)
    return (costs[:S], ncosts.gather(1, j[:, None])[:, 0],
            j.to(torch.int32))


def _in_grid(dims: Sequence[GridDim], cur: torch.Tensor) -> torch.Tensor:
    """(S,) in-grid ±1 neighbour count of each (S, D) grid index."""
    sizes = torch.as_tensor([d.size for d in dims], device=cur.device)
    return ((cur > 0).sum(1) + (cur < sizes - 1).sum(1)).to(torch.int64)


def ensemble_climb_ref(surface: Surface, dims: Sequence[GridDim],
                       starts: torch.Tensor, params: torch.Tensor,
                       max_iters: int
                       ) -> Tuple[torch.Tensor, ...]:
    """Plain torch version of ``ensemble_climb``: for each request, a loop
    of ``neighbor_step_ref`` over all S starts, moving each start that
    improves strictly and freezing the ones that stopped, until none moves
    or ``max_iters`` steps.  Returns ((Q, S, D) int64 final index, (Q, S)
    float32 cost there (inf where no step ran), (Q, S) int64 iterations
    each start evaluated, (Q, S) int64 in-grid neighbours summed over
    them, (Q, S) int64 in-grid neighbours at the final index)."""
    _check(surface, dims, params)
    _check_starts(dims, starts)
    Q, (S, D) = params.shape[0], starts.shape
    offs = torch.as_tensor(_neighbor_offsets(D), device=starts.device)
    out = []
    for q in range(Q):
        cur = starts.clone()
        cost = torch.full((S,), math.inf, dtype=params.dtype,
                          device=params.device)
        iters = torch.zeros(S, dtype=torch.int64, device=starts.device)
        vsum = torch.zeros(S, dtype=torch.int64, device=starts.device)
        moving = torch.ones(S, dtype=torch.bool, device=starts.device)
        for _ in range(max_iters):
            centre, best, slot = neighbor_step_ref(surface, dims, cur,
                                                   params[q:q + 1])
            iters += moving
            vsum += torch.where(moving, _in_grid(dims, cur), 0)
            improved = moving & (best < centre)       # strict <
            cost = torch.where(moving, centre, cost)
            cost = torch.where(improved, best, cost)
            cur = torch.where(improved[:, None], cur + offs[slot.long()], cur)
            moving = improved
            if not bool(moving.any()):
                break
        out.append((cur, cost, iters, vsum, _in_grid(dims, cur)))
    return tuple(torch.stack(col) for col in zip(*out))


# ------------------------------- the kernels -------------------------------- #

class _Dim(ctypes.Structure):
    _fields_ = [("lo", ctypes.c_int64), ("step", ctypes.c_int64),
                ("size", ctypes.c_int64), ("values", ctypes.c_void_p)]


class _Surface(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("objective", ctypes.c_int),
                ("oom", ctypes.c_int), ("n_params", ctypes.c_int),
                ("flags", ctypes.c_int), ("batch", ctypes.c_int64),
                ("c", ctypes.c_float * MAX_CONSTS)]


class _ScanArgs(ctypes.Structure):
    _fields_ = [("dim", _Dim * MAX_DIMS), ("n_dims", ctypes.c_int),
                ("s", _Surface), ("table", ctypes.c_void_p),
                ("total", ctypes.c_int64), ("row0", ctypes.c_int64),
                ("nrows", ctypes.c_int64), ("n_queries", ctypes.c_int64),
                ("q_per_block", ctypes.c_int)]


class _NeighborArgs(ctypes.Structure):
    _fields_ = [("dim", _Dim * MAX_DIMS), ("n_dims", ctypes.c_int),
                ("s", _Surface), ("table", ctypes.c_void_p),
                ("n_starts", ctypes.c_int64)]


class _ClimbArgs(ctypes.Structure):
    _fields_ = [("dim", _Dim * MAX_DIMS), ("n_dims", ctypes.c_int),
                ("s", _Surface), ("table", ctypes.c_void_p),
                ("n_queries", ctypes.c_int64), ("n_starts", ctypes.c_int64),
                ("max_iters", ctypes.c_int64)]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (build.load_library)."""
    vp = ctypes.c_void_p
    lib.scan_argmin.argtypes = [vp, vp, vp, vp]
    lib.scan_argmin.restype = ctypes.c_int
    lib.neighbor_step.argtypes = [vp] * 7
    lib.neighbor_step.restype = ctypes.c_int
    lib.ensemble_climb.argtypes = [vp] * 9
    lib.ensemble_climb.restype = ctypes.c_int
    return lib


# memoized per (dims, surface) object: a planning session launches the
# same pairs wave after wave, and building the ctypes structs costs more
# than the launch (the cache holds strong refs, so ids stay valid)
@functools.lru_cache(maxsize=64)
def _c_dims(dims: Tuple[GridDim, ...]):
    return (_Dim * MAX_DIMS)(*[
        _Dim(d.lo, d.step, d.size,
             None if d.values is None else d.values.data_ptr())
        for d in dims])


@functools.lru_cache(maxsize=64)
def _c_surface(surface: Surface) -> _Surface:
    consts = surface.consts()
    if len(consts) > MAX_CONSTS:
        raise ValueError(f"{surface.kind} surface has {len(consts)} "
                         f"constants, the kernel takes {MAX_CONSTS}")
    return _Surface(SURFACE_KINDS[surface.kind],
                    OBJECTIVES[surface.objective], int(surface.oom),
                    surface.n_params, surface.flags, surface.batch,
                    (ctypes.c_float * MAX_CONSTS)(*consts))


def _table(surface: Surface, device: torch.device) -> Optional[int]:
    """Device pointer of a table surface's costs on ``device``."""
    if surface.kind != "table":
        return None
    return surface.model.flat_costs(device).data_ptr()


def _on_cuda(*tensors: torch.Tensor) -> bool:
    if not on_cuda("plan-scan", *tensors):
        return False
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("plan-scan kernels take contiguous tensors")
    return True


def _values_of(dims: Sequence[GridDim]) -> List[torch.Tensor]:
    return [d.values for d in dims if d.values is not None]


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


def _check_geometry(Q: int, q_per_block: int) -> None:
    if not 1 <= q_per_block <= UNROLL_Q or -(-Q // q_per_block) > MAX_GRID_Y:
        raise ValueError(f"q_per_block={q_per_block} for Q={Q} is outside "
                         f"the kernel's launch geometry")


def _launch_scan(surface: Surface, dims: Sequence[GridDim],
                 params: torch.Tensor, q_per_block: int, total: int,
                 row0: int, nrows: int, strm: int) -> torch.Tensor:
    """One scan_argmin launch over rows [row0, row0 + nrows) on the
    stream ``strm`` of ``params``' device; returns the (Q,) packed keys."""
    lib = load_library("plan_scan")
    Q = params.shape[0]
    # all ones: the largest uint64 key, which every feasible row beats
    keys = torch.full((Q,), -1, dtype=torch.int64, device=params.device)
    args = _ScanArgs(_c_dims(tuple(dims)), len(dims), _c_surface(surface),
                     _table(surface, params.device), total, row0, nrows, Q,
                     q_per_block)
    with torch.cuda.device(params.device):
        check_launch(lib.scan_argmin(ctypes.addressof(args),
                                     params.data_ptr(), keys.data_ptr(),
                                     strm), "scan_argmin")
    return keys


def scan_argmin(surface: Surface, dims: Sequence[GridDim],
                params: torch.Tensor, q_per_block: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First strict minimum of ``surface`` over the grid ``dims`` for each
    request row of ``params`` ((Q, P) float32).  Returns ((Q,) float32
    cost, (Q,) int64 flat id), (inf, -1) where every row costs inf.  CUDA
    tensors launch the kernel on the current stream without syncing; CPU
    tensors take ``scan_argmin_ref``."""
    total = _check(surface, dims, params)
    if not _on_cuda(params, *_values_of(dims)):
        return scan_argmin_ref(surface, dims, params)
    _check_geometry(params.shape[0], q_per_block)
    keys = _launch_scan(surface, dims, params, q_per_block, total, 0, total,
                        stream(params.device))
    scan_argmin.launches += 1
    return _decode_keys(keys)


scan_argmin.launches = 0


def scan_argmin_sharded(surface: Surface, dims: Sequence[GridDim],
                        params: torch.Tensor, devices: Sequence,
                        q_per_block: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scan_argmin`` split over ``len(devices)`` shards (K4): span i of
    ``shard_spans`` is one launch of the same kernel on ``devices[i]``
    over its own row range, and the per-shard keys come back to
    ``devices[0]``, where a min folds them.  A key orders by (cost, global
    flat id) and the spans are ascending, so the min is the first minimum
    with the lowest shard winning a tie — what the reference's
    ``jnp.argmin`` over the per-shard bests computes, because there each
    shard's best is its own first minimum and argmin's first index is the
    lowest shard.  The params are copied once to each distinct device; a
    device that repeats runs each of its shards on a stream of its own,
    joined to its current stream with events.  Results stay on
    ``devices[0]`` without a host sync.  CPU tensors take
    ``scan_argmin_sharded_ref``."""
    total = _check(surface, dims, params)
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("scan_argmin_sharded needs at least one device")
    if not _on_cuda(params, *_values_of(dims)):
        if any(d.type != "cpu" for d in devices):
            raise ValueError(f"CPU params cannot be scanned on {devices}")
        return scan_argmin_sharded_ref(surface, dims, params, len(devices))
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"CUDA params cannot be scanned on {devices}")
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.index is None else d for d in devices]
    _check_geometry(params.shape[0], q_per_block)
    home = devices[0]
    repeats = {d: devices.count(d) for d in devices}
    on = {d: params.to(d) for d in repeats}
    keys = []
    for i, (row0, nrows) in enumerate(shard_spans(total, len(devices))):
        if nrows == 0:
            continue
        dev = devices[i]
        p, dd = on[dev], _dims_on(tuple(dims), dev)
        if repeats[dev] == 1:
            k = _launch_scan(surface, dd, p, q_per_block, total, row0, nrows,
                             stream(dev))
        else:
            # a stream of PyTorch's pool: distinct for up to 32 shards
            cur, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
            side.wait_stream(cur)             # the params are ready
            with torch.cuda.stream(side):
                k = _launch_scan(surface, dd, p, q_per_block, total, row0,
                                 nrows, side.cuda_stream)
            cur.wait_stream(side)             # the shard's keys are done
            k.record_stream(cur)              # read on cur before reuse
        scan_argmin_sharded.launches += 1
        keys.append(k.to(home))
    folded = torch.stack(keys).bitwise_xor(_SIGN).amin(0).bitwise_xor(_SIGN)
    return _decode_keys(folded)


scan_argmin_sharded.launches = 0


def neighbor_step(surface: Surface, dims: Sequence[GridDim],
                  cur: torch.Tensor, params: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ensemble hill-climb step over the (S, D) int64 grid indices
    ``cur`` for one request (``params`` (1, P) float32): ((S,) centre
    cost, (S,) best neighbour cost, (S,) int32 slot in
    ``_neighbor_offsets`` order).  CUDA tensors launch the kernel; CPU
    tensors take ``neighbor_step_ref``."""
    _check(surface, dims, params)
    if params.shape[0] != 1 or cur.dtype != torch.int64 or cur.ndim != 2 \
            or cur.shape[1] != len(dims):
        raise ValueError(f"neighbor_step takes (S, {len(dims)}) int64 "
                         f"indices and (1, P) params")
    if not _on_cuda(cur, params, *_values_of(dims)):
        return neighbor_step_ref(surface, dims, cur, params)
    lib = load_library("plan_scan")
    S = cur.shape[0]
    center = torch.empty(S, dtype=torch.float32, device=cur.device)
    best = torch.empty(S, dtype=torch.float32, device=cur.device)
    slot = torch.empty(S, dtype=torch.int32, device=cur.device)
    args = _NeighborArgs(_c_dims(tuple(dims)), len(dims),
                         _c_surface(surface), _table(surface, cur.device), S)
    with torch.cuda.device(cur.device):
        check_launch(lib.neighbor_step(
            ctypes.addressof(args), cur.data_ptr(), params.data_ptr(),
            center.data_ptr(), best.data_ptr(), slot.data_ptr(),
            stream(cur.device)), "neighbor_step")
    neighbor_step.launches += 1
    return center, best, slot


neighbor_step.launches = 0


def ensemble_climb(surface: Surface, dims: Sequence[GridDim],
                   starts: torch.Tensor, params: torch.Tensor,
                   max_iters: int) -> Tuple[torch.Tensor, ...]:
    """The ensemble hill climb of Q requests (``params`` (Q, P) float32)
    from the S grid indices ``starts`` ((S, D) int64) in one launch, each
    (request, start) to convergence or ``max_iters`` iterations.  Returns
    ``ensemble_climb_ref``'s five tensors.  CUDA tensors launch the kernel
    on the current stream without syncing; CPU tensors take
    ``ensemble_climb_ref``."""
    _check(surface, dims, params)
    _check_starts(dims, starts)
    if max_iters < 0:
        raise ValueError(f"max_iters={max_iters} < 0")
    if not _on_cuda(starts, params, *_values_of(dims)):
        return ensemble_climb_ref(surface, dims, starts, params, max_iters)
    lib = load_library("plan_scan")
    Q, (S, D) = params.shape[0], starts.shape
    dev = starts.device
    idx = torch.empty((Q, S, D), dtype=torch.int64, device=dev)
    cost = torch.empty((Q, S), dtype=torch.float32, device=dev)
    counts = torch.empty((3, Q, S), dtype=torch.int64, device=dev)
    args = _ClimbArgs(_c_dims(tuple(dims)), D, _c_surface(surface),
                      _table(surface, dev), Q, S, max_iters)
    with torch.cuda.device(dev):
        check_launch(lib.ensemble_climb(
            ctypes.addressof(args), starts.data_ptr(), params.data_ptr(),
            idx.data_ptr(), cost.data_ptr(), counts[0].data_ptr(),
            counts[1].data_ptr(), counts[2].data_ptr(), stream(dev)),
            "ensemble_climb")
    ensemble_climb.launches += 1
    return idx, cost, counts[0], counts[1], counts[2]


ensemble_climb.launches = 0


def reset_launch_counts() -> None:
    scan_argmin.launches = 0
    scan_argmin_sharded.launches = 0
    neighbor_step.launches = 0
    ensemble_climb.launches = 0


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
    """``PlanBackend`` over the CUDA scan and ensemble-climb kernels
    (``get_backend("cuda")``), float32 like the reference's pallas
    backend: ``exact = False``, so the broker re-commits every winner in
    float64 and re-searches on the exact ``"torch"`` backend when float32
    rounding let an infeasible configuration win.

    ``device="cpu"`` runs the same wrappers on CPU tensors, which take the
    plain versions — the tests reach the kernel path without a card.  Scans
    and climbs launch on the current stream; ``finalize`` does the one
    device->host copy.  A stacked climb is one ``ensemble_climb`` launch
    that runs every (request, start) to convergence on the device; its
    results and ``configs_explored`` are the reference pallas backend's,
    whose host loop launched one neighbour step and synced per iteration.

    Plan devices (the reference's ``devices`` cap and ``REPRO_PLAN_DEVICES``,
    ``repro_torch.launch.mesh``): ``devices`` is an int cap on the visible
    GPUs (all of them, capped by ``REPRO_PLAN_DEVICES``, by default; one
    device on the CPU), or an explicit sequence of devices, repeats
    allowed — ``["cuda:0"] * 4`` runs four logical shards on one card,
    ``["cpu"] * 4`` their plain versions.  With one plan device the
    geometry is the unsharded one.  With more, ``argmin_grid[_many]`` scan
    through ``scan_argmin_sharded`` (K4), and ``hill_climb_ensemble_many``
    climbs contiguous groups of the requests on the devices in order, one
    launch a group; each request's trajectory is unchanged."""

    name = "cuda"
    exact = False
    dtype = torch.float32

    def __init__(self, device="cuda",
                 devices: Union[int, Sequence, None] = None):
        self.device = resolve_device(device)
        if devices is None or isinstance(devices, int):
            n = plan_device_count()
            if devices is not None:
                n = min(n, max(1, int(devices)))
            self._shards = plan_devices(n) \
                if self.device.type == "cuda" and n > 1 else [self.device]
        else:
            self._shards = [resolve_device(d) for d in devices]
            if not self._shards or \
                    {d.type for d in self._shards} != {self.device.type}:
                raise ValueError(f"plan devices {devices} do not match the "
                                 f"backend's device {self.device}")
        self._grids = {}
        # largest request stack one scan / climb launch served
        # (chip_smoke.py times the kernels at that shape)
        self.max_stack = 0
        self.max_climb_stack = 0

    def device_count(self) -> int:
        """Shards the grid scans are split over (1: unsharded)."""
        return len(self._shards)

    def _dims(self, cluster: ClusterConditions,
              device: Optional[torch.device] = None
              ) -> Tuple[GridDim, ...]:
        device = self.device if device is None else device
        key = (cluster.dims, device)
        dims = self._grids.get(key)
        if dims is None:
            dims = self._grids[key] = grid_dims(cluster, device)
        return dims

    def _params32(self, surface: Surface, params,
                  device: Optional[torch.device] = None) -> torch.Tensor:
        """(Q, P) float32 params: the search runs on float32-rounded
        request scalars, as the reference's ``_params32``."""
        pm = np.atleast_2d(np.asarray(params, dtype=np.float64))
        if pm.shape[1] < surface.n_params:
            raise ValueError(f"{surface.kind} surface needs "
                             f"{surface.n_params} params, got {pm.shape[1]}")
        return torch.as_tensor(pm[:, :surface.n_params].astype(np.float32),
                               device=self.device if device is None
                               else device)

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
        """One ``scan_argmin`` launch (one a shard when sharded) for Q
        requests sharing one cost fn and grid; per-request results
        identical to Q ``argmin_grid`` calls.  Returns the zero-arg
        finalize that copies the winners to the host and decodes them."""
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
        dims = self._dims(cluster)
        if self.device_count() > 1:
            cost, flat = scan_argmin_sharded(surface, dims, p, self._shards,
                                             self.q_per_block(Q))
        else:
            cost, flat = scan_argmin(surface, dims, p, self.q_per_block(Q))
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
        """Exhaustive scan as one kernel launch (one a shard); first
        strict minimum in ``enumerate_configs`` order, (None, inf) when
        every configuration costs inf."""
        if params is None:
            raise ValueError("kernel surfaces take per-request params")
        return self.argmin_grid_many(batch_cost_fn, cluster,
                                     np.asarray(params)[None, :],
                                     stats=stats, chunk_size=chunk_size)[0]

    # -- ensemble climb on the device ---------------------------------------- #

    def hill_climb_ensemble(self, batch_cost_fn: BatchCostFn,
                            cluster: ClusterConditions,
                            starts: Optional[Sequence[Sequence[int]]] = None,
                            stats: Optional[PlanningStats] = None, *,
                            params=None, n_random: int = 0, seed: int = 0,
                            max_iters: int = 100_000) -> Result:
        """Multi-start steepest descent as one ``ensemble_climb`` launch
        on the backend's device."""
        if params is None:
            raise ValueError("kernel surfaces take per-request params")
        return self._climbs(batch_cost_fn, cluster, np.asarray(params)[None],
                            starts, stats, n_random, seed, max_iters,
                            [self.device])()[0]

    def hill_climb_ensemble_many(self, *args, **kwargs) -> List[Result]:
        return self.hill_climb_ensemble_many_async(*args, **kwargs)()

    @hot_path("dispatches the ensemble-climb kernel per flush group",
              folds=1)
    def hill_climb_ensemble_many_async(self, batch_cost_fn: BatchCostFn,
                                       cluster: ClusterConditions,
                                       params_many, *, starts=None,
                                       stats: Optional[PlanningStats] = None,
                                       n_random: int = 0, seed: int = 0,
                                       max_iters: int = 100_000):
        """Q climbs sharing one cost fn, grid and start set: one
        ``ensemble_climb`` launch for all of them, or, with more than one
        plan device, one a device over a contiguous group of the requests
        (the reference shards the request axis the same way).  Each
        request's trajectory is unchanged.  Returns the zero-arg finalize
        that copies the climbs to the host, adds their exploration to
        ``stats`` and decodes the winners."""
        pm = np.asarray(params_many, dtype=np.float64)
        if pm.shape[0] == 0:
            return lambda: []
        return self._climbs(batch_cost_fn, cluster, pm, starts, stats,
                            n_random, seed, max_iters, self._shards)

    def _climbs(self, batch_cost_fn: BatchCostFn, cluster: ClusterConditions,
                pm: np.ndarray, starts, stats: Optional[PlanningStats],
                n_random: int, seed: int, max_iters: int,
                devices: Sequence[torch.device]):
        stats = stats if stats is not None else PlanningStats()
        surface = _surface_of(batch_cost_fn)
        start_idx = start_indices(cluster, starts, n_random, seed)
        Q, S = pm.shape[0], len(start_idx)
        per = max(1, -(-Q // len(devices)))
        self.max_climb_stack = max(self.max_climb_stack, min(Q, per))
        outs = []
        for g, q0 in enumerate(range(0, Q, per)):
            dev = devices[g]
            outs.append(ensemble_climb(
                surface, self._dims(cluster, dev),
                torch.as_tensor(start_idx, device=dev),
                self._params32(surface, pm[q0:q0 + per], dev), max_iters))

        def finalize() -> List[Result]:
            idx, cost, iters, vsum, vfin = (
                torch.cat([o[k].cpu() for o in outs]).numpy()
                for k in range(5))
            # the reference pallas backend's count: every iteration costs
            # all S centres and their in-grid neighbours until the last
            # start stops, a stopped start at its final index
            T = iters.max(1, keepdims=True)
            stats.configs_explored += int(
                (T * S).sum() + vsum.sum() + (vfin * (T - iters)).sum())
            grids = grid_arrays(cluster)
            res = []
            for q in range(Q):
                i = int(np.argmin(cost[q]))
                res.append((tuple(int(grids[d][idx[q, i, d]])
                                  for d in range(len(grids))),
                            float(cost[q, i])))
            return res
        return finalize
