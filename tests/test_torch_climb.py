"""The port's ensemble climb (K3 as one launch a stacked climb group)
against the JAX reference's climbs.

``CudaPlanBackend(device="cpu")`` climbs through ``ensemble_climb``, whose
CPU path is ``ensemble_climb_ref``.  Its results and ``configs_explored``
must equal the reference's pallas backend's (interpret mode), whose host
loop costs every start and its in-grid neighbours once per iteration until
the last start stops; its results must equal the reference numpy
backend's.  The cost tables hold integers below 2**20 plus integer params,
so float32 and float64 costs are exact and every comparison is bit for
bit.  ``ensemble_climb_ref``'s five outputs are also held against a numpy
emulation of the reference's host loop.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as rcm
from repro.core.cluster import ClusterConditions as RCluster
from repro.core.cluster import PlanningStats as RStats
from repro.core.cluster import ResourceDim as RDim
from repro.core.planning_backend import get_backend as r_get_backend
from repro.core.plans import OperatorCosting as ROperatorCosting
from repro_torch.core import cost_model as cm
from repro_torch.core.cluster import ClusterConditions as TCluster
from repro_torch.core.cluster import PlanningStats as TStats
from repro_torch.core.cluster import ResourceDim as TDim
from repro_torch.core.planning_backend import _neighbor_offsets
from repro_torch.kernels import plan_scan as ps

GRIDS = {
    1: [("a", 1, 40)],
    2: [("nc", 1, 60, 3), ("cs", 1, 34, 1, (1, 2, 3, 5, 8, 13, 21, 34))],
    3: [("a", 1, 7), ("b", 2, 20, 3), ("c", 1, 8, 1, (1, 2, 4, 8))],
    4: [("pods", 1, 2, 1, (1, 2)), ("dp", 1, 5), ("tp", 1, 16, 5),
        ("mb", 1, 3)],
}
TABLES = ("random", "plateau", "all-inf")
MAX_ITERS = (1, 2, 3, 100_000)
PARAMS = np.array([[3.0], [0.0], [17.0]])


def _clusters(dims):
    return (RCluster(dims=tuple(RDim(*d) for d in dims)),
            TCluster(dims=tuple(TDim(*d) for d in dims)))


def _table(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "all-inf":
        return np.full(shape, np.inf)
    if kind == "plateau":                 # three levels: ties everywhere
        return rng.integers(0, 3, size=shape).astype(np.float64)
    table = rng.integers(0, 1 << 20, size=shape).astype(np.float64)
    table[rng.random(shape) < 0.15] = np.inf
    return table


def _ref_table_fn(cluster, table, xp):
    """The reference side of a ``CostTable`` surface: each
    configuration's cost by its grid indices, plus params[0]."""
    grids = [np.asarray(d.grid(), dtype=np.int64) for d in cluster.dims]
    t = xp.asarray(table.ravel())
    gs = [xp.asarray(g) for g in grids]

    def fn(cfgs, params):
        a = xp.asarray(cfgs)
        flat = 0
        for d, g in enumerate(gs):
            flat = flat * len(grids[d]) + xp.searchsorted(g, a[:, d])
        return t[flat] + params[0]
    return fn


def _port_fn(surface):
    def fn(cfgs, params):
        return surface(cfgs, params)
    fn.surface = surface
    return fn


def _climb_all(rcl, tcl, rfns, tfn, pm, *, max_iters, n_random, devices):
    """(pallas, numpy, port) results and configs_explored of one stacked
    climb and of the single-request entry point on its first request."""
    kw = dict(n_random=n_random, seed=5, max_iters=max_iters)
    out = {}
    for name, be, fn in (("pallas", r_get_backend("pallas"), rfns[0]),
                         ("numpy", r_get_backend("numpy"), rfns[1]),
                         ("port", ps.CudaPlanBackend(
                             device="cpu", devices=devices), tfn)):
        st, st1 = (RStats(), RStats()) if name != "port" else \
            (TStats(), TStats())
        cl = tcl if name == "port" else rcl
        many = be.hill_climb_ensemble_many(fn, cl, pm, stats=st, **kw)
        one = be.hill_climb_ensemble(fn, cl, None, st1, params=pm[0], **kw)
        out[name] = (many, one, st.configs_explored, st1.configs_explored)
    return out


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("n_dims", sorted(GRIDS))
def test_table_climb_matches_pallas_and_numpy(n_dims, kind):
    rcl, tcl = _clusters(GRIDS[n_dims])
    shape = tuple(len(d.grid()) for d in rcl.dims)
    table = _table(kind, shape, 100 * n_dims + TABLES.index(kind))
    rfns = (_ref_table_fn(rcl, table, jnp), _ref_table_fn(rcl, table, np))
    tfn = _port_fn(cm.Surface(cm.CostTable.of(tcl, table)))
    for max_iters in MAX_ITERS:
        for n_random in (0, 6):
            for Q in (1, 3):
                out = _climb_all(rcl, tcl, rfns, tfn, PARAMS[:Q],
                                 max_iters=max_iters, n_random=n_random,
                                 devices=None)
                case = (n_dims, kind, max_iters, n_random, Q)
                assert out["port"] == out["pallas"], case
                assert out["port"][:2] == out["numpy"][:2], case
    if kind == "all-inf":
        assert all(math.isinf(c) for _, c in out["port"][0])


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_climb_matches_pallas(n_shards):
    """``devices=["cpu"] * D`` cuts the stacked requests into contiguous
    groups, one climb launch each; results and stats are unchanged."""
    rcl, tcl = _clusters(GRIDS[2])
    shape = tuple(len(d.grid()) for d in rcl.dims)
    table = _table("plateau", shape, 7)
    rfns = (_ref_table_fn(rcl, table, jnp), _ref_table_fn(rcl, table, np))
    tfn = _port_fn(cm.Surface(cm.CostTable.of(tcl, table)))
    out = _climb_all(rcl, tcl, rfns, tfn, PARAMS, max_iters=100_000,
                     n_random=6, devices=["cpu"] * n_shards)
    assert out["port"] == out["pallas"]
    assert out["port"][:2] == out["numpy"][:2]


@pytest.mark.parametrize("impl,objective", [("SMJ", "time"),
                                            ("BHJ", "money")])
def test_db_surface_climb_matches_pallas(impl, objective):
    """The paper's regression models (IEEE adds, multiplies and compares
    only, so float32 agrees bit for bit across frameworks) with a
    different surface for every request."""
    dims = [("nc", 1, 200, 1), ("cs", 1, 10)]
    rcl, tcl = _clusters(dims)
    pallas = r_get_backend("pallas")
    rfn = ROperatorCosting(models=rcm.paper_models(), cluster=rcl,
                           objective=objective)._grid_fn(impl, pallas)
    tfn = _port_fn(cm.Surface(cm.paper_models()[impl], objective))
    pm = np.array([[0.4, 3.0], [2.0, 40.0], [6.0, 9.0]])
    for max_iters in (2, 100_000):
        rs, ts = RStats(), TStats()
        ref = pallas.hill_climb_ensemble_many(rfn, rcl, pm, stats=rs,
                                              n_random=6, seed=2,
                                              max_iters=max_iters)
        got = ps.CudaPlanBackend(device="cpu").hill_climb_ensemble_many(
            tfn, tcl, pm, stats=ts, n_random=6, seed=2,
            max_iters=max_iters)
        assert got == ref
        assert dataclasses.asdict(ts) == dataclasses.asdict(rs)


def _emulate(table, starts, offset, max_iters):
    """numpy model of ensemble_climb for one request: the reference's host
    loop, with each start's iterations and in-grid neighbour counts."""
    shape = np.asarray(table.shape)
    cur = starts.copy()
    S, D = cur.shape
    offs = _neighbor_offsets(D)
    cost = np.full(S, np.inf, dtype=np.float32)
    iters = np.zeros(S, dtype=np.int64)
    vsum = np.zeros(S, dtype=np.int64)
    moving = np.ones(S, dtype=bool)

    def in_grid(c):
        return ((c > 0).sum(1) + (c < shape - 1).sum(1)).astype(np.int64)

    for _ in range(max_iters):
        if not moving.any():
            break
        nbr = cur[:, None, :] + offs[None]
        ok = ((nbr >= 0) & (nbr < shape)).all(-1)
        nc = np.where(ok, table[tuple(np.clip(nbr, 0, shape - 1)
                                      .transpose(2, 0, 1))] + offset, np.inf)
        centre = (table[tuple(cur.T)] + offset).astype(np.float32)
        j = nc.argmin(1)
        best = nc[np.arange(S), j].astype(np.float32)
        iters += moving
        vsum += np.where(moving, in_grid(cur), 0)
        improved = moving & (best < centre)
        cost = np.where(moving, centre, cost)
        cost = np.where(improved, best, cost)
        cur = np.where(improved[:, None], nbr[np.arange(S), j], cur)
        moving = improved
    return cur, cost, iters, vsum, in_grid(cur)


@pytest.mark.parametrize("max_iters", [0, 1, 2, 5, 100_000])
@pytest.mark.parametrize("n_dims", [2, 4])
def test_ensemble_climb_ref_outputs(n_dims, max_iters):
    _, tcl = _clusters(GRIDS[n_dims])
    shape = tuple(len(d.grid()) for d in tcl.dims)
    table = _table("random", shape, n_dims)
    surface = cm.Surface(cm.CostTable.of(tcl, table))
    dims = ps.grid_dims(tcl, "cpu")
    rng = np.random.default_rng(max_iters)
    starts = np.stack([rng.integers(0, s, 11) for s in shape], 1)
    pm = torch.tensor(PARAMS, dtype=torch.float32)
    got = ps.ensemble_climb(surface, dims, torch.tensor(starts), pm,
                            max_iters)
    assert [tuple(t.shape) for t in got] == \
        [(3, 11, n_dims)] + [(3, 11)] * 4
    assert [t.dtype for t in got] == [torch.int64, torch.float32] + \
        [torch.int64] * 3
    for q in range(3):
        want = _emulate(table, starts, PARAMS[q, 0], max_iters)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[q].numpy(), w)
    # the iteration count is the moves plus the stopping step, capped
    assert int(got[2].max()) <= max_iters
    assert ps.ensemble_climb.launches == 0      # CPU tensors: no launch


def test_ensemble_climb_checks_its_inputs():
    _, tcl = _clusters(GRIDS[2])
    surface = cm.Surface(cm.CostTable.of(
        tcl, np.zeros(tuple(len(d.grid()) for d in tcl.dims))))
    dims = ps.grid_dims(tcl, "cpu")
    p = torch.zeros(1, 1)
    with pytest.raises(ValueError, match="int64"):
        ps.ensemble_climb(surface, dims, torch.zeros(2, 2), p, 5)
    with pytest.raises(ValueError, match="int64"):
        ps.ensemble_climb(surface, dims, torch.zeros(2, 3,
                                                     dtype=torch.int64), p, 5)
    with pytest.raises(ValueError, match="max_iters"):
        ps.ensemble_climb(surface, dims, torch.zeros(2, 2,
                                                     dtype=torch.int64), p,
                          -1)
