"""The port's plan scans on n-D grids and sharded over plan devices (K4),
against the reference's numpy backend (and its pallas backend in
interpret mode for the n-D fault).

Until the n-D repair the port's scan and neighbor-step kernels took only
2-D (nc, cs) grids: ``scan_argmin``, ``neighbor_step`` and
``CudaPlanBackend`` raised ``ValueError`` on the 3-D and 4-D grids below,
where the reference's backends return a plan.  The sharded families are
those of ``tests/test_sharded_plan.py``'s child process — random, ragged,
tie-heavy and all-infeasible cost tables, plus the param-offset surface —
on grids large enough that the tile-rounded shard spans split them, run
on ``CudaPlanBackend(device="cpu", devices=["cpu"] * D)``, whose sharded
scan is ``scan_argmin_sharded_ref``.  The tables hold integers below
2**20 plus integer params, so float32 and float64 costs are exact and
results must equal the numpy backend's bit for bit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_shape as r_get_shape
from repro.configs import get_config as r_get_config
from repro.core.cluster import ClusterConditions as RCluster
from repro.core.cluster import ResourceDim as RDim
from repro.core.planning_backend import get_backend as r_get_backend
from repro.core.sharding_planner import ShardingPlanner as RPlanner
from repro.core.sharding_planner import TpuCluster as RTpuCluster
from repro_torch.configs import get_config, get_shape
from repro_torch.core import cost_model as cm
from repro_torch.core.cluster import ClusterConditions as TCluster
from repro_torch.core.cluster import ResourceDim as TDim
from repro_torch.core.planning_backend import get_backend
from repro_torch.core.sharding_planner import PLAN_CHOICES, ShardingPlanner
from repro_torch.core.sharding_planner import TpuCluster
from repro_torch.kernels import plan_scan as ps
from repro_torch.launch import mesh

SHARDS = (1, 2, 3, 4, 7, 8)


def _clusters(dims):
    return (RCluster(dims=tuple(RDim(*d) for d in dims)),
            TCluster(dims=tuple(TDim(*d) for d in dims)))


def _ref_table_fn(cluster, table, xp):
    """The reference side of a ``CostTable`` surface: look each
    configuration's cost up by its grid indices, plus params[0]."""
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


def _same(a, b):
    (ra, ca), (rb, cb) = a, b
    return ra == rb and (ca == cb or (math.isinf(ca) and math.isinf(cb)))


# --------------------------- the n-D fault ---------------------------------- #

ND_GRIDS = {
    3: [("a", 1, 7), ("b", 2, 20, 3), ("c", 1, 8, 1, (1, 2, 4, 8))],
    4: [("pods", 1, 2, 1, (1, 2)), ("dp", 1, 5), ("tp", 1, 16, 5),
        ("mb", 1, 3)],
}


@pytest.mark.parametrize("n_dims", sorted(ND_GRIDS))
def test_nd_table_grid_plans_like_the_reference(n_dims):
    rcl, tcl = _clusters(ND_GRIDS[n_dims])
    rng = np.random.default_rng(n_dims)
    shape = tuple(len(d.grid()) for d in rcl.dims)
    table = rng.integers(0, 1 << 20, size=shape).astype(np.float64)
    table[rng.random(shape) < 0.2] = np.inf
    p = np.array([3.0])
    ref = r_get_backend("numpy").argmin_grid(
        _ref_table_fn(rcl, table, np), rcl, params=p)
    pallas = r_get_backend("pallas").argmin_grid(
        _ref_table_fn(rcl, table, jnp), rcl, params=p)
    assert ref[0] is not None and _same(pallas, ref)
    surface = cm.Surface(cm.CostTable.of(tcl, table))
    be = ps.CudaPlanBackend(device="cpu")
    assert _same(be.argmin_grid(_port_fn(surface), tcl, params=p), ref)
    climb = r_get_backend("numpy").hill_climb_ensemble(
        _ref_table_fn(rcl, table, np), rcl, params=p, n_random=6, seed=1)
    assert _same(be.hill_climb_ensemble(_port_fn(surface), tcl, params=p,
                                        n_random=6, seed=1), climb)
    # the kernel wrappers themselves, on CPU tensors
    dims = ps.grid_dims(tcl, "cpu")
    pt = torch.tensor(p[None], dtype=torch.float32)
    cost, flat = ps.scan_argmin(surface, dims, pt)
    assert tuple(ps.decode_rows(dims, flat)[0].tolist()) == ref[0]
    assert float(cost[0]) == ref[1]
    cur = np.stack([rng.integers(0, s, 9) for s in shape], 1)
    centre, best, slot = ps.neighbor_step(surface, dims, torch.tensor(cur),
                                          pt)
    # numpy: each start's +-1 neighbours in _neighbor_offsets order
    nbr = cur[:, None, :] + np.eye(n_dims, dtype=np.int64).repeat(2, 0)[
        None] * np.tile([-1, 1], n_dims)[None, :, None]
    ok = ((nbr >= 0) & (nbr < np.asarray(shape))).all(-1)
    ncost = np.where(ok, table[tuple(np.clip(nbr, 0, np.asarray(shape) - 1)
                                     .transpose(2, 0, 1))] + p[0], np.inf)
    assert np.array_equal(centre.double().numpy(),
                          table[tuple(cur.T)] + p[0])
    assert np.array_equal(best.double().numpy(), ncost.min(1))
    assert np.array_equal(slot.numpy(), ncost.argmin(1))


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_4d_roofline_grid_plans_like_the_reference(kind):
    """The sharding planner's (pods, dp, tp, microbatch) grid: argmin and
    climb over the roofline surface equal the reference numpy backend's
    configurations, and its pallas backend's within float32 rounding."""
    for arch in ("smollm-360m", "deepseek-67b"):
        rshape, tshape = r_get_shape(kind), get_shape(kind)
        rcl, tcl = RTpuCluster().dims(rshape), TpuCluster().dims(tshape)
        choice = PLAN_CHOICES[tshape.kind][0]
        p = np.array([math.inf, math.inf])
        np_be, pallas = r_get_backend("numpy"), r_get_backend("pallas")
        ref = np_be.argmin_grid(RPlanner()._grid_fn(
            r_get_config(arch), rshape, choice, np_be), rcl, params=p)
        pal = pallas.argmin_grid(RPlanner()._grid_fn(
            r_get_config(arch), rshape, choice, pallas), rcl, params=p)
        fn = ShardingPlanner(backend="torch")._grid_fn(
            get_config(arch), tshape, choice, get_backend("torch"))
        got = ps.CudaPlanBackend(device="cpu").argmin_grid(fn, tcl, params=p)
        assert ref[0] is not None and got[0] == ref[0] == pal[0]
        assert got[1] == pytest.approx(pal[1], rel=1e-6)
        assert got[1] == pytest.approx(ref[1], rel=1e-6)
        climb = np_be.hill_climb_ensemble(RPlanner()._grid_fn(
            r_get_config(arch), rshape, choice, np_be), rcl, params=p)
        assert ps.CudaPlanBackend(device="cpu").hill_climb_ensemble(
            fn, tcl, params=p)[0] == climb[0]


def test_grid_above_max_dims_raises_with_its_count():
    dims = tuple(ps.GridDim(0, 1, 2) for _ in range(ps.MAX_DIMS + 1))
    table = cm.CostTable(tuple(np.arange(2) for _ in dims),
                         np.zeros((2,) * len(dims)))
    with pytest.raises(ValueError, match=f"got {ps.MAX_DIMS + 1} dims"):
        ps.scan_argmin(cm.Surface(table), dims,
                       torch.zeros((1, 1), dtype=torch.float32))
    # a table must cover the grid it is scanned over, row for row
    small = cm.CostTable((np.arange(2), np.arange(3)), np.zeros((2, 3)))
    with pytest.raises(ValueError, match="for a grid of"):
        ps.scan_argmin(cm.Surface(small), dims[:2],
                       torch.zeros((1, 1), dtype=torch.float32))


def test_decode_rows_is_enumerate_configs_order():
    from repro_torch.core.planning_backend import enumerate_configs
    _, tcl = _clusters(ND_GRIDS[4])
    dims = ps.grid_dims(tcl, "cpu")
    flat = torch.arange(tcl.grid_size())
    assert np.array_equal(ps.decode_rows(dims, flat).numpy(),
                          enumerate_configs(tcl))


# ------------------------------ sharded scans -------------------------------- #

# (seed, family, dims): big enough that 2048-row tiles split them
FAMILIES = [
    (0, "random", [("a", 0, 149), ("b", 0, 96)]),
    (1, "ragged", [("a", 1, 3001, 3), ("b", 1, 34, 1,
                                        (1, 2, 3, 5, 8, 13, 21, 34))]),
    (2, "ties", [("a", 0, 120), ("b", 0, 110)]),
    (3, "allinf", [("a", 0, 90), ("b", 0, 70)]),
    (4, "random", [("a", 0, 5), ("b", 0, 4)]),
    (5, "ties", [("a", 0, 20), ("b", 0, 3), ("c", 1, 3)]),
]


def _table(rng, family, shape):
    table = rng.integers(0, 1 << 20, size=shape).astype(np.float64)
    table[rng.random(shape) < 0.15] = np.inf
    if family == "ties":
        table = rng.integers(8, 1 << 20, size=shape).astype(np.float64)
        table[rng.random(shape) < 0.6] = 7.0       # mass-tied minima
    if family == "allinf":
        table[:] = np.inf
    return table


def _param_table(cluster):
    """The reference child's ``param_fn`` ((a * 37 + b * 11) % 101) * 8 as
    a table (its params[0] offset is the table surface's own)."""
    grids = np.meshgrid(*[np.asarray(d.grid(), dtype=np.int64)
                          for d in cluster.dims], indexing="ij")
    return ((grids[0] * 37 + grids[1] * 11) % 101) * 8.0


@pytest.mark.parametrize("D", SHARDS)
def test_sharded_backend_matches_numpy_oracle(D):
    np_be = r_get_backend("numpy")
    be = ps.CudaPlanBackend(device="cpu", devices=["cpu"] * D)
    assert be.device_count() == D
    bad = []
    for seed, family, dims in FAMILIES:
        rng = np.random.default_rng(seed)
        rcl, tcl = _clusters(dims)
        shape = tuple(len(d.grid()) for d in rcl.dims)
        table = _table(rng, family, shape)
        zero = np.array([0.0])
        surface = cm.Surface(cm.CostTable.of(tcl, table))
        got = be.argmin_grid(_port_fn(surface), tcl, params=zero)
        ref = np_be.argmin_grid(_ref_table_fn(rcl, table, np), rcl,
                                params=zero, chunk_size=16)
        if not _same(got, ref):
            bad.append((family, "argmin_grid", got, ref))
        pm = rng.integers(0, 1000, size=(5, 1)).astype(np.float64)
        ptab = _param_table(rcl)
        psurf = _port_fn(cm.Surface(cm.CostTable.of(tcl, ptab)))
        gm = be.argmin_grid_many(psurf, tcl, pm)
        rm = np_be.argmin_grid_many(_ref_table_fn(rcl, ptab, np), rcl, pm,
                                    chunk_size=8)
        if not all(_same(g, r) for g, r in zip(gm, rm)):
            bad.append((family, "argmin_grid_many", gm, rm))
        gh = be.hill_climb_ensemble_many(psurf, tcl, pm[:3], n_random=4,
                                         seed=seed)
        rh = np_be.hill_climb_ensemble_many(_ref_table_fn(rcl, ptab, np),
                                            rcl, pm[:3], n_random=4,
                                            seed=seed)
        if not all(_same(g, r) for g, r in zip(gh, rh)):
            bad.append((family, "climb_many", gh, rh))
    assert not bad, bad


@pytest.mark.parametrize("D", SHARDS)
def test_sharded_ref_equals_single_scan_and_spans_cover_the_grid(D):
    """``scan_argmin_sharded`` (CPU: its plain version) equals the
    unsharded scan on the tie-heavy and ragged families, for Q = 1 and a
    stack, and its spans tile the grid in ascending order."""
    for seed, family, dims in FAMILIES:
        rng = np.random.default_rng(seed)
        _, tcl = _clusters(dims)
        shape = tuple(len(d.grid()) for d in tcl.dims)
        surface = cm.Surface(cm.CostTable.of(tcl, _table(rng, family,
                                                         shape)))
        gdims = ps.grid_dims(tcl, "cpu")
        for Q in (1, 6):
            p = torch.tensor(rng.integers(0, 50, (Q, 1)),
                             dtype=torch.float32)
            want = ps.scan_argmin_ref(surface, gdims, p)
            got = ps.scan_argmin_sharded(surface, gdims, p, ["cpu"] * D)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        total = tcl.grid_size()
        spans = ps.shard_spans(total, D)
        assert len(spans) == D and spans[0][0] == 0
        assert sum(n for _, n in spans) == total
        assert all(r0 + n == r1 for (r0, n), (r1, _) in zip(spans, spans[1:])
                   if n)
        # a span followed by a non-empty one holds whole tiles
        assert all(n % ps.TILE_ROWS == 0 for (_, n), (_, m)
                   in zip(spans, spans[1:]) if m)


def test_k4_counter_counts_only_launches():
    ps.reset_launch_counts()
    _, tcl = _clusters(FAMILIES[0][2])
    shape = tuple(len(d.grid()) for d in tcl.dims)
    surface = cm.Surface(cm.CostTable.of(tcl, np.ones(shape)))
    ps.scan_argmin_sharded(surface, ps.grid_dims(tcl, "cpu"),
                           torch.zeros((1, 1), dtype=torch.float32),
                           ["cpu"] * 4)
    assert ps.scan_argmin_sharded.launches == 0     # plain version: no launch
    with pytest.raises(ValueError, match="CPU params"):
        ps.scan_argmin_sharded(surface, ps.grid_dims(tcl, "cpu"),
                               torch.zeros((1, 1), dtype=torch.float32),
                               ["cuda:0"] * 2)


# ------------------------------ plan devices -------------------------------- #

@pytest.fixture
def four_gpus(monkeypatch):
    """Pretend four GPUs are visible (nothing launches: only the device
    bookkeeping is exercised)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv(mesh.PLAN_DEVICES_ENV, raising=False)


def test_plan_devices_env_is_the_rollback_switch(four_gpus, monkeypatch):
    assert mesh.plan_device_count() == 4
    assert ps.CudaPlanBackend(device="cuda").device_count() == 4
    monkeypatch.setenv(mesh.PLAN_DEVICES_ENV, "1")
    assert mesh.plan_device_count() == 1
    be = ps.CudaPlanBackend(device="cuda")
    assert be.device_count() == 1 and be._shards == [be.device]
    monkeypatch.setenv(mesh.PLAN_DEVICES_ENV, "2")
    assert mesh.plan_devices() == [torch.device("cuda", 0),
                                   torch.device("cuda", 1)]
    monkeypatch.setenv(mesh.PLAN_DEVICES_ENV, "not-a-number")
    assert mesh.plan_device_count() == 4          # malformed cap is ignored


def test_int_cap_and_explicit_devices(four_gpus):
    assert ps.CudaPlanBackend(device="cuda", devices=2).device_count() == 2
    assert ps.CudaPlanBackend(device="cuda", devices=8).device_count() == 4
    assert ps.CudaPlanBackend(device="cuda", devices=0).device_count() == 1
    # on the CPU an int cap leaves one device: the CPU is one plan device
    assert ps.CudaPlanBackend(device="cpu", devices=3).device_count() == 1
    assert ps.CudaPlanBackend(device="cpu",
                              devices=["cpu"] * 3).device_count() == 3
    with pytest.raises(ValueError, match="do not match"):
        ps.CudaPlanBackend(device="cpu", devices=["cuda:0", "cuda:0"])


def test_one_gpu_host_has_one_plan_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(mesh.PLAN_DEVICES_ENV, raising=False)
    assert mesh.plan_device_count() == 1
