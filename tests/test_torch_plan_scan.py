"""The port's plan-scan kernels, through their plain versions on the CPU,
against the reference's Pallas kernels in interpret mode.

Both sides compute in float32 on the same float32-rounded params.  Flat
ids (the argmin configurations, ties included) must be equal; costs match
to ``rtol=1e-6`` rather than bit for bit because the SMJ surface's
``log`` comes from XLA:CPU on one side and PyTorch's CPU kernel on the
other, which may round the float32 logarithm differently by an ulp (every
other operation is an IEEE add, multiply, divide or compare).  On the
card, chip_smoke.py holds the CUDA kernels against these plain versions
bit for bit.
"""
import math
import zlib

import numpy as np
import pytest
import torch

from repro.core import cost_model as rcm
from repro.core.cluster import ClusterConditions as RCluster
from repro.core.cluster import ResourceDim as RDim
from repro.core.plans import OperatorCosting as ROperatorCosting
from repro.kernels.plan_scan import PallasPlanBackend, build_neighbor_step
from repro_torch.core import cost_model as tcm
from repro_torch.core.cluster import ClusterConditions as TCluster
from repro_torch.core.cluster import ResourceDim as TDim
from repro_torch.core.cluster import PlanningStats
from repro_torch.core.planning_backend import _decode_flat, grid_arrays
from repro_torch.kernels import plan_scan as ps

RTOL = 1e-6

GRIDS = {
    "paper": [("nc", 1, 100, 1, ()), ("cs", 1, 10, 1, ())],
    "ragged": [("nc", 1, 299, 7, ()),
               ("cs", 1, 55, 1, (1, 2, 3, 5, 8, 13, 21, 34, 55))],
    "wide": [("nc", 1, 500, 1, ()), ("cs", 1, 20, 1, ())],
}


def _clusters(name):
    dims = GRIDS[name]
    return (RCluster(dims=tuple(RDim(*d) for d in dims)),
            TCluster(dims=tuple(TDim(*d) for d in dims)))


MODELS = {"sim": (rcm.simulator_cost_models, tcm.simulator_cost_models),
          "paper": (rcm.paper_models, tcm.paper_models),
          "simreg": (rcm.simulator_models, tcm.simulator_models)}

_PALLAS = {}


def _pallas(variant):
    if variant not in _PALLAS:
        _PALLAS[variant] = PallasPlanBackend(many_variant=variant)
    return _PALLAS[variant]


def _ref_fn(models, impl, objective, rcl, backend):
    costing = ROperatorCosting(models=MODELS[models][0](), cluster=rcl,
                               objective=objective)
    return costing._grid_fn(impl, backend)


def _params(rng, q, ss_hi=30.0):
    ss = rng.uniform(0.05, ss_hi, q)
    return np.stack([ss, ss + rng.uniform(0, 150, q)], 1)


def _assert_results(ref, tcl, cost, flat):
    grids = grid_arrays(tcl)
    shape = tuple(len(g) for g in grids)
    for (rcfg, rcost), c, f in zip(ref, cost.tolist(), flat.tolist()):
        if rcfg is None:
            assert f == -1 and math.isinf(c)
            continue
        assert _decode_flat(grids, shape, f) == rcfg
        assert c == pytest.approx(rcost, rel=RTOL)


@pytest.mark.parametrize("variant,case", [
    ("grid2d", ("sim", "SMJ", "time", "paper")),
    ("grid2d", ("sim", "BHJ", "money", "ragged")),
    ("grid2d", ("simreg", "BHJ", "time", "ragged")),
    ("grid2d", ("paper", "SMJ", "money", "wide")),
    ("grid2d", ("paper", "BHJ", "time", "wide")),
    ("unrolled", ("sim", "SMJ", "money", "ragged"))])
def test_scan_ref_matches_pallas(variant, case):
    models, impl, objective, grid = case
    rcl, tcl = _clusters(grid)
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    # Q > UNROLL_Q exercises the reference's 64-query grouping
    pm = _params(rng, 70)
    pallas = _pallas(variant)
    ref = pallas.argmin_grid_many(
        _ref_fn(models, impl, objective, rcl, pallas), rcl, pm)
    surface = tcm.Surface(MODELS[models][1]()[impl], objective)
    cost, flat = ps.scan_argmin_ref(
        surface, ps.grid_dims(tcl, "cpu"),
        torch.tensor(pm, dtype=torch.float32))
    _assert_results(ref, tcl, cost, flat)


def test_scan_ref_floor_ties_and_all_oom():
    # paper models clamp at the 1e-3 floor on wide grids: the winner is the
    # FIRST floored configuration; BHJ with ss above every 0.7 * cs is
    # infeasible everywhere
    rcl, tcl = _clusters("wide")
    pallas = _pallas("grid2d")
    for impl, pm in (("SMJ", np.array([[0.2, 3.0], [1.0, 50.0]])),
                     ("BHJ", np.array([[15.0, 30.0], [40.0, 90.0]]))):
        ref = pallas.argmin_grid_many(
            _ref_fn("paper", impl, "time", rcl, pallas), rcl, pm)
        surface = tcm.Surface(tcm.paper_models()[impl], "time")
        cost, flat = ps.scan_argmin_ref(
            surface, ps.grid_dims(tcl, "cpu"),
            torch.tensor(pm, dtype=torch.float32))
        _assert_results(ref, tcl, cost, flat)
        if impl == "SMJ":
            assert cost.tolist() == [pytest.approx(1e-3)] * 2
        else:
            assert flat.tolist() == [-1, -1]


@pytest.mark.parametrize("case", [("sim", "SMJ", "time", "paper"),
                                  ("sim", "BHJ", "money", "ragged"),
                                  ("paper", "BHJ", "time", "wide")])
def test_neighbor_ref_matches_pallas(case):
    models, impl, objective, grid = case
    rcl, tcl = _clusters(grid)
    rng = np.random.default_rng(7)
    sizes = [len(d.grid()) for d in tcl.dims]
    cur = np.stack([rng.integers(0, s, 26) for s in sizes], 1)
    cur[0], cur[1] = (0, 0), (sizes[0] - 1, sizes[1] - 1)   # grid edges
    p = _params(rng, 1)[0]
    pallas = _pallas("grid2d")
    step = build_neighbor_step(
        _ref_fn(models, impl, objective, rcl, pallas), rcl, n_starts=26,
        has_params=True, p_width=2, interpret=True)
    import jax.numpy as jnp
    rc, rb, rj = (np.asarray(x) for x in step(
        jnp.asarray(cur, dtype=jnp.int32),
        jnp.asarray(p[None, :].astype(np.float32))))
    surface = tcm.Surface(MODELS[models][1]()[impl], objective)
    tc, tb, tj = ps.neighbor_step_ref(
        surface, ps.grid_dims(tcl, "cpu"), torch.tensor(cur),
        torch.tensor(p[None, :], dtype=torch.float32))
    np.testing.assert_array_equal(rj, tj.numpy())
    np.testing.assert_allclose(tc.numpy(), rc, rtol=RTOL)
    np.testing.assert_allclose(tb.numpy(), rb, rtol=RTOL)


def test_wrappers_take_plain_version_on_cpu():
    _, tcl = _clusters("ragged")
    dims = ps.grid_dims(tcl, "cpu")
    surface = tcm.Surface(tcm.simulator_cost_models()["SMJ"], "money")
    p = torch.tensor(_params(np.random.default_rng(1), 5),
                     dtype=torch.float32)
    before = (ps.scan_argmin.launches, ps.neighbor_step.launches)
    for qb in (1, 5):
        got = ps.scan_argmin(surface, dims, p, qb)
        want = ps.scan_argmin_ref(surface, dims, p)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    cur = torch.tensor([[0, 0], [3, 4], [42, 8]])
    got = ps.neighbor_step(surface, dims, cur, p[:1])
    want = ps.neighbor_step_ref(surface, dims, cur, p[:1])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # launch counters count kernel launches only
    assert (ps.scan_argmin.launches, ps.neighbor_step.launches) == before


def test_cuda_backend_on_cpu_tensors():
    rcl, tcl = _clusters("paper")
    be = ps.CudaPlanBackend(device="cpu")
    assert not be.exact and be.name == "cuda"
    from repro_torch.core.plans import OperatorCosting
    fn = OperatorCosting(models=tcm.simulator_cost_models(),
                         cluster=tcl)._grid_fn("SMJ", be)
    pm = _params(np.random.default_rng(2), 3)
    stats = PlanningStats()
    many = be.argmin_grid_many(fn, tcl, pm, stats=stats)
    assert stats.configs_explored == 3 * tcl.grid_size()
    assert [be.argmin_grid(fn, tcl, params=p) for p in pm] == many
    pallas = _pallas("grid2d")
    ref = pallas.argmin_grid_many(
        _ref_fn("sim", "SMJ", "time", rcl, pallas), rcl, pm)
    assert [r[0] for r in ref] == [m[0] for m in many]
    climb = be.hill_climb_ensemble(fn, tcl, params=pm[0], n_random=6)
    assert climb[0] is not None
    # a cost fn without a Surface descriptor has no kernel to run
    with pytest.raises(TypeError, match="surface"):
        be.argmin_grid(lambda c, p: c[:, 0] * p[0], tcl, params=pm[0])
    with pytest.raises(TypeError, match="surface"):
        be.hill_climb_ensemble(lambda c, p: c[:, 0] * p[0], tcl,
                               params=pm[0])


def test_kernel_limits_and_geometry_rule():
    assert ps.CudaPlanBackend.q_per_block(1) == 1
    assert ps.CudaPlanBackend.q_per_block(8) == 8
    assert ps.CudaPlanBackend.q_per_block(65) == ps.UNROLL_Q
    huge = TCluster(dims=(TDim("nc", 1, 1 << 26), TDim("cs", 1, 100)))
    surface = tcm.Surface(tcm.paper_models()["SMJ"], "time")
    with pytest.raises(ValueError, match="32-bit"):
        ps.scan_argmin_ref(surface, ps.grid_dims(huge, "cpu"),
                           torch.zeros(1, 2))
    _, tcl = _clusters("paper")
    with pytest.raises(ValueError, match="float32"):
        ps.scan_argmin(surface, ps.grid_dims(tcl, "cpu"),
                       torch.zeros(1, 2, dtype=torch.float64))


def _encode(cost, flat):
    """numpy model of the kernel's packed key (plan_scan.cu)."""
    u = int(np.array([cost + 0.0], dtype=np.float32).view(np.uint32)[0])
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return int(np.array([(u << 32) | flat], dtype=np.uint64)
               .view(np.int64)[0])


def test_packed_key_order_and_decode():
    rng = np.random.default_rng(4)
    pairs = [(float(c), int(f)) for c, f in zip(
        np.float32(rng.uniform(-5, 5, 200)), rng.integers(0, 1 << 32, 200))]
    pairs += [(1e-3, 7), (1e-3, 3), (0.0, 9), (math.inf, 2)]
    keys = np.array([_encode(c, f) for c, f in pairs], dtype=np.int64)
    # unsigned key order is the (cost, flat) lexicographic order
    order = np.argsort(keys.view(np.uint64), kind="stable")
    assert [pairs[i] for i in order] == sorted(pairs)
    cost, flat = ps._decode_keys(torch.tensor(np.append(keys, -1)))
    assert cost.tolist()[:-1] == [float(np.float32(c)) for c, _ in pairs]
    assert flat.tolist() == [f for _, f in pairs] + [-1]
    assert math.isinf(cost.tolist()[-1])


def test_plan_scan_is_built_without_contraction():
    """The scan and climb kernels equal their plain versions bit for bit
    only if every float32 multiply and add rounds as written: no FMA
    contraction, no fast-math division, log or exp."""
    from repro_torch.kernels import build
    assert "-fmad=false" in build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f
                   for f in build.NVCC_FLAGS)
    assert "plan_scan" in build.SOURCES
