"""``get_backend("torch")`` against the reference numpy backend.

The port's exact backend computes in float64 torch with the reference's
chunking and strict-< first-minimum folds, so every search primitive must
return the same configuration and the bit-identical cost, ties included,
and count the same explored configurations — on the shipped cost surfaces
(both objectives) and on random lookup tables with OOM cells over random,
ragged and explicit-value grids.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import cost_model as rcm
from repro.core.cluster import ClusterConditions as RCluster
from repro.core.cluster import PlanningStats as RStats
from repro.core.cluster import ResourceDim as RDim
from repro.core.planning_backend import enumerate_configs as r_enum
from repro.core.planning_backend import get_backend as r_backend
from repro.core.planning_backend import start_indices as r_starts
from repro.core.plans import OperatorCosting as ROperatorCosting
from repro_torch.core import cost_model as tcm
from repro_torch.core.cluster import ClusterConditions as TCluster
from repro_torch.core.cluster import PlanningStats as TStats
from repro_torch.core.cluster import ResourceDim as TDim
from repro_torch.core.planning_backend import enumerate_configs as t_enum
from repro_torch.core.planning_backend import get_backend as t_backend
from repro_torch.core.planning_backend import start_indices as t_starts
from repro_torch.core.plans import OperatorCosting as TOperatorCosting
from repro_torch.kernels.plan_scan import CudaPlanBackend


def _clusters(rng, ragged):
    if ragged:
        step = int(rng.integers(2, 4))
        hi = 1 + step * 40 + int(rng.integers(1, step))
        vals = tuple(sorted(rng.choice(np.arange(1, 64), size=7,
                                       replace=False).tolist()))
        dims = [("a", 1, hi, step, ()), ("b", vals[0], vals[-1], 1, vals)]
    else:
        dims = [("a", 1, int(rng.integers(20, 90)), 1, ()),
                ("b", 1, int(rng.integers(3, 12)), 1, ())]
    return (RCluster(dims=tuple(RDim(*d) for d in dims)),
            TCluster(dims=tuple(TDim(*d) for d in dims)))


def _table_fns(rcl, tcl, table):
    """The same lookup-table cost fn for numpy and for torch."""
    ga, gb = (np.asarray(d.grid(), dtype=np.int64) for d in rcl.dims)
    ta, tb, tt = torch.tensor(ga), torch.tensor(gb), torch.tensor(table)

    def rfn(cfgs, params=None):
        c = table[np.searchsorted(ga, cfgs[:, 0]),
                  np.searchsorted(gb, cfgs[:, 1])]
        return c if params is None else c * params[0]

    def tfn(cfgs, params=None):
        c = tt[torch.searchsorted(ta, cfgs[:, 0].contiguous()),
               torch.searchsorted(tb, cfgs[:, 1].contiguous())]
        return c if params is None else c * params[0]
    return rfn, tfn


def _surface_fns(models, impl, objective, rcl, tcl):
    rmodels, tmodels = models
    r = ROperatorCosting(models=rmodels, cluster=rcl, objective=objective)
    t = TOperatorCosting(models=tmodels, cluster=tcl, objective=objective)
    return (r._grid_fn(impl, r_backend("numpy")),
            t._grid_fn(impl, t_backend("torch")))


def _model_pairs():
    return {"sim": (rcm.simulator_cost_models(), tcm.simulator_cost_models()),
            "paper": (rcm.paper_models(), tcm.paper_models()),
            "simreg": (rcm.simulator_models(), tcm.simulator_models())}


def _same(a, b):
    assert a[0] == b[0]
    assert a[1] == b[1] or (math.isinf(a[1]) and math.isinf(b[1]))


def test_grid_helpers_match():
    rng = np.random.default_rng(0)
    for ragged in (False, True):
        rcl, tcl = _clusters(rng, ragged)
        np.testing.assert_array_equal(r_enum(rcl, 3, 77), t_enum(tcl, 3, 77))
        for starts in (None, [(2, 5), (10_000, 0)]):
            np.testing.assert_array_equal(r_starts(rcl, starts, 24, 7),
                                          t_starts(tcl, starts, 24, 7))


@pytest.mark.parametrize("ragged", [False, True])
def test_table_searches_bit_identical(ragged):
    rng = np.random.default_rng(11 + ragged)
    rb, tb = r_backend("numpy"), t_backend("torch")
    assert tb.exact and tb.name == "torch"
    for trial in range(4):
        rcl, tcl = _clusters(rng, ragged)
        shape = tuple(len(d.grid()) for d in rcl.dims)
        # integer costs make ties common; a quarter of the cells are OOM
        table = rng.integers(0, 40, size=shape).astype(np.float64)
        table[rng.random(shape) < 0.25] = np.inf
        if trial == 3:
            table[:] = np.inf                      # all infeasible
        rfn, tfn = _table_fns(rcl, tcl, table)
        pm = rng.uniform(0.5, 2.0, (5, 1))
        rs, ts = RStats(), TStats()
        _same(rb.argmin_grid(rfn, rcl, rs, chunk_size=37),
              tb.argmin_grid(tfn, tcl, ts, chunk_size=37))
        for a, b in zip(rb.argmin_grid_many(rfn, rcl, pm, stats=rs,
                                            chunk_size=64),
                        tb.argmin_grid_many(tfn, tcl, pm, stats=ts,
                                            chunk_size=64)):
            _same(a, b)
        _same(rb.hill_climb_ensemble(rfn, rcl, None, rs, n_random=9,
                                     seed=trial),
              tb.hill_climb_ensemble(tfn, tcl, None, ts, n_random=9,
                                     seed=trial))
        for a, b in zip(rb.hill_climb_ensemble_many(rfn, rcl, pm, stats=rs,
                                                    n_random=5, seed=1),
                        tb.hill_climb_ensemble_many(tfn, tcl, pm, stats=ts,
                                                    n_random=5, seed=1)):
            _same(a, b)
        assert rs.configs_explored == ts.configs_explored


@pytest.mark.parametrize("models", ["sim", "paper", "simreg"])
@pytest.mark.parametrize("objective", ["time", "money"])
def test_surface_searches_bit_identical(models, objective):
    rng = np.random.default_rng(5)
    rb, tb = r_backend("numpy"), t_backend("torch")
    pair = _model_pairs()[models]
    for ragged in (False, True):
        rcl, tcl = _clusters(rng, ragged)
        for impl in ("SMJ", "BHJ"):
            rfn, tfn = _surface_fns(pair, impl, objective, rcl, tcl)
            ss = rng.uniform(0.05, 30, 4)
            pm = np.stack([ss, ss + rng.uniform(0, 150, 4)], 1)
            rs, ts = RStats(), TStats()
            for p in pm:
                _same(rb.argmin_grid(rfn, rcl, rs, params=p),
                      tb.argmin_grid(tfn, tcl, ts, params=p))
                _same(rb.hill_climb_ensemble(rfn, rcl, None, rs, params=p,
                                             n_random=6, seed=2),
                      tb.hill_climb_ensemble(tfn, tcl, None, ts, params=p,
                                             n_random=6, seed=2))
            for a, b in zip(rb.argmin_grid_many(rfn, rcl, pm, stats=rs),
                            tb.argmin_grid_many(tfn, tcl, pm, stats=ts)):
                _same(a, b)
            for a, b in zip(
                    rb.hill_climb_ensemble_many(rfn, rcl, pm, stats=rs,
                                                n_random=6, seed=3),
                    tb.hill_climb_ensemble_many(tfn, tcl, pm, stats=ts,
                                                n_random=6, seed=3)):
                _same(a, b)
            assert rs.configs_explored == ts.configs_explored


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        t_backend("numpy")


# ---- the rest of tests/test_planning_backend.py, twinned ------------------ #
# The reference's ``jax`` lane is the CUDA backend's: here its wrappers on
# CPU tensors (``CudaPlanBackend(device="cpu")``, float32 like jax), on the
# card ``test_torch_cuda.py::test_float32_lane_on_kernels_matches_torch``;
# XLA program reuse is the backend's grid memo and the fn cache.

ARCHS = ("deepseek-67b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
         "zamba2-2.7b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _random_clusters(rng, na, nb, ragged):
    """The reference's ``_random_cluster`` in both packages (a ragged step
    dim and an explicit-values dim when ``ragged``)."""
    if ragged:
        step = int(rng.integers(2, 4))
        hi = 1 + step * (na - 1) + int(rng.integers(1, step))
        vals = tuple(sorted(rng.choice(np.arange(1, 64), size=nb,
                                       replace=False).tolist()))
        dims = [("a", 1, hi, step, ()), ("b", vals[0], vals[-1], 1, vals)]
    else:
        dims = [("a", 0, na - 1, 1, ()), ("b", 0, nb - 1, 1, ())]
    return (RCluster(dims=tuple(RDim(*d) for d in dims)),
            TCluster(dims=tuple(TDim(*d) for d in dims)))


def _random_table(rng, na, nb, oom_frac=0.15):
    """Integer costs below 2^20 (exact in float32) with OOM cells."""
    table = rng.integers(0, 1 << 20, size=(na, nb)).astype(np.float64)
    table[rng.random((na, nb)) < oom_frac] = np.inf
    return table


def _f32_fn(tcl, table):
    """The same table as a ``CostTable`` surface, which the CUDA
    backend's wrappers evaluate (params = [0.0], its offset)."""
    surface = tcm.Surface(tcm.CostTable.of(tcl, table))

    def fn(cfgs, params):
        return surface(cfgs, params)

    fn.surface = surface
    return fn


ZERO = np.zeros(1)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), na=st.integers(2, 12),
       nb=st.integers(2, 9), ragged=st.booleans())
def test_hypothesis_float32_lane_argmin_identical(seed, na, nb, ragged):
    rng = np.random.default_rng(seed)
    rcl, tcl = _random_clusters(rng, na, nb, ragged)
    table = _random_table(rng, na, nb)
    rfn, tfn = _table_fns(rcl, tcl, table)
    want = r_backend("numpy").argmin_grid(rfn, rcl)
    _same(want, t_backend("torch").argmin_grid(tfn, tcl))
    _same(want, CudaPlanBackend(device="cpu").argmin_grid(
        _f32_fn(tcl, table), tcl, params=ZERO))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), na=st.integers(3, 12),
       nb=st.integers(3, 9), ragged=st.booleans(),
       n_random=st.integers(0, 8))
def test_hypothesis_float32_lane_ensemble_identical(seed, na, nb, ragged,
                                                    n_random):
    """Same seed -> same starts -> the same steepest-descent trajectories
    on the reference's numpy backend, the port's float64 backend and the
    CUDA backend's plain version (first-min tie-break on neighbours)."""
    rng = np.random.default_rng(seed)
    rcl, tcl = _random_clusters(rng, na, nb, ragged)
    table = _random_table(rng, na, nb)
    rfn, tfn = _table_fns(rcl, tcl, table)
    want = r_backend("numpy").hill_climb_ensemble(rfn, rcl,
                                                  n_random=n_random,
                                                  seed=seed)
    _same(want, t_backend("torch").hill_climb_ensemble(
        tfn, tcl, n_random=n_random, seed=seed))
    _same(want, CudaPlanBackend(device="cpu").hill_climb_ensemble(
        _f32_fn(tcl, table), tcl, params=ZERO, n_random=n_random,
        seed=seed))


def test_ensemble_local_optimum_invariant():
    rng = np.random.default_rng(11)
    dims = [("a", 0, 20, 1, ()), ("b", 0, 10, 1, ())]
    rcl = RCluster(dims=tuple(RDim(*d) for d in dims))
    tcl = TCluster(dims=tuple(TDim(*d) for d in dims))
    table = rng.random((21, 11))
    rfn, tfn = _table_fns(rcl, tcl, table)
    want = r_backend("numpy").hill_climb_ensemble(rfn, rcl, n_random=8,
                                                  seed=3)
    res, cost = t_backend("torch").hill_climb_ensemble(tfn, tcl, n_random=8,
                                                       seed=3)
    _same(want, (res, cost))
    assert cost == table[res]
    for d, delta in ((0, 1), (0, -1), (1, 1), (1, -1)):
        n = list(res)
        n[d] += delta
        if 0 <= n[0] <= 20 and 0 <= n[1] <= 10:
            assert table[tuple(n)] >= cost


def test_ensemble_more_starts_never_worse():
    """The multi-start ensemble dominates the 2-corner climb (it contains
    those corners) and finds the optimum here, as the reference's."""
    rng = np.random.default_rng(5)
    pts = [(int(rng.integers(1, 31)), int(rng.integers(1, 11)),
            float(rng.random() * 10)) for _ in range(3)]

    def rfn(cfgs, params=None):
        a = np.asarray(cfgs, dtype=np.float64)
        return np.min(np.stack([(a[:, 0] - x) ** 2 + (a[:, 1] - y) ** 2 + z
                                for x, y, z in pts]), axis=0)

    def tfn(cfgs, params=None):
        a = torch.as_tensor(cfgs).to(torch.float64)
        return torch.stack([(a[:, 0] - x) ** 2 + (a[:, 1] - y) ** 2 + z
                            for x, y, z in pts]).min(0).values

    out = {}
    for name, be, fn, cl in (
            ("ref", r_backend("numpy"), rfn, rcm_paper(30, 10)),
            ("port", t_backend("torch"), tfn, tcm_paper(30, 10))):
        out[name] = (be.hill_climb_ensemble(fn, cl),
                     be.hill_climb_ensemble(fn, cl, n_random=24, seed=0),
                     be.argmin_grid(fn, cl))
    assert out["port"] == out["ref"]
    (_, c2), (_, c_ens), (_, c_opt) = out["port"]
    assert c_ens <= c2 and c_ens == c_opt


def test_start_indices_dedupe_and_snap():
    dims = [("p2", 1, 16, 1, (1, 2, 4, 8, 16)), ("lin", 1, 4, 1, ())]
    rcl = RCluster(dims=tuple(RDim(*d) for d in dims))
    tcl = TCluster(dims=tuple(TDim(*d) for d in dims))
    for starts, n, seed in (([(5, 3), (4, 3)], 0, 0), (None, 6, 0)):
        want = r_starts(rcl, starts, n, seed)
        got = t_starts(tcl, starts, n, seed)
        np.testing.assert_array_equal(got, want)
    assert len(t_starts(tcl, [(5, 3), (4, 3)], 0, 0)) == 1   # both snap to 4
    idx = t_starts(tcl, None, 6, seed=0)
    assert len(idx) <= 8
    assert tuple(idx[0]) == (0, 0) and tuple(idx[1]) == (4, 3)


def test_params_are_threaded():
    """params reach the cost fn on both entry points (budget masking)."""
    def rfn(cfgs, params):
        a = np.asarray(cfgs, dtype=np.float64)
        return np.where(a[:, 0] > params[0], np.inf, 1000.0 / a[:, 0]
                        + a[:, 1])

    def tfn(cfgs, params):
        a = torch.as_tensor(cfgs).to(torch.float64)
        cost = a.new_full((), 1000.0) / a[:, 0] + a[:, 1]
        return torch.where(a[:, 0] > params[0], math.inf, cost)

    out = {}
    for name, be, fn, cl in (
            ("ref", r_backend("numpy"), rfn, rcm_paper(10, 4)),
            ("port", t_backend("torch"), tfn, tcm_paper(10, 4))):
        out[name] = (be.argmin_grid(fn, cl, params=np.asarray([10.0])),
                     be.argmin_grid(fn, cl, params=np.asarray([4.0])),
                     be.hill_climb_ensemble(fn, cl,
                                            params=np.asarray([4.0])))
    assert out["port"] == out["ref"]
    (r1, _), (r2, _), (r3, _) = out["port"]
    assert r1[0] == 10 and r2[0] == 4 and r3[0] <= 4


def rcm_paper(nc, cs):
    from repro.core.cluster import paper_cluster
    return paper_cluster(nc, cs)


def tcm_paper(nc, cs):
    from repro_torch.core.cluster import paper_cluster
    return paper_cluster(nc, cs)


# ----------------- roofline: terms_grid == terms_for ----------------------- #

def _tpu(name):
    """(configs module, roofline module, sharding planner module) of
    ``name``'s package."""
    if name == "ref":
        from repro import configs
        from repro.core import roofline, sharding_planner
    else:
        from repro_torch import configs
        from repro_torch.core import roofline, sharding_planner
    return configs, roofline, sharding_planner


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape_name", SHAPES)
def test_terms_grid_bit_identical_to_scalar(arch, shape_name):
    """The port's float64 grid roofline is bit-identical to its scalar
    ``terms_for`` over the full TPU grid, for every plan choice, and to
    the reference's grid."""
    rc, rr, rsp = _tpu("ref")
    tc, tr, tsp = _tpu("port")
    cfg, shape = tc.get_config(arch), tc.get_shape(shape_name)
    rcfg, rshape = rc.get_config(arch), rc.get_shape(shape_name)
    cfgs = t_enum(tsp.TpuCluster().dims(shape))
    for choice in tsp.PLAN_CHOICES[shape.kind]:
        if cfg.family == "ssm" and choice.get("schedule") == "causal_skip":
            continue
        g = tr.terms_grid(cfg, shape, torch.as_tensor(cfgs), xp=torch,
                          **choice)
        want = rr.terms_grid(rcfg, rshape, cfgs, **choice)
        for f in ("compute_s", "memory_s", "collective_s", "hbm_per_chip",
                  "step_s"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          getattr(want, f))
        for i, row in enumerate(cfgs):
            t = tr.terms_for(cfg, shape, tr.Resources(*(int(v) for v in row)),
                             **choice)
            assert float(g.compute_s[i]) == t.compute_s
            assert float(g.memory_s[i]) == t.memory_s
            assert float(g.collective_s[i]) == t.collective_s
            assert float(g.hbm_per_chip[i]) == t.hbm_per_chip
            assert bool(g.feasible[i]) == t.feasible
            assert float(g.step_s[i]) == t.step_s


def test_terms_grid_float32_within_fp_tolerance():
    """The float32 grid (the CUDA backend's plain surface dtype) within
    the reference's jax tolerance of the float64 grid."""
    tc, tr, tsp = _tpu("port")
    for arch, shape_name in (("deepseek-67b", "train_4k"),
                             ("qwen3-moe-30b-a3b", "decode_32k"),
                             ("zamba2-2.7b", "prefill_32k")):
        cfg, shape = tc.get_config(arch), tc.get_shape(shape_name)
        cfgs = torch.as_tensor(t_enum(tsp.TpuCluster().dims(shape)))
        choice = tsp.PLAN_CHOICES[shape.kind][0]
        g64 = tr.terms_grid(cfg, shape, cfgs, xp=torch, **choice)
        g32 = tr.terms_grid(cfg, shape, cfgs, xp=torch,
                            dtype=torch.float32, **choice)
        assert g32.step_s.dtype == torch.float32
        np.testing.assert_allclose(g32.step_s.numpy(), g64.step_s.numpy(),
                                   rtol=5e-5)
        np.testing.assert_allclose(g32.hbm_per_chip.numpy(),
                                   g64.hbm_per_chip.numpy(), rtol=5e-5)


# ------------- sharding planner: vectorized == scalar path ----------------- #

def _scalar_joint(tsp, planner, cfg, shape):
    """The pre-backend scalar search path (hill_climb_multi over scalar
    terms_for, brute-force fallback), the reference's oracle."""
    from repro_torch.core.hillclimb import brute_force, hill_climb_multi
    dims = planner.cluster.dims(shape)
    best = None
    for choice in tsp.PLAN_CHOICES[shape.kind]:
        if cfg.family == "ssm" and choice.get("schedule") == "causal_skip":
            continue
        fn = planner._cost_fn(cfg, shape, choice, None)
        res, cost = hill_climb_multi(fn, dims)
        if not math.isfinite(cost):
            res, cost = brute_force(fn, dims)
        if res is None or not math.isfinite(cost):
            continue
        if best is None or cost < best[0]:
            best = (cost, tuple(res), choice)
    return best


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape_name", SHAPES)
def test_vectorized_joint_matches_scalar_path(arch, shape_name):
    rc, _, rsp = _tpu("ref")
    tc, _, tsp = _tpu("port")
    cfg, shape = tc.get_config(arch), tc.get_shape(shape_name)
    planner = tsp.ShardingPlanner(backend="torch")
    d = planner.joint(cfg, shape)
    ref = _scalar_joint(tsp, planner, cfg, shape)
    assert ref is not None
    cost, res, choice = ref
    assert d.resources.as_tuple() == res
    assert d.plan_choice == choice
    assert d.objective_value == cost
    rd = rsp.ShardingPlanner().joint(rc.get_config(arch),
                                     rc.get_shape(shape_name))
    assert (rd.resources.as_tuple(), rd.plan_choice, rd.objective_value) \
        == (res, choice, cost)


def test_float32_lane_joint_matches_numpy_joint():
    rc, _, rsp = _tpu("ref")
    tc, _, tsp = _tpu("port")
    for arch, shape_name in (("deepseek-67b", "train_4k"),
                             ("smollm-360m", "train_4k"),
                             ("qwen3-moe-30b-a3b", "decode_32k")):
        dn = rsp.ShardingPlanner(backend="numpy").joint(
            rc.get_config(arch), rc.get_shape(shape_name))
        dj = tsp.ShardingPlanner(backend=CudaPlanBackend(device="cpu")).joint(
            tc.get_config(arch), tc.get_shape(shape_name))
        assert dj.resources.as_tuple() == dn.resources.as_tuple()
        assert dj.plan_choice == dn.plan_choice
        # both objective values commit through the scalar float64 path
        assert dj.objective_value == dn.objective_value


def test_ensemble_planner_never_worse_than_hillclimb():
    rc, _, rsp = _tpu("ref")
    tc, _, tsp = _tpu("port")
    out = {}
    for name, sp, c in (("ref", rsp, rc), ("port", tsp, tc)):
        cfg, shape = c.get_config("deepseek-67b"), c.get_shape("train_4k")
        kw = {} if name == "ref" else {"backend": "torch"}
        out[name] = [sp.ShardingPlanner(resource_planning=rp, **kw).joint(
            cfg, shape).objective_value
            for rp in ("hillclimb", "ensemble", "brute")]
    assert out["port"] == out["ref"]
    hc, en, bf = out["port"]
    assert en <= hc + 1e-12 and bf <= en + 1e-12


# --------------- DB domain: the float32 lane through OperatorCosting ------- #

@pytest.mark.parametrize("objective", ["time", "money"])
def test_operator_costing_float32_lane_matches_numpy(objective):
    for ss, ls in ((0.5, 74.0), (2.0, 10.0), (6.0, 200.0)):
        c_np = ROperatorCosting(models=rcm.simulator_cost_models(),
                                cluster=rcm_paper(100, 10),
                                objective=objective,
                                resource_planning="batched")
        c_32 = TOperatorCosting(models=tcm.simulator_cost_models(),
                                cluster=tcm_paper(100, 10),
                                objective=objective,
                                resource_planning="batched",
                                backend=CudaPlanBackend(device="cpu"))
        r_np, cost_np = c_np.plan_resources("SMJ", ss, ls)
        r_32, cost_32 = c_32.plan_resources("SMJ", ss, ls)
        assert r_32 == r_np
        # winner re-costed through the scalar float64 path on both ends
        assert cost_32 == pytest.approx(cost_np, rel=1e-12)


def test_operator_costing_reuses_one_surface_and_grid():
    """ss/ls travel as params: one (impl, objective) fn object serves
    operators with other data sizes (the reference's one jit program),
    and the CUDA backend decodes the grid once (its grid memo)."""
    be = CudaPlanBackend(device="cpu")
    c = TOperatorCosting(models=tcm.simulator_cost_models(),
                         cluster=tcm_paper(50, 10),
                         resource_planning="batched", backend=be)
    c.plan_resources("SMJ", 2.0, 74.0)
    fn1 = c._grid_fn_cache.get(("SMJ", "time", "cuda"))
    assert fn1 is not None and len(be._grids) == 1
    c.begin_query()
    c.plan_resources("SMJ", 5.0, 200.0)
    assert c._grid_fn_cache.get(("SMJ", "time", "cuda")) is fn1
    assert len(be._grids) == 1


def test_torch_lane_matches_numpy():
    """The backend-matrix lane test on the port's lane: exhaustive scan
    and ensemble climb of the ``"torch"`` backend equal numpy's."""
    rng = np.random.default_rng(7)
    for ragged in (False, True):
        rcl, tcl = _random_clusters(rng, 9, 7, ragged)
        table = _random_table(rng, 9, 7)
        rfn, tfn = _table_fns(rcl, tcl, table)
        _same(r_backend("numpy").argmin_grid(rfn, rcl),
              t_backend("torch").argmin_grid(tfn, tcl))
        e_np = r_backend("numpy").hill_climb_ensemble(rfn, rcl, n_random=6,
                                                      seed=3)
        e_t = t_backend("torch").hill_climb_ensemble(tfn, tcl, n_random=6,
                                                     seed=3)
        assert e_t[0] == e_np[0] and e_t[1] == e_np[1]


def test_operator_costing_ensemble_never_worse_than_2start():
    out = {}
    for name, oc, cm_, cl in (
            ("ref", ROperatorCosting, rcm, rcm_paper(100, 10)),
            ("port", TOperatorCosting, tcm, tcm_paper(100, 10))):
        kw = dict(models=cm_.simulator_cost_models(), cluster=cl)
        if name == "port":
            kw["backend"] = "torch"
        costs = []
        for ss, ls in ((0.5, 74.0), (2.0, 74.0), (6.0, 200.0)):
            c2 = oc(resource_planning="hillclimb_batched", **kw)
            ce = oc(resource_planning="ensemble", **kw)
            costs.append((c2.plan_resources("SMJ", ss, ls),
                          ce.plan_resources("SMJ", ss, ls)))
        out[name] = costs
    assert out["port"] == out["ref"]
    for (_, cost2), (_, cost_e) in out["port"]:
        assert cost_e <= cost2 + 1e-12
