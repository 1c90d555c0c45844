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
