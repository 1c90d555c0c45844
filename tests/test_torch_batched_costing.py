"""The batched-costing twins (``tests/test_batched_costing.py``): scalar
against vectorized costing, memoization, and the planner regressions,
each on the reference (``"numpy"``) and on the port (``"torch"``) from
the same inputs, with the same results required.

``cost_grid`` must equal the scalar ``cost`` bit for bit, infinities
included, for all three model families and both operators: the port's
float64 surfaces divide a Python number by a tensor through a 0-d tensor
(``cost_model._rdiv``), as IEEE division, where PyTorch's own
``number / tensor`` is a reciprocal times the number and misses the
quotient by an ulp in about a fifth of the points.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from fixtures_torch_planning import PORT, REF, both, cache_state, same_cost


def _f64(p, x):
    if p is PORT:
        return torch.as_tensor(x).to(torch.float64)
    return np.asarray(x, dtype=np.float64)


def _lookup(p, grid):
    """A batch fn that looks configurations up in ``grid`` by value."""
    if p is PORT:
        t = torch.as_tensor(grid)
        return lambda cfgs: t[cfgs[:, 0], cfgs[:, 1]]
    return lambda cfgs: grid[cfgs[:, 0], cfgs[:, 1]]


# --------------------- batched brute force == scalar ----------------------- #

def _bruteforce_pair(p, seed, na, nb):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 50, size=(na, nb)).astype(np.float64)
    grid[rng.random((na, nb)) < 0.1] = np.inf         # infeasible patches
    cluster = p.ClusterConditions(dims=(p.ResourceDim("a", 0, na - 1),
                                        p.ResourceDim("b", 0, nb - 1)))
    fn = lambda r: float(grid[r[0], r[1]])            # noqa: E731
    s1, s2 = p.PlanningStats(), p.PlanningStats()
    scalar = p.brute_force(fn, cluster, s1)
    batched = p.brute_force(fn, cluster, s2, batch_cost_fn=_lookup(p, grid),
                            backend=p.backend)
    return scalar, batched, s1.configs_explored, s2.configs_explored


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), na=st.integers(1, 23),
       nb=st.integers(1, 17))
def test_hypothesis_batched_bruteforce_bit_identical(seed, na, nb):
    """Batched brute_force returns the scalar loop's argmin (config and
    cost), ties and infinities included, in both packages."""
    ref, port = both(_bruteforce_pair, seed, na, nb)
    (r_s, c_s), (r_b, c_b), n1, n2 = port
    assert r_b == r_s and same_cost(c_b, c_s)
    assert n1 == n2 == na * nb
    assert port[1][0] == ref[1][0] and same_cost(port[1][1], ref[1][1])


def test_batched_bruteforce_chunked_matches_unchunked():
    def run(p):
        cluster = p.paper_cluster(100, 10)
        cfgs = p.enumerate_configs(cluster)
        costs = np.abs(cfgs[:, 0] - 63.0) + 7.0 * np.abs(cfgs[:, 1] - 4.0)
        lookup = {tuple(c): v for c, v in zip(cfgs.tolist(), costs)}

        def batch(a):
            return _f64(p, [lookup[tuple(r)] for r in a.tolist()])
        return [p.argmin_grid(batch, cluster, chunk_size=chunk,
                              backend=p.backend)
                for chunk in (7, 100, 1 << 20)]

    ref, port = both(run)
    assert port == ref == [((63, 4), 0.0)] * 3


def test_enumerate_configs_matches_all_configs_order():
    def run(p):
        cluster = p.ClusterConditions(dims=(
            p.ResourceDim("a", 1, 7, step=2),
            p.ResourceDim("b", 1, 16, values=(1, 2, 4, 8, 16)),
        ))
        got = [tuple(r) for r in p.enumerate_configs(cluster)]
        assert got == list(cluster.all_configs())
        return got
    ref, port = both(run)
    assert port == ref


# ------------------------ cost_grid == scalar cost ------------------------- #

MODELS = ("simulator_cost_models", "simulator_models", "paper_models")


@pytest.mark.parametrize("models", MODELS)
@pytest.mark.parametrize("impl", ["SMJ", "BHJ"])
def test_cost_grid_bit_identical_to_scalar(models, impl):
    """Every model layer's cost_grid equals its scalar cost bit for bit
    over the whole paper grid (inf for OOM included), and the reference's
    grid, at the reference's point and at the costing test's points."""
    r_model = getattr(REF.cost_model, models)()[impl]
    t_model = getattr(PORT.cost_model, models)()[impl]
    cfgs = PORT.enumerate_configs(PORT.paper_cluster(100, 10))
    for ss, ls in ((2.0, 74.0), (0.5, 74.0), (2.0, 10.0), (6.0, 200.0)):
        grid = t_model.cost_grid(ss, ls, torch.as_tensor(cfgs))
        assert grid.dtype == torch.float64
        want = r_model.cost_grid(ss, ls, cfgs)
        np.testing.assert_array_equal(grid.numpy(), want)
        for (nc, cs), g in zip(cfgs.tolist(), grid.tolist()):
            s = t_model.cost(ss, cs, nc, ls=ls)
            assert same_cost(g, s), \
                f"{impl} mismatch at nc={nc} cs={cs}: grid={g} scalar={s}"


def _costing_pair(p, objective, impl):
    cluster = p.paper_cluster(100, 10)
    kw = dict(models=p.simulator_cost_models(), cluster=cluster,
              objective=objective, backend=p.backend)
    out = []
    for ss, ls in ((0.5, 74.0), (2.0, 10.0), (6.0, 200.0)):
        scalar = p.OperatorCosting(resource_planning="brute", **kw)
        # disable the vectorized backend to force the per-config loop
        scalar._batch_fn = lambda *a: None
        batched = p.OperatorCosting(resource_planning="batched", **kw)
        out.append((scalar.plan_resources(impl, ss, ls),
                    batched.plan_resources(impl, ss, ls)))
    return out


@pytest.mark.parametrize("objective", ["time", "money"])
@pytest.mark.parametrize("impl", ["SMJ", "BHJ"])
def test_operator_costing_batched_equals_scalar(objective, impl):
    """plan_resources through the batched path returns the scalar loop's
    config and cost, and the reference's."""
    ref, port = both(_costing_pair, objective, impl)
    for scalar, batched in port:
        assert batched == scalar
    assert port == ref


def test_scaled_cluster_batched_plan_smoke():
    def run(p):
        costing = p.OperatorCosting(models=p.simulator_cost_models(),
                                    cluster=p.scaled_cluster(1000, 20),
                                    resource_planning="batched",
                                    backend=p.backend)
        return (costing.plan_resources("SMJ", 2.0, 74.0),
                costing.stats.configs_explored)
    ref, port = both(run)
    assert port == ref
    (res, cost), explored = port
    assert math.isfinite(cost) and 1 <= res[0] <= 1000 and 1 <= res[1] <= 20
    assert explored == 20_000


# ------------------------- multi-start hill climb -------------------------- #

def test_hill_climb_multi_batched_matches_scalar_on_convex():
    opt = (63, 4)

    def run(p):
        cluster = p.paper_cluster(100, 10)
        fn = lambda r: (r[0] - opt[0]) ** 2 + 3 * (r[1] - opt[1]) ** 2  # noqa

        def batch(a):
            a = _f64(p, a)
            return (a[:, 0] - opt[0]) ** 2.0 + 3 * (a[:, 1] - opt[1]) ** 2.0
        return (p.hill_climb_multi(fn, cluster),
                p.hill_climb_multi(fn, cluster, batch_cost_fn=batch,
                                   backend=p.backend))
    ref, port = both(run)
    assert port == ref
    (r1, c1), (r2, c2) = port
    assert r1 == r2 == opt and c1 == c2 == 0


def test_hill_climb_multi_batched_local_optimum_invariant():
    grid = np.random.default_rng(7).random((21, 11))

    def run(p):
        cluster = p.ClusterConditions(dims=(p.ResourceDim("a", 0, 20),
                                            p.ResourceDim("b", 0, 10)))
        return p.hill_climb_multi(lambda r: float(grid[r]), cluster,
                                  batch_cost_fn=_lookup(p, grid),
                                  backend=p.backend)
    ref, port = both(run)
    assert port == ref
    res, cost = port
    assert cost == grid[res]
    for d, delta in ((0, 1), (0, -1), (1, 1), (1, -1)):
        n = list(res)
        n[d] += delta
        if 0 <= n[0] <= 20 and 0 <= n[1] <= 10:
            assert grid[tuple(n)] >= cost


def test_hill_climb_multi_explicit_starts():
    def run(p):
        fn = lambda r: min((r[0] - 3) ** 2 + (r[1] - 2) ** 2 + 5,   # noqa
                           (r[0] - 19) ** 2 + (r[1] - 7) ** 2)
        return p.hill_climb_multi(fn, p.paper_cluster(20, 8))
    ref, port = both(run)
    assert port == ref == ((19, 7), 0)


# ------------------------- per-query memoization --------------------------- #

def _memo(p):
    costing = p.OperatorCosting(models=p.simulator_cost_models(),
                                cluster=p.paper_cluster(50, 10),
                                resource_planning="batched",
                                backend=p.backend)
    r1 = costing.plan_resources("SMJ", 2.0, 74.0)
    explored = [costing.stats.configs_explored]
    r2 = costing.plan_resources("SMJ", 2.0, 74.0)     # memo hit
    explored.append(costing.stats.configs_explored)
    costing.begin_query()
    costing.plan_resources("SMJ", 2.0, 74.0)          # searches again
    explored.append(costing.stats.configs_explored)
    return r1, r2, explored


def test_plan_memo_dedupes_within_query_and_resets():
    ref, port = both(_memo)
    assert port == ref
    r1, r2, (e1, e2, e3) = port
    assert r2 == r1 and e2 == e1 and e3 == 2 * e1


def test_plan_memo_keys_on_objective_and_ls():
    def run(p):
        kw = dict(models=p.simulator_cost_models(),
                  cluster=p.paper_cluster(50, 10), backend=p.backend)
        t = p.OperatorCosting(objective="time", **kw)
        m = p.OperatorCosting(objective="money", **kw)
        return (t.plan_resources("SMJ", 2.0, 74.0)[0],
                t.plan_resources("SMJ", 2.0, 300.0)[0],
                m.plan_resources("SMJ", 2.0, 74.0)[0])
    ref, port = both(run)
    assert port == ref
    r_time, r_ls, r_money = port
    assert r_money != r_time or r_ls != r_time


# --------------------- regression: cache pollution ------------------------- #

def _objectives_apart(p):
    cluster = p.paper_cluster(100, 10)
    cache = p.ResourcePlanCache("nearest_neighbor", threshold=0.5)
    kw = dict(models=p.simulator_cost_models(), cluster=cluster, cache=cache,
              backend=p.backend)
    t = p.OperatorCosting(objective="time", **kw)
    r_time = t.plan_resources("SMJ", 2.0, 74.0)
    m = p.OperatorCosting(objective="money", **kw)
    r_money = m.plan_resources("SMJ", 2.0, 74.0)
    fresh = p.OperatorCosting(objective="money", models=kw["models"],
                              cluster=cluster, backend=p.backend)
    return (r_time, r_money, fresh.plan_resources("SMJ", 2.0, 74.0),
            m.stats.cache_hits, cache_state(cache))


def test_shared_cache_keeps_objectives_apart():
    """One cache shared by a money and a time costing (as
    RAQO.for_budget shares it) never serves time-optimal configs to
    money lookups."""
    ref, port = both(_objectives_apart)
    assert port == ref
    _, r_money, r_fresh, hits, _ = port
    assert r_money[0] == r_fresh[0] and hits == 0


def _ls_apart(p):
    cluster = p.paper_cluster(100, 10)
    cache = p.ResourcePlanCache("nearest_neighbor", threshold=0.5)
    c = p.OperatorCosting(models=p.simulator_cost_models(), cluster=cluster,
                          cache=cache, backend=p.backend)
    c.plan_resources("SMJ", 2.0, 4.0)
    c.begin_query()
    r_big = c.plan_resources("SMJ", 2.0, 400.0)
    fresh = p.OperatorCosting(models=p.simulator_cost_models(),
                              cluster=cluster, backend=p.backend)
    return r_big, fresh.plan_resources("SMJ", 2.0, 400.0), cache_state(cache)


def test_shared_cache_keeps_ls_buckets_apart():
    ref, port = both(_ls_apart)
    assert port == ref
    assert port[0][0] == port[1][0]


# --------------- regression: for_budget stats attribution ------------------ #

def _for_budget(p):
    raqo = p.RAQO(schema=p.tpch_schema(100),
                  models=p.simulator_cost_models(), backend=p.backend)
    q3 = p.TPCH_QUERIES["Q3"]
    rich = raqo.for_budget(q3, budget=1e9)
    time_only = raqo.joint(q3, objective="time")
    money_only = raqo.joint(q3, objective="money")
    return [(j.plan.total_cost, j.stats.configs_explored)
            for j in (rich, time_only, money_only)]


def test_for_budget_attributes_stats_to_picked_plan():
    """With a generous budget for_budget picks the time-optimized plan, so
    the stats it reports are the time costing's."""
    ref, port = both(_for_budget)
    assert port == ref
    (rich_c, rich_n), (time_c, time_n), (_, money_n) = port
    assert rich_c == pytest.approx(time_c) and rich_n == time_n
    if money_n != time_n:
        assert rich_n != money_n


def test_hill_climb_multi_all_inf_returns_config():
    def run(p):
        return p.hill_climb_multi(lambda r: math.inf, p.paper_cluster(5, 5))
    ref, port = both(run)
    assert port[0] == ref[0] and port[0] is not None
    assert math.isinf(port[1]) and math.isinf(ref[1])


def test_hill_climb_multi_snaps_start_like_scalar():
    """Scalar and batched climbs snap the same off-grid start to the same
    configuration, in both packages."""
    def run(p):
        cluster = p.ClusterConditions(dims=(p.ResourceDim("a", 1, 5, step=2),
                                            p.ResourceDim("b", 1, 3)))
        fn = lambda r: 0.0 if r == (5, 1) else float(r[0])   # noqa: E731

        def batch(a):
            x = _f64(p, a)
            hit = (a[:, 0] == 5) & (a[:, 1] == 1)
            if p is PORT:
                return torch.where(hit, 0.0, x[:, 0])
            return np.where(hit, 0.0, x[:, 0])
        start = [(4, 1)]                    # off-grid on the step-2 dim
        return (p.hill_climb_multi(fn, cluster, starts=start)[0],
                p.hill_climb_multi(fn, cluster, starts=start,
                                   batch_cost_fn=batch,
                                   backend=p.backend)[0])
    ref, port = both(run)
    assert port[0] == port[1]
    assert port == ref
