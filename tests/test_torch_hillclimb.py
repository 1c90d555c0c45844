"""The scalar hill-climb twins (``tests/test_hillclimb.py``): Algorithm 1
(``core/hillclimb.py``, which ``core/plans.py`` reaches for the
``hillclimb`` mode) on the reference and on the port from the same cost
functions, with the same (config, cost) and the same explored-config
counts required, and the reference's invariants kept on the port."""
import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from fixtures_torch_planning import both


def test_separable_convex_reaches_optimum():
    opt = (37, 6)

    def run(p):
        fn = lambda r: (r[0] - opt[0]) ** 2 + 3 * (r[1] - opt[1]) ** 2  # noqa
        s = p.PlanningStats()
        return p.hill_climb(fn, p.paper_cluster(50, 10), stats=s), \
            s.configs_explored
    ref, port = both(run)
    assert port == ref and port[0] == (opt, 0)


@settings(max_examples=40, deadline=None)
@given(a=st.integers(1, 100), b=st.integers(1, 10),
       wa=st.floats(0.1, 5.0), wb=st.floats(0.1, 5.0))
def test_hypothesis_convex_equals_brute_force(a, b, wa, wb):
    """On separable convex costs the local optimum is global: the climb
    matches brute force while exploring fewer configs, in both packages
    alike."""
    def run(p):
        cluster = p.paper_cluster(100, 10)
        fn = lambda r: wa * (r[0] - a) ** 2 + wb * (r[1] - b) ** 2  # noqa
        s1, s2 = p.PlanningStats(), p.PlanningStats()
        return (p.hill_climb(fn, cluster, stats=s1),
                p.brute_force(fn, cluster, stats=s2),
                s1.configs_explored, s2.configs_explored)
    ref, port = both(run)
    assert port == ref
    (_, c_hc), (_, c_bf), n_hc, n_bf = port
    assert c_hc == pytest.approx(c_bf)
    assert n_hc < n_bf


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_hypothesis_local_optimum_invariant(seed):
    grid = np.random.default_rng(seed).random((21, 11))
    fn = lambda r: float(grid[r[0], r[1]])  # noqa: E731

    def run(p):
        cluster = p.ClusterConditions(dims=(p.ResourceDim("a", 0, 20),
                                            p.ResourceDim("b", 0, 10)))
        return p.hill_climb(fn, cluster)
    ref, port = both(run)
    assert port == ref
    res, cost = port
    for d, delta in ((0, 1), (0, -1), (1, 1), (1, -1)):
        n = list(res)
        n[d] += delta
        if 0 <= n[0] <= 20 and 0 <= n[1] <= 10:
            assert fn(tuple(n)) >= cost


def test_paper_4x_reduction_scale():
    """Fig 13: the climb explores ~2-4x fewer configs than brute force on
    the paper's 100x10 grid with a 1/nc-shaped cost."""
    def run(p):
        cluster = p.paper_cluster(100, 10)
        fn = lambda r: 100.0 / r[0] + 5.0 * r[1] + 50.0 / r[1]  # noqa
        s1, s2 = p.PlanningStats(), p.PlanningStats()
        p.hill_climb(fn, cluster, stats=s1)
        p.brute_force(fn, cluster, stats=s2)
        return s1.configs_explored, s2.configs_explored
    ref, port = both(run)
    assert port == ref
    assert port[1] / port[0] > 1.8


def test_infeasible_plateau_returns_start():
    def run(p):
        return p.hill_climb(lambda r: math.inf, p.paper_cluster(5, 5))
    ref, port = both(run)
    assert port[0] == ref[0] and math.isinf(port[1])


def _explicit(p):
    return p.ClusterConditions(dims=(
        p.ResourceDim("p2", 1, 16, values=(1, 2, 4, 8, 16)),
        p.ResourceDim("lin", 1, 4)))


def test_explicit_grid_dims():
    fn = lambda r: abs(r[0] - 8) + abs(r[1] - 2)  # noqa: E731
    ref, port = both(lambda p: p.hill_climb(fn, _explicit(p)))
    assert port == ref == ((8, 2), 0)


def test_off_grid_start_is_snapped():
    """A start off an explicit-values grid is snapped first (5 is not on
    the grid)."""
    fn = lambda r: abs(r[0] - 8) + abs(r[1] - 2)  # noqa: E731
    ref, port = both(lambda p: p.hill_climb(fn, _explicit(p), start=(5, 3)))
    assert port == ref == ((8, 2), 0)


def test_off_grid_start_on_stepped_dim():
    fn = lambda r: abs(r[0] - 4) + abs(r[1] - 2)  # noqa: E731

    def run(p):
        dims = p.ClusterConditions(dims=(
            p.ResourceDim("a", 1, 9, step=3),              # grid 1, 4, 7
            p.ResourceDim("b", 1, 4)))
        return p.hill_climb(fn, dims, start=(9, 2))   # snaps inside
    ref, port = both(run)
    assert port == ref == ((4, 2), 0)


def test_multi_start_beats_single_on_two_basins():
    fn = lambda r: min((r[0] - 3) ** 2 + (r[1] - 2) ** 2 + 5,   # noqa: E731
                       (r[0] - 19) ** 2 + (r[1] - 7) ** 2)

    def run(p):
        cluster = p.paper_cluster(20, 8)
        return p.hill_climb(fn, cluster), p.hill_climb_multi(fn, cluster)
    ref, port = both(run)
    assert port == ref
    (_, single), (res, multi) = port
    assert multi <= single and multi == 0 and res == (19, 7)
