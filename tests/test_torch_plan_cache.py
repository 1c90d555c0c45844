"""The resource-plan cache twins (``tests/test_plan_cache.py``, paper
§VI-B3): exact, nearest-neighbour and weighted-average lookups and
``snap_to_grid`` on the reference and on the port, with the same
answers, stored entries and counters required."""
import pytest
from hypothesis import given, settings, strategies as st

from fixtures_torch_planning import both, cache_state


def test_exact_mode():
    def run(p):
        c = p.ResourcePlanCache("exact")
        c.insert("SMJ", "join", 1.0, (10, 4))
        return [c.lookup("SMJ", "join", 1.0), c.lookup("SMJ", "join", 1.01),
                c.lookup("BHJ", "join", 1.0)]            # model-id keyed
    ref, port = both(run)
    assert port == ref == [(10, 4), None, None]


def test_nearest_neighbor_threshold():
    def run(p):
        c = p.ResourcePlanCache("nearest_neighbor", threshold=0.1)
        c.insert("SMJ", "join", 1.0, (10, 4))
        out = [c.lookup("SMJ", "join", 1.05), c.lookup("SMJ", "join", 1.2)]
        c.insert("SMJ", "join", 1.08, (20, 8))
        return out + [c.lookup("SMJ", "join", 1.07)]   # nearest wins
    ref, port = both(run)
    assert port == ref == [(10, 4), None, (20, 8)]


def test_weighted_average_snaps_to_grid():
    def run(p):
        c = p.ResourcePlanCache("weighted_average", threshold=1.0)
        c.insert("SMJ", "join", 1.0, (10, 4))
        c.insert("SMJ", "join", 2.0, (30, 8))
        return c.lookup("SMJ", "join", 1.5, p.paper_cluster(100, 10))
    ref, port = both(run)
    assert port == ref
    assert 10 <= port[0] <= 30 and 4 <= port[1] <= 8


def test_exact_match_preferred_over_interpolation():
    def run(p):
        c = p.ResourcePlanCache("weighted_average", threshold=5.0)
        c.insert("SMJ", "join", 1.0, (10, 4))
        c.insert("SMJ", "join", 1.5, (50, 9))
        return c.lookup("SMJ", "join", 1.0)
    ref, port = both(run)
    assert port == ref == (10, 4)


def test_stats_counting():
    def run(p):
        s = p.PlanningStats()
        c = p.ResourcePlanCache("exact")
        c.insert("SMJ", "join", 1.0, (1, 1))
        c.lookup("SMJ", "join", 1.0, stats=s)
        c.lookup("SMJ", "join", 9.9, stats=s)
        return vars(s), cache_state(c)
    ref, port = both(run)
    assert port == ref
    assert port[0]["cache_hits"] == 1 and port[0]["cache_misses"] == 1


def test_insert_overwrites_same_key():
    def run(p):
        c = p.ResourcePlanCache("exact")
        c.insert("SMJ", "join", 1.0, (1, 1))
        c.insert("SMJ", "join", 1.0, (2, 2))
        return c.lookup("SMJ", "join", 1.0), len(c)
    ref, port = both(run)
    assert port == ref == ((2, 2), 1)


@settings(max_examples=40, deadline=None)
@given(keys=st.lists(st.floats(0.1, 100.0), min_size=1, max_size=20,
                     unique=True),
       probe=st.floats(0.1, 100.0), thr=st.floats(0.01, 5.0))
def test_hypothesis_nn_within_threshold(keys, probe, thr):
    """NN lookups never return an entry farther than the threshold, always
    return one when an entry is within it, and return the reference's."""
    def run(p):
        c = p.ResourcePlanCache("nearest_neighbor", threshold=thr)
        for i, k in enumerate(keys):
            c.insert("m", "join", k, (i + 1, 1))
        return c.lookup("m", "join", probe)
    ref, got = both(run)
    assert got == ref
    dists = [abs(k - probe) for k in keys]
    if got is not None:
        i = got[0] - 1
        assert abs(keys[i] - probe) <= thr + 1e-9
        assert abs(keys[i] - probe) == pytest.approx(min(dists), abs=1e-9)
    else:
        assert min(dists) > thr - 1e-12


def test_snap_to_grid():
    def run(p):
        cluster = p.paper_cluster(100, 10)
        return (p.plan_cache.snap_to_grid((150, 12), cluster),
                p.plan_cache.snap_to_grid((0, 0), cluster))
    ref, port = both(run)
    assert port == ref == ((100, 10), (1, 1))


def test_snap_to_grid_clamps_stepped_dims_inside_range():
    """lo + round((v - lo) / step) * step could overshoot hi when
    (hi - lo) is not a multiple of step; both snap inside the grid."""
    def run(p):
        cluster = p.ClusterConditions(dims=(
            p.ResourceDim("a", 1, 9, step=3),              # grid 1, 4, 7
            p.ResourceDim("b", 1, 10, step=4),             # grid 1, 5, 9
        ))
        out = []
        for cfg in ((9, 11), (8, 8), (100, 100), (6, 7), (0, 0)):
            got = p.plan_cache.snap_to_grid(cfg, cluster)
            assert cluster.neighbors_ok(got), f"{cfg} snapped to {got}"
            out.append(got)
        return out
    ref, port = both(run)
    assert port == ref and port[0] == (7, 9)
