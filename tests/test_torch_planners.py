"""The planner twins (``tests/test_planners.py``): Selinger's System-R DP
against the exhaustive left-deep oracle, and FastRandomized's validity,
on the reference (``"numpy"``) and on the port (``"torch"``) from the
same schemas and seeds, with the same plans required."""
import math

import pytest
from hypothesis import given, settings, strategies as st

from fixtures_torch_planning import PORT, both, tree_sig


def _costing(p, **kw):
    return p.OperatorCosting(models=p.simulator_cost_models(),
                             cluster=p.paper_cluster(40, 10),
                             backend=p.backend, **kw)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 500), n=st.integers(2, 5))
def test_selinger_matches_exhaustive_oracle(seed, n):
    """The DP equals brute-force enumeration of all left-deep orders under
    the same resource-aware costing, and both equal the reference's."""
    def run(p):
        schema = p.random_schema(6, seed=seed)
        q = p.random_query(schema, n, seed=seed)
        return (q, p.selinger_plan(schema, q, _costing(p)),
                p.exhaustive_left_deep(schema, q, _costing(p)))
    ref, port = both(run)
    q, p1, p2 = port
    assert (p1 is None) == (p2 is None)
    assert (tree_sig(p1), tree_sig(p2)) == (tree_sig(ref[1]),
                                            tree_sig(ref[2]))
    if p1 is not None:
        assert p1.total_cost == pytest.approx(p2.total_cost, rel=1e-9)
        assert p1.tables == frozenset(q)


def test_selinger_tpch_all_runs():
    def run(p):
        schema = p.tpch_schema(100)
        return p.selinger_plan(schema, list(schema.relations), _costing(p))
    ref, plan = both(run)
    assert tree_sig(plan) == tree_sig(ref)
    assert len(plan.tables) == 8 and math.isfinite(plan.total_cost)

    def walk(n):
        if n.is_leaf:
            return
        assert n.resources is not None and n.impl in ("SMJ", "BHJ")
        walk(n.left)
        walk(n.right)
    walk(plan)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 200))
def test_fast_randomized_valid_and_not_worse_than_random(seed):
    def run(p):
        schema = p.random_schema(8, seed=seed)
        q = p.random_query(schema, 5, seed=seed)
        best, archive = p.fast_randomized_plan(schema, q, _costing(p),
                                               iterations=10, seed=seed)
        return q, best, archive
    ref, port = both(run)
    q, best, archive = port
    assert tree_sig(best) == tree_sig(ref[1])
    assert [tree_sig(a) for a in archive.plans] == \
        [tree_sig(a) for a in ref[2].plans]
    if best is None:
        return
    assert best.tables == frozenset(q)
    # the archive is mutually non-dominated (a Pareto set)
    for a in archive.plans:
        for b in archive.plans:
            if a is not b:
                assert not PORT.dominates(PORT.cost_vec(a),
                                          PORT.cost_vec(b), 0.0)


def test_fast_randomized_near_selinger_on_tpch():
    def run(p):
        schema = p.tpch_schema(100)
        q = ("customer", "orders", "lineitem")
        sel = p.selinger_plan(schema, q, _costing(p))
        best, _ = p.fast_randomized_plan(schema, q, _costing(p),
                                         iterations=10, population=6,
                                         seed=1)
        return tree_sig(sel), tree_sig(best), sel.total_cost, \
            best.total_cost
    ref, port = both(run)
    assert port == ref
    # within 2x of the DP's optimum on a 2-join query
    assert port[3] <= 2.0 * port[2]


def test_pareto_archive_eps_dominance():
    def run(p):
        a = p.ParetoArchive(eps=0.1)

        def plan(t, m):
            return p.PlanNode(tables=frozenset({"x"}), rows=1, row_bytes=1,
                              total_cost=t, total_money=m)
        out = [a.offer(plan(10, 10)),
               a.offer(plan(10.5, 10.5)),    # within (1+eps) of existing
               a.offer(plan(5, 20)),         # new tradeoff
               a.offer(plan(1, 1))]          # dominates all
        return out, a.best(0).total_cost, len(a.plans)
    ref, port = both(run)
    assert port == ref == ([True, False, True, True], 1, port[2])
