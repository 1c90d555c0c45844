"""The port's slice as a whole against the JAX reference: RAQO lockstep
planning (Selinger and FastRandomized) through the session broker.

The same schema (handed over with ``schema_from_dict``), the same models
(``models_from_arrays``) and the same queries go through both packages;
plan signatures, per-query ``PlanningStats`` and the broker's
``counters_snapshot()`` must be identical:

* port ``"torch"`` (float64, exact) against reference ``"numpy"``;
* port ``CudaPlanBackend(device="cpu")`` — the CUDA backend's wrappers,
  taking their plain versions on CPU tensors — against reference
  ``"pallas"`` (float32, interpret mode); both re-commit every winner in
  float64, so plans agree to the last bit.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import cost_model as rcm
from repro.core import schema as rschema
from repro.core.cluster import paper_cluster as r_paper_cluster
from repro.core.plan_broker import PlanBroker as RBroker
from repro.core.plan_cache import ResourcePlanCache as RCache
from repro.core.raqo import RAQO as RRAQO
from repro_torch.core import cost_model as tcm
from repro_torch.core import schema as tschema
from repro_torch.core.cluster import paper_cluster as t_paper_cluster
from repro_torch.core.plan_broker import PlanBroker as TBroker
from repro_torch.core.plan_cache import ResourcePlanCache as TCache
from repro_torch.core.raqo import RAQO as TRAQO
from repro_torch.kernels.plan_scan import CudaPlanBackend


def _schema_pair(seed):
    ref = rschema.random_schema(8, seed=seed)
    port = tschema.schema_from_dict({
        "relations": [(r.name, r.rows, r.row_bytes)
                      for r in ref.relations.values()],
        "edges": [(e.a, e.b, e.selectivity) for e in ref.edges]})
    return ref, port


def _models_pair(kind):
    if kind == "sim":
        sim = rcm.HiveSimulator()
        return (rcm.simulator_cost_models(sim),
                tcm.models_from_arrays(dataclasses.asdict(sim)))
    ref = rcm.paper_models()
    return ref, tcm.models_from_arrays(
        {n: {"coef": m.coef, "floor": m.floor,
             "oom_frac": None if m.oom_fn is None else 0.7}
         for n, m in ref.items()})


def plan_signature(jp):
    ops = []

    def walk(n):
        if n.is_leaf:
            ops.append(tuple(sorted(n.tables)))
            return
        ops.append((n.impl, n.resources, n.op_cost, n.total_cost,
                    n.total_money))
        walk(n.left)
        walk(n.right)
    walk(jp.plan)
    return tuple(ops), jp.exec_time, jp.money


def _run(raqo_cls, broker, schema, models, cluster, queries, **kw):
    objective = kw.pop("objective")
    raqo = raqo_cls(schema, models=models, cluster=cluster, broker=broker,
                    backend=broker.backend, **kw)
    plans = raqo.plan_queries(queries, objective=objective)
    return ([plan_signature(p) for p in plans],
            [dataclasses.asdict(p.stats) for p in plans],
            broker.counters_snapshot())


CASES = [(planner, rp, objective)
         for planner in ("selinger", "fastrandomized")
         for rp in ("batched", "ensemble")
         for objective in ("time", "money")]


def _ids(case):
    return "-".join(case)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_torch_matches_numpy(case):
    planner, rp, objective = case
    rs, ts = _schema_pair(1)
    rm, tm = _models_pair("sim" if objective == "time" else "paper")
    queries = [rschema.random_query(rs, 4, seed=q) for q in range(3)]
    kw = dict(planner=planner, resource_planning=rp, objective=objective)
    ref = _run(RRAQO, RBroker("numpy"), rs, rm, r_paper_cluster(60, 8),
               queries, **kw)
    port = _run(TRAQO, TBroker("torch"), ts, tm, t_paper_cluster(60, 8),
                queries, **kw)
    assert port == ref


def test_torch_matches_numpy_with_cache():
    rs, ts = _schema_pair(2)
    rm, tm = _models_pair("sim")
    queries = [rschema.random_query(rs, 4, seed=q) for q in range(4)]
    rc, tc = RCache("exact"), TCache("exact")
    kw = dict(planner="selinger", resource_planning="batched",
              objective="time")
    ref = _run(RRAQO, RBroker("numpy"), rs, rm, r_paper_cluster(), queries,
               cache=rc, **kw)
    port = _run(TRAQO, TBroker("torch"), ts, tm, t_paper_cluster(), queries,
                cache=tc, **kw)
    assert port == ref
    assert tc.counters_snapshot() == rc.counters_snapshot()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cuda_backend_on_cpu_matches_pallas(case):
    planner, rp, objective = case
    rs, ts = _schema_pair(3)
    rm, tm = _models_pair("sim" if objective == "time" else "paper")
    queries = [rschema.random_query(rs, 4, seed=q) for q in range(2)]
    kw = dict(planner=planner, resource_planning=rp, objective=objective)
    ref = _run(RRAQO, RBroker("pallas"), rs, rm, r_paper_cluster(40, 8),
               queries, **kw)
    port = _run(TRAQO, TBroker(CudaPlanBackend(device="cpu")), ts, tm,
                t_paper_cluster(40, 8), queries, **kw)
    assert port == ref


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_schemas_and_queries_match(seed):
    ref, port = rschema.random_schema(10, seed=seed), \
        tschema.random_schema(10, seed=seed)
    assert {n: (r.rows, r.row_bytes) for n, r in ref.relations.items()} == \
        {n: (r.rows, r.row_bytes) for n, r in port.relations.items()}
    assert [(e.a, e.b, e.selectivity) for e in ref.edges] == \
        [(e.a, e.b, e.selectivity) for e in port.edges]
    for n in (2, 5, 8):
        assert rschema.random_query(ref, n, seed=seed) == \
            tschema.random_query(port, n, seed=seed)
    rt, tt = rschema.tpch_schema(seed + 1), tschema.tpch_schema(seed + 1)
    assert {n: (r.rows, r.row_bytes) for n, r in rt.relations.items()} == \
        {n: (r.rows, r.row_bytes) for n, r in tt.relations.items()}
    assert [(e.a, e.b, e.selectivity) for e in rt.edges] == \
        [(e.a, e.b, e.selectivity) for e in tt.edges]
    assert tschema.TPCH_QUERIES == rschema.TPCH_QUERIES


def test_tpch_paper_models_match():
    # the four TPC-H queries with the default (paper) models on the exact
    # backend: identical plans, stats and broker counters
    rt, tt = rschema.tpch_schema(100), tschema.tpch_schema(100)
    queries = list(rschema.TPCH_QUERIES.values())
    kw = dict(planner="selinger", resource_planning="batched",
              objective="time")
    ref = _run(RRAQO, RBroker("numpy"), rt, rcm.paper_models(),
               r_paper_cluster(), queries, **kw)
    port = _run(TRAQO, TBroker("torch"), tt, tcm.paper_models(),
                t_paper_cluster(), queries, **kw)
    assert port == ref
    assert np.isfinite([s[1] for s in port[0]]).all()


@pytest.mark.parametrize("mode", ["resources_for_plan", "for_budget",
                                  "plan_for_resources"])
def test_other_modes_match(mode):
    # the three single-query §IV modes on the exact backend (the SLA scan
    # of resources_for_plan goes through its own "sla" surface)
    rs, ts = _schema_pair(4)
    rm, tm = _models_pair("sim")
    tables = rschema.random_query(rs, 4, seed=0)
    ref = RRAQO(rs, models=rm, cluster=r_paper_cluster(),
                resource_planning="batched", backend="numpy")
    port = TRAQO(ts, models=tm, cluster=t_paper_cluster(),
                 resource_planning="batched", backend="torch")
    if mode == "resources_for_plan":
        for target in (5.0, 40.0):
            got = port.resources_for_plan(port.joint(tables).plan, target)
            want = ref.resources_for_plan(ref.joint(tables).plan, target)
            assert got == want
    elif mode == "for_budget":
        for budget in (0.001, 1.0):
            assert plan_signature(port.for_budget(tables, budget)) == \
                plan_signature(ref.for_budget(tables, budget))
    else:
        assert plan_signature(port.plan_for_resources(tables, (20, 4))) == \
            plan_signature(ref.plan_for_resources(tables, (20, 4)))


def test_sla_scan_matches_pallas():
    # resources_for_plan's SLA surface through the CUDA backend's wrappers
    # (plain versions on CPU tensors) against the reference's pallas scan
    rs, ts = _schema_pair(4)
    rm, tm = _models_pair("sim")
    tables = rschema.random_query(rs, 4, seed=0)
    ref = RRAQO(rs, models=rm, cluster=r_paper_cluster(40, 8),
                resource_planning="batched", backend="pallas")
    port = TRAQO(ts, models=tm, cluster=t_paper_cluster(40, 8),
                 resource_planning="batched",
                 backend=CudaPlanBackend(device="cpu"))
    plan_r, plan_t = ref.joint(tables).plan, port.joint(tables).plan
    for target in (5.0, 40.0):
        assert port.resources_for_plan(plan_t, target) == \
            ref.resources_for_plan(plan_r, target)
