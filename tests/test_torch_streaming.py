"""The port's streaming planner service (repro_torch.service) against the
JAX reference's, on the CPU.

The cases of tests/test_streaming.py, run on the port: a query admitted
into a RUNNING lockstep plans bit-identically to the same query planned
solo on a fresh broker, on the exact ``"torch"`` backend and on
``CudaPlanBackend(device="cpu")`` (the CUDA backend's wrappers taking
their plain versions); the edge cases (arrival on an incumbent's final
wave, single-table queries mid-run, arrival during an in-flight
``flush_async`` wave, an empty trace, the non-double-buffered broker).
Across packages: the port's trace generators give the reference's
arrivals for every generator and seed, and on one schema and trace the
port's service tickets carry the reference service's plans, costs,
resources and waves.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import cost_model as rcm
from repro.core import schema as rschema
from repro.core.cluster import paper_cluster as r_paper_cluster
from repro.core.plan_broker import PlanBroker as RBroker
from repro.core.raqo import RAQO as RRAQO
from repro import service as rservice
from repro_torch.core import cost_model as tcm
from repro_torch.core.cluster import paper_cluster
from repro_torch.core.plan_broker import PlanBroker
from repro_torch.core.plan_cache import ResourcePlanCache
from repro_torch.core.raqo import RAQO
from repro_torch.core.schema import (random_query, random_schema,
                                     schema_from_dict)
from repro_torch.kernels.plan_scan import CudaPlanBackend
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.service import (StreamingPlannerService, bursty_trace,
                                 diurnal_trace, poisson_trace)

BACKENDS = {"torch": lambda: "torch",
            "cuda-on-cpu": lambda: CudaPlanBackend(device="cpu")}


def _raqo(schema, *, cache=None, backend="torch"):
    return RAQO(schema, cluster=paper_cluster(24, 8),
                resource_planning="batched", cache=cache, backend=backend,
                broker=PlanBroker(backend))


def _tree_sig(p):
    if p is None:
        return None
    if p.is_leaf:
        return tuple(sorted(p.tables))
    return (p.impl, p.resources, p.op_cost, p.total_cost, p.total_money,
            _tree_sig(p.left), _tree_sig(p.right))


def _assert_solo_identical(tickets, schema, backend="torch"):
    for t in tickets:
        solo = _raqo(schema, backend=backend).joint(t.tables)
        assert _tree_sig(solo.plan) == _tree_sig(t.joint.plan), t.tables
        assert (solo.exec_time, solo.money) == \
            (t.joint.exec_time, t.joint.money)


# ----------------------- trace generators ---------------------------------- #

GENERATORS = {"poisson": (poisson_trace, rservice.poisson_trace),
              "bursty": (bursty_trace, rservice.bursty_trace),
              "diurnal": (diurnal_trace, rservice.diurnal_trace)}


def test_trace_generators_deterministic_and_sorted():
    schema = random_schema(10, seed=1)
    for gen, _ in GENERATORS.values():
        a = gen(schema, 40, rate=5.0, seed=9, tenants=4)
        b = gen(schema, 40, rate=5.0, seed=9, tenants=4)
        assert a == b, gen.__name__            # pure function of the seed
        assert len(a) == 40
        assert all(x.t <= y.t for x, y in zip(a, a[1:]))
        assert all(0 <= x.tenant < 4 for x in a)
        assert all(2 <= len(x.tables) <= 6 for x in a)
        c = gen(schema, 40, rate=5.0, seed=10, tenants=4)
        assert c != a                          # seed actually matters

    burst = bursty_trace(schema, 32, rate=8.0, seed=0, burst=8)
    assert len({x.t for x in burst}) == 4      # 4 bursts of 8
    with pytest.raises(ValueError):
        diurnal_trace(schema, 4, rate=1.0, swing=1.5)


@pytest.mark.parametrize("seed", [0, 11, 43])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_traces_equal_reference(name, seed):
    """Field for field, on the streaming bench's schema."""
    port_gen, ref_gen = GENERATORS[name]
    kw = dict(rate=100.0, seed=seed, tenants=64)
    got = port_gen(random_schema(16, seed=0), 64, **kw)
    want = ref_gen(rschema.random_schema(16, seed=0), 64, **kw)
    assert [dataclasses.astuple(a) for a in got] == \
        [dataclasses.astuple(a) for a in want]


# ----------------------- admission-join identity --------------------------- #

@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_hypothesis_admission_join_matches_solo(seed):
    """Random schemas, ragged query sizes (1..5), admissions staggered
    across waves: every ticket's plan bit-equals the fresh-broker solo
    plan of the same query."""
    rng = np.random.default_rng(seed)
    schema = random_schema(8, seed=seed % 100)
    svc = StreamingPlannerService(_raqo(schema))
    tickets = []
    for i in range(5):
        k = int(rng.integers(1, 6))
        tickets.append(svc.submit(random_query(schema, k, seed=seed + i),
                                  tenant=i))
        if rng.integers(0, 2):
            svc.step()                # interleave admissions with waves
    svc.drain()
    assert all(t.done for t in tickets)
    _assert_solo_identical(tickets, schema)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_admission_identical_on_backend(backend):
    schema = random_schema(8, seed=6)
    be = BACKENDS[backend]()
    svc = StreamingPlannerService(_raqo(schema, backend=be))
    tickets = [svc.submit(random_query(schema, 4, seed=0), tenant=0)]
    svc.step()
    svc.step()
    tickets.append(svc.submit(random_query(schema, 3, seed=1), tenant=1))
    svc.drain()
    _assert_solo_identical(tickets, schema, backend=be)
    assert svc.broker.counters_snapshot()["waves"] > 0


# ----------------------------- edge cases ---------------------------------- #

@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_arrival_at_final_wave(backend):
    """A query admitted just before an incumbent's LAST wave: the shared
    flush commits the incumbent's final level and dispatches the
    newcomer's level 2; both plans stay solo-identical."""
    schema = random_schema(8, seed=11)
    be = BACKENDS[backend]()
    svc = StreamingPlannerService(_raqo(schema, backend=be))
    inc = svc.submit(random_query(schema, 4, seed=2), tenant=0)
    for _ in range(3):
        svc.step()
    assert not inc.done                         # level 4 in flight
    late = svc.submit(random_query(schema, 3, seed=3), tenant=1)
    svc.step()                                  # incumbent's final wave
    assert inc.done and inc.final_wave == 4
    assert not late.done
    svc.drain()
    assert late.done and late.admit_wave == 3
    _assert_solo_identical([inc, late], schema, backend=be)


def test_single_table_query_joins_mid_run():
    """Trivial queries resolve at submit — no wave ride — and leave the
    running incumbents untouched."""
    schema = random_schema(8, seed=12)
    svc = StreamingPlannerService(_raqo(schema))
    inc = svc.submit(random_query(schema, 5, seed=4), tenant=0)
    svc.step()
    waves_before = svc.waves
    one = svc.submit(random_query(schema, 1, seed=5), tenant=1)
    assert one.done and one.latency_s is not None
    assert one.joint.plan.is_leaf
    assert tuple(one.joint.plan.tables) == tuple(one.tables)
    assert svc.waves == waves_before            # no wave consumed
    svc.drain()
    _assert_solo_identical([inc, one], schema)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_arrival_during_inflight_commit(backend):
    """Submission while a flush_async wave is still IN FLIGHT (dispatched,
    uncommitted): the newcomer's level 2 rides the next flush, which
    commits the incumbent wave first — identity intact."""
    schema = random_schema(8, seed=13)
    be = BACKENDS[backend]()
    svc = StreamingPlannerService(_raqo(schema, backend=be))
    inc = svc.submit(random_query(schema, 5, seed=6), tenant=0)
    svc.step()
    assert svc.broker.inflight_count() > 0      # wave uncommitted
    late = svc.submit(random_query(schema, 4, seed=7), tenant=1)
    svc.drain()
    assert inc.done and late.done
    _assert_solo_identical([inc, late], schema, backend=be)


def test_empty_trace_and_zero_admissions():
    schema = random_schema(6, seed=14)
    svc = StreamingPlannerService(_raqo(schema))
    assert svc.run_closed_loop([], concurrency=8) == []
    assert svc.run_open_loop(()) == []
    svc.drain()                                 # no-op on an idle service
    rep = svc.report(elapsed_s=0.01)
    assert rep["submitted"] == rep["completed"] == rep["waves"] == 0
    assert rep["query_p99_s"] is None
    with pytest.raises(ValueError):
        svc.submit([], tenant=0)


def test_closed_loop_respects_concurrency_and_reports():
    schema = random_schema(10, seed=15)
    trace = poisson_trace(schema, 24, rate=50.0, seed=3, tenants=6)
    svc = StreamingPlannerService(_raqo(schema))
    high_water = 0
    orig_step = svc.step

    def step():
        nonlocal high_water
        high_water = max(high_water, svc.active)
        return orig_step()
    svc.step = step
    tickets = svc.run_closed_loop([(a.tenant, a.tables) for a in trace],
                                  concurrency=6)
    assert len(tickets) == 24
    assert all(t.done and t.joint.plan is not None for t in tickets)
    assert all(t.final_wave >= t.admit_wave for t in tickets)
    assert high_water <= 6
    rep = svc.report(elapsed_s=1.0)
    assert rep["completed"] == 24
    assert rep["plans_per_s"] == 24.0
    assert rep["query_p50_s"] <= rep["query_p99_s"]
    assert 1 <= rep["broker"]["waves"] <= svc.waves


def test_open_loop_replays_trace():
    schema = random_schema(8, seed=19)
    trace = poisson_trace(schema, 12, rate=2000.0, seed=5, tenants=3)
    svc = StreamingPlannerService(_raqo(schema))
    tickets = svc.run_open_loop(trace)
    assert [t.tables for t in tickets] == [a.tables for a in trace]
    assert all(t.done for t in tickets)
    _assert_solo_identical(tickets, schema)


def test_admission_on_legacy_broker():
    """A broker without flush_async drives the driver's one-level-per-
    step fallback; admissions still join mid-run, identity holds."""
    class _LegacyBroker(PlanBroker):
        flush_async = property()

    schema = random_schema(8, seed=16)
    raqo = RAQO(schema, cluster=paper_cluster(24, 8),
                resource_planning="batched", backend="torch",
                broker=_LegacyBroker("torch"))
    svc = StreamingPlannerService(raqo)
    assert not svc.driver.pipelined
    a = svc.submit(random_query(schema, 4, seed=8), tenant=0)
    svc.step()
    b = svc.submit(random_query(schema, 3, seed=9), tenant=1)
    svc.drain()
    assert a.done and b.done
    _assert_solo_identical([a, b], schema)


def test_shared_cache_stream_completes():
    """With a shared exact resource-plan cache the stream still plans
    every query; plan equality across recurring identical queries is
    exact."""
    schema = random_schema(8, seed=17)
    q = random_query(schema, 4, seed=10)
    svc = StreamingPlannerService(
        _raqo(schema, cache=ResourcePlanCache("exact")))
    first = svc.submit(q, tenant=0)
    svc.step()
    second = svc.submit(q, tenant=1)            # recurring job mid-run
    svc.drain()
    assert _tree_sig(first.joint.plan) == _tree_sig(second.joint.plan)


def test_tracing_never_perturbs_streaming_plans():
    """Tracing off vs on: identical plans and broker counters; the
    traced run feeds service.query_s and records critical-path
    samples."""
    schema = random_schema(8, seed=18)
    trace = poisson_trace(schema, 10, rate=50.0, seed=4, tenants=3)
    work = [(a.tenant, a.tables) for a in trace]

    def run():
        svc = StreamingPlannerService(_raqo(schema))
        tickets = svc.run_closed_loop(work, concurrency=4)
        return [_tree_sig(t.joint.plan) for t in tickets], \
            svc.broker.counters_snapshot(), svc

    tr, mx = get_tracer(), get_metrics()
    was = tr.enabled
    sig_off, cnt_off, _ = run()
    tr.reset()
    mx.reset()
    tr.enable()
    try:
        sig_on, cnt_on, svc = run()
        assert sig_on == sig_off
        assert cnt_on == cnt_off
        assert mx.histogram("service.query_s").count == len(work)
        rep = svc.report(elapsed_s=1.0)
        assert rep["request"]["count"] > 0
        assert rep["critical_path"]["samples"] > 0
    finally:
        tr.enabled = was
        tr.reset()
        mx.reset()


# --------------------- the reference service, ticket by ticket ------------- #

def _ticket_sig(t):
    return (t.tenant, t.tables, t.admit_wave, t.final_wave,
            _tree_sig(t.joint.plan), t.joint.exec_time, t.joint.money,
            dataclasses.astuple(t.joint.stats))


# (port backend, reference backend): exact float64 on both sides, and
# the CUDA backend's wrappers on CPU tensors against the float32 pallas
# backend in interpret mode (both re-commit winners in float64)
BACKEND_PAIRS = {"torch-numpy": ("torch", "numpy"),
                 "cuda_on_cpu-pallas": ("cuda-on-cpu", "pallas")}


@pytest.mark.parametrize("loop", ["closed", "staggered"])
@pytest.mark.parametrize("pair", sorted(BACKEND_PAIRS))
def test_service_matches_reference_service(pair, loop):
    """One schema (handed over), the simulator models (handed over) and
    one trace through both services: every ticket carries the same plan,
    costs, resources, waves and planning stats, and the brokers' counters
    agree."""
    port_be, ref_be = BACKEND_PAIRS[pair]
    port_be = BACKENDS[port_be]()
    ref_schema = rschema.random_schema(10, seed=20)
    schema = schema_from_dict({
        "relations": [(r.name, r.rows, r.row_bytes)
                      for r in ref_schema.relations.values()],
        "edges": [(e.a, e.b, e.selectivity) for e in ref_schema.edges]})
    sim = rcm.HiveSimulator()
    trace = rservice.poisson_trace(ref_schema, 20, rate=50.0, seed=21,
                                   tenants=5)
    work = [(a.tenant, a.tables) for a in trace]

    def run(svc):
        if loop == "closed":
            return svc.run_closed_loop(work, concurrency=5)
        tickets = []
        for i, (tenant, tables) in enumerate(work):
            tickets.append(svc.submit(tables, tenant))
            if i % 3 == 2:
                svc.step()
        svc.drain()
        return tickets

    ref_svc = rservice.StreamingPlannerService(RRAQO(
        ref_schema, models=rcm.simulator_cost_models(sim),
        cluster=r_paper_cluster(24, 8), resource_planning="batched",
        backend=ref_be, broker=RBroker(ref_be)))
    port_svc = StreamingPlannerService(RAQO(
        schema, models=tcm.models_from_arrays(dataclasses.asdict(sim)),
        cluster=paper_cluster(24, 8), resource_planning="batched",
        backend=port_be, broker=PlanBroker(port_be)))
    want = [_ticket_sig(t) for t in run(ref_svc)]
    got = [_ticket_sig(t) for t in run(port_svc)]
    assert got == want
    assert port_svc.waves == ref_svc.waves
    assert port_svc.broker.counters_snapshot() == \
        ref_svc.broker.counters_snapshot()
