"""The session broker's parity twins (``tests/test_plan_broker.py``).

Each test runs the reference test's body on the JAX package with its
float64 ``"numpy"`` backend and on the port with its float64 ``"torch"``
backend, from the same seeds, and requires the same results: plans and
costs bit for bit (ties included), cache contents and counters, broker
traffic; and on the port the reference's own invariant (brokered
planning equals the sequential per-operator loop).

Where the reference uses machinery the port does not have:

- the ``jax`` lane (``test_hypothesis_broker_jax_matches_numpy``) is the
  CUDA backend: here ``CudaPlanBackend(device="cpu")`` (its wrappers on
  CPU tensors, float32 like the reference's jax backend), on the card
  ``test_torch_cuda.py::test_broker_on_kernels_matches_torch``;
- the ``jax_x64`` tests, which fail on jax 0.9 (ROADMAP §3), are held
  against the ``numpy`` backend, which is exact; the float32 lane that
  cannot see the tie is the CUDA backend's plain version;
- the scalar-only ``oom_fn`` lambda is the port's ``oom_frac`` (the
  lambda is ``ss > 0.7 * cs`` on this grid);
- the CI matrix lane (``plan_backend`` fixture) is the ``"torch"`` lane.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from fixtures_torch_planning import PORT, REF, both, cache_state, tree_sig
from repro.configs import get_config as r_get_config
from repro.configs import get_shape as r_get_shape
from repro.core.sharding_planner import ShardingPlanner as RPlanner
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_shape as t_get_shape
from repro_torch.core.sharding_planner import ShardingPlanner as TPlanner
from repro_torch.kernels.plan_scan import CudaPlanBackend

SHARDING = {"ref": (RPlanner, r_get_config, r_get_shape),
            "port": (TPlanner, t_get_config, t_get_shape)}


def _costing(p, cluster=None, broker=None, cache=None, mode="batched",
             objective="time", backend=None):
    return p.OperatorCosting(models=p.simulator_cost_models(),
                             cluster=cluster or p.paper_cluster(40, 10),
                             resource_planning=mode, broker=broker,
                             cache=cache, objective=objective,
                             backend=backend or p.backend)


def _ragged_cluster(p):
    """Stepped dim with a ragged top plus an explicit-values dim."""
    return p.ClusterConditions(dims=(
        p.ResourceDim("num_containers", 1, 38, step=3),
        p.ResourceDim("container_gb", 1, 10, values=(1, 2, 3, 5, 8, 10)),
    ))


def _ops(rng, n):
    impls = ("SMJ", "BHJ")
    return [(impls[int(rng.integers(2))],
             float(np.round(rng.uniform(0.2, 8.0), 3)),
             float(np.round(rng.uniform(5.0, 300.0), 3))) for _ in range(n)]


def _f64(p, cfgs):
    """Configs as float64 in the package's array type."""
    if p is PORT:
        return torch.as_tensor(cfgs).to(torch.float64)
    return np.asarray(cfgs, dtype=np.float64)


# --------------------- operator-level broker parity ------------------------ #

def _broker_vs_sequential(p, seed, mode, objective, ragged, warm):
    rng = np.random.default_rng(seed)
    cluster = _ragged_cluster(p) if ragged else p.paper_cluster(35, 9)
    queries = [_ops(rng, 3) for _ in range(3)]
    # duplicate one operator across two queries (cross-query dedup path)
    queries[1][0] = queries[0][1]
    caches = [p.ResourcePlanCache("exact"), p.ResourcePlanCache("exact")] \
        if warm or rng.random() < 0.5 else [None, None]
    seq = _costing(p, cluster, cache=caches[0], mode=mode,
                   objective=objective)
    brk = _costing(p, cluster, broker=p.PlanBroker(p.backend),
                   cache=caches[1], mode=mode, objective=objective)
    if warm:
        for c in (seq, brk):
            c.plan_resources(*queries[0][0])
            c.begin_query()
    expect, got = [], []
    for q in queries:
        seq.begin_query()
        expect += [seq.plan_resources(*op) for op in q]
    for q in queries:                        # prefetch-everything path
        brk.begin_query()
        for op in q:
            brk.prefetch(*op)
    for q in queries:
        brk.begin_query()
        got += [brk.plan_resources(*op) for op in q]
    return expect, got, [cache_state(c) for c in caches if c is not None]


def _check_broker_vs_sequential(*case):
    (r_exp, r_got, r_caches), (t_exp, t_got, t_caches) = \
        both(_broker_vs_sequential, *case)
    assert t_got == t_exp                    # bit-identical, ties included
    assert t_got == r_got and t_exp == r_exp
    assert t_caches == r_caches


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000),
       mode=st.sampled_from(["batched", "hillclimb_batched", "ensemble"]),
       objective=st.sampled_from(["time", "money"]),
       ragged=st.booleans(), warm=st.booleans())
def test_hypothesis_broker_bit_identical_numpy(seed, mode, objective,
                                               ragged, warm):
    """Broker-batched multi-query planning == the sequential per-operator
    loop, plans AND costs, on random operator workloads, and both equal
    the reference's."""
    _check_broker_vs_sequential(seed, mode, objective, ragged, warm)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("mode", ["batched", "hillclimb_batched",
                                  "ensemble"])
def test_broker_bit_identical_at_seed_0(mode, warm, ragged):
    """The property test's seed 0 in every mode, both objectives: the
    synchronous ``batched`` path once divided Python floats by tensors
    through a reciprocal and missed the broker's costs by an ulp."""
    for objective in ("time", "money"):
        _check_broker_vs_sequential(0, mode, objective, ragged, warm)


def _broker_plans(p, backend, seed, mode, ragged):
    rng = np.random.default_rng(seed)
    cluster = _ragged_cluster(p) if ragged else p.paper_cluster(30, 8)
    ops = _ops(rng, 5)
    c = _costing(p, cluster, broker=p.PlanBroker(backend), mode=mode)
    for op in ops:
        c.prefetch(*op)
    return [c.plan_resources(*op) for op in ops]


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000),
       mode=st.sampled_from(["batched", "ensemble"]), ragged=st.booleans())
def test_hypothesis_broker_float32_matches_numpy(seed, mode, ragged):
    """The float32 lane: the CUDA backend's plain version as the broker's
    backend plans what the reference's numpy broker plans (winners
    re-committed through float64 on both ends)."""
    want = _broker_plans(REF, "numpy", seed, mode, ragged)
    got = _broker_plans(PORT, CudaPlanBackend(device="cpu"), seed, mode,
                        ragged)
    for (rj, cj), (rn, cn) in zip(got, want):
        if math.isinf(cn):
            # all-infeasible operator: the climb reports its start config
            # at inf, the float64 redo reports None — both mean "no plan"
            assert math.isinf(cj)
        else:
            assert rj == rn
            assert cj == pytest.approx(cn, rel=1e-12)


def _dedup_and_memo(p):
    broker = p.PlanBroker(p.backend)
    c = _costing(p, broker=broker)
    for _ in range(3):
        c.prefetch("SMJ", 2.0, 74.0)         # per-query pending dedups
    c.prefetch("SMJ", 3.0, 74.0)
    r1 = c.plan_resources("SMJ", 2.0, 74.0)
    seen = [(broker.stats.broker_requests, broker.stats.broker_batches)]
    c.begin_query()
    r2 = c.plan_resources("SMJ", 2.0, 74.0)  # resubmits -> session memo
    seen.append((broker.stats.broker_dedup_hits,
                 broker.stats.broker_batches))
    return r1, r2, seen, broker.counters_snapshot()


def test_broker_dedup_and_memo_counters():
    ref, port = both(_dedup_and_memo)
    assert port == ref
    r1, r2, seen, _ = port
    assert seen[0] == (2, 1)                 # one stacked program, Q=2
    assert r2 == r1
    assert seen[1][0] >= 1 and seen[1][1] == 1   # no new search


def _isolation(p):
    broker = p.PlanBroker(p.backend)
    c = _costing(p, broker=broker, cache=p.ResourcePlanCache("exact"))
    c.plan_resources("SMJ", 2.0, 4.0)
    c.begin_query()
    r_big = c.plan_resources("SMJ", 2.0, 400.0)
    fresh = _costing(p, cache=p.ResourcePlanCache("exact"))
    r_fresh = fresh.plan_resources("SMJ", 2.0, 400.0)
    before = broker.stats.broker_requests
    c.plan_resources("SMJ", 2.0, 400.0)
    return r_big, r_fresh, broker.stats.broker_requests - before


def test_begin_query_isolation_survives_broker():
    ref, port = both(_isolation)
    assert port == ref
    r_big, r_fresh, resubmitted = port
    assert r_big[0] == r_fresh[0]
    assert resubmitted == 0                  # the memo answers in-query


# ----------------------- planner-level broker parity ----------------------- #

def _selinger_pair(p, seed, n, mode):
    schema = p.random_schema(6, seed=seed)
    q = p.random_query(schema, n, seed=seed)
    p1 = p.selinger_plan(schema, q, _costing(p, mode=mode))
    p2 = p.selinger_plan(schema, q, _costing(
        p, broker=p.PlanBroker(p.backend), mode=mode))
    return tree_sig(p1), tree_sig(p2)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 500), n=st.integers(2, 5),
       mode=st.sampled_from(["batched", "ensemble"]))
def test_hypothesis_selinger_broker_identical(seed, n, mode):
    ref, port = both(_selinger_pair, seed, n, mode)
    assert port[0] == port[1]
    assert port == ref


def _fast_randomized_pair(p, seed):
    schema = p.random_schema(7, seed=seed)
    q = p.random_query(schema, 4, seed=seed)
    b1, a1 = p.fast_randomized_plan(schema, q, _costing(p), seed=seed)
    b2, a2 = p.fast_randomized_plan(
        schema, q, _costing(p, broker=p.PlanBroker(p.backend)), seed=seed)
    return ((tree_sig(b1), [tree_sig(x) for x in a1.plans]),
            (tree_sig(b2), [tree_sig(x) for x in a2.plans]))


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 500))
def test_hypothesis_fast_randomized_broker_identical(seed):
    """Seeded FastRandomized runs draw the same mutations and return the
    same best plan and archive, brokered or not, in both packages."""
    ref, port = both(_fast_randomized_pair, seed)
    assert port[0] == port[1]
    assert port == ref


_TPCH_QUERIES = [["lineitem", "orders", "customer"],
                 ["lineitem", "part", "supplier"],
                 ["orders", "customer", "nation", "region"],
                 ["lineitem", "orders", "customer"]]     # recurring tenant


def _plan_queries_vs_joint(p, objective):
    schema = p.tpch_schema(100)
    seq = p.RAQO(schema, resource_planning="batched", backend=p.backend)
    expect = [seq.joint(q, objective) for q in _TPCH_QUERIES]
    got = p.RAQO(schema, resource_planning="batched",
                 backend=p.backend).plan_queries(_TPCH_QUERIES, objective)
    return ([(tree_sig(a.plan), a.exec_time, a.money) for a in expect],
            [(tree_sig(b.plan), b.exec_time, b.money) for b in got])


@pytest.mark.parametrize("objective", ["time", "money"])
def test_raqo_plan_queries_matches_sequential_joint(objective):
    ref, port = both(_plan_queries_vs_joint, objective)
    assert len(port[1]) == len(_TPCH_QUERIES)
    assert port[0] == port[1]
    assert port == ref


def _recurring(p):
    broker = p.PlanBroker(p.backend)
    r = p.RAQO(p.tpch_schema(100), resource_planning="batched",
               backend=p.backend, broker=broker)
    plans = r.plan_queries([["lineitem", "orders", "customer"]] * 3)
    return [tree_sig(x.plan) for x in plans], broker.counters_snapshot()


def test_raqo_plan_queries_dedups_recurring_queries():
    ref, port = both(_recurring)
    assert port == ref
    plans, snap = port
    assert snap["dedup_hits"] > 0 and len(set(plans)) == 1


# --------------------------- TPU domain via broker ------------------------- #

def _decision(d):
    return (d.resources.as_tuple(), d.plan_choice, d.objective_value)


def _sharding_joint(p, rp):
    planner, get_config, get_shape = SHARDING[p.name]
    cfg, shape = get_config("deepseek-67b"), get_shape("train_4k")
    d1 = planner(resource_planning=rp, backend=p.backend).joint(cfg, shape)
    d2 = planner(resource_planning=rp, backend=p.backend,
                 broker=p.PlanBroker(p.backend)).joint(cfg, shape)
    return _decision(d1), _decision(d2)


@pytest.mark.parametrize("rp", ["hillclimb", "ensemble", "brute"])
def test_sharding_joint_broker_identical(rp):
    ref, port = both(_sharding_joint, rp)
    assert port[0] == port[1]
    assert port == ref


def _budget_and_replan(p):
    planner, get_config, get_shape = SHARDING[p.name]
    cfg, shape = get_config("deepseek-67b"), get_shape("train_4k")
    pb = planner(resource_planning="ensemble", backend=p.backend,
                 broker=p.PlanBroker(p.backend),
                 cache=p.ResourcePlanCache("exact"))
    pi = planner(resource_planning="ensemble", backend=p.backend,
                 cache=p.ResourcePlanCache("exact"))
    out = []
    for call in (lambda x: x.for_budget(cfg, shape, chip_budget=256),
                 lambda x: x.replan(cfg, shape, lost_chips=200),
                 lambda x: x.joint(cfg, shape)):
        d, dr = call(pb), call(pi)
        out.append(((d.resources.as_tuple(), d.objective_value),
                    (dr.resources.as_tuple(), dr.objective_value)))
    return out, cache_state(pb.cache), cache_state(pi.cache)


def test_sharding_budget_and_replan_broker_identical_with_cache():
    """for_budget / replan through the broker with cache-hit validation
    agree call for call with an identically warmed inline planner, and
    with the reference's."""
    ref, port = both(_budget_and_replan)
    for brokered, inline in port[0]:
        assert brokered == inline
    assert port == ref


def _shared_flush(p):
    planner, get_config, get_shape = SHARDING[p.name]
    broker = p.PlanBroker(p.backend)
    db = _costing(p, broker=broker)
    db.prefetch("SMJ", 2.0, 74.0)
    db.prefetch("BHJ", 1.0, 74.0)
    pending = [broker.pending_count()]
    tpu = planner(resource_planning="hillclimb", backend=p.backend,
                  broker=broker)
    d = tpu.joint(get_config("smollm-360m"), get_shape("train_4k"))
    pending.append(broker.pending_count())    # TPU resolve flushed DB too
    smj = db.plan_resources("SMJ", 2.0, 74.0)
    alone = planner(resource_planning="hillclimb", backend=p.backend).joint(
        get_config("smollm-360m"), get_shape("train_4k"))
    return pending, smj, _decision(d), _decision(alone)


def test_db_and_tpu_share_one_broker_flush():
    ref, port = both(_shared_flush)
    assert port == ref
    pending, smj, d, alone = port
    assert pending == [2, 0]
    assert smj[0] is not None and d[0] == alone[0]


# ----------------- exact selection (the reference's x64 tests) ------------- #

def test_exact_backend_exact_argmin():
    """On a surface whose float32 rounding flips the argmin, the port's
    float64 backend agrees with numpy bit for bit (config and cost, the
    stacked form too), while the float32 lane cannot see the tie."""
    base = np.full(64, 2.0)
    base[17] = 2.0 - 1e-12           # invisible in float32, wins in f64

    def run(p):
        cluster = p.ClusterConditions(dims=(p.ResourceDim("a", 0, 63),
                                            p.ResourceDim("b", 0, 0)))
        if p is PORT:
            table = torch.tensor(base)

            def fn(cfgs, params=None):
                return table[torch.as_tensor(cfgs)[:, 0]]
        else:
            def fn(cfgs, params=None):
                return base[np.asarray(cfgs)[:, 0]]
        be = p.exact
        return (be.argmin_grid(fn, cluster),
                be.argmin_grid_many(fn, cluster, np.zeros((1, 1))), cluster)

    (r_one, r_many, _), (t_one, t_many, tcl) = both(run)
    assert r_one == ((17, 0), 2.0 - 1e-12) and PORT.exact.exact
    assert t_one == r_one and t_many == r_many == [r_one]
    surface = PORT.cost_model.Surface(PORT.cost_model.CostTable.of(
        tcl, base.reshape(64, 1)))

    def f32(cfgs, params):
        return surface(cfgs, params)

    f32.surface = surface
    r32, _ = CudaPlanBackend(device="cpu").argmin_grid(
        f32, tcl, params=np.zeros(1))
    assert r32 != r_one[0]           # the float32 lane cannot see it


def _costing_exact(p, mode):
    c = _costing(p, mode=mode)
    c_brk = _costing(p, mode=mode, broker=p.PlanBroker(p.backend))
    return [(c.plan_resources("SMJ", ss, ls),
             c_brk.plan_resources("SMJ", ss, ls))
            for ss, ls in ((0.5, 74.0), (2.0, 10.0), (6.0, 200.0))]


@pytest.mark.parametrize("mode", ["batched", "ensemble"])
def test_operator_costing_exact_backend_matches_numpy(mode):
    """The port's exact backend, with and without a broker, plans what
    the reference's numpy backend plans, config and cost."""
    ref, port = both(_costing_exact, mode)
    assert all(a == b for a, b in port)
    assert port == ref


def _scalar_oom(p):
    coef = p.cost_model.PAPER_BHJ
    if p is REF:
        def scalar_only_oom(ss, cs):
            return bool(ss > 0.7 * cs and cs < 64)    # ValueError on arrays
        bhj = p.RegressionModel("BHJ", coef, oom_fn=scalar_only_oom)
    else:
        bhj = p.RegressionModel("BHJ", coef, oom_frac=0.7)
    models = {"SMJ": p.RegressionModel("SMJ", coef * 0 + 1.0), "BHJ": bhj}
    kw = dict(models=models, cluster=p.paper_cluster(20, 8),
              resource_planning="batched", backend=p.backend)
    seq = p.OperatorCosting(**kw)
    brk = p.OperatorCosting(broker=p.PlanBroker(p.backend), **kw)
    ops = [("BHJ", 2.0, 74.0), ("BHJ", 3.0, 50.0)]
    for op in ops:
        brk.prefetch(*op)
    return ([brk.plan_resources(*op) for op in ops],
            [seq.plan_resources(*op) for op in ops])


def test_oom_predicate_survives_stacked_path():
    """The reference's scalar-only OOM lambda degrades to per-row
    evaluation on the stacked path; the port's ``oom_frac`` is a number
    on every path.  Same plans, brokered or not, in both."""
    ref, port = both(_scalar_oom)
    assert port[0] == port[1]
    assert port == ref


def _lane(p, mode):
    seq = _costing(p, mode=mode)
    brk = _costing(p, mode=mode, broker=p.PlanBroker(p.backend))
    ops = [("SMJ", 2.0, 74.0), ("BHJ", 1.0, 74.0), ("SMJ", 4.0, 120.0)]
    for op in ops:
        brk.prefetch(*op)
    return ([brk.plan_resources(*op) for op in ops],
            [seq.plan_resources(*op) for op in ops])


@pytest.mark.parametrize("mode", ["batched", "ensemble"])
def test_torch_lane_broker_identical_with_sequential(mode):
    """The reference's backend-matrix lane test on the port's lane: the
    broker and the sequential loop agree, and equal the numpy lane."""
    ref, port = both(_lane, mode)
    assert port[0] == port[1]
    assert port == ref


# -------------- interpolating caches: two-phase flush re-lookup ------------ #

def _target_fn(p):
    def batch_fn(cfgs, params):
        a = _f64(p, cfgs)
        return (a[:, 0] - params[0]) ** 2 + 0.5 * a[:, 1]
    return batch_fn


def _interpolating(p, mode):
    batch_fn = _target_fn(p)

    def commit_fn(target):
        return lambda cfg: float((cfg[0] - target) ** 2 + 0.5 * cfg[1])

    cluster = p.ClusterConditions(dims=(p.ResourceDim("a", 1, 10),
                                        p.ResourceDim("b", 1, 3)))
    jobs = [(5.0, 3.0), (5.5, 8.0), (5.0, 9.0)]

    def make_reqs(cache):
        return [p.PlanRequest(fn=batch_fn, cluster=cluster,
                              params=np.asarray([t]),
                              commit_fn=commit_fn(t), mode="grid",
                              cache=cache, cache_key=("M", "join", k),
                              validate_hit=True)
                for k, t in jobs]

    seq_cache = p.ResourcePlanCache(mode, threshold=1.0)
    expect = [p.PlanBroker(p.backend)._solve_one(r)
              for r in make_reqs(seq_cache)]
    brk_cache = p.ResourcePlanCache(mode, threshold=1.0)
    broker = p.PlanBroker(p.backend)
    futs = [broker.submit(r) for r in make_reqs(brk_cache)]
    pending = broker.pending_count()
    got = [f.result() for f in futs]          # ONE flush
    return expect, got, pending, cache_state(seq_cache), \
        cache_state(brk_cache)


@pytest.mark.parametrize("mode", ["nearest_neighbor", "weighted_average"])
def test_broker_interpolating_cache_sequential_identical(mode):
    """NN / weighted-average lookups observe same-flush inserts: one flush
    equals the sequential loop in plans, costs, cache contents and
    counters, in both packages."""
    ref, port = both(_interpolating, mode)
    expect, got, pending, seq_state, brk_state = port
    assert pending == 3 and got == expect and brk_state == seq_state
    assert port == ref


def _interpolating_fallthrough(p, mode):
    batch_fn = _target_fn(p)
    cluster = p.ClusterConditions(dims=(p.ResourceDim("a", 1, 10),
                                        p.ResourceDim("b", 1, 3)))

    def commit2(cfg):
        return math.inf if cfg[0] == 3 else \
            float((cfg[0] - 8.0) ** 2 + 0.5 * cfg[1])

    def make_reqs(cache):
        r1 = p.PlanRequest(fn=batch_fn, cluster=cluster,
                           params=np.asarray([3.0]),
                           commit_fn=lambda c: float((c[0] - 3.0) ** 2
                                                     + 0.5 * c[1]),
                           mode="grid", cache=cache,
                           cache_key=("M", "join", 5.0), validate_hit=True)
        r2 = p.PlanRequest(fn=batch_fn, cluster=cluster,
                           params=np.asarray([8.0]), commit_fn=commit2,
                           mode="grid", cache=cache,
                           cache_key=("M", "join", 5.5), validate_hit=True)
        return [r1, r2]

    cache_seq = p.ResourcePlanCache(mode, threshold=1.0)
    cache_brk = p.ResourcePlanCache(mode, threshold=1.0)
    expect = [p.PlanBroker(p.backend)._solve_one(r)
              for r in make_reqs(cache_seq)]
    brk = p.PlanBroker(p.backend)
    got = [f.result() for f in [brk.submit(r) for r in make_reqs(cache_brk)]]
    return expect, got, cache_state(cache_seq), cache_state(cache_brk)


@pytest.mark.parametrize("mode", ["nearest_neighbor", "weighted_average"])
def test_broker_interpolating_cache_exact_key_still_dedups(mode):
    ref, port = both(_interpolating_fallthrough, mode)
    expect, got, seq_state, brk_state = port
    assert got == expect and expect[1][0] == (8, 1)
    assert brk_state[1] == seq_state[1]
    assert port == ref


# --------------------------- cache counters -------------------------------- #

def _counters(p):
    cache = p.ResourcePlanCache("exact")
    stats = p.PlanningStats()
    cache.lookup("SMJ", "join:time:ls6", 2.0, stats=stats)      # miss
    cache.insert("SMJ", "join:time:ls6", 2.0, (10, 4), stats=stats)
    cache.lookup("SMJ", "join:time:ls6", 2.0, stats=stats)      # hit
    cache.lookup("BHJ", "join:time:ls6", 2.0, stats=stats)      # miss
    other = p.PlanningStats()
    other.merge(stats)
    return cache.counters_snapshot(), vars(stats), other.cache_detail


def test_cache_counters_per_model_and_kind():
    ref, port = both(_counters)
    assert port == ref
    snap, stats, merged = port
    assert snap["SMJ|join:time:ls6"] == \
        {"hits": 1, "misses": 1, "inserts": 1}
    assert snap["BHJ|join:time:ls6"] == \
        {"hits": 0, "misses": 1, "inserts": 0}
    assert (stats["cache_hits"], stats["cache_misses"],
            stats["cache_inserts"]) == (1, 2, 1)
    assert merged == stats["cache_detail"]


def _fronted(p):
    cache = p.ResourcePlanCache("exact")
    broker = p.PlanBroker(p.backend)
    c = _costing(p, broker=broker, cache=cache)
    out = []
    for _ in range(2):
        c.begin_query()
        for op in (("SMJ", 2.0, 74.0), ("BHJ", 1.0, 74.0)):
            c.prefetch(*op)
        out.append((c.plan_resources("SMJ", 2.0, 74.0),
                    c.plan_resources("BHJ", 1.0, 74.0)))
    return out, cache_state(cache), broker.counters_snapshot()


def test_broker_fronts_cache_with_counters():
    ref, port = both(_fronted)
    assert port == ref
    smj = port[1][1]["SMJ|join:time:ls6"]
    assert smj["inserts"] == 1 and smj["hits"] >= 1   # 2nd query hits
