"""The lockstep twins (``tests/test_lockstep.py``): ``RAQO.plan_queries``
advancing every query one DP level per shared flush wave equals the
sequential per-query ``joint()`` loop — plans, costs, cache contents and
counters, broker traffic — on the reference (``"numpy"``) and on the port
(``"torch"``), and the port's results equal the reference's.

The reference's jax lanes are the CUDA backend's: its wrappers on CPU
tensors here (``CudaPlanBackend(device="cpu")``), and for the
8-simulated-device subprocess 8 logical shards of it
(``devices=["cpu"] * 8``; on the card ``devices=["cuda"] * 8``,
``test_torch_cuda.py::test_lockstep_on_8_logical_shards_of_the_card``).
XLA program counts are the grid-memo audit's grids and dispatches.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from fixtures_torch_planning import PORT, REF, both, cache_state, sigs
from repro.analysis.recompile_audit import expected_compile_counts
from repro_torch.analysis import recompile_audit as ra
from repro_torch.kernels.plan_scan import CudaPlanBackend


def _raqo(p, schema, broker, *, cache=None, planner="selinger",
          backend=None):
    return p.RAQO(schema, cluster=p.paper_cluster(24, 8), planner=planner,
                  resource_planning="batched", cache=cache,
                  backend=backend or p.backend, broker=broker)


def _legacy(p):
    """A broker WITHOUT flush_async: drives the lockstep driver's
    queue-then-flush-per-level fallback branch."""
    class _LegacyBroker(p.PlanBroker):
        flush_async = property()
    return _LegacyBroker


def _exec(plans):
    return [(g.exec_time, g.money) for g in plans]


# ----------------- lockstep == sequential per-query joint ------------------ #

def _ragged(p, seed):
    rng = np.random.default_rng(seed)
    schema = p.random_schema(8, seed=seed % 100)
    sizes = [int(rng.integers(1, 6)) for _ in range(4)]
    queries = [p.random_query(schema, k, seed=seed + i)
               for i, k in enumerate(sizes)]
    got = _raqo(p, schema, p.PlanBroker(p.backend)).plan_queries(queries)
    r_seq = _raqo(p, schema, p.PlanBroker(p.backend))
    exp = [r_seq.joint(q) for q in queries]
    return (sigs(got), _exec(got)), (sigs(exp), _exec(exp))


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_hypothesis_lockstep_matches_sequential_joint(seed):
    """Ragged query batches (sizes 1..5) on random schemas: plans, times
    and money bit-equal the sequential joint() loop, in both packages."""
    ref, port = both(_ragged, seed)
    assert port[0] == port[1]
    assert port == ref


def _shared_cache(p):
    schema = p.random_schema(9, seed=3)
    queries = [p.random_query(schema, k, seed=q)
               for q, k in enumerate((5, 3, 5, 4, 1, 5))]
    runs = {}
    for label in ("lockstep", "sequential"):
        cache = p.ResourcePlanCache("exact")
        broker = p.PlanBroker(p.backend)
        r = _raqo(p, schema, broker, cache=cache)
        plans = r.plan_queries(queries) if label == "lockstep" else \
            [r.joint(q) for q in queries]
        snap = broker.counters_snapshot()
        runs[label] = (sigs(plans), cache_state(cache),
                       (snap["requests"], snap["dedup_hits"]))
    return runs


def test_lockstep_matches_sequential_joint_with_shared_cache():
    """With a shared exact cache, lockstep equals the sequential loop on
    plans, per-(model, kind) counters, stored keys and configs, and the
    broker's request/dedup totals; the port's equal the reference's."""
    ref, port = both(_shared_cache)
    assert port["lockstep"] == port["sequential"]
    assert port == ref


def _pipeline(p):
    schema = p.random_schema(9, seed=5)
    queries = [p.random_query(schema, 5, seed=q) for q in range(4)]
    b1, b2 = p.PlanBroker(p.backend), p.PlanBroker(p.backend)
    got = _raqo(p, schema, b1).plan_queries(queries, lockstep=True)
    exp = _raqo(p, schema, b2).plan_queries(queries, lockstep=False)
    counters, cached = {}, {}
    for lockstep in (True, False):
        cache = p.ResourcePlanCache("exact")
        plans = _raqo(p, schema, p.PlanBroker(p.backend),
                      cache=cache).plan_queries(queries, lockstep=lockstep)
        counters[lockstep] = cache.counters_snapshot()
        cached[lockstep] = sigs(plans)
    return (sigs(got), sigs(exp), b1.counters_snapshot(),
            b2.counters_snapshot(), counters, cached)


def test_lockstep_matches_per_query_pipeline():
    """Against lockstep=False: identical plans, the same searches
    (requests minus dedup), and with a shared cache equal misses and
    inserts while the per-query pipeline's hits are inflated."""
    ref, port = both(_pipeline)
    assert port == ref
    got, exp, s1, s2, counters, cached = port
    assert got == exp == cached[True] == cached[False]
    assert s1["requests"] - s1["dedup_hits"] == \
        s2["requests"] - s2["dedup_hits"]
    assert set(counters[True]) == set(counters[False])
    for k, c in counters[True].items():
        assert c["misses"] == counters[False][k]["misses"]
        assert c["inserts"] == counters[False][k]["inserts"]
        assert c["hits"] <= counters[False][k]["hits"]


def _disconnected(p):
    rels = {n: p.Relation(n, 200_000 + 170_000 * i, 110 + 12 * i)
            for i, n in enumerate("abcde")}
    edges = [p.JoinEdge("a", "b", 1e-6), p.JoinEdge("b", "c", 2e-6)]
    schema = p.Schema(rels, edges)        # components {a,b,c}, {d}, {e}
    queries = [["a", "b", "c", "d"],      # one cross join at the top
               ["a", "b"],                # connected
               ["d", "e"],                # no edges at all
               ["a", "b", "c"]]
    assert not schema.connected(queries[0])
    got = _raqo(p, schema, p.PlanBroker(p.backend)).plan_queries(queries)
    r_seq = _raqo(p, schema, p.PlanBroker(p.backend))
    exp = [r_seq.joint(q) for q in queries]
    assert all(jp.plan is not None for jp in got)
    return sigs(got), sigs(exp)


def test_lockstep_disconnected_cross_join_fallback():
    ref, port = both(_disconnected)
    assert port[0] == port[1]
    assert port == ref


def _fastrandomized(p):
    schema = p.random_schema(8, seed=2)
    queries = [p.random_query(schema, k, seed=q)
               for q, k in enumerate((5, 3, 4))]
    out = []
    for lockstep in (True, False):
        r = _raqo(p, schema, p.PlanBroker(p.backend),
                  planner="fastrandomized")
        out.append(sigs(r.plan_queries(queries, lockstep=lockstep)))
    r3 = _raqo(p, schema, p.PlanBroker(p.backend), planner="fastrandomized")
    out.append(sigs([r3.joint(q) for q in queries]))
    return out


def test_lockstep_fastrandomized_identical():
    """FastRandomized lockstep == per-query pipeline == sequential joint
    (per-session RNG streams), in both packages."""
    ref, port = both(_fastrandomized)
    assert port[0] == port[1] == port[2]
    assert port == ref


def _legacy_broker(p):
    schema = p.random_schema(8, seed=7)
    queries = [p.random_query(schema, k, seed=q)
               for q, k in enumerate((4, 5, 2))]
    out = [sigs(_raqo(p, schema, broker).plan_queries(queries))
           for broker in (p.PlanBroker(p.backend),
                          _legacy(p)(p.backend))]
    r_seq = _raqo(p, schema, p.PlanBroker(p.backend))
    out.append(sigs([r_seq.joint(q) for q in queries]))
    return out


def test_lockstep_legacy_broker_identical():
    ref, port = both(_legacy_broker)
    assert port[0] == port[1] == port[2]
    assert port == ref


# --------------------------- wave accounting ------------------------------- #

def _waves(p):
    schema = p.random_schema(9, seed=1)
    queries = [p.random_query(schema, 5, seed=q) for q in range(6)]
    b_lock, b_seq = p.PlanBroker(p.backend), p.PlanBroker(p.backend)
    _raqo(p, schema, b_lock).plan_queries(queries)
    r_seq = _raqo(p, schema, b_seq)
    for q in queries:
        r_seq.joint(q)
    return b_lock.counters_snapshot(), b_seq.counters_snapshot()


def test_wave_accounting_snapshot_consistency():
    """counters_snapshot's wave ledger: every request not resolved at
    submit rides one wave; lockstep does the same work in fewer, larger
    waves; the port's ledger is the reference's."""
    ref, port = both(_waves)
    assert port == ref
    for snap in port:
        assert set(snap) == {"requests", "dedup_hits", "batches", "waves",
                             "wave_sizes", "max_wave", "mean_wave"}
        assert snap["waves"] == len(snap["wave_sizes"])
        assert snap["requests"] - snap["dedup_hits"] \
            <= sum(snap["wave_sizes"]) <= snap["requests"]
        assert snap["max_wave"] == max(snap["wave_sizes"])
        assert snap["mean_wave"] == round(
            sum(snap["wave_sizes"]) / len(snap["wave_sizes"]), 3)
    lock, seq = port
    assert lock["waves"] < seq["waves"]
    assert lock["mean_wave"] > seq["mean_wave"]


def _fanout(p):
    schema = p.random_schema(8, seed=4)
    q = p.random_query(schema, 5, seed=0)
    queries = [list(q), list(q), list(q)]
    b_lock, b_seq = p.PlanBroker(p.backend), p.PlanBroker(p.backend)
    got = _raqo(p, schema, b_lock).plan_queries(queries)
    r_seq = _raqo(p, schema, b_seq)
    exp = [r_seq.joint(t) for t in queries]
    return (sigs(got), sigs(exp), b_lock.counters_snapshot(),
            b_seq.counters_snapshot())


def test_level1_fanout_submits_base_candidates_once():
    ref, port = both(_fanout)
    assert port == ref
    got, exp, sl, ss = port
    assert got == exp and got[0] == got[1] == got[2]
    assert sl["requests"] < ss["requests"]
    assert sl["requests"] - sl["dedup_hits"] == \
        ss["requests"] - ss["dedup_hits"]


# ------------------------- recompile contract ------------------------------ #

def test_lockstep_recompile_contract_frozen():
    """Lockstep adds no device grid and no dispatch shape beyond its one
    probe: the port's audit has the reference's probes, its lockstep
    probe dispatches once a wave as the reference's compiles (3 waves),
    and measured at 8 logical shards on the CPU every count is what
    ``expected_counts`` freezes (``test_torch_analysis.py`` holds D=1
    and D=4)."""
    legacy = {"scan_params_reuse", "scan_chunk_churn", "scan_many_qpad",
              "climb_params_reuse", "climb_many_qpad", "grid_rekey"}
    want = expected_compile_counts("pallas", 8)
    d8 = ra.expected_counts("cuda", 8)
    assert set(want) == set(d8["grids"]) == set(d8["dispatches"]) == \
        legacy | {"lockstep_wave_qpad"}
    assert d8["dispatches"]["lockstep_wave_qpad"] == \
        want["lockstep_wave_qpad"] == 3
    assert d8["grids"]["lockstep_wave_qpad"] == 0
    backend = ra.fresh_backend("cuda", device="cpu", devices=["cpu"] * 8)
    assert ra.run_probes(backend) == d8
    assert all(v == 0 for c in ra.expected_counts("torch", 8).values()
               for v in c.values())


# ------------------------- backend lanes ----------------------------------- #

def _lane(p, backend):
    schema = p.random_schema(8, seed=6)
    queries = [p.random_query(schema, k, seed=q)
               for q, k in enumerate((4, 3, 4))]
    broker = p.PlanBroker(backend)
    got = _raqo(p, schema, broker, backend=backend).plan_queries(queries)
    r_seq = _raqo(p, schema, p.PlanBroker(backend), backend=backend)
    exp = [r_seq.joint(q) for q in queries]
    return sigs(got), sigs(exp), broker.counters_snapshot()["waves"]


@pytest.mark.parametrize("lane", ["torch", "float32"])
def test_lockstep_identical_on_lane_backend(lane):
    """Each of the port's lanes plans the batch identically lockstep and
    sequential, and as the reference's numpy lane: the float32 lane (the
    CUDA backend's plain version) re-commits every winner in float64."""
    backend = "torch" if lane == "torch" else CudaPlanBackend(device="cpu")
    got, exp, waves = _lane(PORT, backend)
    want = _lane(REF, "numpy")
    assert got == exp and waves > 0
    assert (got, exp) == want[:2]


def _lockstep_8(p, backend):
    schema = p.random_schema(8, seed=3)
    queries = [p.random_query(schema, k, seed=q)
               for q, k in enumerate((5, 3, 1, 4, 5))]
    b_lock = p.PlanBroker(backend)
    lock = _raqo(p, schema, b_lock, backend=backend).plan_queries(queries)
    b_seq = p.PlanBroker(backend)
    r_seq = _raqo(p, schema, b_seq, backend=backend)
    seq = [r_seq.joint(q) for q in queries]
    return sigs(lock), sigs(seq), b_lock.counters_snapshot(), \
        b_seq.counters_snapshot()


def test_lockstep_parity_at_8_logical_shards():
    """The device-sharded lane: 8 logical shards of the CUDA backend's
    plain version plan what one device plans and what the reference's
    numpy backend plans, lockstep == sequential on plans and searches,
    in fewer waves."""
    lock, seq, sl, ss = _lockstep_8(
        PORT, CudaPlanBackend(device="cpu", devices=["cpu"] * 8))
    assert lock == seq
    assert sl["requests"] - sl["dedup_hits"] == \
        ss["requests"] - ss["dedup_hits"]
    assert sl["waves"] < ss["waves"]
    one = _lockstep_8(PORT, CudaPlanBackend(device="cpu"))
    assert (lock, seq, sl, ss) == one
    assert lock == _lockstep_8(REF, "numpy")[0]
