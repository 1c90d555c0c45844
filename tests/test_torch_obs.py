"""The observability twins (``tests/test_obs.py``): the port's
``repro_torch.obs`` (tracer, metrics, exporters) against the reference's
``repro.obs`` on the same operations — the same events (kinds, names,
depths, arguments, ids; timestamps aside), the same histogram
percentiles and registry snapshots to the bit, the same critical paths
and wave ledgers from the broker — and the reference's contracts on the
port: tracing never perturbs planning, the trace reconciles with the
broker's counters.

The reference's 8-simulated-device lane with ``REPRO_TRACE=1`` is a
subprocess here too, on 8 logical shards of the CUDA backend's plain
version; the port builds no programs, so ``programs_built`` is its grid
memo's builds.
"""
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs as r_obs
import repro_torch.obs as t_obs
from fixtures_torch_planning import PORT, REF, sigs

OBS = {"ref": r_obs, "port": t_obs}
SRC = str(Path(__file__).resolve().parents[1] / "src")


def both_obs(body, *args):
    """``body(p, obs, ...)`` on the reference and on the port."""
    return tuple(body(p, OBS[p.name], *args) for p in (REF, PORT))


@contextlib.contextmanager
def traced(obs):
    """The process-wide tracer and metrics of ``obs`` enabled with fresh
    buffers for one block, then restored to disabled and empty."""
    tr, mx = obs.get_tracer(), obs.get_metrics()
    was = tr.enabled
    tr.reset()
    mx.reset()
    tr.enable()
    try:
        yield tr, mx
    finally:
        tr.enabled = was
        tr.reset()
        mx.reset()


def _shape(events):
    """Events without their clock readings and thread ids."""
    return [{k: v for k, v in e.items()
             if k not in ("ts", "dur", "tid", "pid")} for e in events]


# ------------------------------ tracer ------------------------------------- #

def _disabled(p, obs):
    tr = obs.Tracer(enabled=False)
    sp = tr.span("x", cat="c", payload=1)
    assert sp is obs.NULL_SPAN and sp is tr.span("y")
    assert not sp
    with sp as inner:
        assert inner.set(a=1) is obs.NULL_SPAN
    tr.instant("i")
    tr.complete("c", 0)
    tr.async_begin("w", 1)
    tr.async_end("w", 1)
    return tr.events()


def test_disabled_tracer_returns_shared_null_span():
    assert both_obs(_disabled) == ([], [])


def _alloc_delta(p, obs):
    tr = obs.Tracer(enabled=False)

    def loop(n):
        for i in range(n):
            sp = tr.span("broker.dispatch.group", cat="broker")
            if sp:
                sp.set(mode="grid", q=i)
            with sp:
                pass

    loop(1000)
    gc.collect()
    before = sys.getallocatedblocks()
    loop(20_000)
    gc.collect()
    return sys.getallocatedblocks() - before


def test_disabled_path_is_allocation_free():
    for delta in both_obs(_alloc_delta):
        assert abs(delta) < 50, delta


def _nesting(p, obs):
    tr = obs.Tracer(enabled=True)
    with tr.span("outer", cat="t") as so:
        so.set(k="v")
        with tr.span("inner", cat="t"):
            pass
    outer, inner = tr.spans("outer")[0], tr.spans("inner")[0]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    return _shape(tr.events())


def test_span_nesting_depth_and_containment():
    ref, port = both_obs(_nesting)
    assert port == ref
    outer, inner = port[1], port[0]         # inner closes first
    assert outer["args"] == {"k": "v", "depth": 0}
    assert inner["args"]["depth"] == 1 and outer["ph"] == inner["ph"] == "X"


def _manual(p, obs):
    tr = obs.Tracer(enabled=True)
    tr.complete("manual", time.perf_counter_ns(), cat="c", n=3)
    tr.instant("mark", cat="c")
    tr.async_begin("wave", 7, size=4)
    tr.async_end("wave", 7)
    evs = tr.events()
    assert evs[0]["dur"] >= 0 and evs[2]["ts"] <= evs[3]["ts"]
    out = _shape(evs)
    tr.reset()
    return out, tr.events()


def test_complete_instant_async_events():
    ref, port = both_obs(_manual)
    assert port == ref
    evs, after = port
    assert [e["ph"] for e in evs] == ["X", "i", "b", "e"]
    assert evs[0]["args"]["n"] == 3
    assert evs[2]["id"] == evs[3]["id"] == "7" and after == []


def _threads(p, obs):
    tr = obs.Tracer(enabled=True)
    n_threads, iters = 8, 50
    gate = threading.Barrier(n_threads)

    def work():
        gate.wait()
        for i in range(iters):
            with tr.span("outer", cat="t", i=i):
                with tr.span("inner", cat="t", i=i):
                    pass

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    by_tid = {}
    for e in tr.spans():
        by_tid.setdefault(e["tid"], []).append(e)
    out = []
    for tevs in by_tid.values():
        outers = sorted(e["args"]["i"] for e in tevs
                        if e["name"] == "outer" and e["args"]["depth"] == 0)
        inners = sorted(e["args"]["i"] for e in tevs
                        if e["name"] == "inner" and e["args"]["depth"] == 1)
        out.append((len(tevs), outers == inners == list(range(iters))))
    return sorted(out)


def test_tracer_thread_safety_nested_spans():
    """8 threads x 50 nested span pairs: every event lands, per-thread
    depths stay intact, in both packages alike."""
    ref, port = both_obs(_threads)
    assert port == ref == [(100, True)] * 8


# ------------------------------ metrics ------------------------------------ #

def _hist_single(p, obs):
    h = obs.Histogram()
    empty = (h.percentile(50), h.mean(), h.snapshot())
    for _ in range(10):
        h.observe(2.5e-3)
    return empty, [h.percentile(q) for q in (0, 50, 100)], h.mean(), \
        h.snapshot()


def test_histogram_empty_and_single_value():
    ref, port = both_obs(_hist_single)
    (p50, mean, snap), pcts, m, s = port
    assert math.isnan(p50) and math.isnan(mean)
    assert snap == {"count": 0, "sum": 0.0}
    assert pcts == [pytest.approx(2.5e-3)] * 3 and m == pytest.approx(2.5e-3)
    assert (pcts, m, s) == ref[1:]


def _hist_interp(p, obs):
    h = obs.Histogram()
    vals = [10.0 ** (-6 + i / 25.0) for i in range(100)]   # 1us..~10ms
    for v in vals:
        h.observe(v)
    return vals, [h.percentile(q) for q in (1, 25, 50, 90, 99)], \
        h.snapshot()


def test_histogram_percentile_interpolation_and_bounds():
    ref, port = both_obs(_hist_interp)
    assert port == ref                    # the same buckets, the same bits
    vals, (_, _, p50, _, p99), s = port
    assert min(vals) <= p50 <= p99 <= max(vals)
    exact50 = float(np.percentile(vals, 50))
    assert 0.4 * exact50 <= p50 <= 2.5 * exact50
    assert s["count"] == 100 and s["min"] == min(vals)
    assert s["max"] == max(vals)


def _hist_merge(p, obs):
    a, b = obs.Histogram(), obs.Histogram()
    for v in (1e-4, 2e-4, 3e-4):
        a.observe(v)
    for v in (5e-2, 6e-2):
        b.observe(v)
    a.merge(b)
    with pytest.raises(AssertionError):
        a.merge(obs.Histogram(edges=(1.0, 2.0)))
    return a.count, a.sum, a.min, a.max, a.snapshot()


def test_histogram_merge_is_bucketwise_addition():
    ref, port = both_obs(_hist_merge)
    assert port == ref
    count, total, lo, hi, _ = port
    assert count == 5 and total == pytest.approx(6e-4 + 11e-2)
    assert (lo, hi) == (1e-4, 6e-2)


def _registry(p, obs):
    r = obs.MetricsRegistry()
    assert r.counter("c") is r.counter("c")
    r.counter("c").inc(3)
    r.gauge("g").set(1.5)
    r.histogram("h").observe(0.25)
    with pytest.raises(AssertionError):
        r.gauge("c")                  # name/type conflict
    snap = r.snapshot()
    other = obs.MetricsRegistry()
    other.counter("c").inc(2)
    other.counter("new").inc(1)
    other.histogram("h").observe(0.5)
    r.merge(other)
    merged = r.snapshot()
    r.reset()
    return snap, merged, r.snapshot()


def test_registry_get_or_create_snapshot_merge():
    ref, port = both_obs(_registry)
    assert port == ref
    snap, merged, after = port
    assert list(snap) == sorted(snap)
    assert snap["c"] == 3 and snap["g"] == 1.5 and snap["h"]["count"] == 1
    assert merged["c"] == 5 and merged["new"] == 1
    assert merged["h"]["count"] == 2 and after == {}


# ----------------- PlanningStats.merge field completeness ------------------ #

def _stats_merge(p, obs):
    a, b = p.PlanningStats(), p.PlanningStats()
    want = {}
    for i, f in enumerate(dataclasses.fields(p.PlanningStats)):
        sentinel = 100 + i
        if f.type in ("int", int):
            setattr(b, f.name, sentinel)
            want[f.name] = 2 * sentinel
        elif f.type in ("list", list):
            setattr(b, f.name, [sentinel])
            want[f.name] = [sentinel, sentinel]
        elif f.type in ("dict", dict):
            setattr(b, f.name, {"m|k": {"hits": sentinel}})
            want[f.name] = {"m|k": {"hits": 2 * sentinel,
                                    "misses": 0, "inserts": 0}}
        else:
            pytest.fail(f"unhandled PlanningStats field type: "
                        f"{f.name}: {f.type!r} — extend this test")
    a.merge(b)
    a.merge(b)                        # twice: catches copy-not-add bugs
    for name, expect in want.items():
        assert getattr(a, name) == expect, name
    return vars(a)


def test_planning_stats_merge_covers_every_field():
    """Every field of the port's PlanningStats merges, and the port's
    fields are the reference's."""
    ref, port = both_obs(_stats_merge)
    assert port == ref


# -------------------- broker instrumentation (direct) ---------------------- #

def _batch_fn_np(cfgs, params):
    c = np.asarray(cfgs, dtype=np.float64)
    return (c[:, 0] - params[0]) ** 2 + 0.1 * c[:, 1]


def _batch_fn_torch(cfgs, params):
    c = torch.as_tensor(cfgs).to(torch.float64)
    return (c[:, 0] - params[0]) ** 2 + 0.1 * c[:, 1]


def _req(p, target):
    """One request on the package's one batch fn (requests on one fn
    object and equal params are duplicates)."""
    batch_fn = _batch_fn_torch if p is PORT else _batch_fn_np
    cluster = p.ClusterConditions(dims=(p.ResourceDim("a", 1, 8),
                                        p.ResourceDim("b", 1, 4)))
    return p.PlanRequest(fn=batch_fn, cluster=cluster,
                         params=np.asarray([target]),
                         commit_fn=lambda cfg: float(
                             (cfg[0] - target) ** 2 + 0.1 * cfg[1]),
                         mode="grid")


def _untraced_path(p, obs):
    fut = p.PlanBroker(p.backend).submit(_req(p, 3.0))
    out = fut.result()
    return out, fut.obs, fut.critical_path()


def test_critical_path_none_when_disabled():
    ref, port = both_obs(_untraced_path)
    assert port == ref
    assert port[1] is None and port[2] is None


def _critical(p, obs):
    with traced(obs):
        broker = p.PlanBroker(p.backend)
        f1 = broker.submit(_req(p, 3.0))
        f2 = broker.submit(_req(p, 3.0))     # exact dup -> follower
        broker.flush()
        f3 = broker.submit(_req(p, 3.0))     # memoized -> resolves at submit
        cps = [f.critical_path() for f in (f1, f2, f3)]
    for cp in cps:
        assert all(v >= 0 for k, v in cp.items() if k.endswith("_s"))
    return [(cp["verdict"], cp["wave"], sorted(cp)) for cp in cps]


def test_critical_path_breakdown():
    ref, port = both_obs(_critical)
    assert port == ref
    (v1, w1, k1), (v2, w2, _), (v3, w3, k3) = port
    assert (v1, w1, v2, w2, v3, w3) == ("leader", 1, "follower", 1,
                                        "memo", None)
    assert {"total_s", "queue_s", "execute_s", "commit_s"} <= set(k1)
    assert "queue_s" not in k3


def _pipelined(p, obs):
    with traced(obs) as (tr, _):
        broker = p.PlanBroker(p.backend, double_buffer=True)
        f1 = broker.submit(_req(p, 2.0))
        broker.flush_async()              # dispatch wave 1, no sync
        with tr.span("host.enumerate", cat="test"):
            pass                          # host work overlapped under wave 1
        broker.submit(_req(p, 5.0))
        broker.flush_async()              # commits wave 1, dispatches wave 2
        broker.flush()                    # commits wave 2
        assert f1.done
        evs = tr.events()
        begins = {e["id"]: e for e in evs if e["ph"] == "b"}
        ends = {e["id"]: e for e in evs if e["ph"] == "e"}
        marker = tr.spans("host.enumerate")[0]
        inside = begins["1"]["ts"] <= marker["ts"] and \
            marker["ts"] + marker["dur"] <= ends["1"]["ts"]
        return (sorted(begins), sorted(ends), inside,
                f1.critical_path()["verdict"],
                [(e["ph"], e["name"]) for e in evs if e["ph"] in "be"])


def test_flush_async_wave_interval_encloses_interleaved_host_work():
    ref, port = both_obs(_pipelined)
    assert port == ref
    begins, ends, inside, verdict, _ = port
    assert begins == ends == ["1", "2"] and inside and verdict == "leader"


# ----------------------- invariance & reconciliation ----------------------- #

def _run_lockstep(p, backend=None, n_queries=8):
    backend = backend or p.backend
    schema = p.random_schema(8, seed=3)
    queries = [p.random_query(schema, 2 + q % 4, seed=q)
               for q in range(n_queries)]
    broker = p.PlanBroker(backend)
    r = p.RAQO(schema, cluster=p.paper_cluster(24, 8),
               resource_planning="batched", backend=backend, broker=broker)
    return r.plan_queries(queries), broker


def _summary(plans, broker):
    return (sigs(plans), [a.exec_time for a in plans],
            [dataclasses.asdict(a.stats) for a in plans],
            broker.counters_snapshot())


def test_tracing_never_perturbs_planning():
    """The same plans, PlanningStats and broker counters with the tracer
    off and on, and the reference's."""
    tr = t_obs.get_tracer()
    was = tr.enabled
    tr.disable()
    try:
        base = _summary(*_run_lockstep(PORT))
        with traced(t_obs):
            on = _summary(*_run_lockstep(PORT))
    finally:
        tr.enabled = was
    assert on == base
    assert base == _summary(*_run_lockstep(REF))


def _reconcile(p, obs, tmp_path):
    with traced(obs) as (tr, mx):
        plans, broker = _run_lockstep(p)
        cs = broker.counters_snapshot()
        ws = obs.wave_summary(tr, mx)
        per_wave = {sp["args"]["wave"]: sp["args"]["size"]
                    for sp in tr.spans("broker.wave")}
        path = obs.write_chrome_trace(tmp_path / f"{p.name}.json", tr)
        doc = json.loads(path.read_text())
        md = obs.attribution_md(plans, tr, mx)
    geometry = {k: ws[k] for k in ("waves", "wave_sizes", "max_wave")}
    counts = {s: ws[s]["count"] for s in ("request", "wave_assembly",
                                          "wave_execute", "wave_commit")}
    return cs, ws, geometry, counts, per_wave, doc, md, len(plans)


def test_wave_spans_reconcile_with_counters(tmp_path):
    """The trace and the counters describe the same run: wave geometry,
    request and stage counts, per-wave sizes, a valid chrome trace with
    balanced async pairs, one attribution row a query; and the port's
    ledger, geometry and counts are the reference's."""
    ref, port = both_obs(_reconcile, tmp_path)
    cs, ws, geometry, counts, per_wave, doc, md, n = port
    assert (cs, geometry, counts, per_wave) == \
        (ref[0], ref[2], ref[3], ref[4])
    assert geometry == {k: cs[k] for k in ("waves", "wave_sizes",
                                           "max_wave")}
    assert cs["waves"] > 0
    assert ws["mean_wave"] == pytest.approx(cs["mean_wave"], abs=1e-3)
    assert counts["request"] == cs["requests"]
    assert counts["wave_assembly"] == cs["waves"]
    assert counts["wave_execute"] == counts["wave_commit"]
    assert 0 < counts["wave_execute"] <= cs["waves"]
    for stage in ("request", "wave_assembly", "wave_execute",
                  "wave_commit"):
        assert ws[stage]["p50_s"] <= ws[stage]["p99_s"]
    assert sorted(per_wave) == list(range(1, cs["waves"] + 1))
    assert doc["traceEvents"] and doc["displayTimeUnit"] == "ms"
    begins = sorted(e["id"] for e in doc["traceEvents"] if e["ph"] == "b")
    ends = sorted(e["id"] for e in doc["traceEvents"] if e["ph"] == "e")
    assert begins == ends
    assert md.count("\n| ") >= n and "## Broker critical path" in md


# ------------------ 8 logical shards (REPRO_TRACE=1) ----------------------- #

_TRACED_DRIVER = """
import json
from repro_torch.core.cluster import paper_cluster
from repro_torch.core.plan_broker import PlanBroker
from repro_torch.core.raqo import RAQO
from repro_torch.core.schema import random_query, random_schema
from repro_torch.kernels.plan_scan import CudaPlanBackend
from repro_torch.obs import get_tracer, wave_summary

assert get_tracer().enabled          # REPRO_TRACE=1 import-time path
backend = CudaPlanBackend(device="cpu", devices=["cpu"] * 8)
schema = random_schema(8, seed=3)
queries = [random_query(schema, k, seed=q)
           for q, k in enumerate((5, 3, 1, 4, 5))]
broker = PlanBroker(backend)
raqo = RAQO(schema, cluster=paper_cluster(24, 8), backend=backend,
            resource_planning="batched", broker=broker)
plans = raqo.plan_queries(queries)
cs = broker.counters_snapshot()
ws = wave_summary()
out = {"devices": backend.device_count(),
       "planned": sum(p.plan is not None for p in plans),
       "waves_match": ws["waves"] == cs["waves"] > 0,
       "sizes_match": ws["wave_sizes"] == cs["wave_sizes"],
       "requests_match": ws["request"]["count"] == cs["requests"],
       "grids_built": len(backend._grids),
       "events": len(get_tracer().events())}
out["ok"] = (out["planned"] == len(queries) and out["waves_match"]
             and out["sizes_match"] and out["requests_match"]
             and out["grids_built"] > 0 and out["events"] > 0)
print(json.dumps(out))
"""


def test_traced_lockstep_at_8_logical_shards():
    """Tracing enabled through the environment: wave spans and the
    request histogram reconcile with the broker's counters at 8 logical
    shards, in a process that imports no JAX."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["REPRO_TRACE"] = "1"
    env.pop("REPRO_PLAN_DEVICES", None)
    proc = subprocess.run([sys.executable, "-c", _TRACED_DRIVER],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["devices"] == 8
    assert out["ok"], out
