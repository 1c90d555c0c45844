"""Golden tests for the port's plan-lint (``repro_torch.analysis``), the
twins of tests/test_analysis.py: every rule is exercised on a
deliberately broken torch fixture (tests/fixtures_torch_plan_lint.py)
asserting the exact rule id, severity and line, and the shipped port is
asserted clean (no unallowed warn or error) so ``--fail-on warn`` stays
meaningful.  The grid-memo audit runs the CUDA backend's wrappers on CPU
tensors (``CudaPlanBackend(device="cpu")``), where they take their plain
versions; its counts are the ones the card sees.  One test holds every
cost surface the reference registers against the port's at float64.
"""
import itertools
import json

import numpy as np
import pytest
import torch

import fixtures_torch_plan_lint as fx
from repro.analysis import registry as rregistry
from repro_torch.analysis import recompile_audit as ra
from repro_torch.analysis.__main__ import append_history, main
from repro_torch.analysis.hotpath_lint import lint_file, lint_tree
from repro_torch.analysis.registry import (CostSurface, hot_path,
                                           iter_cost_surfaces, surface_names)
from repro_torch.analysis.report import (Finding, apply_pragmas,
                                         parse_pragmas, pragma_findings,
                                         render_report, summarize)
from repro_torch.analysis.surface_lint import (TRACE_ROWS, lint_cost_fn,
                                               lint_registered, lint_surface,
                                               trace_configs)
from repro_torch.core import cost_model as cm
from repro_torch.core.cluster import paper_cluster
from repro_torch.core.roofline import HW, RooflineCost
from repro_torch.core.sharding_planner import TpuCluster
from repro_torch.kernels import plan_scan

FIXTURE_SRC = open(fx.__file__).read()
CONFIGS = np.array([[n, 1 + n % 3] for n in range(1, TRACE_ROWS + 1)])
PARAMS = (2.0, 0.5)


def lint(fn, name):
    return lint_cost_fn(fn, CONFIGS, PARAMS, name=name)


def fixture_line(needle, exact=False):
    """1-based line of the first fixture source line containing needle."""
    for i, text in enumerate(FIXTURE_SRC.splitlines(), start=1):
        if (text.strip() == needle) if exact else (needle in text):
            return i
    raise AssertionError(f"marker {needle!r} not in fixture")


def only(findings):
    assert len(findings) == 1, [f.render() for f in findings]
    return findings[0]


def assert_only(findings, rule, severity, line):
    f = only(findings)
    assert (f.rule, f.severity, f.line) == (rule, severity, line), f.render()
    return f


# ------------------------- pass 1: surface lint ---------------------------- #

@pytest.mark.parametrize("fn,rule,severity", [
    (fx.fn_host_branch, "host-branch", "error"),
    (fx.fn_dtype_follow, "dtype-follow", "warn"),
    (fx.fn_low_precision, "dtype", "error"),
    (fx.fn_multi_output, "dtype", "error"),
    (fx.fn_wrong_shape, "dtype", "error"),
    (fx.fn_int_output, "dtype", "error"),
    (fx.fn_cross_reduce, "cross-config-reduce", "error"),
    (fx.fn_cross_sort, "cross-config-reduce", "error"),
], ids=lambda v: getattr(v, "__name__", None))
def test_surface_fixture_gives_exactly_its_rule(fn, rule, severity):
    f = assert_only(lint(fn, "fx"), rule, severity,
                    fn.__code__.co_firstlineno)
    assert f.path.endswith("tests/fixtures_torch_plan_lint.py")


def test_host_branch_names_the_host_read():
    f = only(lint(fx.fn_host_branch, "fx/host-branch"))
    assert "_local_scalar_dense" in f.message


def test_low_precision_names_the_dtype():
    assert "float16" in only(lint(fx.fn_low_precision, "fx/f16")).message


def test_multi_output_message():
    assert "2 outputs" in only(lint(fx.fn_multi_output, "fx/m")).message


def test_dtype_follow_only_at_float64_params():
    f = only(lint(fx.fn_dtype_follow, "fx/follow"))
    assert "torch.float32 for torch.float64 params" in f.message


def test_scalar_closure_capture_warns():
    fn = fx.make_fn_scalar_capture()
    assert_only(lint(fn, "fx/capture"), "closure-capture", "warn",
                fn.__code__.co_firstlineno)


def test_array_closure_capture_errors():
    fn = fx.make_fn_array_capture()
    f = assert_only(lint(fn, "fx/capture-array"), "closure-capture",
                    "error", fn.__code__.co_firstlineno)
    assert "(7,)" in f.message


def test_clean_surface_has_no_findings():
    """clamp_min, min.other and a sum over the dims axis are elementwise
    per configuration: matched by op name, never by substring."""
    assert lint(fx.make_fn_clean(), "fx/clean") == []


def test_no_surface_descriptor_is_an_error():
    s = CostSurface(name="fx/no-surface", domain="db",
                    make_fn=fx.make_fn_clean, make_cluster=paper_cluster,
                    params=PARAMS)
    fn = fx.make_fn_clean()
    assert_only(lint_surface(s), "no-surface", "error",
                fn.__code__.co_firstlineno)


def test_registered_surfaces_lint_clean():
    """Zero false positives on every shipped cost surface."""
    findings = lint_registered()
    assert findings == [], [f.render() for f in findings]
    names = {s.name for s in iter_cost_surfaces()}
    assert {"db/paper/SMJ", "db/paper/BHJ", "db/sim/SMJ", "db/sim/BHJ",
            "tpu/roofline/train", "tpu/roofline/prefill",
            "tpu/roofline/decode"} <= names


def _surface_fn(surface):
    def fn(cfgs, params):
        return surface(cfgs, params)
    fn.surface = surface
    return fn


@pytest.mark.parametrize("objective", ["money", "sla"])
@pytest.mark.parametrize("models", ["paper", "simreg", "sim"])
def test_db_objectives_lint_clean(models, objective):
    """Every DB model under the money and SLA wraps the kernel mirrors."""
    ms = {"paper": cm.paper_models, "simreg": cm.simulator_models,
          "sim": cm.simulator_cost_models}[models]()
    cfgs = trace_configs(paper_cluster())
    for impl in ("SMJ", "BHJ"):
        fn = _surface_fn(cm.Surface(ms[impl], objective))
        assert lint_cost_fn(fn, cfgs, (2.0, 74.0, 30.0),
                            name=f"{models}/{impl}/{objective}") == []


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_roofline_chip_seconds_lint_clean(kind):
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig(name=kind, seq_len=512, global_batch=8, kind=kind)
    cfg = REGISTRY["qwen3-moe-30b-a3b"].smoke()
    fn = _surface_fn(cm.Surface(RooflineCost(cfg, shape, {}, HW),
                                "chip_seconds"))
    cfgs = trace_configs(TpuCluster().dims(shape))
    assert lint_cost_fn(fn, cfgs, (64.0, 256.0), name=kind) == []


def test_cost_table_surface_lints_clean():
    """A CostTable's own table is the kernel's table input, not a
    capture — also when it was copied to the device by an earlier call."""
    cluster = paper_cluster(7, 3)
    costs = np.random.default_rng(0).uniform(1, 9, (7, 3))
    fn = _surface_fn(cm.Surface(cm.CostTable.of(cluster, costs)))
    cfgs = trace_configs(cluster)
    assert lint_cost_fn(fn, cfgs, (0.5,), name="table") == []
    assert lint_cost_fn(fn, cfgs, (0.5,), name="table") == []


def _all_configs(cluster):
    return np.array(list(itertools.product(*(d.grid()
                                             for d in cluster.dims))))


def test_registered_surfaces_equal_the_reference():
    """Every surface the reference registers is registered by the port
    under its name, and the port's fn at float64 equals the reference's
    ``make_fn(np)`` on every configuration of its grid."""
    import repro.core.cost_model    # noqa: F401 — registers DB surfaces
    import repro.core.roofline      # noqa: F401 — registers rooflines
    port = {s.name: s for s in iter_cost_surfaces()}
    ref_names = rregistry.surface_names()
    assert len(ref_names) == 7
    assert set(ref_names) <= set(surface_names())
    for rs in rregistry.iter_cost_surfaces():
        ps = port[rs.name]
        assert tuple(ps.params) == tuple(rs.params), rs.name
        assert ps.domain == rs.domain
        cfgs = _all_configs(rs.make_cluster())
        np.testing.assert_array_equal(cfgs, _all_configs(ps.make_cluster()))
        params = np.asarray(rs.params, dtype=np.float64)
        want = np.asarray(rs.make_fn(np)(cfgs, params))
        got = ps.make_fn()(torch.as_tensor(cfgs),
                           torch.as_tensor(params)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=rs.name)


# ---------------------- pass 3: hot-path host-sync ------------------------- #

@pytest.fixture(scope="module")
def hot_findings():
    return lint_file(fx.__file__)


def of(findings, obj):
    return [f for f in findings if f.obj == obj]


def test_hot_loop_sync_is_warn(hot_findings):
    f = only([f for f in of(hot_findings, "hot_loop_sync")
              if f.severity == "warn"])
    assert (f.rule, f.line) == ("host-sync",
                                fixture_line("out.append(v.item())"))
    assert not f.allowed


def test_hot_depth_zero_sync_is_info(hot_findings):
    f = only([f for f in of(hot_findings, "hot_loop_sync")
              if f.severity == "info"])
    assert (f.rule, f.line) == ("host-sync",
                                fixture_line("return values.cpu()"))


def test_pragma_allows_with_reason(hot_findings):
    f = only(of(hot_findings, "hot_allowed_fold"))
    assert f.rule == "host-sync"
    assert f.allowed
    assert "justified fold" in f.allow_reason


def test_cold_function_not_linted(hot_findings):
    assert not of(hot_findings, "cold_loop_sync")


def test_sync_budget_overrun_warns_at_fn_head(hot_findings):
    """Two depth-zero syncs against folds=1 -> one sync-budget warn at
    the function head (plus the two underlying host-sync infos)."""
    fs = of(hot_findings, "hot_over_budget")
    infos = [f for f in fs if f.rule == "host-sync"]
    assert [(f.severity, f.line) for f in infos] == [
        ("info", fixture_line("ca = a.cpu()")),
        ("info", fixture_line("cb = b.tolist()"))]
    f = only([f for f in fs if f.rule == "sync-budget"])
    assert (f.severity, f.line) == (
        "warn", fixture_line("def hot_over_budget(a, b):"))
    assert "folds=1" in f.message


@pytest.mark.parametrize("obj,needle", [
    ("hot_host_tracked_decode", "costs = device_costs.cpu().numpy()"),
    ("hot_tuple_host_decode", "idx, cost = (torch.cat("),
    ("hot_admission_loop", "wave = wave_costs.cpu()"),
])
def test_host_copy_then_free_decode_stays_in_budget(hot_findings, obj,
                                                    needle):
    """float() on a name assigned from a .cpu()/.numpy() copy (each name
    of a tuple target too) is a free host read: only the copy itself is
    flagged, and the folds=1 budget holds."""
    f = assert_only(of(hot_findings, obj), "host-sync", "info",
                    fixture_line(needle))
    assert ".cpu()" in f.message and not f.allowed


@pytest.mark.parametrize("obj", ["hot_numpy_params", "hot_int_bool",
                                 "hot_traced_clean"])
def test_free_hot_paths_lint_clean(hot_findings, obj):
    """np.asarray of host params is no sync, int()/bool() are not
    flagged, and obs payloads are sync-free: zero findings, and each
    folds=0 budget holds."""
    assert not of(hot_findings, obj)


def test_every_copy_and_wait_kind_is_a_sync(hot_findings):
    fs = of(hot_findings, "hot_sync_kinds")
    needles = ['a = x.to("cpu")', 'b = x.to(device="cpu")',
               'c = x.to(torch.device("cpu"))', "torch.cuda.synchronize()",
               "ev.synchronize()"]
    assert [(f.rule, f.severity, f.line) for f in fs] == [
        ("host-sync", "info", fixture_line(n)) for n in needles]


def test_data_dependent_shapes_in_a_loop_warn(hot_findings):
    fs = of(hot_findings, "hot_data_dependent")
    needles = ["out.append(torch.nonzero(x))", "out.append(x.nonzero())",
               "out.append(torch.masked_select(x, mask))",
               "out.append(torch.unique(x))"]
    assert [(f.rule, f.severity, f.line) for f in fs] == [
        ("host-sync", "warn", fixture_line(n)) for n in needles]


def test_obs_exemption_does_not_leak(hot_findings):
    f = assert_only(of(hot_findings, "hot_traced_still_syncs"), "host-sync",
                    "warn", fixture_line("out.append(c.item())"))
    assert not f.allowed


def test_reasonless_pragma_flagged(hot_findings):
    line = fixture_line("# plan-lint: allow(host-sync)", exact=True)
    f = only([f for f in hot_findings if f.rule == "pragma-no-reason"])
    assert (f.severity, f.line) == ("warn", line)


def test_shipped_tree_hot_paths_clean():
    """No unallowed warn+ findings in src/repro_torch, and the two
    deliberate folds are where the budgets say."""
    findings = lint_tree()
    bad = [f for f in findings if not f.allowed and f.severity != "info"]
    assert bad == [], [f.render() for f in bad]
    folds = {f.obj for f in findings if f.rule == "host-sync"}
    assert folds == {"CudaPlanBackend.argmin_grid_many_async",
                     "CudaPlanBackend._climbs"}


def test_climb_fold_is_budgeted_where_it_is():
    assert plan_scan.CudaPlanBackend._climbs.__plan_lint_hot_folds__ == 1


def test_hot_path_decorator_requires_reason():
    with pytest.raises(ValueError):
        hot_path("")

    @hot_path("why this is hot")
    def g(x):
        return x

    assert g(3) == 3
    assert g.__plan_lint_hot_reason__ == "why this is hot"


# ------------------- pass 2 (static): memo-key coverage -------------------- #

UNKEYED_SRC = '''\
class FakeBackend:
    def dims(self, cluster, device, nonce):
        key = (cluster.dims, device)
        dims = self._grids.get(key)
        if dims is None:
            dims = self._grids[key] = build(cluster, nonce)
        return dims


def build(cluster, nonce):
    return [nonce for d in cluster.dims]
'''

KEYED_SRC = UNKEYED_SRC.replace("key = (cluster.dims, device)",
                                "key = (cluster.dims, device, nonce)")

CHAIN_SRC = UNKEYED_SRC.replace("key = (cluster.dims, device)",
                                "key = (cluster.name, nonce)")

DERIVED_SRC = '''\
class FakeTable:
    def on(self, device, dtype):
        key = (str(device), dtype)
        if key not in self._on:
            dt = dtype
            self._on[key] = [x for x in self.costs if x.dtype == dt]
        return self._on[key]
'''


def test_unkeyed_memo_input_flagged(tmp_path):
    p = tmp_path / "fake_backend.py"
    p.write_text(UNKEYED_SRC)
    f = only(ra.audit_source(p))
    assert (f.rule, f.severity, f.line) == ("unkeyed-memo-input", "warn", 6)
    assert f.obj == "dims" and "'nonce'" in f.message


def test_keyed_memo_clean(tmp_path):
    p = tmp_path / "fake_backend.py"
    p.write_text(KEYED_SRC)
    assert ra.audit_source(p) == []


def test_callee_attribute_chain_must_be_keyed(tmp_path):
    """build() reads cluster.dims: a key on cluster.name does not cover
    it, though it names the same object."""
    p = tmp_path / "fake_backend.py"
    p.write_text(CHAIN_SRC)
    f = only(ra.audit_source(p))
    assert (f.rule, f.line) == ("unkeyed-memo-input", 6)
    assert "'cluster.dims'" in f.message


def test_derivation_through_locals_is_covered(tmp_path):
    """Locals derived from keyed inputs, comprehension targets and self
    (the memo is per instance) are covered."""
    p = tmp_path / "fake_table.py"
    p.write_text(DERIVED_SRC)
    assert ra.audit_source(p) == []


def test_shipped_backend_sources_are_keyed():
    assert ra.audit_sources() == []


# ------------------- pass 2 (dynamic): grid-memo audit --------------------- #

FROZEN_D1 = {
    "grids": {"scan_params_reuse": 1, "scan_chunk_churn": 0,
              "scan_many_qpad": 0, "climb_params_reuse": 0,
              "climb_many_qpad": 0, "grid_rekey": 1,
              "lockstep_wave_qpad": 0},
    "dispatches": {"scan_params_reuse": 2, "scan_chunk_churn": 2,
                   "scan_many_qpad": 5, "climb_params_reuse": 2,
                   "climb_many_qpad": 4, "grid_rekey": 2,
                   "lockstep_wave_qpad": 3}}


def test_lockstep_grid_contract_frozen():
    """Lockstep adds no device grid and no dispatch beyond one a flush
    group: its probe (lockstep_wave_qpad) dispatches once per wave,
    per-query or stacked, and every probe's counts are frozen here at D=1
    and at four logical shards, where only the climb sweep splits."""
    assert ra.expected_counts("cuda", 1) == FROZEN_D1
    d4 = ra.expected_counts("cuda", 4)
    assert d4["grids"] == FROZEN_D1["grids"]
    assert d4["dispatches"] == dict(FROZEN_D1["dispatches"],
                                    climb_many_qpad=1 + 2 + 3 + 4)
    for n in (1, 4):
        t = ra.expected_counts("torch", n)
        assert set(t) == {"grids", "dispatches"}
        assert all(v == 0 for c in t.values() for v in c.values())


def test_expected_launches_follow_the_geometry():
    """One launch a scan dispatch at D=1; the probe grids (12 and 9 rows)
    fit one tile, so each sharded dispatch launches one non-empty span."""
    assert ra.expected_launches(1) == {"scan_argmin": 14,
                                       "scan_argmin_sharded": 0,
                                       "ensemble_climb": 6}
    assert ra.expected_launches(4) == {"scan_argmin": 0,
                                       "scan_argmin_sharded": 14,
                                       "ensemble_climb": 12}


def test_compare_counts_churn_stale_and_launch_churn():
    exp = ra.expected_counts("cuda", 1)

    def with_(kind, probe, delta):
        t = json.loads(json.dumps(exp))
        t[kind][probe] += delta
        return t

    f = only(ra.compare_counts("cuda", with_("grids", "grid_rekey", 1), exp))
    assert (f.rule, f.severity, f.obj) == ("rebuild-churn", "error",
                                           "cuda.grid_rekey")
    f = only(ra.compare_counts("cuda", with_("grids", "grid_rekey", -1),
                               exp))
    assert (f.rule, f.severity) == ("stale-grid", "error")
    f = only(ra.compare_counts(
        "cuda", with_("dispatches", "scan_many_qpad", 1), exp))
    assert (f.rule, f.severity, f.obj) == ("launch-churn", "error",
                                           "cuda.scan_many_qpad")
    assert ra.compare_counts("cuda", exp, exp) == []


def test_torch_backend_builds_and_dispatches_nothing():
    counts = ra.run_probes(ra.fresh_backend("torch"))
    assert counts == ra.expected_counts("torch")
    assert set(counts["grids"]) == set(ra.PROBES)


@pytest.mark.parametrize("devices", [None, ["cpu"] * 4],
                         ids=["D1", "D4"])
def test_cuda_backend_counts_match_contract(devices):
    """The CUDA backend's wrappers on CPU tensors: the counts the card
    sees, and the wrappers are restored afterwards with their launch
    counters untouched (the plain versions launch nothing)."""
    orig = {n: getattr(plan_scan, n) for n in ("grid_dims",) + ra.DISPATCHED}
    before = {n: orig[n].launches for n in ra.DISPATCHED}
    backend = ra.fresh_backend("cuda", "cpu", devices)
    counts = ra.run_probes(backend)
    assert counts == ra.expected_counts("cuda", backend.device_count())
    assert backend.device_count() == (4 if devices else 1)
    assert {n: getattr(plan_scan, n) for n in orig} == orig
    assert {n: orig[n].launches for n in ra.DISPATCHED} == before


def test_audit_backends_table_and_findings():
    table, findings = ra.audit_backends(device="cpu")
    assert findings == []
    assert table == {n: ra.expected_counts(n) for n in ra.BACKENDS}


def test_table_hash_is_stable_and_sensitive():
    t = {"cuda": {"grids": {"p": 1}}, "torch": {"grids": {"p": 0}}}
    h = ra.table_hash(t)
    assert h == ra.table_hash({"torch": {"grids": {"p": 0}},
                               "cuda": {"grids": {"p": 1}}})
    assert h != ra.table_hash({"cuda": {"grids": {"p": 2}},
                               "torch": {"grids": {"p": 0}}})
    assert len(h) == 12


# --------------------------- report / pragmas ------------------------------ #

def test_parse_pragmas_covers_own_and_next_line():
    src = ("x = 1\n# plan-lint: allow(dtype, dtype-follow): known "
           "promotion\ny = 2\nz = 3\n")
    pragmas = parse_pragmas(src)
    assert set(pragmas) == {2, 3}
    rules, reason = pragmas[3]
    assert rules == ("dtype", "dtype-follow")
    assert reason == "known promotion"


def test_apply_pragmas_matches_rule_and_line():
    src = "# plan-lint: allow(dtype): fine here\ny = 2\n"
    hit = Finding(rule="dtype", severity="error", path="f.py", line=2,
                  obj="g", message="m")
    wrong_rule = Finding(rule="dtype-follow", severity="warn", path="f.py",
                         line=2, obj="g", message="m")
    far = Finding(rule="dtype", severity="error", path="f.py", line=4,
                  obj="g", message="m")
    apply_pragmas([hit, wrong_rule, far], {"f.py": src})
    assert hit.allowed and hit.allow_reason == "fine here"
    assert not wrong_rule.allowed
    assert not far.allowed


def test_summarize_excludes_allowed():
    a = Finding(rule="dtype", severity="error", path="f.py", line=1,
                obj="g", message="m", allowed=True, allow_reason="r")
    b = Finding(rule="host-sync", severity="warn", path="f.py", line=2,
                obj="g", message="m")
    s = summarize([a, b])
    assert s["by_severity"] == {"info": 0, "warn": 1, "error": 0}
    assert s["by_rule"] == {"host-sync": 1}
    assert s["allowed"] == 1 and s["total"] == 2


def test_pragma_findings_only_reasonless():
    src = ("# plan-lint: allow(dtype): ok\n"
           "# plan-lint: allow(dtype)\n")
    fs = pragma_findings("f.py", src)
    assert [f.line for f in fs] == [2]
    assert fs[0].rule == "pragma-no-reason"


def test_render_report_prints_both_counts():
    text = render_report([], {"cuda": ra.expected_counts("cuda")}, "abc")
    assert "grid-memo audit table (hash abc)" in text
    assert "cuda  grids      climb_many_qpad=0" in text
    assert "cuda  dispatches climb_many_qpad=4" in text


# ------------------------------- CLI --------------------------------------- #

def test_cli_clean_tree_exits_zero(tmp_path):
    out = tmp_path / "plan_lint.json"
    rc = main(["--device", "cpu", "--fail-on", "warn", "--json", str(out)])
    assert rc == 0
    payload = json.loads(out.read_text())
    assert payload["summary"]["by_severity"]["warn"] == 0
    assert payload["summary"]["by_severity"]["error"] == 0
    assert all(f["allow_reason"] for f in payload["findings"]
               if f["allowed"])
    assert payload["audit_counts"] == {n: ra.expected_counts(n)
                                       for n in ra.BACKENDS}
    assert {"findings", "summary", "audit_counts", "table_hash"} \
        <= set(payload)


def test_cli_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(["--skip-audit"])


def test_history_appends_under_the_given_path(tmp_path):
    path = tmp_path / "BENCH_port_plan_lint.json"
    table = {"cuda": ra.expected_counts("cuda")}
    for _ in range(2):
        append_history([], table, ra.table_hash(table), path=path)
    doc = json.loads(path.read_text())
    assert doc["bench"] == "port_plan_lint" and len(doc["history"]) == 2
    snap = doc["history"][-1]
    assert snap["audit.cuda.dispatches.scan_many_qpad"] == 5.0
    assert snap["error"] == 0.0
    assert doc["table_hash"] == ra.table_hash(table)
