"""Pass 2 — grid-memo and dispatch audit of the port's planning backends.

The counterpart of ``repro.analysis.recompile_audit``.  The port compiles
nothing at run time (``nvcc`` runs once, at first use:
``kernels/build.py``), so there is no compiled-program memo to audit.
What ``CudaPlanBackend`` caches per request class instead is the device
grid: ``_dims`` keys ``self._grids`` on ``(cluster.dims, device)`` and
builds a missing entry through ``grid_dims``.  Two halves:

**Dynamic sweep.**  A fresh (never the ``get_backend`` singleton) instance
of each backend runs the reference's seven-probe battery on its tiny
grids (``_small_cluster`` / ``_alt_cluster``), through a param-dependent
``Surface`` (the simulator's SMJ: the CUDA backend takes only fns that
carry ``.surface``).  Two things are counted per probe, by wrapping the
module's callables for the sweep only:

* **grids** — calls of ``plan_scan.grid_dims`` (from ``_dims``);
* **dispatches** — calls of ``scan_argmin``, ``scan_argmin_sharded`` and
  ``ensemble_climb``, counted whether the wrapper launches its kernel or
  takes its plain version, so the CPU and the card see the same counts.

The contract is ``expected_counts(name, n_devices)``, derived from the
backend's own geometry: one scan dispatch a flush (one launch of K1/K2 at
``q_per_block(Q)``, or of K4 over the shards), and one climb dispatch a
group of ``ceil(Q / D)`` requests (``CudaPlanBackend._climbs``).  The
``"torch"`` backend builds no device grid and calls no kernel wrapper.

rule ``rebuild-churn`` (error)
    More grid builds than the contract: a varying input leaked into the
    memo key, so recurring requests rebuild (and re-upload) their grid.

rule ``stale-grid`` (error)
    Fewer grid builds than the contract: a varying input is *missing*
    from the key, so a request is scanned over another request's grid.

rule ``launch-churn`` (error)
    More dispatches than one a flush group: the stacked launch was split.

**Static key-coverage check** (``audit_source``).  An AST pass over the
backend sources finds every dict memo — ``self.<memo>[key] = <build>`` in
a function that also looks ``key`` up in ``self.<memo>`` (``.get(key)``
or ``key in``) — and verifies that every value the build reads is
covered by the key: named in it, the same attribute chain (``cluster.
dims``), or derived (transitively, through local assignments) from
covered names.  A name passed to a function of the same module counts as
read through the attribute chains that function reads from the matching
parameter (``grid_dims(cluster, device)`` reads ``cluster.dims``).
Module-level names, builtins and ``self`` (the memo is per instance) are
covered.  ``functools.lru_cache`` memos key on every argument by
construction and need no check.

rule ``unkeyed-memo-input`` (warn)
    A value the build reads is not covered by the key — whatever it
    varies with at run time silently reuses a stale entry.
"""
from __future__ import annotations

import ast
import builtins
import contextlib
import hashlib
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.analysis.report import Finding
from repro_torch.core.cluster import ClusterConditions, ResourceDim

_REPO_ROOT = Path(__file__).resolve().parents[3]
_BACKEND_SOURCES = (
    _REPO_ROOT / "src" / "repro_torch" / "kernels" / "plan_scan.py",
    _REPO_ROOT / "src" / "repro_torch" / "core" / "cost_model.py",
)
_AUDITED_SOURCE = "src/repro_torch/kernels/plan_scan.py"

BACKENDS = ("torch", "cuda")
PROBES = ("scan_params_reuse", "scan_chunk_churn", "scan_many_qpad",
          "climb_params_reuse", "climb_many_qpad", "grid_rekey",
          "lockstep_wave_qpad")
COUNTS = ("grids", "dispatches")
DISPATCHED = ("scan_argmin", "scan_argmin_sharded", "ensemble_climb")

# probe-battery geometry the expectations derive from (keep in sync with
# run_probes / _small_cluster below)
_PROBE_ROWS = 4 * 3                 # _small_cluster grid size
_ALT_ROWS = 3 * 3                   # _alt_cluster grid size
_SCAN_MANY_QS = range(1, 6)         # scan_many_qpad Q sweep
_CLIMB_MANY_QS = range(1, 5)        # climb_many_qpad Q sweep
# lockstep_wave_qpad: two per-query wave sizes, then the stacked
# cross-query union wave (2 + 3 queries' requests in one flush)
_LOCKSTEP_QS = (2, 3, 5)
# scans of each probe, in order: (grid rows, Q) per argmin_grid[_many] call
_SCANS = {
    "scan_params_reuse": [(_PROBE_ROWS, 1)] * 2,
    "scan_chunk_churn": [(_PROBE_ROWS, 1)] * 2,
    "scan_many_qpad": [(_PROBE_ROWS, q) for q in _SCAN_MANY_QS],
    "grid_rekey": [(_PROBE_ROWS, 1), (_ALT_ROWS, 1)],
    "lockstep_wave_qpad": [(_PROBE_ROWS, q) for q in _LOCKSTEP_QS],
}
# climbs of each probe: (Q, sharded over the plan devices?) per call —
# hill_climb_ensemble climbs on the backend's device alone
_CLIMBS = {
    "climb_params_reuse": [(1, False)] * 2,
    "climb_many_qpad": [(q, True) for q in _CLIMB_MANY_QS],
}
# the probes that meet a grid key the sweep has not seen yet
_NEW_GRIDS = {"scan_params_reuse": 1, "grid_rekey": 1}


def climb_groups(Q: int, n_devices: int) -> int:
    """Launches of one ``CudaPlanBackend._climbs`` call: contiguous
    groups of ``ceil(Q / D)`` requests."""
    per = max(1, -(-Q // max(1, n_devices)))
    return len(range(0, Q, per))


def expected_counts(backend_name: str,
                    n_devices: int = 1) -> Dict[str, Dict[str, int]]:
    """The per-probe grid-build and dispatch contract at ``n_devices``
    plan devices (see module docstring)."""
    zero = {p: 0 for p in PROBES}
    if backend_name == "torch":
        return {"grids": dict(zero), "dispatches": dict(zero)}
    if backend_name != "cuda":
        raise ValueError(f"unknown backend {backend_name!r}")
    dispatches = dict(zero)
    for probe, scans in _SCANS.items():
        dispatches[probe] = len(scans)
    for probe, climbs in _CLIMBS.items():
        dispatches[probe] = sum(climb_groups(q, n_devices if sharded else 1)
                                for q, sharded in climbs)
    return {"grids": dict(zero, **_NEW_GRIDS), "dispatches": dispatches}


def expected_launches(n_devices: int = 1) -> Dict[str, int]:
    """Kernel launches the ``"cuda"`` battery makes on the card, by
    wrapper launch counter: one a scan dispatch (K1/K2), or one a
    non-empty shard span (K4) when sharded, and one a climb dispatch."""
    from repro_torch.kernels.plan_scan import shard_spans
    D = max(1, int(n_devices))
    scans = [s for scans in _SCANS.values() for s in scans]
    out = {k: 0 for k in DISPATCHED}
    if D == 1:
        out["scan_argmin"] = len(scans)
    else:
        out["scan_argmin_sharded"] = sum(
            sum(1 for _, n in shard_spans(rows, D) if n) for rows, _ in scans)
    climbs = expected_counts("cuda", D)["dispatches"]
    out["ensemble_climb"] = sum(climbs[p] for p in _CLIMBS)
    return out


def _small_cluster() -> ClusterConditions:
    return ClusterConditions(dims=(ResourceDim("a", 1, 4),
                                   ResourceDim("b", 1, 3)))


def _alt_cluster() -> ClusterConditions:
    return ClusterConditions(dims=(ResourceDim("a", 1, 3),
                                   ResourceDim("b", 1, 3)))


def _make_probe_fn():
    """A fresh param-dependent surface fn per probe (the simulator's SMJ
    over (nc, cs), params [ss, ls]), carrying ``.surface`` as the
    planners' fns do."""
    from repro_torch.core.cost_model import Surface, SimulatorCostModel
    surface = Surface(SimulatorCostModel("SMJ"), "time")

    def probe_fn(cfgs, params):
        return surface(cfgs, params)

    probe_fn.surface = surface
    return probe_fn


def fresh_backend(name: str, device="cpu", devices=None):
    """A NEW backend instance (never the get_backend singleton: the
    audit must count grid builds from a cold memo).  ``"torch"`` is the
    exact float64 CPU backend; ``"cuda"`` runs on ``device`` over
    ``devices`` plan shards."""
    if name == "torch":
        from repro_torch.core.planning_backend import TorchPlanBackend
        return TorchPlanBackend()
    if name == "cuda":
        from repro_torch.kernels.plan_scan import CudaPlanBackend
        return CudaPlanBackend(device=device, devices=devices)
    raise ValueError(f"unknown backend {name!r}")


class _Counted:
    """A callable that counts its calls into ``bump()`` and forwards the
    wrapped wrapper's ``launches`` counter, which the wrapper bumps
    through its module-global name."""

    def __init__(self, fn: Callable, bump: Callable[[], None]):
        self._fn, self._bump = fn, bump

    def __call__(self, *args, **kwargs):
        self._bump()
        return self._fn(*args, **kwargs)

    @property
    def launches(self):
        return self._fn.launches

    @launches.setter
    def launches(self, value):
        self._fn.launches = value


@contextlib.contextmanager
def _counting(counts: Dict[str, Dict[str, int]], label: Dict[str, str]):
    """Wrap ``plan_scan``'s grid builder and kernel wrappers, counting
    into ``counts[kind][label["cur"]]``; restored on exit."""
    from repro_torch.kernels import plan_scan
    names = ("grid_dims",) + DISPATCHED
    orig = {n: getattr(plan_scan, n) for n in names}

    def bump(kind):
        def f():
            counts[kind][label["cur"]] += 1
        return f

    try:
        for n in names:
            setattr(plan_scan, n, _Counted(
                orig[n], bump("grids" if n == "grid_dims" else "dispatches")))
        yield
    finally:
        for n, fn in orig.items():
            setattr(plan_scan, n, fn)


def run_probes(backend) -> Dict[str, Dict[str, int]]:
    """Run the probe battery on ``backend``, counting grid builds and
    kernel dispatches per probe."""
    counts = {c: {p: 0 for p in PROBES} for c in COUNTS}
    label = {"cur": None}
    small, alt = _small_cluster(), _alt_cluster()

    def stack(q):
        return np.stack([[float(i), 0.0] for i in range(1, q + 1)])

    with _counting(counts, label):
        label["cur"] = "scan_params_reuse"
        fn = _make_probe_fn()
        backend.argmin_grid(fn, small, params=np.asarray([1.0, 0.0]))
        backend.argmin_grid(fn, small, params=np.asarray([3.0, 0.0]))

        label["cur"] = "scan_chunk_churn"
        fn = _make_probe_fn()
        backend.argmin_grid(fn, small, params=np.asarray([1.0, 0.0]),
                            chunk_size=8)
        backend.argmin_grid(fn, small, params=np.asarray([1.0, 0.0]),
                            chunk_size=4)

        label["cur"] = "scan_many_qpad"
        fn = _make_probe_fn()
        for q in _SCAN_MANY_QS:
            backend.argmin_grid_many(fn, small, stack(q))

        label["cur"] = "climb_params_reuse"
        fn = _make_probe_fn()
        backend.hill_climb_ensemble(fn, small, params=np.asarray([1.0, 0.0]))
        backend.hill_climb_ensemble(fn, small, params=np.asarray([3.0, 0.0]))

        label["cur"] = "climb_many_qpad"
        fn = _make_probe_fn()
        for q in _CLIMB_MANY_QS:
            backend.hill_climb_ensemble_many(fn, small, stack(q))

        label["cur"] = "grid_rekey"
        fn = _make_probe_fn()
        backend.argmin_grid(fn, small, params=np.asarray([1.0, 0.0]))
        backend.argmin_grid(fn, alt, params=np.asarray([1.0, 0.0]))

        label["cur"] = "lockstep_wave_qpad"
        fn = _make_probe_fn()
        for q in _LOCKSTEP_QS:             # per-query waves, then union
            backend.argmin_grid_many(fn, small, stack(q))
    return counts


def compare_counts(backend_name: str, actual: Dict[str, Dict[str, int]],
                   expected: Dict[str, Dict[str, int]]) -> List[Finding]:
    out: List[Finding] = []
    for probe in PROBES:
        obj = f"{backend_name}.{probe}"
        got = actual["grids"].get(probe, 0)
        want = expected["grids"].get(probe, 0)
        if got > want:
            out.append(Finding(
                rule="rebuild-churn", severity="error",
                path=_AUDITED_SOURCE, line=0, obj=obj,
                message=f"{got} grid builds where the contract expects "
                        f"{want}: a varying input leaked into the grid "
                        "memo key, so recurring requests rebuild their "
                        "device grid"))
        elif got < want:
            out.append(Finding(
                rule="stale-grid", severity="error",
                path=_AUDITED_SOURCE, line=0, obj=obj,
                message=f"{got} grid builds where the contract expects "
                        f"{want}: a varying input is missing from the grid "
                        "memo key, so a request is scanned over a stale "
                        "grid"))
        got = actual["dispatches"].get(probe, 0)
        want = expected["dispatches"].get(probe, 0)
        if got > want:
            out.append(Finding(
                rule="launch-churn", severity="error",
                path=_AUDITED_SOURCE, line=0, obj=obj,
                message=f"{got} kernel dispatches where the contract "
                        f"expects {want} (one a flush group): the stacked "
                        "launch was split"))
    return out


def audit_backends(names: Optional[Sequence[str]] = None, device="cpu",
                   devices=None
                   ) -> Tuple[Dict[str, Dict[str, Dict[str, int]]],
                              List[Finding]]:
    """Dynamic sweep over ``names`` (default: both backends) on fresh
    instances; returns the per-backend count table plus contract
    findings against ``expected_counts`` at the backend's shard count."""
    table: Dict[str, Dict[str, Dict[str, int]]] = {}
    findings: List[Finding] = []
    for name in (names if names is not None else BACKENDS):
        backend = fresh_backend(name, device, devices)
        counts = run_probes(backend)
        table[name] = counts
        n_dev = backend.device_count() if name == "cuda" else 1
        findings.extend(compare_counts(name, counts,
                                       expected_counts(name, n_dev)))
    return table, findings


def table_hash(table: Dict) -> str:
    """Stable short hash of the count table for trend reports."""
    blob = json.dumps(table, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


# ------------------- static memo-key coverage check ------------------------- #

def _chain(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for an attribute chain rooted at a Name, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    return ".".join([node.id] + parts[::-1])


def _reads(node: ast.AST, module_fns: Optional[Dict[str, ast.AST]] = None
           ) -> Set[str]:
    """The longest attribute chains (or bare names) an expression loads,
    minus names it binds itself (comprehension / lambda targets).  With
    ``module_fns``, a name passed to one of them is read through the
    chains that function reads from the matching parameter."""
    out, bound = set(), set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            bound.add(n.id)
        elif isinstance(n, ast.Lambda):
            bound.update(a.arg for a in n.args.args)

    def visit(n):
        if isinstance(n, ast.Attribute):
            c = _chain(n)
            if c is not None:
                out.add(c)
                return
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            out.add(n.id)
            return
        if module_fns and isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Name) and n.func.id in module_fns:
            callee = module_fns[n.func.id]
            params = [a.arg for a in callee.args.args]
            by_param = _param_reads(callee)
            args = list(zip(params, n.args)) + \
                [(kw.arg, kw.value) for kw in n.keywords]
            for name, arg in args:
                if isinstance(arg, ast.Name) and name in by_param:
                    out.update(arg.id + r[len(name):]
                               for r in by_param[name])
                else:
                    visit(arg)
            return
        for child in ast.iter_child_nodes(n):
            visit(child)

    visit(node)
    return {r for r in out if r.split(".")[0] not in bound}


def _covers(chain: str, covered: Set[str]) -> bool:
    """A chain is covered by itself or by any covered prefix of it."""
    parts = chain.split(".")
    return any(".".join(parts[:i]) in covered
               for i in range(1, len(parts) + 1))


def _module_names(tree: ast.Module) -> Set[str]:
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                names |= {n.id for n in ast.walk(t)
                          if isinstance(n, ast.Name)}
    return names


def _local_derivations(fn_node: ast.AST) -> Dict[str, Set[str]]:
    """target name -> chains its assignments read, for every simple
    assignment in the function body (nested defs excluded)."""
    deps: Dict[str, Set[str]] = {}

    def visit(stmts):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.Assign):
                bases = _reads(stmt.value)
                for t in stmt.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) \
                                and isinstance(n.ctx, ast.Store):
                            deps.setdefault(n.id, set()).update(bases)
            elif isinstance(stmt, ast.AugAssign) and \
                    isinstance(stmt.target, ast.Name):
                deps.setdefault(stmt.target.id, set()).update(
                    _reads(stmt.value))
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list):
                    visit([s for s in sub if isinstance(s, ast.stmt)])
    visit(fn_node.body)
    return deps


def _param_reads(fn_node: ast.FunctionDef) -> Dict[str, Set[str]]:
    """parameter -> chains the function reads from it, rebased on the
    parameter (``cluster.dims`` for ``for d in cluster.dims``)."""
    params = [a.arg for a in fn_node.args.args]
    reads = set()
    for stmt in fn_node.body:
        reads |= _reads(stmt)
    return {p: {r for r in reads if r.split(".")[0] == p} for p in params}


def _memo_key(fn_node: ast.AST, memo: str) -> Optional[ast.AST]:
    """The key of a lookup of ``memo`` in the function (``memo.get(k)``
    or ``k in memo`` / ``k not in memo``), or None."""
    for n in ast.walk(fn_node):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "get" and _chain(n.func.value) == memo \
                and n.args:
            return n.args[0]
        if isinstance(n, ast.Compare) and len(n.ops) == 1 \
                and isinstance(n.ops[0], (ast.In, ast.NotIn)) \
                and _chain(n.comparators[0]) == memo:
            return n.left
    return None


def audit_source(path: Path) -> List[Finding]:
    """Static key coverage for every ``self.<memo>[key] = <build>`` dict
    memo in one source file (see module docstring)."""
    path = Path(path)
    source = path.read_text()
    tree = ast.parse(source)
    try:
        rel = str(path.resolve().relative_to(_REPO_ROOT))
    except ValueError:
        rel = str(path)
    module_names = _module_names(tree)
    module_fns = {n.name: n for n in tree.body
                  if isinstance(n, ast.FunctionDef)}

    out: List[Finding] = []
    for fn_node in ast.walk(tree):
        if not isinstance(fn_node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for stmt in ast.walk(fn_node):
            if not isinstance(stmt, ast.Assign):
                continue
            for tgt in stmt.targets:
                if not isinstance(tgt, ast.Subscript):
                    continue
                memo = _chain(tgt.value)
                if memo is None or not memo.startswith("self.") \
                        or _memo_key(fn_node, memo) is None:
                    continue
                out.extend(_audit_memo(fn_node, memo, tgt.slice, stmt.value,
                                       module_names, module_fns, rel))
    return out


def _audit_memo(fn_node, memo: str, key: ast.AST, value: ast.AST,
                module_names: Set[str], module_fns: Dict[str, ast.AST],
                rel: str) -> List[Finding]:
    deps = _local_derivations(fn_node)
    key_reads = _reads(key)
    # a key held in a local (``key = (cluster.dims, device)``) is what
    # that local was assigned from
    for name in list(key_reads):
        key_reads |= deps.get(name, set())
    covered = key_reads | {"self"} | module_names | set(dir(builtins))
    changed = True
    while changed:                     # a local of covered chains only
        changed = False
        for name, bases in deps.items():
            if name not in covered and bases and \
                    all(_covers(b, covered) for b in bases):
                covered.add(name)
                changed = True
    return [Finding(
        rule="unkeyed-memo-input", severity="warn", path=rel,
        line=value.lineno, obj=fn_node.name,
        message=f"'{r}' is read by the {memo} entry's build but not "
                "covered by its key (directly or derived from keyed "
                "inputs) — run-time variation in it silently reuses a "
                "stale entry")
        for r in sorted(_reads(value, module_fns))
        if not _covers(r, covered)]


def audit_sources(paths: Sequence[Path] = _BACKEND_SOURCES
                  ) -> List[Finding]:
    out: List[Finding] = []
    for p in paths:
        if Path(p).exists():
            out.extend(audit_source(p))
    return out
