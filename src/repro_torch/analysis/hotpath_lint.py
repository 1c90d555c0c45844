"""Pass 3 — AST host-sync lint over the port's designated hot paths.

The counterpart of ``repro.analysis.hotpath_lint``, with rules written for
torch and CUDA.  Hot paths are functions decorated ``@hot_path("reason")``
(``repro_torch.analysis.registry``): the broker flush machinery, the
lockstep drivers, the admission wave, and the CUDA backend's scan and
climb drivers.  Inside them — including nested ``def``s — these calls
force a device->host synchronization when their operand is a CUDA tensor,
and are flagged:

    x.item()   x.tolist()   x.cpu()   x.to("cpu")   x.to(device="cpu")
    x.to(torch.device("cpu"))   torch.cuda.synchronize()
    event.synchronize() / stream.synchronize()   float(x)
    torch.nonzero(x) / x.nonzero()   torch.masked_select(x, m)
    torch.unique(x) / x.unique()

(the last three return a tensor whose shape depends on the data, so the
host waits for the device to learn it).

rule ``host-sync``
    * **warn** when the call sits inside a ``for``/``while`` loop of the
      hot function: a sync per chunk/iteration serializes the async
      launch pipeline.
    * **info** at loop depth zero: one deliberate sync per call is the
      documented pattern (fold once at the end); it stays visible in the
      report without failing ``--fail-on warn``.

Loop depth counts ``for``/``while`` statements, as the reference counts
it: a comprehension is not a loop here.

**Host values.**  ``np.asarray(...)`` is not a sync in the port: numpy
cannot read a CUDA tensor (it raises), so on a hot path it only ever
converts host data.  It is, with ``.numpy()``, ``.tolist()`` and
``.cpu()``, a *source* of host values: a name assigned from an
expression holding one of them (every name of a tuple target, too),
aliased from such a name, or a loop target iterating one, holds host
data, and ``float(x)``, ``x.item()`` and ``x.tolist()`` on it are free —
e.g. the per-request decode loop reading a ``(2, Q)`` result that one
``.cpu()`` copied.  The ``.cpu()`` itself is still the flagged sync.

**``int()`` and ``bool()`` are not flagged.**  In these functions they
take Python values (counts, flat ids already on the host, flags) far more
often than tensors, and flagging them would bury the real syncs; a
``bool()`` of a CUDA tensor on a hot path is the one pattern this pass
does not see.

rule ``sync-budget``
    ``@hot_path(..., folds=N)`` declares the function's depth-zero
    host-sync budget: the documented end-of-flush fold sites.  When the
    visitor finds MORE depth-zero syncs than declared, a **warn** fires
    at the function head.

**Obs calls are sync-free.**  The tracing/metrics layer
(``repro_torch.obs``) records monotonic clocks only, so span and metric
calls rooted at the conventional singleton bindings (``_obs`` /
``_metrics`` / ``get_tracer()`` / ``get_metrics()``, plus ``with
_obs.span(...) as sp`` aliases) are skipped entirely, arguments included.

Suppressions use the inline pragma — ``# plan-lint:`` then
``allow(host-sync): reason`` — on the offending line or the line above;
a pragma without a reason is a ``pragma-no-reason`` warning (report.py).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.report import (Finding, apply_pragmas,
                                         pragma_findings)

NP_MODULE_NAMES = {"np", "numpy"}
TORCH_MODULE_NAMES = {"torch"}
# method calls that end in host data (the value is on the host after them)
HOST_SOURCE_ATTRS = {"numpy", "tolist", "cpu"}
# method calls that sync; .tolist()/.item() on a host name are free
SYNC_ATTRS = {
    "item": ".item() pulls a scalar to the host",
    "tolist": ".tolist() copies to the host",
    "cpu": ".cpu() copies to the host",
    "synchronize": ".synchronize() blocks on the device",
    "nonzero": ".nonzero() has a data-dependent shape",
    "masked_select": ".masked_select() has a data-dependent shape",
    "unique": ".unique() has a data-dependent shape",
}
# torch.<fn>(x) forms with a data-dependent output shape
TORCH_DATA_SHAPE = {"nonzero", "masked_select", "unique"}
FREE_ON_HOST = {"item", "tolist"}

# obs (repro_torch.obs) span/metric calls are sync-free by contract (see
# the module docstring); the roots are the unambiguous conventional
# bindings only
OBS_ROOT_NAMES = {"_obs", "_tracer", "_metrics",
                  "get_tracer", "get_metrics"}

_REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_TREE = _REPO_ROOT / "src" / "repro_torch"


def _is_hot_decorator(dec: ast.expr) -> bool:
    """``@hot_path("...")`` — possibly attribute-qualified."""
    if isinstance(dec, ast.Call):
        dec = dec.func
    if isinstance(dec, ast.Name):
        return dec.id == "hot_path"
    if isinstance(dec, ast.Attribute):
        return dec.attr == "hot_path"
    return False


def _is_cpu_device(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "device" and bool(node.args)
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


def _sync_call(node: ast.Call) -> str:
    """Non-empty description when the call is a known host sync."""
    fn = node.func
    if isinstance(fn, ast.Name) and fn.id == "float":
        return "float() on a tensor"
    if not isinstance(fn, ast.Attribute):
        return ""
    if isinstance(fn.value, ast.Name) and fn.value.id in TORCH_MODULE_NAMES:
        if fn.attr in TORCH_DATA_SHAPE:
            return f"torch.{fn.attr}() has a data-dependent shape"
        return ""
    if fn.attr == "to":
        dev = [kw.value for kw in node.keywords if kw.arg == "device"]
        if any(_is_cpu_device(a) for a in list(node.args[:1]) + dev):
            return ".to('cpu') copies to the host"
        return ""
    return SYNC_ATTRS.get(fn.attr, "")


def _is_host_source(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call) or \
            not isinstance(node.func, ast.Attribute):
        return False
    fn = node.func
    if fn.attr == "asarray" and isinstance(fn.value, ast.Name) \
            and fn.value.id in NP_MODULE_NAMES:
        return True
    return fn.attr in HOST_SOURCE_ATTRS


def _root_name(node: ast.AST) -> Optional[str]:
    """The base Name of a subscript/attribute chain (``costs[k[q], q]``
    -> ``costs``), or None."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _call_chain(node: ast.Call) -> List[str]:
    """Dotted/called segments of a call's func, outermost attr first:
    ``self._obs.span(...)`` -> ["span", "_obs", "self"]."""
    parts: List[str] = []
    fn = node.func
    while True:
        if isinstance(fn, ast.Attribute):
            parts.append(fn.attr)
            fn = fn.value
        elif isinstance(fn, ast.Call):
            fn = fn.func
        else:
            break
    if isinstance(fn, ast.Name):
        parts.append(fn.id)
    return parts


class _HotFnVisitor(ast.NodeVisitor):
    """Walk one hot function (nested defs included), tracking loop depth
    and which names hold host values."""

    def __init__(self, path: str, qualname: str, reason: str):
        self.path = path
        self.qualname = qualname
        self.reason = reason
        self.loop_depth = 0
        self.host_names: Set[str] = set()
        self.obs_names: Set[str] = set(OBS_ROOT_NAMES)
        self.findings: List[Finding] = []

    def _is_obs_call(self, node: ast.Call) -> bool:
        parts = _call_chain(node)
        return len(parts) >= 2 and \
            any(p in self.obs_names for p in parts[1:])

    def _loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def _iterate(self, node):
        """``for x in <host>`` (a statement or a comprehension's
        generator): the loop targets hold host data too."""
        if self._is_hosty(node.iter):
            self.host_names.update(n.id for n in ast.walk(node.target)
                                   if isinstance(n, ast.Name))

    def visit_For(self, node):
        self._iterate(node)
        self._loop(node)

    def visit_comprehension(self, node):
        self._iterate(node)
        self.generic_visit(node)

    def _comp(self, node):
        # generators first, so their targets are known in the element
        for gen in node.generators:
            self.visit(gen)
        for field in ("key", "value", "elt"):
            child = getattr(node, field, None)
            if child is not None:
                self.visit(child)

    visit_ListComp = visit_SetComp = visit_DictComp = _comp
    visit_GeneratorExp = _comp

    visit_AsyncFor = visit_For
    visit_While = _loop

    def _is_hosty(self, expr: ast.AST) -> bool:
        """The expression yields host data: it holds a host source, or
        roots in an already-tracked name."""
        if any(_is_host_source(n) for n in ast.walk(expr)):
            return True
        root = _root_name(expr)
        return root is not None and root in self.host_names

    def visit_Assign(self, node: ast.Assign):
        if self._is_hosty(node.value):
            for tgt in node.targets:
                elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                    else [tgt]
                self.host_names.update(
                    e.id for e in elts if isinstance(e, ast.Name))
        if isinstance(node.value, ast.Call) \
                and self._is_obs_call(node.value):
            self.obs_names.update(
                t.id for t in node.targets if isinstance(t, ast.Name))
        self.generic_visit(node)

    def visit_With(self, node):
        for item in node.items:
            if isinstance(item.context_expr, ast.Call) \
                    and self._is_obs_call(item.context_expr) \
                    and isinstance(item.optional_vars, ast.Name):
                self.obs_names.add(item.optional_vars.id)
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def _on_host(self, node: ast.Call) -> bool:
        """``float(x)`` / ``x.item()`` / ``x.tolist()`` on host data."""
        if isinstance(node.func, ast.Name):
            arg = node.args[0] if node.args else None
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in FREE_ON_HOST:
            arg = node.func.value
        else:
            return False
        if arg is None:
            return False
        root = _root_name(arg)
        return (root is not None and root in self.host_names) or \
            any(_is_host_source(n) for n in ast.walk(arg))

    def visit_Call(self, node: ast.Call):
        if self._is_obs_call(node):
            # do not recurse: conversions in the argument list are
            # attribution payload, not device syncs (module docstring)
            return
        desc = _sync_call(node)
        if desc and not self._on_host(node):
            in_loop = self.loop_depth > 0
            self.findings.append(Finding(
                rule="host-sync",
                severity="warn" if in_loop else "info",
                path=self.path, line=node.lineno, obj=self.qualname,
                message=desc + (
                    " inside a loop of a hot path — one sync per "
                    "iteration serializes the async launch pipeline"
                    if in_loop else
                    " in a hot path (single deliberate sync)")))
        self.generic_visit(node)


def _iter_hot_functions(tree: ast.Module
                        ) -> Iterator[Tuple[ast.AST, str, str,
                                            Optional[int]]]:
    """(function node, qualname, reason, declared folds budget) for
    every @hot_path def."""
    stack: List[Tuple[ast.AST, str]] = [(tree, "")]
    while stack:
        node, prefix = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                hot = [d for d in child.decorator_list
                       if _is_hot_decorator(d)]
                if hot:
                    reason, folds = "", None
                    d = hot[0]
                    if isinstance(d, ast.Call):
                        if d.args and isinstance(d.args[0], ast.Constant):
                            reason = str(d.args[0].value)
                        for kw in d.keywords:
                            if kw.arg == "folds" and \
                                    isinstance(kw.value, ast.Constant) \
                                    and isinstance(kw.value.value, int):
                                folds = kw.value.value
                    yield child, qual, reason, folds
                else:
                    # nested defs of a hot fn are covered by its visitor;
                    # only recurse into *non*-hot scopes looking for more
                    stack.append((child, qual + "."))
            elif isinstance(child, ast.ClassDef):
                stack.append((child, f"{prefix}{child.name}."))


def lint_file(path: Path) -> List[Finding]:
    """Hot-path host-sync findings (+ pragma hygiene) for one file,
    with pragmas already applied."""
    path = Path(path)
    source = path.read_text()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(rule="host-sync", severity="error",
                        path=_rel(path), line=e.lineno or 0, obj="<module>",
                        message=f"file does not parse: {e.msg}")]
    rel = _rel(path)
    findings: List[Finding] = []
    for fn_node, qual, reason, folds in _iter_hot_functions(tree):
        v = _HotFnVisitor(rel, qual, reason)
        # visit the body (not the def itself, so decorators are skipped)
        for stmt in fn_node.body:
            v.visit(stmt)
        findings.extend(v.findings)
        if folds is not None:
            depth0 = sum(1 for f in v.findings if f.severity == "info")
            if depth0 > folds:
                findings.append(Finding(
                    rule="sync-budget", severity="warn", path=rel,
                    line=fn_node.lineno, obj=qual,
                    message=(f"{depth0} depth-zero host syncs exceed the "
                             f"declared folds={folds} budget — the "
                             "end-of-flush fold must stay the declared "
                             "synchronization point (raise folds only "
                             "with the design note to match)")))
    findings.extend(pragma_findings(rel, source))
    return apply_pragmas(findings, {rel: source})


def lint_tree(root: Path = DEFAULT_TREE) -> List[Finding]:
    out: List[Finding] = []
    for path in sorted(Path(root).rglob("*.py")):
        out.extend(lint_file(path))
    return out


def _rel(path: Path) -> str:
    p = Path(path).resolve()
    try:
        return str(p.relative_to(_REPO_ROOT))
    except ValueError:
        return str(p)
