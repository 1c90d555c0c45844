"""Pass 1 — contract lint for the registered cost surfaces of the port.

The counterpart of ``repro.analysis.jaxpr_lint``.  Torch has no jaxpr to
trace, so each registered batch cost surface (``repro_torch.analysis.
registry``) is *evaluated* once on ``TRACE_ROWS`` configurations of its
grid under a ``TorchDispatchMode`` that records every aten op, its
arguments and its outputs — at float32 params, the dtype the CUDA scan
kernel computes in, and at float64, the exact ``"torch"`` backend's
dtype.  The record is checked against the contracts the CUDA backend and
the broker depend on:

rule ``host-branch`` (error)
    ``aten._local_scalar_dense`` (or another op that reads a value to the
    host: ``is_nonzero``, ``equal``, ``nonzero``, ...) ran: the surface
    branches on or converts a tensor in Python (``if t > 0``,
    ``.item()``, ``float(t)``).  The kernel's ``__device__`` function
    cannot branch like that, so the plain version and the kernel part;
    on the card it is also a device->host sync per evaluation.  An
    evaluation that raises is reported under this rule too, as the
    reference reports a failed trace.

rule ``dtype`` (error)
    The output is not one ``(N,)`` floating tensor, or a float16 /
    bfloat16 tensor appears on the path: low-precision intermediates can
    flip a strict-``<`` winner that the float64 commit then rejects.

rule ``dtype-follow`` (warn)
    The output's dtype differs from the params' dtype (e.g. float32 from
    an int column times a Python float when params are float64).  Torch
    has no weak types; this is how a surface drifts from the dtype its
    backend searches in.

rule ``closure-capture`` (warn / error)
    A tensor that is neither an input nor made inside the call feeds an
    op.  The kernel takes only ``Surface.consts()`` (Python floats), the
    params and a ``CostTable``'s table: a 0-d capture is a per-request
    scalar that belongs in params (warn); any other capture has no kernel
    input to ride on (error).  A ``CostTable`` surface's own table is the
    kernel input ``plan_scan._table`` and is not a finding.

rule ``cross-config-reduce`` (error)
    A reduction, scan or sort runs over a dim of size ``TRACE_ROWS``:
    costs must be elementwise per configuration, or the chunked and tiled
    scans change the result with their geometry.  Ops are matched by
    name (``aten.sum``, ``aten.min.dim``, ...), never by substring:
    ``aten.clamp_min`` and ``aten.min.other`` are elementwise.

rule ``no-surface`` (error)
    The registered fn carries no ``.surface`` descriptor:
    ``CudaPlanBackend`` would raise on it at run time.

Tensors made from numpy inside the call reach the dispatcher as
``aten.lift_fresh`` and count as made inside; Python scalars reach it as
numbers and are not tensors at all.
"""
from __future__ import annotations

import inspect
from pathlib import Path
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.registry import CostSurface, iter_cost_surfaces
from repro_torch.analysis.report import Finding

# distinctive config-axis length for the evaluation: reductions over a dim
# of this size are reductions over configs (no shipped surface has another
# axis of 7)
TRACE_ROWS = 7
PARAM_DTYPES = (torch.float32, torch.float64)
LOW_PRECISION = (torch.float16, torch.bfloat16)

# aten op packets that read a tensor's value to the host
HOST_READS = {"_local_scalar_dense", "is_nonzero", "item", "equal",
              "nonzero", "masked_select", "_unique2", "unique_dim",
              "unique_consecutive"}
# aten op packets that reduce, scan or sort along a dim (all dims when the
# op has no ``dim`` argument or it is None / empty)
REDUCE_OPS = {"sum", "nansum", "prod", "mean", "nanmean", "amin", "amax",
              "aminmax", "argmin", "argmax", "any", "all", "logsumexp",
              "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
              "sort", "argsort", "topk", "kthvalue", "median", "nanmedian",
              "mode", "std", "var", "std_mean", "var_mean",
              "linalg_vector_norm", "norm"}
# min / max are reductions only in these overloads (``other`` is the
# elementwise binary form)
MINMAX_REDUCE_OVERLOADS = {"default", "dim", "dim_min", "dim_max",
                           "unary_out"}

_REPO_ROOT = Path(__file__).resolve().parents[3]


def _locate(fn: Callable) -> Tuple[str, int]:
    """(repo-relative path, def line) of a callable, best effort."""
    try:
        target = inspect.unwrap(fn)
        path = inspect.getsourcefile(target)
        line = target.__code__.co_firstlineno
    except (TypeError, OSError, AttributeError):
        return "<unknown>", 0
    if path is None:
        return "<unknown>", 0
    p = Path(path).resolve()
    try:
        return str(p.relative_to(_REPO_ROOT)), line
    except ValueError:
        return str(p), line


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _Recorder(TorchDispatchMode):
    """Records every aten op with the tensors it read that were neither
    inputs nor made inside the evaluation (``captured``).  Every tensor
    seen is kept alive, so ``id``s stay unique while recording."""

    def __init__(self, inputs: Sequence[torch.Tensor]):
        super().__init__()
        self.ops: List[Tuple[object, tuple, dict, list]] = []
        self.captured: List[torch.Tensor] = []
        self._keep = list(inputs)
        self._known = {id(t) for t in inputs}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket.__name__ != "lift_fresh":
            for t in _tensors((args, kwargs)):
                if id(t) not in self._known:
                    self._known.add(id(t))
                    self._keep.append(t)
                    self.captured.append(t)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._keep.extend(outs)
        self._known.update(id(t) for t in outs)
        self.ops.append((func, args, kwargs, outs))
        return out


def _reduced_dims(func, args, kwargs, ndim: int) -> set:
    """The dims an op of REDUCE_OPS reduces over (all when it has no dim
    argument, or it is None or empty)."""
    names = [a.name for a in func._schema.arguments]
    if "dim" not in names:
        return set(range(ndim))
    i = names.index("dim")
    if "dim" in kwargs:
        val = kwargs["dim"]
    elif i < len(args):
        val = args[i]
    else:
        val = func._schema.arguments[i].default_value
    if val is None or val == []:
        return set(range(ndim))
    vals = val if isinstance(val, (list, tuple)) else [val]
    return {v % ndim if ndim else 0 for v in vals}


def _is_reduce(func) -> bool:
    packet = func.overloadpacket.__name__
    if packet in ("min", "max"):
        return func._overloadname in MINMAX_REDUCE_OVERLOADS
    return packet in REDUCE_OPS


def _table_tensors(fn: Callable) -> List[torch.Tensor]:
    """The device copies of a ``CostTable`` surface's table: the kernel
    takes them as an input (``plan_scan._table``)."""
    model = getattr(getattr(fn, "surface", None), "model", None)
    on = getattr(model, "_on", None)
    return list(on.values()) if isinstance(on, dict) else []


def trace_configs(cluster, n_rows: int = TRACE_ROWS,
                  device="cpu") -> torch.Tensor:
    """(n_rows, n_dims) int64 configurations of ``cluster`` spread evenly
    over its grid in ``enumerate_configs`` order."""
    grids = [np.asarray(d.grid(), dtype=np.int64) for d in cluster.dims]
    flat = np.linspace(0, cluster.grid_size() - 1, n_rows).astype(np.int64)
    idx = np.unravel_index(flat, tuple(len(g) for g in grids))
    cols = [g[i] for g, i in zip(grids, idx)]
    return torch.as_tensor(np.stack(cols, 1), device=device)


def _check_one(fn: Callable, configs: torch.Tensor, params: torch.Tensor,
               finding: Callable) -> List[Finding]:
    n_rows = configs.shape[0]
    rec = _Recorder([configs, params])
    try:
        with rec:
            out = fn(configs, params)
    except Exception as e:  # noqa: BLE001 — any evaluation failure is a finding
        first = (str(e).strip().splitlines() or [""])[0]
        return [finding(
            "host-branch", "error",
            f"evaluating the surface raised {type(e).__name__}: {first} — "
            "it cannot run as the kernel's elementwise device function")]

    out_list: List[Finding] = []
    for func, args, kwargs, outs in rec.ops:
        packet = func.overloadpacket.__name__
        if packet in HOST_READS:
            out_list.append(finding(
                "host-branch", "error",
                f"{func} reads a tensor's value to the host (a Python "
                "branch or conversion on a tensor) — use torch.where "
                "masks; the kernel's device function cannot branch so"))
        for t in _tensors((args, kwargs)) + outs:
            if t.dtype in LOW_PRECISION:
                out_list.append(finding(
                    "dtype", "error",
                    f"{t.dtype} tensor on the cost path: low-precision "
                    "intermediates can flip a strict-< winner that the "
                    "float64 commit then rejects"))
                break
        if _is_reduce(func):
            inp = next(iter(_tensors(args)), None)
            if inp is not None and any(
                    inp.shape[d] == n_rows
                    for d in _reduced_dims(func, args, kwargs, inp.ndim)):
                out_list.append(finding(
                    "cross-config-reduce", "error",
                    f"{func} reduces across the config axis: costs must be "
                    "elementwise per configuration, or the chunked and "
                    "tiled scans change the result with their geometry"))

    tables = {id(t) for t in _table_tensors(fn)}
    for t in rec.captured:
        if id(t) in tables:
            continue
        if t.ndim == 0:
            out_list.append(finding(
                "closure-capture", "warn",
                f"0-d {t.dtype} tensor captured from the enclosing scope: "
                "a per-request scalar the kernel cannot take — it belongs "
                "in params"))
        else:
            out_list.append(finding(
                "closure-capture", "error",
                f"captured {t.dtype}{tuple(t.shape)} tensor: the kernel "
                "takes only the surface's constants, the params and a "
                "CostTable's table"))

    if not isinstance(out, torch.Tensor):
        n = len(out) if isinstance(out, (tuple, list)) else 0
        out_list.append(finding(
            "dtype", "error",
            f"cost surface returned {n} outputs "
            f"({type(out).__name__}); the backends require exactly one "
            "(n_configs,) cost tensor"))
        return out_list
    if tuple(out.shape) != (n_rows,):
        out_list.append(finding(
            "dtype", "error",
            f"cost output has shape {tuple(out.shape)} for "
            f"{tuple(configs.shape)} configs; expected ({n_rows},) — one "
            "cost per configuration"))
    if not out.dtype.is_floating_point:
        out_list.append(finding(
            "dtype", "error",
            f"cost output dtype is {out.dtype}, not float — argmin "
            "selection and the inf infeasibility mask require a float "
            "cost vector"))
    elif out.dtype != params.dtype:
        out_list.append(finding(
            "dtype-follow", "warn",
            f"cost output is {out.dtype} for {params.dtype} params: the "
            "surface does not compute in the dtype its backend searches "
            "in"))
    return out_list


def lint_cost_fn(fn: Callable, configs, params: Sequence[float], *,
                 name: str, device="cpu") -> List[Finding]:
    """Evaluate one param-style batch cost fn on ``configs`` ((N, D)
    ints) at float32 and at float64 ``params`` and check the contracts;
    a finding seen at both dtypes is reported once."""
    path, line = _locate(fn)

    def finding(rule, severity, message):
        return Finding(rule=rule, severity=severity, path=path, line=line,
                       obj=name, message=message)

    cfgs = torch.as_tensor(configs, dtype=torch.int64, device=device)
    out: List[Finding] = []
    seen = set()
    for dtype in PARAM_DTYPES:
        p = torch.as_tensor(list(params), dtype=dtype, device=device)
        for f in _check_one(fn, cfgs, p, finding):
            if (f.rule, f.message) not in seen:
                seen.add((f.rule, f.message))
                out.append(f)
    return out


def lint_surface(surface: CostSurface, device="cpu") -> List[Finding]:
    from repro_torch.core.cost_model import Surface
    try:
        fn = surface.make_fn()
        cluster = surface.make_cluster()
    except Exception as e:  # noqa: BLE001 — a broken factory is a finding
        return [Finding(
            rule="host-branch", severity="error", path="<registry>", line=0,
            obj=surface.name,
            message=f"surface factory failed: {type(e).__name__}: {e}")]
    out = []
    if not isinstance(getattr(fn, "surface", None), Surface):
        path, line = _locate(fn)
        out.append(Finding(
            rule="no-surface", severity="error", path=path, line=line,
            obj=surface.name,
            message="the registered fn carries no .surface descriptor — "
                    "CudaPlanBackend raises on it at run time"))
    return out + lint_cost_fn(fn, trace_configs(cluster), surface.params,
                              name=surface.name, device=device)


def lint_registered(device="cpu") -> List[Finding]:
    """Lint every registered cost surface (importing the modules that
    register the shipped ones) on ``device``."""
    import repro_torch.core.cost_model    # noqa: F401 — registers DB surfaces
    import repro_torch.core.roofline      # noqa: F401 — registers rooflines
    out: List[Finding] = []
    for s in iter_cost_surfaces():
        out.extend(lint_surface(s, device))
    return out
