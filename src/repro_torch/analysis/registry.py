"""plan-lint registration surface of the port: the *only* analysis
module the core planning stack imports.

The counterpart of ``repro.analysis.registry``.  Two registries live
here, both dependency-free (no torch, no ``repro_torch.core`` imports) so
that tagging a function as a hot path or registering a cost surface costs
nothing at import time:

* ``hot_path(reason, folds=...)`` — a passthrough decorator marking a
  function as a designated hot path for the AST host-sync lint
  (``repro_torch.analysis.hotpath_lint``), which detects it
  syntactically; the attributes set here let tests and tooling find hot
  paths at run time.

* ``register_cost_surface(surface)`` / ``iter_cost_surfaces()`` — the
  corpus of DB and roofline cost surfaces the surface contract lint
  (``repro_torch.analysis.surface_lint``) evaluates and certifies,
  registered as lazy factories: nothing is built until the lint runs.
  ``core/cost_model.py`` registers the paper and simulator join models,
  ``core/roofline.py`` the three roofline kinds.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence

HOT_PATH_ATTR = "__plan_lint_hot__"
HOT_PATH_REASON_ATTR = "__plan_lint_hot_reason__"
HOT_PATH_FOLDS_ATTR = "__plan_lint_hot_folds__"


def hot_path(reason: str, *, folds: Optional[int] = None) -> Callable:
    """Mark a function as a designated hot path (see module docstring).

    ``reason`` documents *why* the path is hot (which loop dispatches it
    per request/chunk/iteration) — it is required, so the registry reads
    as an inventory rather than a bag of tags.

    ``folds`` optionally declares the host-sync budget: the number of
    loop-depth-zero device->host sync call sites this function is
    *supposed* to contain (the documented end-of-scan fold).  When
    declared, the host-sync lint (pass 3) adds a ``sync-budget`` warning
    if the function ever grows more depth-zero syncs than declared — the
    cross-shard fold must stay the single synchronization point.
    """
    if not isinstance(reason, str) or not reason.strip():
        raise ValueError("hot_path requires a non-empty reason string")
    if folds is not None and (not isinstance(folds, int) or folds < 0):
        raise ValueError("hot_path folds must be a non-negative int")

    def mark(fn):
        setattr(fn, HOT_PATH_ATTR, True)
        setattr(fn, HOT_PATH_REASON_ATTR, reason)
        setattr(fn, HOT_PATH_FOLDS_ATTR, folds)
        return fn

    return mark


@dataclasses.dataclass(frozen=True)
class CostSurface:
    """One registered batch-cost surface for the surface contract lint.

    ``make_fn()`` returns the param-style batch cost callable ``fn(configs,
    params) -> costs`` that carries its kernel descriptor as ``fn.surface``
    (built as ``OperatorCosting._grid_fn`` and ``ShardingPlanner._grid_fn``
    build theirs), ``make_cluster()`` the ``ClusterConditions`` grid it
    searches, and ``params`` a representative per-request scalar vector.
    Everything is lazy, so the registry never builds a model."""
    name: str
    domain: str                        # "db" | "tpu"
    make_fn: Callable                  # () -> fn(configs, params)
    make_cluster: Callable             # () -> ClusterConditions
    params: Sequence[float]


_COST_SURFACES: Dict[str, CostSurface] = {}


def register_cost_surface(surface: CostSurface) -> CostSurface:
    """Register (or replace) a cost surface by name."""
    _COST_SURFACES[surface.name] = surface
    return surface


def iter_cost_surfaces(domain: Optional[str] = None
                       ) -> Iterator[CostSurface]:
    for s in _COST_SURFACES.values():
        if domain is None or s.domain == domain:
            yield s


def surface_names() -> List[str]:
    return sorted(_COST_SURFACES)
