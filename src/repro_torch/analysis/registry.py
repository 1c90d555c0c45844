"""Hot-path marker of the port's planning stack.

The counterpart of ``repro.analysis.registry``, cut to the ``hot_path``
decorator: it tags the functions a per-request / per-chunk / per-iteration
loop dispatches, with the reason and the host-sync budget, for the
plan-lint passes (not ported yet).  Dependency-free, so core modules can
import it at no cost.
"""
from __future__ import annotations

from typing import Callable, Optional

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
