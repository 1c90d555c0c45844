"""Resource-plan cache (paper §VI-B3).

Keyed by (cost model, sub-plan kind); within a key we keep a *sorted array*
of data-characteristic keys (the paper keeps a sorted array with automatic
resizing and binary-search lookup; a CSB+-tree is cited as the scale-up
option).  Three lookup modes:

  exact            : hit only on identical data characteristics
  nearest_neighbor : nearest key within ``threshold``
  weighted_average : distance-weighted average of all neighbors within
                     ``threshold`` (component-wise, snapped to the grid)
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import ClusterConditions, PlanningStats

Mode = str  # "exact" | "nearest_neighbor" | "weighted_average"


@dataclasses.dataclass
class _Entry:
    keys: List[float]
    configs: List[Tuple[int, ...]]


class ResourcePlanCache:
    def __init__(self, mode: Mode = "exact", threshold: float = 0.0):
        assert mode in ("exact", "nearest_neighbor", "weighted_average")
        self.mode = mode
        self.threshold = threshold
        self._store: Dict[Tuple[str, str], _Entry] = {}
        # per-(model_id, subplan_kind) hit/miss/insert counters: the
        # dedup win of the cache (and of the broker fronting it) is
        # measurable per cost model and sub-plan kind, not just globally
        self.counters: Dict[Tuple[str, str], Dict[str, int]] = {}

    def _count(self, model_id: str, subplan_kind: str, field: str,
               stats: Optional[PlanningStats]) -> None:
        c = self.counters.setdefault((model_id, subplan_kind),
                                     {"hits": 0, "misses": 0, "inserts": 0})
        c[field] += 1
        if stats is not None:
            d = stats.cache_detail.setdefault(
                f"{model_id}|{subplan_kind}",
                {"hits": 0, "misses": 0, "inserts": 0})
            d[field] += 1

    def counters_snapshot(self) -> Dict[str, Dict[str, int]]:
        """JSON-friendly copy of the per-(model, kind) counters."""
        return {f"{m}|{k}": dict(v) for (m, k), v in self.counters.items()}

    # ------------------------------------------------------------------ #
    def lookup(self, model_id: str, subplan_kind: str, data_key: float,
               cluster: Optional[ClusterConditions] = None,
               stats: Optional[PlanningStats] = None
               ) -> Optional[Tuple[int, ...]]:
        e = self._store.get((model_id, subplan_kind))
        hit = None
        if e:
            i = bisect.bisect_left(e.keys, data_key)
            # exact match first (both NN and WA "first look for exact match")
            if i < len(e.keys) and e.keys[i] == data_key:
                hit = e.configs[i]
            elif self.mode == "nearest_neighbor":
                best_d, best = self.threshold, None
                for j in (i - 1, i):
                    if 0 <= j < len(e.keys):
                        d = abs(e.keys[j] - data_key)
                        if d <= best_d:
                            best_d, best = d, e.configs[j]
                hit = best
            elif self.mode == "weighted_average":
                lo = bisect.bisect_left(e.keys, data_key - self.threshold)
                hi = bisect.bisect_right(e.keys, data_key + self.threshold)
                if hi > lo:
                    num = [0.0] * len(e.configs[lo])
                    den = 0.0
                    for j in range(lo, hi):
                        w = 1.0 / (abs(e.keys[j] - data_key) + 1e-9)
                        den += w
                        for k, v in enumerate(e.configs[j]):
                            num[k] += w * v
                    cfg = tuple(int(round(v / den)) for v in num)
                    if cluster is not None:
                        cfg = snap_to_grid(cfg, cluster)
                    hit = cfg
        if hit is not None:
            if stats is not None:
                stats.cache_hits += 1
            self._count(model_id, subplan_kind, "hits", stats)
        else:
            if stats is not None:
                stats.cache_misses += 1
            self._count(model_id, subplan_kind, "misses", stats)
        return hit

    def insert(self, model_id: str, subplan_kind: str, data_key: float,
               config: Sequence[int],
               stats: Optional[PlanningStats] = None) -> None:
        if stats is not None:
            stats.cache_inserts += 1
        self._count(model_id, subplan_kind, "inserts", stats)
        e = self._store.setdefault((model_id, subplan_kind),
                                   _Entry(keys=[], configs=[]))
        i = bisect.bisect_left(e.keys, data_key)
        if i < len(e.keys) and e.keys[i] == data_key:
            e.configs[i] = tuple(config)
            return
        e.keys.insert(i, data_key)          # sorted array w/ auto-resize
        e.configs.insert(i, tuple(config))

    def clear(self) -> None:
        self._store.clear()

    def __len__(self) -> int:
        return sum(len(e.keys) for e in self._store.values())


def snap_to_grid(cfg: Sequence[int], cluster: ClusterConditions
                 ) -> Tuple[int, ...]:
    out = []
    for v, d in zip(cfg, cluster.dims):
        if d.values:
            out.append(min(d.values, key=lambda g: abs(g - v)))
        else:
            v = max(d.lo, min(d.hi, v))
            v = d.lo + round((v - d.lo) / d.step) * d.step
            # rounding can overshoot hi when (hi - lo) is not a multiple of
            # step; clamp back onto the last reachable grid point
            if v > d.hi:
                v -= d.step
            out.append(int(max(d.lo, v)))
    return tuple(out)
