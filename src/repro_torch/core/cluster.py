"""Cluster conditions and discrete resource grids (paper §II-B, §VI-B).

A resource configuration is a point on a discrete grid with one entry per
resource dimension.  The paper's dimensions are (number of containers,
container size GB); the TPU transfer re-uses the identical machinery with
dimensions (mesh model-parallel degree, data degree, pods, microbatch).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ResourceDim:
    name: str
    lo: int
    hi: int
    step: int = 1
    # optional explicit grid (e.g. powers of two for mesh degrees)
    values: Tuple[int, ...] = ()

    def grid(self) -> Tuple[int, ...]:
        if self.values:
            return self.values
        return tuple(range(self.lo, self.hi + 1, self.step))

    def clamp_ok(self, v: int) -> bool:
        if self.values:
            return v in self.values
        return self.lo <= v <= self.hi


@dataclasses.dataclass(frozen=True)
class ClusterConditions:
    """Current cluster condition as exposed by the RM (paper Fig. 8)."""
    dims: Tuple[ResourceDim, ...]

    @property
    def n_dims(self) -> int:
        return len(self.dims)

    def min_config(self) -> Tuple[int, ...]:
        return tuple(d.values[0] if d.values else d.lo for d in self.dims)

    def max_config(self) -> Tuple[int, ...]:
        return tuple(d.values[-1] if d.values else d.hi for d in self.dims)

    def grid_size(self) -> int:
        n = 1
        for d in self.dims:
            n *= len(d.grid())
        return n

    def all_configs(self):
        return itertools.product(*[d.grid() for d in self.dims])

    def neighbors_ok(self, cfg: Sequence[int]) -> bool:
        return all(d.clamp_ok(v) for d, v in zip(self.dims, cfg))


def paper_cluster(max_containers: int = 100, max_gb: int = 10,
                  step_containers: int = 1, step_gb: int = 1
                  ) -> ClusterConditions:
    """The evaluation cluster of §VII: 100 containers x 10 GB, discrete
    steps of 1 on either axis, minimum 1 container of 1 GB."""
    return ClusterConditions(dims=(
        ResourceDim("num_containers", 1, max_containers, step_containers),
        ResourceDim("container_gb", 1, max_gb, step_gb),
    ))


def scaled_cluster(max_containers: int, max_gb: int) -> ClusterConditions:
    """§VII-C scalability: up to 100K containers x 100 GB.  Steps stay
    discrete-1 on the GB axis and scale on the container axis so the grid
    mirrors 'discrete intervals of 1 on either axis' at paper scale."""
    return ClusterConditions(dims=(
        ResourceDim("num_containers", 1, max_containers, 1),
        ResourceDim("container_gb", 1, max_gb, 1),
    ))


@dataclasses.dataclass
class PlanningStats:
    """Counters reported in the paper's evaluation, extended with the
    resource-plan cache's per-(model, sub-plan-kind) detail and the
    session broker's dedup/batching counters (so the broker's win — fewer
    searches, larger array programs — is measurable, not anecdotal)."""
    configs_explored: int = 0
    cost_calls: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_inserts: int = 0
    # per-"model_id|subplan_kind" {"hits"/"misses"/"inserts": n}
    cache_detail: dict = dataclasses.field(default_factory=dict)
    # session planning broker (repro_torch.core.plan_broker)
    broker_requests: int = 0          # requests submitted
    broker_dedup_hits: int = 0        # resolved without their own search
    broker_batches: int = 0           # stacked array programs executed
    # flush-wave geometry (broker-level only: a wave spans requests from
    # many costings, so per-request stats never see these) — one entry
    # per non-empty flush, counting the requests that entered the wave
    broker_waves: int = 0
    broker_wave_sizes: list = dataclasses.field(default_factory=list)

    def merge(self, other: "PlanningStats") -> None:
        self.configs_explored += other.configs_explored
        self.cost_calls += other.cost_calls
        self.cache_hits += other.cache_hits
        self.cache_misses += other.cache_misses
        self.cache_inserts += other.cache_inserts
        self.broker_requests += other.broker_requests
        self.broker_dedup_hits += other.broker_dedup_hits
        self.broker_batches += other.broker_batches
        self.broker_waves += other.broker_waves
        self.broker_wave_sizes.extend(other.broker_wave_sizes)
        for key, d in other.cache_detail.items():
            mine = self.cache_detail.setdefault(
                key, {"hits": 0, "misses": 0, "inserts": 0})
            for k, v in d.items():
                mine[k] = mine.get(k, 0) + v
