"""Schemas and join graphs (paper §VII setup).

TPC-H at SF=100 with the benchmark's join edges and FK selectivities, plus
the randomly-generated schema: "a random number of tables, each of which
have a randomly picked row size between 100 and 200 bytes, and a randomly
picked number of rows between 100K and 2M ... randomly generate join edges
... with similar join selectivities as in the TPC-H schema".
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, FrozenSet, List, Sequence, Tuple

GB = 1 << 30


@dataclasses.dataclass(frozen=True)
class Relation:
    name: str
    rows: int
    row_bytes: int

    @property
    def size_gb(self) -> float:
        return self.rows * self.row_bytes / GB


@dataclasses.dataclass(frozen=True)
class JoinEdge:
    a: str
    b: str
    selectivity: float          # |a join b| = rows(a) * rows(b) * sel


@dataclasses.dataclass
class Schema:
    relations: Dict[str, Relation]
    edges: List[JoinEdge]

    def edge_map(self) -> Dict[FrozenSet[str], float]:
        return {frozenset((e.a, e.b)): e.selectivity for e in self.edges}

    def neighbors(self, t: str) -> List[str]:
        out = []
        for e in self.edges:
            if e.a == t:
                out.append(e.b)
            elif e.b == t:
                out.append(e.a)
        return out

    def connected(self, tables: Sequence[str]) -> bool:
        ts = set(tables)
        if not ts:
            return False
        seen = {next(iter(ts))}
        frontier = list(seen)
        while frontier:
            t = frontier.pop()
            for n in self.neighbors(t):
                if n in ts and n not in seen:
                    seen.add(n)
                    frontier.append(n)
        return seen == ts


def tpch_schema(scale_factor: int = 100) -> Schema:
    sf = scale_factor
    rel = {
        "region":   Relation("region", 5, 124),
        "nation":   Relation("nation", 25, 128),
        "supplier": Relation("supplier", 10_000 * sf, 144),
        "customer": Relation("customer", 150_000 * sf, 165),
        "part":     Relation("part", 200_000 * sf, 128),
        "partsupp": Relation("partsupp", 800_000 * sf, 144),
        "orders":   Relation("orders", 1_500_000 * sf, 121),
        "lineitem": Relation("lineitem", 6_000_000 * sf, 112),
    }
    # FK-join selectivity = 1 / |PK side|
    def fk(a, b, pk):   # noqa: E306
        return JoinEdge(a, b, 1.0 / rel[pk].rows)
    edges = [
        fk("lineitem", "orders", "orders"),
        fk("lineitem", "partsupp", "partsupp"),
        fk("lineitem", "part", "part"),
        fk("lineitem", "supplier", "supplier"),
        fk("orders", "customer", "customer"),
        fk("customer", "nation", "nation"),
        fk("supplier", "nation", "nation"),
        fk("nation", "region", "region"),
        fk("partsupp", "part", "part"),
        fk("partsupp", "supplier", "supplier"),
    ]
    return Schema(rel, edges)


# paper queries: Q12 (1 join), Q3 (2 joins), Q2 (3 joins), All (all tables)
TPCH_QUERIES: Dict[str, Tuple[str, ...]] = {
    "Q12": ("orders", "lineitem"),
    "Q3":  ("customer", "orders", "lineitem"),
    "Q2":  ("part", "partsupp", "supplier", "nation"),
    "All": ("region", "nation", "supplier", "customer", "part", "partsupp",
            "orders", "lineitem"),
}


def random_schema(n_tables: int, seed: int = 0, extra_edge_frac: float = 0.3
                  ) -> Schema:
    rng = random.Random(seed)
    rel = {}
    for i in range(n_tables):
        name = f"t{i}"
        rel[name] = Relation(name, rng.randint(100_000, 2_000_000),
                             rng.randint(100, 200))
    names = list(rel)
    edges = []
    seen = set()
    # spanning tree for connectivity
    for i in range(1, n_tables):
        j = rng.randrange(i)
        a, b = names[i], names[j]
        sel = 1.0 / max(rel[a].rows, rel[b].rows)   # TPC-H-like FK selectivity
        edges.append(JoinEdge(a, b, sel))
        seen.add(frozenset((a, b)))
    # extra edges
    n_extra = int(extra_edge_frac * n_tables)
    while n_extra > 0:
        a, b = rng.sample(names, 2)
        if frozenset((a, b)) in seen:
            continue
        seen.add(frozenset((a, b)))
        edges.append(JoinEdge(a, b, 1.0 / max(rel[a].rows, rel[b].rows)))
        n_extra -= 1
    return Schema(rel, edges)


def random_query(schema: Schema, n_relations: int, seed: int = 0
                 ) -> Tuple[str, ...]:
    """A connected random subset of relations (paper: 'queries having
    increasing number of joins')."""
    rng = random.Random(seed)
    names = list(schema.relations)
    start = rng.choice(names)
    chosen = [start]
    while len(chosen) < n_relations:
        cands = sorted({n for t in chosen for n in schema.neighbors(t)
                        if n not in chosen})
        if not cands:
            break
        chosen.append(rng.choice(cands))
    return tuple(chosen)


def schema_from_dict(spec: dict) -> Schema:
    """Rebuild a schema from plain data: ``{"relations": [(name, rows,
    row_bytes), ...], "edges": [(a, b, selectivity), ...]}`` — the form in
    which another implementation's schema (the JAX reference in the parity
    tests) hands over its state."""
    rel = {name: Relation(name, int(rows), int(row_bytes))
           for name, rows, row_bytes in spec["relations"]}
    edges = [JoinEdge(a, b, float(sel)) for a, b, sel in spec["edges"]]
    return Schema(rel, edges)
