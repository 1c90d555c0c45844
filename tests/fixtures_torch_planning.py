"""Shared pieces of the planning path's parity twins
(``test_torch_{plan_broker,planning_backend,batched_costing,lockstep,
hillclimb,plan_cache,planners,obs}.py``).

Each twin runs a reference test's body twice, once on ``REF`` (the JAX
package's modules, its exact float64 ``"numpy"`` backend) and once on
``PORT`` (``repro_torch``'s modules, its exact float64 ``"torch"``
backend), on the same inputs, and requires the same results.  A package
namespace carries the modules a body needs under one name each, so a
body reads as the reference's test does: ``p.OperatorCosting(...)``,
``p.PlanBroker(p.backend)``.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

from repro.core import cluster as r_cluster
from repro.core import cost_model as r_cost_model
from repro.core import fast_randomized as r_fast
from repro.core import hillclimb as r_hillclimb
from repro.core import plan_broker as r_broker
from repro.core import plan_cache as r_cache
from repro.core import planning_backend as r_backend
from repro.core import plans as r_plans
from repro.core import raqo as r_raqo
from repro.core import schema as r_schema
from repro.core import selinger as r_selinger
from repro_torch.core import cluster as t_cluster
from repro_torch.core import cost_model as t_cost_model
from repro_torch.core import fast_randomized as t_fast
from repro_torch.core import hillclimb as t_hillclimb
from repro_torch.core import plan_broker as t_broker
from repro_torch.core import plan_cache as t_cache
from repro_torch.core import planning_backend as t_backend
from repro_torch.core import plans as t_plans
from repro_torch.core import raqo as t_raqo
from repro_torch.core import schema as t_schema
from repro_torch.core import selinger as t_selinger


def _package(name, backend, cluster, cost_model, fast, hillclimb, broker,
             cache, planning_backend, plans, raqo, schema, selinger):
    ns = SimpleNamespace(name=name, backend=backend)
    for mod in (cluster, cost_model, fast, hillclimb, broker, cache,
                planning_backend, plans, raqo, schema, selinger):
        for k in getattr(mod, "__all__", None) or dir(mod):
            if not k.startswith("__"):
                setattr(ns, k, getattr(mod, k))
    # the modules themselves, for what a name would shadow
    ns.cost_model, ns.hillclimb, ns.planning_backend = \
        cost_model, hillclimb, planning_backend
    ns.plan_broker, ns.plan_cache = broker, cache
    # the hill-climb wrappers of each package (planning_backend exports
    # same-named primitives with other signatures)
    for k in ("argmin_grid", "brute_force", "hill_climb",
              "hill_climb_multi", "enumerate_configs"):
        setattr(ns, k, getattr(hillclimb, k))
    ns.get_backend = planning_backend.get_backend
    ns.exact = planning_backend.get_backend(backend)
    return ns


REF = _package("ref", "numpy", r_cluster, r_cost_model, r_fast,
               r_hillclimb, r_broker, r_cache, r_backend, r_plans, r_raqo,
               r_schema, r_selinger)
PORT = _package("port", "torch", t_cluster, t_cost_model, t_fast,
                t_hillclimb, t_broker, t_cache, t_backend, t_plans, t_raqo,
                t_schema, t_selinger)
PACKAGES = (REF, PORT)


def both(body, *args, **kw):
    """``body(p, ...)`` on the reference and on the port: (ref, port)."""
    return tuple(body(p, *args, **kw) for p in PACKAGES)


def tree_sig(p):
    """A plan tree as plain data: (impl, resources, op cost, total cost,
    left, right), a leaf as its sorted tables."""
    if p is None:
        return None
    if p.is_leaf:
        return tuple(sorted(p.tables))
    return (p.impl, tuple(p.resources), p.op_cost, p.total_cost,
            tree_sig(p.left), tree_sig(p.right))


def sigs(joint_plans):
    return [tree_sig(jp.plan) for jp in joint_plans]


def same_cost(a, b) -> bool:
    """Bit-equal floats, or both infinite."""
    return a == b or (math.isinf(a) and math.isinf(b))


def cache_state(cache):
    """A ``ResourcePlanCache``'s stored keys and configs and its counters,
    as plain data."""
    return ({k: (list(v.keys), [tuple(c) for c in v.configs])
             for k, v in cache._store.items()}, cache.counters_snapshot())
