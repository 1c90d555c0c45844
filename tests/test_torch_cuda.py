"""CUDA kernels of the port against their plain versions, on the card.

Marked ``cuda``: these skip on hosts without a GPU.  On a machine with
one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are built with -fmad=false and IEEE division, so flat ids and
float32 costs must equal the plain torch versions' bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core.cluster import (ClusterConditions, ResourceDim,
                                      paper_cluster)
from repro_torch.core.planning_backend import TorchPlanBackend
from repro_torch.core.raqo import RAQO
from repro_torch.core.schema import random_query, random_schema
from repro_torch.kernels import plan_scan as ps

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


GRIDS = [paper_cluster(), ClusterConditions(dims=(
    ResourceDim("nc", 1, 4_001, 5),
    ResourceDim("cs", 1, 34, values=(1, 2, 3, 5, 8, 13, 21, 34))))]


@pytest.mark.parametrize("objective", ["time", "money", "sla"])
def test_kernels_bit_equal_plain(dev, objective):
    rng = np.random.default_rng(0)
    for cluster in GRIDS:
        dims = ps.grid_dims(cluster, dev)
        for models in (cm.paper_models(), cm.simulator_cost_models()):
            for model in models.values():
                s = cm.Surface(model, objective)
                for Q in (1, 9, 70):
                    ss = rng.uniform(0.01, 40, Q)
                    cols = [ss, ss + rng.uniform(0, 100, Q)]
                    if objective == "sla":
                        cols.append(rng.uniform(1, 30, Q))
                    p = torch.tensor(np.stack(cols, 1), dtype=torch.float32,
                                     device=dev)
                    want = ps.scan_argmin_ref(s, dims, p)
                    for qb in (1, min(Q, ps.UNROLL_Q)):
                        got = ps.scan_argmin(s, dims, p, qb)
                        assert all(torch.equal(a, b)
                                   for a, b in zip(got, want))
                cur = torch.tensor(np.stack(
                    [rng.integers(0, d.size, 26) for d in dims], 1),
                    device=dev)
                got = ps.neighbor_step(s, dims, cur, p[:1])
                want = ps.neighbor_step_ref(s, dims, cur, p[:1])
                assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("rp", ["batched", "ensemble"])
def test_raqo_on_kernels_matches_plain(dev, rp):
    schema = random_schema(8, seed=0)
    queries = [random_query(schema, 4, seed=q) for q in range(3)]
    before = (ps.scan_argmin.launches, ps.neighbor_step.launches)
    sigs = []
    for backend in (ps.CudaPlanBackend(),
                    TorchPlanBackend(device="cuda", dtype=torch.float32)):
        plans = RAQO(schema, models=cm.simulator_cost_models(),
                     cluster=paper_cluster(), resource_planning=rp,
                     backend=backend).plan_queries(queries)
        sigs.append([(p.plan.describe(), p.exec_time) for p in plans])
    assert sigs[0] == sigs[1]
    after = (ps.scan_argmin.launches, ps.neighbor_step.launches)
    assert after[rp == "ensemble"] > before[rp == "ensemble"]
