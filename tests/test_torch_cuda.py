"""CUDA kernels of the port against their plain versions, on the card.

Marked ``cuda``: these skip on hosts without a GPU.  On a machine with
one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The plan-scan kernels are built with -fmad=false and IEEE division, so
flat ids and float32 costs must equal the plain torch versions' bit for
bit.  The model kernels sum in other orders than their plain versions and
are held to the tolerances of tests/test_kernels.py: 1e-5 for float32
attention, 2e-2 for bfloat16, 1e-4 for the selective scan.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core.cluster import (ClusterConditions, ResourceDim,
                                      paper_cluster)
from repro_torch.core.planning_backend import TorchPlanBackend
from repro_torch.core.raqo import RAQO
from repro_torch.core.schema import random_query, random_schema
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import plan_scan as ps
from repro_torch.kernels import ref
from repro_torch.launch.serve import serve

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,Skv,H,KV,hd,opts", [
    (2, 128, 128, 4, 4, 64, {}),
    (1, 100, 100, 15, 5, 64, {}),
    (2, 70, 70, 6, 2, 16, dict(window=24, attn_softcap=30.0)),
    (1, 64, 96, 4, 1, 128, dict(causal=False)),
    (1, 33, 33, 2, 2, 256, {}),
])
def test_flash_attention_matches_plain(dev, dtype, tol, B, S, Skv, H, KV,
                                       hd, opts):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=g, device=dev).to(dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **opts)
    want = ref.attention_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,N,with_h0", [
    (1, 128, 64, 8, False), (2, 100, 200, 16, True), (1, 7, 64, 4, False),
    (3, 64, 128, 32, True)])
def test_selective_scan_matches_plain(dev, dtype, B, S, D, N, with_h0):
    g = torch.Generator(device=dev).manual_seed(1)
    u = torch.randn((B, S, D), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, D), generator=g, device=dev) - 1)
    A = -torch.exp(torch.randn((D, N), generator=g, device=dev) * 0.3)
    Bm = torch.randn((B, S, N), generator=g, device=dev).to(dtype)
    Cm = torch.randn((B, S, N), generator=g, device=dev).to(dtype)
    h0 = torch.randn((B, D, N), generator=g, device=dev) if with_h0 \
        else None
    before = ms.selective_scan.launches
    y, h = ms.selective_scan(u, dt, A, Bm, Cm, h0)
    yr, hr = ref.selective_scan_ref(u, dt, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    assert ms.selective_scan.launches == before + 1
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, hr, atol=1e-4, rtol=1e-4)


def test_smoke_serve_through_kernels(dev):
    before = (fa.flash_attention.launches, ms.selective_scan.launches)
    for arch in ("smollm-360m", "falcon-mamba-7b"):
        cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        got = serve(cfg, requests=4, slots=2, max_new=6, device="cuda")
        plain = serve(cfg, requests=4, slots=2, max_new=6, device="cuda",
                      impl="ref")
        assert got["served"] == 4 and got["tokens"] == plain["tokens"]
    after = (fa.flash_attention.launches, ms.selective_scan.launches)
    assert after[0] > before[0] and after[1] > before[1]
