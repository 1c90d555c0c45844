"""CUDA kernels of the port against their plain versions, on the card.

Marked ``cuda``: these skip on hosts without a GPU.  On a machine with
one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The plan-scan kernels are built with -fmad=false and IEEE division, so
flat ids and float32 costs must equal the plain torch versions' bit for
bit.  The model kernels sum in other orders than their plain versions and
are held to the tolerances of tests/test_kernels.py: 1e-5 for float32
attention, 2e-2 for bfloat16, 1e-4 for the selective scan.  The join
kernels return int32 values and must equal their plain versions exactly;
the streaming service through the scan kernel must plan as solo planning
does.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core.cluster import (ClusterConditions, ResourceDim,
                                      paper_cluster)
from repro_torch.core.plan_broker import PlanBroker
from repro_torch.core.planning_backend import TorchPlanBackend
from repro_torch.core.raqo import RAQO
from repro_torch.core.schema import random_query, random_schema
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import build
from repro_torch.kernels import hash_join as hj
from repro_torch.kernels import join_cases as jc
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import merge_join as mj
from repro_torch.kernels import plan_scan as ps
from repro_torch.kernels import ref
from repro_torch.launch.serve import serve
from repro_torch.service import StreamingPlannerService, poisson_trace

import fixtures_torch_multidevice as fx
from fixtures_torch_media import inputs, open_gates

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


GRIDS = [paper_cluster(), ClusterConditions(dims=(
    ResourceDim("nc", 1, 4_001, 5),
    ResourceDim("cs", 1, 34, values=(1, 2, 3, 5, 8, 13, 21, 34))))]
# the DB scan's tiles: whole dim-0 values x dim 1, at most ps.TILE_ROWS
# rows; dim-1 sizes 7 and 100 do not divide a tile, 2,001 values of dim 0
# leave a ragged last tile, and 3 x 5,000 runs windows of dim 1
TILE_GRIDS = [ClusterConditions(dims=(
    ResourceDim("nc", 1, 2_001), ResourceDim("cs", 1, 7))),
    ClusterConditions(dims=(ResourceDim("nc", 1, 2_001),
                            ResourceDim("cs", 1, 100))),
    ClusterConditions(dims=(ResourceDim("nc", 1, 3),
                            ResourceDim("cs", 1, 5_000)))]


@pytest.mark.parametrize("objective,grids,queries", [
    ("time", "base", (1, 9, 70)), ("money", "base", (1, 9, 70)),
    ("sla", "base", (1, 9, 70)),
    ("time", "tiles", (1, 8, 63, 64, 65)),
    ("money", "tiles", (1, 8, 63, 64, 65)),
    ("sla", "tiles", (1, 8, 63, 64, 65))],
    ids=["time", "money", "sla", "tiles-time", "tiles-money", "tiles-sla"])
def test_kernels_bit_equal_plain(dev, objective, grids, queries):
    rng = np.random.default_rng(0)
    for cluster in GRIDS if grids == "base" else TILE_GRIDS:
        dims = ps.grid_dims(cluster, dev)
        for models in (cm.paper_models(), cm.simulator_models(),
                       cm.simulator_cost_models()):
            for model in models.values():
                s = cm.Surface(model, objective)
                for Q in queries:
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
    if grids == "base":
        return
    # all-OOM: the hash side exceeds 70% of every container size
    dims = ps.grid_dims(TILE_GRIDS[1], dev)
    p = torch.tensor([[80.0, 300.0] + ([1e9] if objective == "sla" else [])]
                     * 65, device=dev)
    bhj = cm.Surface(cm.simulator_cost_models()["BHJ"], objective)
    for qb in (1, ps.UNROLL_Q):
        cost, flat = ps.scan_argmin(bhj, dims, p, qb)
        assert bool(torch.isinf(cost).all()) and bool((flat == -1).all())
    # a tie plateau across tile boundaries: 2000 ss - nc clamped at the
    # 1e-3 floor ties every row from nc >= 2000 ss on, over many tiles
    ties = cm.Surface(cm.RegressionModel(
        "ties", np.array([2000.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0])),
        objective)
    ss = rng.uniform(0.01, 0.9, 65)
    cols = [ss, ss] + ([np.full(65, 1e9)] if objective == "sla" else [])
    p = torch.tensor(np.stack(cols, 1), dtype=torch.float32, device=dev)
    for cluster in TILE_GRIDS:
        dims = ps.grid_dims(cluster, dev)
        want = ps.scan_argmin_ref(ties, dims, p)
        for qb in (1, ps.UNROLL_Q):
            got = ps.scan_argmin(ties, dims, p, qb)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("rp", ["batched", "ensemble"])
def test_raqo_on_kernels_matches_plain(dev, rp):
    schema = random_schema(8, seed=0)
    queries = [random_query(schema, 4, seed=q) for q in range(3)]
    before = (ps.scan_argmin.launches, ps.ensemble_climb.launches,
              ps.neighbor_step.launches)
    sigs = []
    for backend in (ps.CudaPlanBackend(),
                    TorchPlanBackend(device="cuda", dtype=torch.float32)):
        plans = RAQO(schema, models=cm.simulator_cost_models(),
                     cluster=paper_cluster(), resource_planning=rp,
                     backend=backend).plan_queries(queries)
        sigs.append([(p.plan.describe(), p.exec_time) for p in plans])
    assert sigs[0] == sigs[1]
    after = (ps.scan_argmin.launches, ps.ensemble_climb.launches,
             ps.neighbor_step.launches)
    assert after[rp == "ensemble"] > before[rp == "ensemble"]
    assert after[2] == before[2]          # the climb runs on the device


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,Skv,H,KV,hd,opts", [
    (2, 128, 128, 4, 4, 64, {}),
    (1, 100, 100, 15, 5, 64, {}),
    (2, 70, 70, 6, 2, 16, dict(window=24, attn_softcap=30.0)),
    (1, 64, 96, 4, 1, 128, dict(causal=False)),
    (1, 33, 33, 2, 2, 256, {}),
    # zamba2's head dim 80 (32:32 heads cut to 4:4), bfloat16 on the CUDA
    # cores too
    (2, 100, 100, 4, 4, 80, {}),
    (1, 130, 130, 4, 2, 80, dict(window=40, attn_softcap=30.0)),
    (1, 50, 77, 4, 4, 80, dict(causal=False)),
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


@pytest.mark.parametrize("B,S,Skv,H,KV,hd,opts", [
    (4, 256, 256, 15, 5, 64, {}),
    (1, 100, 100, 15, 5, 64, dict(window=24, attn_softcap=30.0)),
    (2, 77, 130, 4, 2, 64, dict(causal=False)),
    (2, 200, 200, 8, 2, 128, {}),
    (1, 300, 300, 4, 2, 128, dict(window=70, attn_softcap=20.0)),
    (1, 64, 96, 4, 1, 128, dict(causal=False)),
    (3, 1, 1, 2, 1, 64, {}),
])
def test_flash_attention_tensor_cores_match_plain(dev, B, S, Skv, H, KV,
                                                  hd, opts):
    """bfloat16 at hd 64 and 128 takes the wgmma/TMA kernel: ragged S and
    Skv, window and softcap, non-causal."""
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).bfloat16()
    k = torch.randn((B, Skv, KV, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((B, Skv, KV, hd), generator=g, device=dev).bfloat16()
    got = fa.flash_attention(q, k, v, **opts)
    want = ref.attention_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


# across the 32-step chunk edge, every N the kernel instantiates, with and
# without h0 (D=200: lanes() gives min(N, 16) lanes a channel)
SCAN_CHUNK_CASES = [(B, S, 200, N, h0) for B in (1, 4)
                    for S in (1, 31, 32, 33, 100, 512)
                    for N in ms.STATE_SIZES for h0 in (False, True)]
# shapes lanes() maps to fewer lanes than N allows: 2 (B * D = 32K, the
# serve prefill's B=4, D=8192), 4 (a B=1 prompt) and 8 lanes
SCAN_LANE_CASES = [(4, 33, 8192, 16, True), (2, 100, 8192, 64, False),
                   (1, 33, 8192, 16, False), (1, 31, 8192, 32, True),
                   (1, 33, 4096, 16, True), (2, 32, 2048, 64, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,N,with_h0", [
    (1, 128, 64, 8, False), (2, 100, 200, 16, True), (1, 7, 64, 4, False),
    (3, 64, 128, 32, True), (2, 45, 201, 16, False),
    (2, 45, 204, 16, True)] + SCAN_CHUNK_CASES + SCAN_LANE_CASES)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,opts", [
    (2, 100, 15, 5, 64, {}), (1, 77, 8, 2, 128, dict(window=20)),
    (2, 64, 4, 4, 32, dict(attn_softcap=30.0)),
    (1, 50, 6, 2, 64, dict(causal=False)), (2, 90, 4, 4, 80, {})])
def test_flash_attention_autograd_matches_plain(dev, dtype, B, S, H, KV, hd,
                                                opts):
    """K7 under autograd on the card: the forward launches the kernel, the
    gradients match autograd through attention_ref."""
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn((B, S, n, hd), generator=g,
                               device=dev).to(dtype) for n in (H, KV, KV, H))
    out = {}
    for name, fn in (("kernel", lambda *a: fa.FlashAttention.apply(
            *a, opts.get("causal", True), opts.get("window"),
            opts.get("attn_softcap"))),
            ("plain", lambda *a: ref.attention_ref(*a, **opts))):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        before = fa.flash_attention.launches
        o = fn(*xs)
        launched = fa.flash_attention.launches - before
        out[name] = (o,) + torch.autograd.grad(o, xs, do)
        assert launched == (name == "kernel")
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,D,N,with_h0,chunk", [
    (1, 128, 8192, 16, False, 256), (2, 100, 200, 16, True, 32),
    (2, 45, 201, 8, True, 7)])
def test_selective_scan_autograd_matches_plain(dev, B, S, D, N, with_h0,
                                               chunk):
    """K8 under autograd on the card: the forward launches the kernel, the
    gradients match autograd through selective_scan_ref."""
    g = torch.Generator(device=dev).manual_seed(3)
    ins = [torch.randn((B, S, D), generator=g, device=dev),
           torch.nn.functional.softplus(
               torch.randn((B, S, D), generator=g, device=dev) - 1),
           -torch.exp(torch.randn((D, N), generator=g, device=dev) * 0.3),
           torch.randn((B, S, N), generator=g, device=dev),
           torch.randn((B, S, N), generator=g, device=dev),
           torch.randn((B, D, N), generator=g, device=dev) if with_h0
           else None]
    dy = torch.randn((B, S, D), generator=g, device=dev)
    dh = torch.randn((B, D, N), generator=g, device=dev)
    out = {}
    for name, fn in (("kernel", lambda *a: ms.SelectiveScan.apply(*a,
                                                                  chunk)),
                     ("plain", ref.selective_scan_ref)):
        xs = [None if t is None else t.clone().requires_grad_()
              for t in ins]
        before = ms.selective_scan.launches
        y, h = fn(*xs)
        assert ms.selective_scan.launches - before == (name == "kernel")
        out[name] = (y, h) + torch.autograd.grad(
            (y, h), [t for t in xs if t is not None], (dy, dh))
    torch.cuda.synchronize()
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_smoke_train_through_kernels(dev):
    """One float32 train step of each smoke model on the kernels equals
    impl="ref"'s; the kernels launched."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import init_train_state, make_train_step
    for arch, wrapper in (("smollm-360m", fa.flash_attention),
                          ("falcon-mamba-7b", ms.selective_scan)):
        cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        batch = {"tokens": np.arange(64).reshape(2, 32) % cfg.vocab_size,
                 "labels": np.arange(1, 65).reshape(2, 32) % cfg.vocab_size}
        got = {}
        for impl in ("cuda", "ref"):
            model = build_model(cfg, device="cuda", seed=1, impl=impl)
            opt = AdamW(lr=1e-3)
            before = wrapper.launches
            state, m = make_train_step(model, opt)(
                init_train_state(model, opt), batch)
            assert (wrapper.launches > before) == (impl == "cuda")
            got[impl] = (float(m["loss"]), float(m["grad_norm"]))
        assert got["cuda"][0] == pytest.approx(got["ref"][0], rel=1e-5)
        assert got["cuda"][1] == pytest.approx(got["ref"][1], rel=1e-4)


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


def test_moe_smoke_train_and_serve_through_kernels(dev):
    """qwen3-moe-30b-a3b's smoke model in float32 on the card: one train
    step on K7 equals impl="ref"'s (loss, gradient norm, the aux
    metrics), serve's tokens equal impl="ref"'s, K7 launched; the MoE
    FFN on the card equals it on the CPU."""
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import moe_ffn
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.sharding import single_device_plan
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").smoke(),
                              dtype="float32")
    batch = {"tokens": np.arange(64).reshape(2, 32) % cfg.vocab_size,
             "labels": np.arange(1, 65).reshape(2, 32) % cfg.vocab_size}
    got = {}
    for impl in ("cuda", "ref"):
        model = build_model(cfg, device="cuda", seed=1, impl=impl)
        opt = AdamW(lr=1e-3)
        before = fa.flash_attention.launches
        _, m = make_train_step(model, opt)(init_train_state(model, opt),
                                           batch)
        assert (fa.flash_attention.launches > before) == (impl == "cuda")
        got[impl] = {k: float(v) for k, v in m.items()}
    for k in ("loss", "ce", "lb_loss", "z_loss", "drop_frac"):
        assert got["cuda"][k] == pytest.approx(got["ref"][k], rel=1e-5), k
    assert got["cuda"]["grad_norm"] == pytest.approx(
        got["ref"]["grad_norm"], rel=1e-4)
    before = fa.flash_attention.launches
    served = serve(cfg, requests=4, slots=2, max_new=6, device="cuda")
    plain = serve(cfg, requests=4, slots=2, max_new=6, device="cuda",
                  impl="ref")
    assert served["served"] == 4 and served["tokens"] == plain["tokens"]
    assert fa.flash_attention.launches > before
    model = build_model(cfg, device="cpu", seed=2)
    p = {k: v.detach() for k, v in model.layers[0].moe.named_parameters()}
    x = torch.randn((3, 37, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    plan = single_device_plan().with_(moe_group_size=16)
    y, aux = moe_ffn(p, x, cfg, plan)
    yd, auxd = moe_ffn({k: v.to(dev) for k, v in p.items()}, x.to(dev), cfg,
                       plan)
    torch.testing.assert_close(yd.cpu(), y, rtol=1e-5, atol=1e-5)
    for k in aux:
        torch.testing.assert_close(auxd[k].cpu(), aux[k], rtol=1e-6, atol=0)


def test_hybrid_smoke_train_and_serve_through_kernels(dev):
    """zamba2-2.7b's smoke model in float32 on the card: one train step
    on K7 (the shared block's six invocations) equals impl="ref"'s, and
    serve's tokens equal impl="ref"'s with 2 and with 4 slots."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config("zamba2-2.7b").smoke(),
                              dtype="float32")
    batch = {"tokens": np.arange(80).reshape(2, 40) % cfg.vocab_size,
             "labels": np.arange(1, 81).reshape(2, 40) % cfg.vocab_size}
    got = {}
    for impl in ("cuda", "ref"):
        model = build_model(cfg, device="cuda", seed=1, impl=impl)
        opt = AdamW(lr=1e-3)
        before = fa.flash_attention.launches
        _, m = make_train_step(model, opt)(init_train_state(model, opt),
                                           batch)
        launched = fa.flash_attention.launches - before
        assert launched == (cfg.n_layers // cfg.hybrid_period
                            if impl == "cuda" else 0)
        got[impl] = (float(m["loss"]), float(m["grad_norm"]))
    assert got["cuda"][0] == pytest.approx(got["ref"][0], rel=1e-5)
    assert got["cuda"][1] == pytest.approx(got["ref"][1], rel=1e-4)
    before = fa.flash_attention.launches
    tokens = {}
    for slots in (2, 4):
        served = serve(cfg, requests=4, slots=slots, max_new=6,
                       device="cuda")
        plain = serve(cfg, requests=4, slots=slots, max_new=6,
                      device="cuda", impl="ref")
        assert served["served"] == 4 and served["tokens"] == plain["tokens"]
        tokens[slots] = served["tokens"]
    assert tokens[2] == tokens[4]
    assert fa.flash_attention.launches > before


def _left_padded(lengths, S, device):
    """(B, S) int64 positions: -1 on each row's leading pads, then 0, 1,
    ..."""
    return torch.stack([torch.cat([torch.full((S - n,), -1),
                                   torch.arange(n)]) for n in lengths]
                       ).to(device)


# K7 by positions on both kernels: (dtype, H, KV, hd); bf16 at hd 64 and
# 128 on the tensor cores, the rest on the CUDA cores
POSITION_KERNELS = [(torch.bfloat16, 15, 5, 64), (torch.bfloat16, 32, 4, 128),
                    (torch.float32, 4, 2, 80), (torch.bfloat16, 4, 2, 80),
                    (torch.float32, 4, 2, 256), (torch.bfloat16, 4, 2, 256),
                    (torch.float32, 6, 2, 64)]


@pytest.mark.parametrize("dtype,H,KV,hd", POSITION_KERNELS)
def test_flash_attention_by_positions_matches_plain(dev, dtype, H, KV, hd):
    """K7 masking by positions on the card against attention_ref: left
    pads (one row all pads), offsets, a window with softcap, S = 150
    (ragged tiles); positions arange bit-equal to the index path; and
    under autograd, its gradients against autograd through the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, S = 4, 150
    q, k, v, do = (torch.randn((B, S, n, hd), generator=g,
                               device=dev).to(dtype) for n in (H, KV, KV, H))
    pads = _left_padded((S, 100, 37, 0), S, dev)
    offset = _left_padded((S,) * 4, S, dev) + torch.tensor(
        [[0], [3], [64], [500]], device=dev)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for pos, opts in ((pads, {}), (offset, {}),
                      (pads, dict(window=40, attn_softcap=30.0))):
        kw = dict(opts, q_positions=pos, kv_positions=pos)
        torch.testing.assert_close(fa.flash_attention(q, k, v, **kw),
                                   ref.attention_ref(q, k, v, **kw),
                                   atol=tol, rtol=tol)
    ar = torch.arange(S, device=dev).expand(B, S).contiguous()
    for opts in ({}, dict(window=40, attn_softcap=30.0)):
        assert torch.equal(fa.flash_attention(q, k, v, q_positions=ar,
                                              kv_positions=ar, **opts),
                           fa.flash_attention(q, k, v, **opts))
    out = {}
    for name, fn in (("kernel", lambda *a: fa.FlashAttention.apply(
            *a, True, 40, None, pads, pads)),
            ("plain", lambda *a: ref.attention_ref(
                *a, window=40, q_positions=pads, kv_positions=pads))):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*xs)
        out[name] = (o,) + torch.autograd.grad(o, xs, do)
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


def test_write_cache_keeps_valid_entries_on_the_card(dev):
    """Left pads clamp onto slot 0 (a rolling cache's W - 1) beside a
    valid entry; on the card, whatever order the scatter takes, each
    valid position's K/V lands in its slot and no pad's does (a rolling
    cache after ``prefill_tail``, as prefill writes it)."""
    from repro_torch.models import attention as A
    B, T, size = 8, 64, 80
    pos = _left_padded([T - 7 * b for b in range(B)], T, dev)
    k = torch.randn((B, T, 2, 16), device=dev)
    for window in (None, 16):
        ck, cv = (torch.zeros((B, size if window is None else window, 2, 16),
                              device=dev) for _ in range(2))
        sp = torch.full(ck.shape[:2], -1, dtype=torch.int64, device=dev)
        # a rolling cache takes the last W positions, as prefill does
        kk, _, pp = (k, k, pos) if window is None else \
            A.prefill_tail(k, k, pos, window)
        A.write_cache(ck, cv, sp, kk, kk, pp, rolling_window=window)
        for b in range(B):
            for t in range(pp.shape[1]):
                p = int(pp[b, t])
                if p >= 0:
                    slot = p % window if window else p
                    assert int(sp[b, slot]) == p
                    assert torch.equal(ck[b, slot], kk[b, t])
        assert int((sp >= 0).sum()) == int((pp >= 0).sum())


@pytest.mark.parametrize("arch,over", [("smollm-360m", {}),
                                       ("zamba2-2.7b", {"ssm_version": 1})])
def test_positions_and_mamba1_hybrid_smoke_on_the_card(dev, arch, over):
    """The smoke model (smollm; the Mamba1 hybrid: K8 once a block, K7
    once a group) in float32 on the card through the kernels against
    impl="ref" (the plain versions, the same seeded parameters): a
    left-padded batch's train loss within 1e-5, prefill then 4 decode
    steps from each row's next position within 1e-3."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime.steps import make_loss_fn
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32",
                              **over)
    B, S = 2, 40
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    pos = _left_padded((S - 13, S), S, "cpu").numpy()
    batch = {"tokens": toks, "positions": pos,
             "labels": np.where(pos < 0, -1, np.roll(toks, -1, 1))}
    out = {}
    for impl in ("cuda", "ref"):
        model = build_model(cfg, device="cuda", seed=4, impl=impl)
        before = (fa.flash_attention.launches,
                  ms.selective_scan.launches)
        loss, _ = make_loss_fn(model)(batch)
        launched = (fa.flash_attention.launches - before[0],
                    ms.selective_scan.launches - before[1])
        attn = cfg.n_layers // (cfg.hybrid_period
                                if cfg.family == "hybrid" else 1)
        assert launched == ((attn, cfg.n_layers if over else 0)
                            if impl == "cuda" else (0, 0))
        with torch.no_grad():
            logits, cache = model.prefill(batch, cache_len=S + 4)
            steps = [logits.cpu()]
            q0 = pos[:, -1] + 1
            for t in range(4):
                logits, cache = model.decode_step(
                    cache, {"tokens": toks[:, t:t + 1]}, q0 + t)
                steps.append(logits.cpu())
        out[impl] = (float(loss.detach()), steps)
    assert out["cuda"][0] == pytest.approx(out["ref"][0], rel=1e-5)
    for a, b in zip(out["cuda"][1], out["ref"][1]):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


# gemma2-9b's heads (16:8, hd 256: the CUDA-core kernel in both dtypes,
# one 213,760-byte block an SM) with its softcap, windowed as its local
# layers are; mixtral-8x7b's (32:8, hd 128, bf16 on the tensor cores),
# windowed
SWA_LOCAL_GLOBAL_ATTN = [
    (1, 100, 16, 8, 256, {}), (2, 300, 16, 8, 256, dict(attn_softcap=50.0)),
    (1, 200, 16, 8, 256, dict(window=64, attn_softcap=50.0)),
    (1, 300, 32, 8, 128, dict(window=128))]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,KV,hd,opts", SWA_LOCAL_GLOBAL_ATTN)
def test_swa_local_global_attention_matches_plain(dev, dtype, tol, B, S, H,
                                                  KV, hd, opts):
    """K7 at gemma2's and mixtral's heads, forward (one launch), and under
    autograd: the analytic backward with the window and the softcap
    against autograd through attention_ref."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v, do = (torch.randn((B, S, n, hd), generator=g,
                               device=dev).to(dtype) for n in (H, KV, KV, H))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **opts)
    want = ref.attention_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    out = {}
    for name, fn in (("kernel", lambda *a: fa.FlashAttention.apply(
            *a, True, opts.get("window"), opts.get("attn_softcap"))),
            ("plain", lambda *a: ref.attention_ref(*a, **opts))):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*xs)
        out[name] = (o,) + torch.autograd.grad(o, xs, do)
    torch.cuda.synchronize()
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "gemma2-9b"])
def test_swa_local_global_smoke_train_and_serve_on_card(dev, arch):
    """mixtral's (swa) and gemma2's (local_global, at 4 layers: two
    pairs) smoke models in float32 on the card against the same models
    (the parameters drawn on the CPU) on the CPU: one train step at S = 40
    over a window of 16 (loss, gradient norm; K7 launched once a layer),
    and serve's tokens with 2 and 4 slots, prompt 16 and 10 new tokens, so
    decode rolls the local caches."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    if cfg.attention == "local_global":
        cfg = dataclasses.replace(cfg, n_layers=4)
    batch = {"tokens": np.arange(80).reshape(2, 40) % cfg.vocab_size,
             "labels": np.arange(1, 81).reshape(2, 40) % cfg.vocab_size}
    params = {k: v.detach().clone() for k, v in build_model(
        cfg, device="cpu", seed=1).state_dict().items()}
    got = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device)
        model.load_state_dict(params)
        opt = AdamW(lr=1e-3)
        before = fa.flash_attention.launches
        _, m = make_train_step(model, opt)(init_train_state(model, opt),
                                           batch)
        launched = fa.flash_attention.launches - before
        assert launched == (cfg.n_layers if device == "cuda" else 0)
        got[device] = {k: float(v) for k, v in m.items()}
    assert got["cuda"]["loss"] == pytest.approx(got["cpu"]["loss"], rel=1e-5)
    assert got["cuda"]["grad_norm"] == pytest.approx(
        got["cpu"]["grad_norm"], rel=1e-4)
    before = fa.flash_attention.launches
    for slots in (2, 4):
        served, cpu = (serve(cfg, params, requests=4, slots=slots,
                             max_new=10, device=d) for d in ("cuda", "cpu"))
        assert served["served"] == 4 and served["tokens"] == cpu["tokens"]
        torch.testing.assert_close(served["first_logits"],
                                   cpu["first_logits"], atol=1e-4,
                                   rtol=1e-4)
    assert fa.flash_attention.launches > before


# musicgen-medium's heads (24:24, hd 64: group size 1 on the tensor-core
# kernel in bfloat16), causal and not
VLM_AUDIO_ATTN = [(2, 256, 24, 24, 64, {}), (1, 130, 24, 24, 64, {}),
                  (1, 77, 24, 24, 64, dict(causal=False))]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,KV,hd,opts", VLM_AUDIO_ATTN)
def test_vlm_audio_attention_matches_plain(dev, dtype, tol, B, S, H, KV, hd,
                                           opts):
    """K7 at musicgen's heads, forward (one launch) and under autograd
    against autograd through attention_ref."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn((B, S, n, hd), generator=g,
                               device=dev).to(dtype) for n in (H, KV, KV, H))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **opts)
    want = ref.attention_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    out = {}
    for name, fn in (("kernel", lambda *a: fa.FlashAttention.apply(
            *a, opts.get("causal", True), None, None)),
            ("plain", lambda *a: ref.attention_ref(*a, **opts))):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*xs)
        out[name] = (o,) + torch.autograd.grad(o, xs, do)
    torch.cuda.synchronize()
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_vlm_audio_smoke_train_and_serve_on_card(dev, arch):
    """The vlm's and musicgen's smoke models in float32 on the card
    against the same models (parameters drawn on the CPU, the vlm's cross
    gates set non-zero: ``open_gates``) on the CPU: one train step (loss, gradient norm; K7
    launched once a self block), then a Model-API prefill of 4 prompts of
    16 and 4 decode steps (the vlm's greedy tokens, musicgen's seeded
    frames): logits within 1e-4, the vlm's tokens equal."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import (init_train_state, make_decode_step,
                                           make_prefill_step, make_train_step)
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    model = open_gates(build_model(cfg, device="cpu", seed=1))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = inputs(cfg, seed=0, B=2, S=40)
    batch["labels"] = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                        (2, 40))
    B, P, new = 4, 16, 4
    wave = inputs(cfg, seed=1, B=B, S=P)
    frames = inputs(cfg, seed=2, B=B, S=new).get("embeddings")
    got = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device)
        model.load_state_dict(params)
        opt = AdamW(lr=1e-3)
        before = fa.flash_attention.launches
        _, m = make_train_step(model, opt)(init_train_state(model, opt),
                                           batch)
        launched = fa.flash_attention.launches - before
        assert launched == (len(model.layers) if device == "cuda" else 0)
        model.load_state_dict(params)
        logits, cache = make_prefill_step(model, cache_len=P + new)(wave)
        decode, out = make_decode_step(model), [logits.cpu()]
        for t in range(new):
            step = {"embeddings": frames[:, t:t + 1]} if frames is not None \
                else {"tokens": out[-1].argmax(-1)[:, None].numpy()}
            logits, cache = decode(cache, step, np.full(B, P + t))
            out.append(logits.cpu())
        got[device] = ({k: float(v) for k, v in m.items()}, out)
    assert got["cuda"][0]["loss"] == pytest.approx(got["cpu"][0]["loss"],
                                                   rel=1e-5)
    assert got["cuda"][0]["grad_norm"] == pytest.approx(
        got["cpu"][0]["grad_norm"], rel=1e-4)
    for a, b in zip(got["cuda"][1], got["cpu"][1]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


@functools.lru_cache(maxsize=1)
def _shared_join_cases():
    return jc.join_cases()


INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
# name -> (S, R, key range, values' range): random keys from numpy; then
# the cases of join_cases, each shaped to reach one mode of the kernels
# (the hash join's dense array or table, the merge join's staged or
# narrowed tiles) or one edge: a key range over int32, key -1 with value
# -1 among keys that start at its slot, clustered and scattered probes,
# tile ranges at the staging budget and one over, all probes equal, S not
# a multiple of the 16-byte width
JOIN_CASES = {
    "pk": (1024, 512, (0, 5000), (0, 1 << 20)),
    "duplicates-negative": (10_007, 3_001, (-300, 300),
                            (INT32_MIN, INT32_MAX)),
    "full-range": (100_003, 50_001, (INT32_MIN, INT32_MAX),
                   (INT32_MIN, INT32_MAX)),
    "r1": (257, 1, (0, 3), (-9, 9)),
    "r0": (33, 0, (0, 3), (0, 1)),
    "s0": (0, 64, (0, 100), (0, 100)),
    **{name: None for name in _shared_join_cases()},
}


def _join_inputs(name):
    if JOIN_CASES[name] is None:
        return _shared_join_cases()[name]
    S, R, (klo, khi), (vlo, vhi) = JOIN_CASES[name]
    rng = np.random.default_rng(7)
    probe = rng.integers(klo, khi, S, dtype=np.int64).astype(np.int32)
    keys = rng.integers(klo, khi, R, dtype=np.int64).astype(np.int32)
    vals = rng.integers(vlo, vhi, R, dtype=np.int64).astype(np.int32)
    probe[: min(S, 3)] = [INT32_MIN, INT32_MAX, 0][: min(S, 3)]
    return probe, keys, vals


def _on_card(x, dev, offset):
    """x on the card; with offset 1 a slice one element into a larger
    tensor, so its data pointer is 4 bytes off a 16-byte boundary."""
    t = torch.zeros(x.size + offset, dtype=torch.int32, device=dev)
    t[offset:] = torch.from_numpy(x)
    return t[offset:]


@pytest.mark.parametrize("name", sorted(JOIN_CASES))
def test_join_kernels_equal_plain(dev, name):
    probe, keys, vals = _join_inputs(name)
    S = probe.size
    sk, sv = jc.sorted_build(keys, vals)
    before = (hj.hash_join.launches, mj.merge_join.launches)
    for offset in (0, 1):
        p, k, v, sk_, sv_ = (_on_card(x, dev, offset)
                             for x in (probe, keys, vals, sk, sv))
        assert offset == 0 or S == 0 or p.data_ptr() % 16
        for kernel, plain, args in ((hj.hash_join, ref.hash_join_ref,
                                     (p, k, v)),
                                    (hj.hash_join, ref.hash_join_ref,
                                     (p, sk_, sv_)),
                                    (mj.merge_join, ref.merge_join_ref,
                                     (p, sk_, sv_))):
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, want), \
                (name, offset, kernel.__name__)
    launched = S > 0
    assert (hj.hash_join.launches, mj.merge_join.launches) == \
        (before[0] + 4 * launched, before[1] + 2 * launched)


def test_merge_join_sizes_match_the_source(dev):
    """The wrapper's TILE, STAGE and SAMPLE, which the cases are shaped
    by, are the sizes the kernel was compiled with."""
    import ctypes
    sizes = (ctypes.c_int32 * 3)()
    build.load_library("merge_join").merge_join_sizes(sizes)
    assert list(sizes) == [mj.TILE, mj.STAGE, mj.SAMPLE]


def test_join_kernels_first_match(dev):
    """Duplicate build keys and values below -1: the first matching row's
    value, as the reference's oracles give it."""
    p, k, v = (torch.tensor(xs, dtype=torch.int32, device=dev)
               for xs in ([5, 9, 2, 3], [2, 5, 9, 9], [20, -50, 90, 91]))
    assert hj.hash_join(p, k, v).tolist() == [-50, 90, 20, -1]
    assert mj.merge_join(p, k, v).tolist() == [-50, 90, 20, -1]
    assert hj.hash_join(p, k.flip(0), v.flip(0)).tolist() == \
        [-50, 91, 20, -1]


def test_streaming_service_through_kernels_matches_solo(dev):
    schema = random_schema(10, seed=0)
    backend = ps.CudaPlanBackend()

    def raqo():
        return RAQO(schema, models=cm.simulator_cost_models(),
                    cluster=paper_cluster(), resource_planning="batched",
                    backend=backend, broker=PlanBroker(backend))

    trace = poisson_trace(schema, 24, rate=1000.0, seed=3, tenants=6)
    before = ps.scan_argmin.launches
    svc = StreamingPlannerService(raqo())
    tickets = svc.run_closed_loop([(a.tenant, a.tables) for a in trace],
                                  concurrency=8)
    assert ps.scan_argmin.launches > before
    for t in tickets:
        solo = raqo().joint(t.tables)
        assert (solo.plan.describe(), solo.exec_time, solo.money) == \
            (t.joint.plan.describe(), t.joint.exec_time, t.joint.money)


ND_GRIDS = [ClusterConditions(dims=(
    ResourceDim("a", 1, 301, 3), ResourceDim("b", 1, 9),
    ResourceDim("c", 1, 8, values=(1, 2, 4, 8)))),
    ClusterConditions(dims=tuple(ResourceDim(f"d{i}", 0, 3)
                                 for i in range(ps.MAX_DIMS)))]


def test_nd_table_kernels_bit_equal_plain(dev):
    """K1/K2 and K3 on 3-D and MAX_DIMS-D grids over a cost table."""
    rng = np.random.default_rng(3)
    for cluster in ND_GRIDS:
        shape = tuple(len(d.grid()) for d in cluster.dims)
        table = rng.integers(0, 1 << 20, size=shape).astype(np.float64)
        table[rng.random(shape) < 0.3] = np.inf
        s = cm.Surface(cm.CostTable.of(cluster, table))
        dims = ps.grid_dims(cluster, dev)
        p = torch.tensor(rng.integers(0, 9, (70, 1)), dtype=torch.float32,
                         device=dev)
        want = ps.scan_argmin_ref(s, dims, p)
        for qb in (1, ps.UNROLL_Q):
            got = ps.scan_argmin(s, dims, p, qb)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        cur = torch.tensor(np.stack([rng.integers(0, n, 40) for n in shape],
                                    1), device=dev)
        got = ps.neighbor_step(s, dims, cur, p[:1])
        want = ps.neighbor_step_ref(s, dims, cur, p[:1])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = ps.ensemble_climb(s, dims, cur, p[:3], 100_000)
        want = ps.ensemble_climb_ref(s, dims, cur, p[:3], 100_000)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("max_iters", [1, 2, 3, 100_000])
@pytest.mark.parametrize("objective", ["time", "money", "sla"])
def test_ensemble_climb_bit_equal_plain(dev, objective, max_iters):
    """K3's whole climb in one launch: final indices, costs, iteration and
    neighbour counts equal to the host loop of neighbor_step_ref."""
    rng = np.random.default_rng(max_iters)
    for cluster in GRIDS:
        dims = ps.grid_dims(cluster, dev)
        cur = np.stack([rng.integers(0, d.size, 26) for d in dims], 1)
        cur[0], cur[1] = 0, [d.size - 1 for d in dims]
        cur = torch.tensor(cur, device=dev)
        for models in (cm.paper_models(), cm.simulator_cost_models()):
            for model in models.values():
                s = cm.Surface(model, objective)
                ss = rng.uniform(0.01, 40, 3)
                cols = [ss, ss + rng.uniform(0, 100, 3)]
                if objective == "sla":
                    cols.append(rng.uniform(1, 30, 3))
                p = torch.tensor(np.stack(cols, 1), dtype=torch.float32,
                                 device=dev)
                before = ps.ensemble_climb.launches
                got = ps.ensemble_climb(s, dims, cur, p, max_iters)
                want = ps.ensemble_climb_ref(s, dims, cur, p, max_iters)
                assert ps.ensemble_climb.launches == before + 1
                assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("D", [1, 2, 3, 4, 7])
def test_sharded_scan_bit_equal_single_launch_and_plain(dev, D):
    """K4 over D logical shards of one card (and real GPUs when there are
    enough): ties across every shard boundary and a ragged last shard."""
    rng = np.random.default_rng(D)
    cluster = ClusterConditions(dims=(ResourceDim("nc", 1, 3197),
                                      ResourceDim("cs", 1, 8)))
    dims = ps.grid_dims(cluster, dev)
    ties = cm.Surface(cm.RegressionModel(
        "ties", np.array([2000.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0])), "time")
    sim = cm.Surface(cm.simulator_cost_models()["SMJ"], "time")
    ss = rng.uniform(0.01, 1.5, 33)
    p = torch.tensor(np.stack([ss, ss + rng.uniform(0, 50, 33)], 1),
                     dtype=torch.float32, device=dev)
    shard_sets = [[dev] * D]
    if torch.cuda.device_count() >= D:
        shard_sets.append([torch.device("cuda", i) for i in range(D)])
    for s in (ties, sim):
        for Q in (1, 33):
            one = ps.scan_argmin(s, dims, p[:Q], min(Q, ps.UNROLL_Q))
            plain = ps.scan_argmin_sharded_ref(s, dims, p[:Q], D)
            for devices in shard_sets:
                before = ps.scan_argmin_sharded.launches
                got = ps.scan_argmin_sharded(s, dims, p[:Q], devices,
                                             min(Q, ps.UNROLL_Q))
                assert ps.scan_argmin_sharded.launches - before == \
                    sum(1 for _, n in ps.shard_spans(3197 * 8, D) if n)
                assert all(torch.equal(a.to(dev), b) and torch.equal(b, c)
                           for a, b, c in zip(got, one, plain))


def test_sharding_planner_on_kernels_matches_torch(dev):
    from repro_torch.core.sharding_planner import ShardingPlanner
    from repro_torch.configs import get_shape
    for arch in ("smollm-360m", "qwen3-moe-30b-a3b", "falcon-mamba-7b"):
        for sname in ("train_4k", "prefill_32k", "decode_32k"):
            for mode in ("hillclimb", "ensemble", "brute"):
                got = ShardingPlanner(resource_planning=mode).joint(
                    get_config(arch), get_shape(sname))
                want = ShardingPlanner(resource_planning=mode,
                                       backend="torch").joint(
                    get_config(arch), get_shape(sname))
                assert (got.resources, got.plan_choice,
                        got.objective_value) == \
                    (want.resources, want.plan_choice, want.objective_value)


_LOCAL_MAP_CASES = [
    ("falcon-mamba-7b", "selective_scan", "_selective_scan_sharded", {}),
    ("mixtral-8x7b", "flash_attention", "_flash_attention_sharded", {}),
    ("zamba2-2.7b", "flash_attention", "_flash_attention_sharded", {}),
    ("gemma2-9b", "flash_attention", "_flash_attention_sharded", {}),
    ("llama-3.2-vision-11b", "flash_attention", "_flash_attention_sharded",
     {}),
    ("smollm-360m", "flash_attention", "_flash_attention_sharded",
     {"tp_mode": "shard_map", "attention_schedule": "causal_skip"}),
    ("llama-3.2-vision-11b", "flash_attention", "_flash_attention_sharded",
     {"tp_mode": "shard_map"})]


@pytest.mark.parametrize(
    "arch,kernel,path,plan_kw", _LOCAL_MAP_CASES,
    ids=["-".join([a, k, p] + [str(v) for v in kw.values()])
         for a, k, p, kw in _LOCAL_MAP_CASES])
def test_kernels_launch_through_local_map_on_the_card(monkeypatch, arch,
                                                      kernel, path, plan_kw):
    """A world of one over NCCL: the smoke model's loss and gradients on
    the (1, 1, 1) mesh under plan_for's train plan (with ``plan_kw``)
    equal one device's (LOSS_TOL; GRAD_TOL of each tensor's largest), and
    its kernel (K8 for falcon; K7 for mixtral, its window of 16 engaged at
    S=64, for zamba2's shared block, for gemma2's (local, global) pair
    with its softcap, the local layer's window of 16 engaged, for the
    vlm's self blocks, its gates open, and for smollm under causal_skip)
    launches as often on both, each launch on the mesh through its
    ``local_map`` wrapper in ``kernels.ops``; the vlm's cross blocks
    attend through their own on the mesh.  Under tp_mode="shard_map"
    (smollm, the vlm) the explicit projections run over NCCL, as many as
    ``fx.explicit_projections`` counts a forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import socket
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import plan_for
    from repro_torch.models import attention
    from repro_torch.models.model import build_model
    from repro_torch import sharding
    from repro_torch.runtime.steps import make_loss_fn
    from repro_torch.sharding import full
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        cfg = fx.smoke_cfg(arch)
        batch = fx.batch(cfg, 2, 64)
        mesh = make_mesh((1, 1, 1), fx.AXES)
        sharded = getattr(ops, path)
        calls, cross = [], []
        monkeypatch.setattr(ops, path,
                            lambda *a: calls.append(1) or sharded(*a))
        cross_sharded = attention._cross_attention_sharded
        monkeypatch.setattr(attention, "_cross_attention_sharded",
                            lambda *a: cross.append(1) or cross_sharded(*a))
        explicit = {"col": 0, "row": 0}
        for kind in explicit:
            fn = getattr(sharding, f"explicit_{kind}_project")
            monkeypatch.setattr(
                sharding, f"explicit_{kind}_project",
                lambda *a, _fn=fn, _k=kind: explicit.update(
                    {_k: explicit[_k] + 1}) or _fn(*a))
        out = {}
        # remat none on both, so each launches its kernel once a layer
        for name, plan in (("one", None), ("mesh", plan_for(
                cfg, ShapeConfig("train", 64, 2, "train"), mesh,
                remat="none", **plan_kw))):
            model = open_gates(build_model(cfg, plan, device="cuda",
                                           seed=0))
            ops.reset_launch_counts()
            loss, _ = make_loss_fn(model)(batch)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            out[name] = (float(loss.detach()),
                         [full(g).cpu() for g in grads],
                         getattr({"selective_scan": ms,
                                  "flash_attention": fa}[kernel],
                                 kernel).launches)
        (l1, g1, k1), (l2, g2, k2) = out["one"], out["mesh"]
        assert k1 == k2 == len(calls) > 0
        assert len(cross) == (cfg.n_layers // cfg.cross_attn_period
                              if cfg.family == "vlm" else 0)
        col, row = fx.explicit_projections(cfg) \
            if plan_kw.get("tp_mode") == "shard_map" else (0, 0)
        assert (explicit["col"], explicit["row"]) == (col, row)
        assert abs(l2 / l1 - 1) <= fx.LOSS_TOL
        for a, b in zip(g2, g1):
            assert float((a - b).abs().max() / b.abs().max()) <= fx.GRAD_TOL
    finally:
        dist.destroy_process_group()


def test_serve_plans_on_the_card():
    """A world of one over NCCL: the smoke smollm-360m (float32) prefills
    a prompt of 18 into a cache of 22 slots under plan_for's prefill plan
    and takes 4 greedy decode steps under its decode plan over the same
    parameter tensors, on the (1, 1, 1) mesh; its logits equal one
    device's (prefill 1e-4, decode 1e-3), its greedy tokens and prefill
    cache (1e-5) too, K7 launches through its ``local_map`` once a layer
    in prefill and never in decode, and decode attention and the cache
    writes run on the DTensor cache
    (``test_torch_multidevice_serve.py``'s twin)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        arch = "smollm-360m"
        cfg = fx.smoke_cfg(arch)
        batch, _ = fx.serve_inputs(arch, 2)
        one = fx.serve_one_device(arch, batch, None, device="cuda")
        paths = fx.count_paths()
        mesh = make_mesh((1, 1, 1), fx.AXES)
        prefill, decode = fx.serve_plans(cfg, mesh, 2)
        model = build_model(cfg, prefill, device="cuda", seed=0)
        got = {}
        fa.flash_attention.launches = 0

        def record(key, t):
            if key == "prefill":
                got["k7"] = fa.flash_attention.launches
            got[key] = t.detach().cpu().numpy()

        fx.serve_run(model, model.with_plan(decode), batch,
                     lambda t, _: {"tokens": one[f"step{t}/tokens"]},
                     record)
        n = cfg.n_layers
        assert got["k7"] == fa.flash_attention.launches == n
        assert paths["_flash_attention_sharded"] == n
        assert paths["_decode_attention_sharded"] == n * fx.SERVE_NEW
        assert paths["_write_cache_sharded"] == n * (1 + fx.SERVE_NEW)
        for key, tol in [("prefill", 1e-4)] + [
                (f"decode{t}", 1e-3) for t in range(fx.SERVE_NEW)]:
            np.testing.assert_allclose(got[key], one[key], atol=tol,
                                       rtol=tol)
            assert np.array_equal(got[key].argmax(-1), one[key].argmax(-1))
        for key in (k for k in one if k.startswith("cache/")):
            np.testing.assert_allclose(got[key], one[key], atol=1e-5,
                                       rtol=1e-5)
    finally:
        dist.destroy_process_group()


# ---- the planning twins' float32 lanes on the card ------------------------ #
# The reference's jax lanes (test_plan_broker.py, test_planning_backend.py,
# test_lockstep.py) are the CUDA backend's: here on the card, held against
# the port's exact "torch" backend, which the CPU twins hold against the
# reference's numpy backend.

def _twin_ops(rng, n):
    impls = ("SMJ", "BHJ")
    return [(impls[int(rng.integers(2))],
             float(np.round(rng.uniform(0.2, 8.0), 3)),
             float(np.round(rng.uniform(5.0, 300.0), 3))) for _ in range(n)]


def _twin_ragged():
    return ClusterConditions(dims=(
        ResourceDim("num_containers", 1, 38, step=3),
        ResourceDim("container_gb", 1, 10, values=(1, 2, 3, 5, 8, 10))))


@pytest.mark.parametrize("mode", ["batched", "ensemble"])
@pytest.mark.parametrize("ragged", [False, True])
def test_broker_on_kernels_matches_torch(dev, mode, ragged):
    """test_plan_broker.py's jax lane: brokered planning on the kernels
    plans what the exact backend plans (winners re-committed in float64
    on both)."""
    from repro_torch.core.plans import OperatorCosting
    for seed in range(6):
        ops = _twin_ops(np.random.default_rng(seed), 5)
        res = {}
        for name, be in (("cuda", ps.CudaPlanBackend()), ("torch", "torch")):
            c = OperatorCosting(models=cm.simulator_cost_models(),
                                cluster=_twin_ragged() if ragged else
                                paper_cluster(30, 8),
                                resource_planning=mode,
                                broker=PlanBroker(be), backend=be)
            for op in ops:
                c.prefetch(*op)
            res[name] = [c.plan_resources(*op) for op in ops]
        for (rj, cj), (rn, cn) in zip(res["cuda"], res["torch"]):
            if np.isinf(cn):
                assert np.isinf(cj)
            else:
                assert rj == rn and cj == pytest.approx(cn, rel=1e-12)


def test_float32_lane_on_kernels_matches_torch(dev):
    """test_planning_backend.py's jax lane: scans and ensemble climbs of
    integer tables (exact in float32) on the kernels equal the exact
    backend's, ties and OOM cells included."""
    from repro_torch.core.planning_backend import get_backend
    rng = np.random.default_rng(7)
    for ragged in (False, True) * 4:
        if ragged:
            cluster = _twin_ragged()
        else:
            cluster = paper_cluster(int(rng.integers(2, 12)),
                                    int(rng.integers(2, 9)))
        shape = tuple(len(d.grid()) for d in cluster.dims)
        table = rng.integers(0, 1 << 20, size=shape).astype(np.float64)
        table[rng.random(shape) < 0.15] = np.inf
        s = cm.Surface(cm.CostTable.of(cluster, table))

        def fn(cfgs, params):
            return s(cfgs, params)
        fn.surface = s
        zero = np.zeros(1)
        cuda, exact = ps.CudaPlanBackend(), get_backend("torch")
        assert cuda.argmin_grid(fn, cluster, params=zero) == \
            exact.argmin_grid(fn, cluster, params=zero)
        for n_random in (0, 6):
            assert cuda.hill_climb_ensemble(fn, cluster, params=zero,
                                            n_random=n_random, seed=3) == \
                exact.hill_climb_ensemble(fn, cluster, params=zero,
                                          n_random=n_random, seed=3)


@pytest.mark.parametrize("objective", ["time", "money"])
def test_operator_costing_on_kernels_matches_torch(dev, objective):
    from repro_torch.core.plans import OperatorCosting
    for ss, ls in ((0.5, 74.0), (2.0, 10.0), (6.0, 200.0)):
        got, want = (OperatorCosting(
            models=cm.simulator_cost_models(), cluster=paper_cluster(100, 10),
            objective=objective, resource_planning="batched",
            backend=be).plan_resources("SMJ", ss, ls)
            for be in (None, "torch"))
        assert got[0] == want[0]
        assert got[1] == pytest.approx(want[1], rel=1e-12)


def test_lockstep_on_8_logical_shards_of_the_card(dev):
    """test_lockstep.py's 8-simulated-device lane: 8 logical shards of the
    card plan lockstep as sequentially, as one device, and as the exact
    backend, in fewer waves."""
    schema = random_schema(8, seed=3)
    queries = [random_query(schema, k, seed=q)
               for q, k in enumerate((5, 3, 1, 4, 5))]

    def run(backend):
        def raqo(broker):
            return RAQO(schema, cluster=paper_cluster(24, 8),
                        backend=backend, resource_planning="batched",
                        broker=broker)
        b_lock, b_seq = PlanBroker(backend), PlanBroker(backend)
        lock = raqo(b_lock).plan_queries(queries)
        r_seq = raqo(b_seq)
        seq = [r_seq.joint(q) for q in queries]
        sig = [(jp.plan.describe(), jp.exec_time) for jp in lock]
        assert sig == [(jp.plan.describe(), jp.exec_time) for jp in seq]
        sl, ss = b_lock.counters_snapshot(), b_seq.counters_snapshot()
        assert sl["requests"] - sl["dedup_hits"] == \
            ss["requests"] - ss["dedup_hits"]
        assert sl["waves"] < ss["waves"]
        return sig

    sharded = ps.CudaPlanBackend(devices=["cuda"] * 8)
    assert sharded.device_count() == 8
    assert run(sharded) == run(ps.CudaPlanBackend(devices=1)) == run("torch")


COST_GRID_FAMILIES = ("paper_models", "simulator_models",
                      "simulator_cost_models")
# test_batched_costing.py's (ss, ls) points
COST_GRID_POINTS = ((0.5, 74.0), (2.0, 10.0), (6.0, 200.0))


def test_cost_grid_float64_on_card_bit_equal_scalar(dev):
    """The float64 cost surfaces on CUDA tensors equal the scalar cost
    and the same grid on CPU tensors bit for bit, infinities included
    (chip_smoke.py phase 4 runs the same check on a larger grid)."""
    from repro_torch.core.plans import OperatorCosting
    from repro_torch.core.planning_backend import enumerate_configs
    cluster = paper_cluster(100, 10)
    cpu = torch.as_tensor(enumerate_configs(cluster))
    on_card = cpu.to(dev)
    for family in COST_GRID_FAMILIES:
        models = getattr(cm, family)()
        for objective in ("time", "money"):
            c = OperatorCosting(models=models, cluster=cluster,
                                objective=objective, backend="torch")
            for impl in ("SMJ", "BHJ"):
                for ss, ls in COST_GRID_POINTS:
                    g = c._op_cost_grid(impl, ss, ls, on_card)
                    assert g.dtype == torch.float64
                    assert g.device == on_card.device
                    g = g.cpu()
                    assert torch.equal(g, c._op_cost_grid(impl, ss, ls, cpu))
                    want = torch.tensor([c._op_cost_at(impl, ss, ls, tuple(r))
                                         for r in cpu.tolist()],
                                        dtype=torch.float64)
                    assert torch.equal(g, want), (family, objective, impl,
                                                  ss, ls)
