"""The port's model kernels (K7 flash attention, K8 selective scan) through
their plain versions on the CPU, against the reference's Pallas kernels in
interpret mode and its jnp oracles (``repro.kernels.ref``).

Inputs are drawn with numpy from a seed and handed to both packages (bf16
cases round the same float32 draws to bfloat16 on both sides).
Tolerances are those of ``tests/test_kernels.py``: 1e-5 for float32
attention (same float32 arithmetic, other summation order), 2e-2 for
bfloat16 attention (the Pallas kernel rounds p to bfloat16 before the PV
product, the oracles do not), 1e-4 for the scan (the Pallas kernel and
the sequential oracles step the same recurrence; sums over N differ in
order).  S stays <= 128 so interpret mode stays quick.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from fixtures_torch_threads import few_threads  # noqa: F401 (autouse)

ATTN_CASES = {          # B, S, H, KV, hd
    "mha": (1, 128, 4, 4, 64),
    "gqa2": (2, 128, 4, 2, 64),
    "g3": (1, 64, 6, 2, 32),
    "mqa": (1, 128, 8, 1, 64),
    "ragged100": (2, 100, 6, 2, 16),
}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _attn_inputs(B, S, H, KV, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tt


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else jnp.asarray(got, jnp.float32)),
        np.asarray(jnp.asarray(want, jnp.float32)), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(case, dtype):
    B, S, H, KV, hd = ATTN_CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(B, S, H, KV, hd, dtype)
    got = tops.flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL[dtype]
    _close(got, rops.flash_attention(jq, jk, jv), tol)          # Pallas
    _close(got, rref.attention_ref(jq, jk, jv), tol)            # oracle


@pytest.mark.parametrize("opts", [
    dict(window=32, attn_softcap=30.0), dict(window=64, attn_softcap=30.0),
    dict(causal=False)], ids=["window32_cap", "window64_cap", "noncausal"])
def test_flash_attention_options(opts):
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(1, 128, 2, 2, 64, "float32",
                                              seed=1)
    got = tops.flash_attention(tq, tk, tv, **opts)
    _close(got, rops.flash_attention(jq, jk, jv, block_q=64, block_kv=64,
                                     **opts), 1e-5)
    _close(got, rref.attention_ref(jq, jk, jv, **opts), 1e-5)


def _scan_inputs(B, S, D, N, seed=0, with_h0=False):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, D)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, D)) - 1, 0).astype(
        np.float32)
    A = -np.exp(rng.standard_normal((D, N)) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, D, N)).astype(np.float32) if with_h0 \
        else None
    return u, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("B,S,D,N", [(1, 128, 64, 8), (2, 64, 128, 16),
                                     (1, 100, 96, 16)])
def test_selective_scan_matches_reference(B, S, D, N):
    arrs = _scan_inputs(B, S, D, N)[:5]
    y, h = tops.selective_scan(*[torch.from_numpy(a) for a in arrs])
    assert y.dtype == torch.float32 and h.shape == (B, D, N)
    jargs = [jnp.asarray(a) for a in arrs]
    for ry, rh in (rops.selective_scan(*jargs),                  # Pallas
                   rref.selective_scan_ref(*jargs)):             # oracle
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=1e-4,
                                   rtol=1e-4)


def test_selective_scan_with_h0_matches_reference():
    u, dt, A, Bm, Cm, h0 = _scan_inputs(2, 64, 64, 16, seed=3, with_h0=True)
    y, h = tops.selective_scan(*[torch.from_numpy(a)
                                 for a in (u, dt, A, Bm, Cm)],
                               h0=torch.from_numpy(h0))
    ry, rh = rref.selective_scan_ref(*[jnp.asarray(a)
                                       for a in (u, dt, A, Bm, Cm)],
                                     h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=1e-4,
                               rtol=1e-4)
    # h0 carries a split sequence: two halves equal the whole
    t = [torch.from_numpy(a) for a in (u, dt, A, Bm, Cm)]
    y1, h1 = tref.selective_scan_ref(*[a[:, :32] if a.ndim == 3 else a
                                       for a in t])
    y2, h2 = tref.selective_scan_ref(*[a[:, 32:] if a.ndim == 3 else a
                                       for a in t], h0=h1)
    yw, hw = tref.selective_scan_ref(*t)
    torch.testing.assert_close(torch.cat([y1, y2], 1), yw, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(h2, hw, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,D,N,G", [
    (1, 8192, 16, 4), (4, 8192, 16, 2), (8, 8192, 16, 2), (1, 256, 16, 16),
    (1, 64, 4, 4), (2, 4096, 64, 4), (64, 8192, 64, 2), (1, 1, 8, 8)])
def test_selective_scan_lanes_rule(B, D, N, G):
    """K8's lanes a channel: the fewest of 2, 4, 8, 16 (at most N) that put
    FILL_THREADS threads on the card, so falcon-mamba-7b's prefill (B=4,
    D=8192, N=16) runs 2 lanes a channel and a B=1 prompt 4."""
    got = tms.lanes(B, D, N)
    assert got == G and got in tms.LANES and got <= N
    assert B * D * got >= tms.FILL_THREADS or got == min(N, tms.LANES[-1])
    smaller = [g for g in tms.LANES if g < got]
    assert all(B * D * g < tms.FILL_THREADS for g in smaller)


def test_wrappers_take_plain_version_on_cpu_without_launching():
    (_, _, _), (q, k, v) = _attn_inputs(1, 16, 4, 2, 16, "float32")
    u, dt, A, Bm, Cm, _ = [torch.from_numpy(a) if a is not None else None
                           for a in _scan_inputs(1, 16, 8, 4)]
    tops.reset_launch_counts()
    for impl in ("cuda", "ref"):
        torch.testing.assert_close(
            tops.flash_attention(q, k, v, impl=impl),
            tref.attention_ref(q, k, v), atol=0, rtol=0)
        y, h = tops.selective_scan(u, dt, A, Bm, Cm, impl=impl)
        yr, hr = tref.selective_scan_ref(u, dt, A, Bm, Cm)
        assert torch.equal(y, yr) and torch.equal(h, hr)
    assert tfa.flash_attention.launches == 0
    assert tms.selective_scan.launches == 0
    with pytest.raises(ValueError, match="impl"):
        tops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError):
        tops.flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1), v)
    with pytest.raises(ValueError):
        tops.selective_scan(u, dt, A[:, :2], Bm, Cm)
