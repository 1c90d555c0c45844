"""State-space blocks: the Mamba1 and Mamba2 (SSD) mixers (the port of
``repro.models.ssm``'s ``causal_conv1d``, ``selective_scan_step``,
``mamba1_mix``, ``ssd_chunked``, ``ssd_step`` and ``mamba2_mix``).

Mamba1's prefill runs the selective scan through ``ops.selective_scan``
(the CUDA kernel K8 on the card) where the reference runs its jnp
``selective_scan_chunked`` (an associative scan in another summation
order, so the two agree to a tolerance).  Mamba2's SSD is plain jnp in
the reference (no Pallas kernel), so it is plain torch here, term for
term: the chunked quadratic form for prefill (a Python loop over chunks
where the reference runs ``lax.scan``), the O(1) recurrence for decode.
Decode of either is plain torch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import rms_norm, softplus


def causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, S, C); w: (C, K); b: (C,).
    state: (B, K-1, C) trailing context from the previous segment (or None).
    Returns (y, new_state)."""
    B, S, C = x.shape
    K = w.shape[1]
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)              # (B, S+K-1, C)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for k in range(K):                                         # K is tiny (4)
        y = y + xp[:, k:k + S].float() * w[:, k].float()
    y = y + b.float()
    new_state = xp[:, S:] if S >= K - 1 else xp[:, -(K - 1):]
    return y.to(x.dtype), new_state


def selective_scan_step(h, u, dt, A, Bvec, Cvec):
    """One decode step.  h: (B, D, N) f32; u, dt: (B, D); Bvec, Cvec: (B, N)."""
    dtf = dt.float()
    dA = torch.exp(dtf[..., None] * A.float())                 # (B, D, N)
    dBu = (dtf * u.float())[..., None] * Bvec.float()[:, None, :]
    h = dA * h + dBu
    y = torch.einsum("bdn,bn->bd", h, Cvec.float())
    return h, y


def mamba1_mix(p, x, cfg, *, conv_state=None, ssm_state=None,
               decode: bool = False, impl: str = "cuda",
               ssm_chunk: int = 256):
    """Full Mamba1 mixer.  x: (B, S, d_model).  Returns (y, conv_state,
    ssm_state).  ``ssm_chunk``: the time steps the scan's backward
    recomputes at a time (``ParallelPlan.ssm_chunk``)."""
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    xz = x @ p["in_proj"].to(x.dtype)
    xin, z = torch.split(xz, di, dim=-1)
    xin, conv_state = causal_conv1d(xin, p["conv_w"], p["conv_b"], conv_state)
    xin = F.silu(xin)
    dbc = xin @ p["x_proj"].to(xin.dtype)
    dt_low, Bmat, Cmat = torch.split(dbc, [R, N, N], dim=-1)
    dt = softplus((dt_low @ p["dt_proj"].to(xin.dtype)).float()
                  + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    if decode:
        ssm_state, y = selective_scan_step(
            ssm_state, xin[:, 0], dt[:, 0], A, Bmat[:, 0], Cmat[:, 0])
        y = y[:, None]
    else:
        y, ssm_state = ops.selective_scan(xin, dt, A, Bmat, Cmat,
                                          h0=ssm_state, impl=impl,
                                          chunk=ssm_chunk)
    y = y + xin.float() * p["D"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"].to(y.dtype)
    return out, conv_state, ssm_state


# ----------------------------- Mamba2 (SSD) -------------------------------- #

def ssd_chunked(xh, dt, A, Bmat, Cmat, *, chunk: int = 128, h0=None):
    """Mamba2 SSD with scalar-per-head decay.

    xh: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    Bmat, Cmat: (B, S, N) (shared across heads).  S is padded with zeros
    to a multiple of ``chunk`` (a zero dt leaves the state unchanged).
    Returns (y: (B, S, H, P) f32, h_last: (B, H, P, N) f32)."""
    Bsz, S, H, Pdim = xh.shape
    N = Bmat.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    h = torch.zeros((Bsz, H, Pdim, N), dtype=torch.float32,
                    device=xh.device) if h0 is None else h0
    Af = A.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))[None, :, :, None]
    ys = []
    for c0 in range(0, xh.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        dtf = dt[:, sl].float()                            # (B, c, H)
        a = dtf * Af                                       # log decay, <= 0
        cum = torch.cumsum(a, dim=1)                       # (B, c, H)
        Bf, Cf, xf = Bmat[:, sl].float(), Cmat[:, sl].float(), \
            xh[:, sl].float()
        # state -> output:  y_state[t] = exp(cum[t]) * C[t] . h
        y_state = torch.exp(cum)[..., None] * \
            torch.einsum("bcn,bhpn->bchp", Cf, h)
        # intra-chunk quadratic form; the mask goes in before the exp
        # (the same values as the reference's where-after-exp, and no
        # inf above the diagonal for the backward to multiply by 0)
        G = torch.einsum("btn,bsn->bts", Cf, Bf)           # (B, c, c)
        L = cum[:, :, None, :] - cum[:, None, :, :]        # (B, t, s, H)
        L = torch.exp(torch.where(tri, L, -torch.inf))
        M = G[..., None] * L * dtf[:, None, :, :]          # (B, t, s, H)
        y_intra = torch.einsum("btsh,bshp->bthp", M, xf)
        # chunk state update
        w = torch.exp(cum[:, -1:, :] - cum) * dtf          # (B, c, H)
        h = torch.exp(cum[:, -1])[..., None, None] * h + \
            torch.einsum("bchp,bcn->bhpn", w[..., None] * xf, Bf)
        ys.append(y_state + y_intra)
    return torch.cat(ys, dim=1)[:, :S], h


def ssd_step(h, xh, dt, A, Bvec, Cvec):
    """One decode step.  h: (B, H, P, N); xh: (B, H, P); dt: (B, H);
    Bvec, Cvec: (B, N)."""
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())                        # (B, H)
    dBx = dtf[..., None, None] * \
        torch.einsum("bhp,bn->bhpn", xh.float(), Bvec.float())
    h = dA[..., None, None] * h + dBx
    y = torch.einsum("bhpn,bn->bhp", h, Cvec.float())
    return h, y


def mamba2_mix(p, x, cfg, *, conv_state=None, ssm_state=None,
               decode: bool = False, ssm_chunk: int = 256):
    """Mamba2 mixer.  x: (B, S, d_model).  Returns (y, conv_state,
    ssm_state).  The SSD's chunk is ``min(128, ssm_chunk)``, the
    reference's ``min(128, plan.ssm_chunk)``."""
    di, N = cfg.d_inner, cfg.ssm_state
    H, Pdim = cfg.n_ssm_heads, cfg.ssm_head_dim
    Bsz, S, _ = x.shape
    xin, z = torch.split(x @ p["in_proj_xz"].to(x.dtype), di, dim=-1)
    Bmat, Cmat = torch.split(x @ p["in_proj_bc"].to(x.dtype), N, dim=-1)
    dt_raw = x @ p["in_proj_dt"].to(x.dtype)
    dt = softplus(dt_raw.float() + p["dt_bias"].float())
    xin, conv_state = causal_conv1d(xin, p["conv_w"], p["conv_b"], conv_state)
    xin = F.silu(xin)
    xh = xin.reshape(Bsz, S, H, Pdim)
    A = -torch.exp(p["A_log"].float())
    if decode:
        ssm_state, y = ssd_step(ssm_state, xh[:, 0], dt[:, 0], A,
                                Bmat[:, 0], Cmat[:, 0])
        y = y[:, None]
    else:
        y, ssm_state = ssd_chunked(xh, dt, A, Bmat, Cmat,
                                   chunk=min(128, ssm_chunk), h0=ssm_state)
    y = y + xh.float() * p["D"].float()[:, None]
    y = y.reshape(Bsz, S, di)
    # gated RMSNorm (mamba2) then output projection
    y = rms_norm(y * F.silu(z.float()), p["norm"], cfg.norm_eps).to(x.dtype)
    out = y @ p["out_proj"].to(y.dtype)
    return out, conv_state, ssm_state
