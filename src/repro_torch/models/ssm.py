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

Under a multi-device plan (``plan`` enabled, the activations DTensors)
the mixers place their activations as the reference constrains them:
``xin`` to ("batch", None, "inner"), Mamba's channels (Mamba1's d_inner,
Mamba2's heads and their d_inner) over "model", the sequence whole.  The
depthwise conv, K8 (``ops.selective_scan``) and the SSD run on each
rank's own batch rows and channels (``sharding.map_channels``); Mamba1's
``x_proj`` contracts over the sharded d_inner, so dt_low, B and C are one
all-reduce over "model" (``constrain`` of the partial sums), and
Mamba2's gated RMSNorm reduces over it the same way (``rms_norm``).
``in_proj`` / ``in_proj_xz`` are (d, 2 d_inner) with "inner" on all 2
d_inner columns, so a rank's columns of ``x @ w`` are not its shard of
``xin`` and its shard of ``z``; splitting the product would gather the
whole (B, S, 2 d_inner) activation every layer.  ``_in_proj`` splits the
weight instead: it is gathered over "model" (d x 2 d_inner elements a
layer, over FSDP's shard of d; its gradient comes back by one gather of
each half, as much again), each rank keeps its columns of each half (no
communication) and projects onto them, so xin and z come out sharded
along d_inner.  The reference's mixers are plain einsums that read no
``tp_mode``, so their projections (``_in_proj``'s halves, ``out_proj``)
keep the GSPMD form under ``tp_mode="shard_map"`` too.  A decode step
(under a serve plan's decode plan) runs ``selective_scan_step`` /
``ssd_step`` and the conv-state update the same way, on each rank's
channels of the "inner"-sharded conv and ssm states.  On one device
every constraint is the identity and the mixers run as before.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import rms_norm, softplus
from repro_torch.sharding import is_dtensor, map_channels, single_device_plan

_SINGLE = single_device_plan()


def causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, S, C); w: (C, K); b: (C,).
    state: (B, K-1, C) trailing context from the previous segment (or None).
    Returns (y, new_state)."""
    if is_dtensor(x):               # each rank's own batch rows and channels
        args = (x, w, b) + (() if state is None else (state,))
        return map_channels(causal_conv1d, args,
                            ((0, 2), (None, 0), (None, 0), (0, 2))[
                                :len(args)], ((0, 2), (0, 2)), x)
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
    """One decode step.  h: (B, D, N) f32; u, dt: (B, D); Bvec, Cvec: (B, N).
    DTensors run on each rank's own batch rows and channels."""
    if is_dtensor(u):
        # (B, 1, D) stands for the (batch, sequence, channels) map_channels
        # places by; the state and outputs carry their roles as K8's do
        y, h = map_channels(
            lambda hl, ul, dtl, Al, Bl, Cl: selective_scan_step(
                hl, ul[:, 0], dtl[:, 0], Al, Bl, Cl)[::-1],
            (h, u[:, None], dt[:, None], A, Bvec, Cvec),
            ((0, 1), (0, 2), (0, 2), (None, 0), (0, None), (0, None)),
            ((0, 1), (0, 1)), u[:, None])
        return h, y
    dtf = dt.float()
    dA = torch.exp(dtf[..., None] * A.float())                 # (B, D, N)
    dBu = (dtf * u.float())[..., None] * Bvec.float()[:, None, :]
    h = dA * h + dBu
    y = torch.einsum("bdn,bn->bd", h, Cvec.float())
    return h, y


def _in_proj(x, w, di: int, plan):
    """(xin, z): the two halves of ``x @ w`` for w (d, 2 di); under a plan
    each projected on its own half of the weight (module docstring)."""
    if not plan.enabled or not is_dtensor(x):
        return torch.split(x @ w.to(x.dtype), di, dim=-1)
    w = plan.constrain(w, ("embed", None))
    return tuple(plan.col_parallel_project(
        x, plan.constrain(half, ("embed", "inner")), tp_mode="gspmd")
        for half in (w[:, :di], w[:, di:]))


def mamba1_mix(p, x, cfg, plan=_SINGLE, *, conv_state=None, ssm_state=None,
               decode: bool = False, impl: str = "cuda"):
    """Full Mamba1 mixer.  x: (B, S, d_model).  Returns (y, conv_state,
    ssm_state).  ``plan.ssm_chunk``: the time steps the scan's backward
    recomputes at a time."""
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    xin, z = _in_proj(x, p["in_proj"], di, plan)
    xin = plan.constrain(xin, ("batch", None, "inner"))
    xin, conv_state = causal_conv1d(xin, p["conv_w"], p["conv_b"], conv_state)
    xin = F.silu(xin)
    # a contraction over the sharded d_inner: one sum over "model"
    dbc = plan.constrain(xin @ p["x_proj"].to(xin.dtype),
                         ("batch", None, None))
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
                                          chunk=plan.ssm_chunk)
    y = y + xin.float() * p["D"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = plan.row_parallel_project(y, p["out_proj"], tp_mode="gspmd")
    return out, conv_state, ssm_state


# ----------------------------- Mamba2 (SSD) -------------------------------- #

def ssd_chunked(xh, dt, A, Bmat, Cmat, *, chunk: int = 128, h0=None):
    """Mamba2 SSD with scalar-per-head decay.

    xh: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    Bmat, Cmat: (B, S, N) (shared across heads).  S is padded with zeros
    to a multiple of ``chunk`` (a zero dt leaves the state unchanged).
    Returns (y: (B, S, H, P) f32, h_last: (B, H, P, N) f32).  DTensor
    inputs run on each rank's own batch rows and heads."""
    if is_dtensor(xh):
        args = (xh, dt, A, Bmat, Cmat) + (() if h0 is None else (h0,))
        dims = ((0, 2), (0, 2), (None, 0), (0, None), (0, None), (0, 1))
        return map_channels(
            lambda *a: ssd_chunked(*a[:5], chunk=chunk,
                                   h0=a[5] if len(a) > 5 else None),
            args, dims[:len(args)], ((0, 2), (0, 1)), xh)
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
    Bvec, Cvec: (B, N).  DTensors run on each rank's own batch rows and
    heads."""
    if is_dtensor(xh):
        y, h = map_channels(
            lambda hl, xl, dtl, Al, Bl, Cl: ssd_step(
                hl, xl[:, 0], dtl[:, 0], Al, Bl, Cl)[::-1],
            (h, xh[:, None], dt[:, None], A, Bvec, Cvec),
            ((0, 1), (0, 2), (0, 2), (None, 0), (0, None), (0, None)),
            ((0, 1), (0, 1)), xh[:, None])
        return h, y
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())                        # (B, H)
    dBx = dtf[..., None, None] * \
        torch.einsum("bhp,bn->bhpn", xh.float(), Bvec.float())
    h = dA[..., None, None] * h + dBx
    y = torch.einsum("bhpn,bn->bhp", h, Cvec.float())
    return h, y


def mamba2_mix(p, x, cfg, plan=_SINGLE, *, conv_state=None, ssm_state=None,
               decode: bool = False, ssm_chunk=None):
    """Mamba2 mixer.  x: (B, S, d_model).  Returns (y, conv_state,
    ssm_state).  The SSD's chunk is the reference's ``min(128,
    plan.ssm_chunk)`` (``ssm_chunk`` in place of ``plan.ssm_chunk`` when
    given)."""
    di, N = cfg.d_inner, cfg.ssm_state
    H, Pdim = cfg.n_ssm_heads, cfg.ssm_head_dim
    Bsz, S, _ = x.shape
    xin, z = _in_proj(x, p["in_proj_xz"], di, plan)
    xin = plan.constrain(xin, ("batch", None, "inner"))
    x = plan.constrain(x, ("batch", None, None))       # the sequence whole
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
                                   chunk=min(128,
                                             ssm_chunk or plan.ssm_chunk),
                                   h0=ssm_state)
    y = y + xh.float() * p["D"].float()[:, None]
    y = y.reshape(Bsz, S, di)
    # gated RMSNorm (mamba2) then output projection
    y = rms_norm(y * F.silu(z.float()), p["norm"], cfg.norm_eps).to(x.dtype)
    out = plan.row_parallel_project(y, p["out_proj"], tp_mode="gspmd")
    return out, conv_state, ssm_state
