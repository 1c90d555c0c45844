"""State-space blocks: the Mamba1 mixer (the port of ``repro.models.ssm``'s
``causal_conv1d``, ``selective_scan_step`` and ``mamba1_mix``).

Prefill runs the selective scan through ``ops.selective_scan`` (the CUDA
kernel K8 on the card) where the reference runs its jnp
``selective_scan_chunked`` (an associative scan in another summation
order, so the two agree to a tolerance).  Decode is the O(1) recurrence
in plain torch.  Mamba2 (SSD) waits for the hybrid family's slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import softplus


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
