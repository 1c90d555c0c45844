"""Shared model building blocks: norms, RoPE, activations, softcap.

The port of ``repro.models.common``; the float32 upcasts and downcasts
sit where the reference has them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float, *, offset: float = 1.0):
    """RMSNorm in fp32 accumulate.  gemma-style (1+scale) when offset=1."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (offset + scale.float())).to(dt)


def rope(x, positions, theta: float):
    """Rotary embedding, llama half-rotation convention.

    x: (..., S, H, hd);  positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.tensor(math.log(theta), dtype=torch.float32,
                             device=x.device)
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (log_theta / half))                     # (half,)
    ang = positions[..., None].float() * freqs                  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    xf1, xf2 = x1.float(), x2.float()
    out = torch.cat([xf1 * cos - xf2 * sin,
                     xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def activate(gate, up, kind: str):
    """MLP nonlinearity on (gate, up) pair; squared_relu ignores ``up``=None."""
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if kind == "squared_relu":
        r = F.relu(gate)
        return r * r
    raise ValueError(kind)


def softcap(x, cap):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0), with no
    linear cut-over (torch's ``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))
