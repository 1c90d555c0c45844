"""Plain torch versions of the model kernels (the port of
``repro.kernels.ref``'s ``attention_ref`` and ``selective_scan_ref``).

They are the CPU path of ``ops.flash_attention`` / ``ops.selective_scan``
and what ``chip_smoke.py`` holds the CUDA kernels against on the card
(``impl="ref"``).
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  attn_softcap: Optional[float] = None):
    """Naive softmax attention.  q: (B,S,H,hd); k, v: (B,Skv,KV,hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    kf = torch.repeat_interleave(k, g, dim=2).float()
    vf = torch.repeat_interleave(v, g, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * hd ** -0.5
    if attn_softcap is not None:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    if causal:
        qp = torch.arange(S, device=q.device)[:, None]
        kp = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = kp <= qp
        if window is not None:
            mask &= (qp - kp) < window
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return o.to(q.dtype)


def selective_scan_ref(u, dt, A, Bmat, Cmat, h0=None):
    """Sequential Mamba1 scan.  u, dt: (B,S,D); A: (D,N); Bmat, Cmat: (B,S,N).
    Returns (y: (B,S,D) f32, h_last (B,D,N) f32)."""
    Bsz, S, D = u.shape
    N = A.shape[1]
    h = torch.zeros((Bsz, D, N), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    Af = A.float()
    ys = []
    for t in range(S):
        dtf = dt[:, t].float()
        dA = torch.exp(dtf[..., None] * Af)
        dBu = (dtf * u[:, t].float())[..., None] * \
            Bmat[:, t].float()[:, None, :]
        h = dA * h + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, Cmat[:, t].float()))
    y = torch.stack(ys, dim=1) if ys else \
        torch.zeros((Bsz, 0, D), dtype=torch.float32, device=u.device)
    return y, h
