"""Plain torch versions of the model and join kernels (the port of
``repro.kernels.ref``'s ``attention_ref``, ``selective_scan_ref``,
``hash_join_ref`` and ``merge_join_ref``).

They are the CPU path of the wrappers in ``ops`` and what
``chip_smoke.py`` holds the CUDA kernels against on the card
(``impl="ref"``).
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_mask(S: int, Skv: int, device, *, causal: bool = True,
                   window: Optional[int] = None, q_positions=None,
                   kv_positions=None):
    """The attention mask, True where a score is kept, or None (nothing
    masked).  By index: (S, Skv), ``kpos <= qpos`` and ``qpos - kpos <
    window`` under ``causal``.  With positions ((B, S) and (B, Skv), -1 an
    invalid slot), as the reference's ``_block_update``: (B, S, Skv),
    ``kv_pos >= 0`` always, and under ``causal`` also ``q_pos - kv_pos``
    in [0, window)."""
    if q_positions is None:
        if not causal:
            return None
        qp = torch.arange(S, device=device)[:, None]
        kp = torch.arange(Skv, device=device)[None, :]
    else:
        qp, kp = q_positions[:, :, None], kv_positions[:, None, :]
    mask = kp >= 0 if q_positions is not None else None
    if causal:
        rel = qp - kp
        keep = rel >= 0
        if window is not None:
            keep &= rel < window
        mask = keep if mask is None else mask & keep
    return mask


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  attn_softcap: Optional[float] = None,
                  q_positions=None, kv_positions=None):
    """Naive softmax attention.  q: (B,S,H,hd); k, v: (B,Skv,KV,hd);
    masked by index, or by ``q_positions`` (B, S) and ``kv_positions``
    (B, Skv) when given (``attention_mask``).  Masked scores are -1e30
    after the softcap, so a row with no kept key averages V over all Skv
    keys, as the reference's online softmax does within one kv block."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    kf = torch.repeat_interleave(k, g, dim=2).float()
    vf = torch.repeat_interleave(v, g, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * hd ** -0.5
    if attn_softcap is not None:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    mask = attention_mask(S, k.shape[1], q.device, causal=causal,
                          window=window, q_positions=q_positions,
                          kv_positions=kv_positions)
    if mask is not None:
        s = torch.where(mask[None, None] if mask.ndim == 2 else
                        mask[:, None], s, -1e30)
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


def check_join(probe_keys, build_keys, build_vals) -> None:
    """The joins take 1-D int32 probe keys and equal-length 1-D int32
    build keys and values."""
    ts = (probe_keys, build_keys, build_vals)
    if any(t.dtype != torch.int32 or t.ndim != 1 for t in ts) or \
            build_keys.shape != build_vals.shape:
        raise ValueError(
            "joins take 1-D int32 probe keys and equal-length 1-D int32 "
            "build keys and values, got " +
            ", ".join(f"{tuple(t.shape)} {t.dtype}" for t in ts))


def hash_join_ref(probe_keys, build_keys, build_vals):
    """PK join: for each probe key, the value of the FIRST build row whose
    key matches (the reference's ``argmax`` over the (S, R) compare), or
    -1.  A stable sort of the build keys and a left ``searchsorted`` find
    that row in O(S log R) instead of the (S, R) compare matrix."""
    check_join(probe_keys, build_keys, build_vals)
    R = build_keys.shape[0]
    if R == 0:
        return torch.full_like(probe_keys, -1)
    skeys, order = torch.sort(build_keys, stable=True)
    pos = torch.searchsorted(skeys, probe_keys).clamp_(max=R - 1)
    hit = skeys[pos] == probe_keys
    return torch.where(hit, build_vals[order[pos]], -1)


def merge_join_ref(probe_keys, build_keys, build_vals):
    """Sorted-runs join: ``build_keys`` ascending (not checked); the value
    at the first build row whose key matches, or -1."""
    check_join(probe_keys, build_keys, build_vals)
    R = build_keys.shape[0]
    if R == 0:
        return torch.full_like(probe_keys, -1)
    pos = torch.searchsorted(build_keys, probe_keys).clamp_(0, R - 1)
    hit = build_keys[pos] == probe_keys
    return torch.where(hit, build_vals[pos], -1)
