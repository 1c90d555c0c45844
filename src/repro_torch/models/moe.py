"""Mixture-of-Experts FFN with capacity-based grouped dispatch (the port of
``repro.models.moe``).

Tokens are cut into G groups of Sg; each group routes its tokens to the
top-k of E experts, and every expert takes at most C of a group's
(token, k) slots, in token order: a slot past C is dropped and adds
nothing (its token keeps its residual stream).  The dispatch buffer holds
every expert's C rows of every group, and each expert's swiglu runs over
all of them, as the reference computes it (no token-sorted dispatch).
The aux losses are the Switch / ST-MoE load-balance and router-z losses.

On one device the reference's sharding constraints are the identity and
its ``_over_groups`` a ``vmap`` over G; here the groups are a batch dim.
The buffer is laid out expert-major, (E, G, C, d), so the expert FFN is
one batched matmul over E with no copy; that changes no result.  Each
token's k slots are combined by a sum over k in a fixed order (the
reference's ``segment_sum`` over a token-major index is that sum), not by
a scatter-add, whose CUDA atomics would add in a varying order.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import activate


def _capacity(sg: int, k: int, e: int, cf: float) -> int:
    c = max(int(math.ceil(sg * k * cf / e)), k)   # >= k so tiny groups keep top-k
    return -(-c // 4) * 4                          # round up to a multiple of 4


def route(logits: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Float32 router logits (..., E) -> (probs, gate values (..., k),
    expert ids (..., k) int64).  The top k in ``jax.lax.top_k``'s order:
    descending, and the lower expert id first among equal probabilities
    (a stable sort; ``torch.topk`` promises no order among ties).  The
    gates are renormalised over the k."""
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_idx


def moe_ffn(p, x: torch.Tensor, cfg, plan, *, valid=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y: (B, S, d), aux: {lb_loss, z_loss, drop_frac}).
    ``p`` holds ``router`` (d, E), ``w1`` / ``w3`` (E, d, f) and ``w2``
    (E, f, d); ``valid`` (B, S) bool masks tokens out of routing and of
    the aux losses (default: every token)."""
    Bsz, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = Bsz * S
    dev = x.device
    xt = x.reshape(T, d)
    vt = torch.ones((T,), dtype=torch.bool, device=dev) if valid is None \
        else torch.as_tensor(valid, device=dev).reshape(T).bool()

    # group size adapts so there are >= moe_target_groups groups
    Sg = min(plan.moe_group_size, max(1, T // max(1, plan.moe_target_groups)))
    pad = (-T) % Sg
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
        vt = F.pad(vt, (0, pad))
    G = xt.shape[0] // Sg
    xg = xt.reshape(G, Sg, d)
    vg = vt.reshape(G, Sg)

    # ---- router (the product in x's dtype, softmax in float32) ---- #
    logits = (xg @ p["router"].to(xg.dtype)).float()          # (G, Sg, E)
    probs, gate_vals, expert_idx = route(logits, K)           # (G, Sg, K)

    # ---- capacity positions via masked cumsum, token-major ---- #
    C = _capacity(Sg, K, E, cfg.capacity_factor)
    e_flat = expert_idx.reshape(G, Sg * K)
    e_flat = torch.where(vg.repeat_interleave(K, dim=1), e_flat, E)
    # one-hot expert-major, (G, E, SgK), so the cumsum runs along the
    # innermost dim (on the card a scan along an outer dim took ~30x as
    # long, a third of a prefill's device time)
    onehot = e_flat[:, None, :] == torch.arange(E, device=dev)[:, None]
    pos = (torch.cumsum(onehot, dim=-1) * onehot).sum(1) - 1  # (G, SgK)
    keep = (pos >= 0) & (pos < C)
    pos_c = pos.clamp(0, C - 1)
    e_c = e_flat.clamp(0, E - 1)
    # each slot's row of the (E, G, C) buffer; a dropped slot lands on its
    # expert's row C - 1 and adds exact zeros there
    g_idx = torch.arange(G, device=dev)[:, None]
    rows = ((e_c * G + g_idx) * C + pos_c).reshape(G * Sg * K)

    # ---- dispatch: scatter-add of the kept slots ---- #
    src = xg.repeat_interleave(K, dim=1) * keep[..., None].to(xg.dtype)
    buf = torch.zeros((E * G * C, d), dtype=xg.dtype, device=dev)
    buf = buf.index_add(0, rows, src.reshape(G * Sg * K, d))
    buf = buf.view(E, G * C, d)

    # ---- expert FFN (per-expert swiglu, batched over E) ---- #
    g = torch.bmm(buf, p["w1"].to(buf.dtype))                 # (E, GC, f)
    u = torch.bmm(buf, p["w3"].to(buf.dtype))
    h = activate(g, u, cfg.activation)
    out = torch.bmm(h, p["w2"].to(h.dtype))                   # (E, GC, d)

    # ---- combine (float32): gather each slot's row, gate, sum over k ---- #
    yk = out.reshape(E * G * C, d)[rows].float().view(G, Sg, K, d)
    wk = (gate_vals.float() * keep.view(G, Sg, K).float())[..., None]
    y = (yk * wk).sum(2)                                      # (G, Sg, d)
    y = y.reshape(G * Sg, d)[:T].reshape(Bsz, S, d).to(x.dtype)

    # ---- aux losses ---- #
    vmask = vg.float()[..., None]
    ntok = torch.clamp(vmask.sum(), min=1.0)
    me = (probs * vmask).sum((0, 1)) / ntok                   # mean prob/expert
    top1 = F.one_hot(expert_idx[..., 0], E).float() * vmask
    ce = top1.sum((0, 1)) / ntok                              # frac routed/expert
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)) * vmask[..., 0])
    # the mean as the reference's rounds it: the exact count of kept slots
    # times the float32 reciprocal of the slot count
    inv = torch.tensor(1.0 / keep.numel(), dtype=torch.float32, device=dev)
    dropped = 1.0 - keep.float().sum() * inv
    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "drop_frac": dropped}
    return y, aux


def moe_aux_total(aux: dict, cfg) -> torch.Tensor:
    return cfg.router_aux_coef * aux["lb_loss"] + \
        cfg.router_z_coef * aux["z_loss"]
