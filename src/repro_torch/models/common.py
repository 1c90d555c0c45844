"""Shared model building blocks: norms, RoPE, activations, softcap, and
the chunked cross-entropy of the training loss.

The port of ``repro.models.common``; the float32 upcasts and downcasts
sit where the reference has them.  Under a multi-device plan the
activations are DTensors; RoPE's frequencies then join them as
replicated DTensors (``like``), and the loss's logits are constrained
to the plan's vocab sharding as the reference's are (the log-sum-exp
and the label gather over that sharded dim are DTensor reductions
across the ranks, not per-shard ones).  ``rms_norm`` over a sharded last
dim (Mamba2's gated norm over d_inner) is one all-reduce of the ranks'
sums of squares.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import is_dtensor, replicate


def _sharded_last(x) -> bool:
    """Whether DTensor ``x`` is sharded along its last dim."""
    from torch.distributed.tensor import Shard
    return is_dtensor(x) and any(isinstance(p, Shard) and p.dim == x.ndim - 1
                                 for p in x.placements)


def rms_norm(x, scale, eps: float, *, offset: float = 1.0):
    """RMSNorm in fp32 accumulate.  gemma-style (1+scale) when offset=1."""
    dt = x.dtype
    xf = x.float()
    if _sharded_last(xf):
        # the mean over a dim the ranks share: each rank's sum of squares,
        # then one all-reduce over the mesh dims that shard it
        var = replicate(torch.sum(torch.square(xf), dim=-1, keepdim=True)) \
            / xf.shape[-1]
    else:
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (offset + scale.float())).to(dt)


def like(t, ref):
    """``t`` as a DTensor replicated on ``ref``'s mesh when ``ref`` is a
    DTensor (so the two mix in one operation), else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(ref):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def rope(x, positions, theta: float):
    """Rotary embedding, llama half-rotation convention.

    x: (..., S, H, hd);  positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.tensor(math.log(theta), dtype=torch.float32,
                             device=x.device)
    freqs = like(torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                         device=x.device)
                           * (log_theta / half)), positions)    # (half,)
    ang = positions.unsqueeze(-1).float() * freqs               # (..., S, half)
    cos = torch.cos(ang).unsqueeze(-2)                          # (..., S, 1, half)
    sin = torch.sin(ang).unsqueeze(-2)
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


def _chunk_nll(h, head, lab, m, *, vocab: int, cap, plan=None):
    """(sum of masked NLL, mask count) of one sequence chunk, logits in
    float32 (h.dtype operands, float32 products and sums)."""
    if plan is not None:
        h = plan.constrain(h, ("batch", None, None))
    logits = h.float() @ head.to(h.dtype).float()           # (B, c, V)
    if plan is not None:
        logits = plan.constrain(logits, ("batch", None, "vocab"))
    logits = softcap(logits, cap)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          lab.clamp(0, vocab - 1).unsqueeze(-1)).squeeze(-1)
    mf = m.float()
    return ((lse - picked) * mf).sum(), mf.sum()


def chunked_cross_entropy(hidden, head, labels, *, cfg, plan=None,
                          chunk: int = 512, mask=None):
    """Cross-entropy over a large vocab without materializing (B, S, V) in
    float32: one sequence chunk at a time, each under
    ``torch.utils.checkpoint`` when gradients are on, so the backward
    recomputes a chunk's logits instead of keeping them all.

    hidden: (B, S, d);  head: (d, V);  labels: (B, S) integer, -1 = pad
    (masked unless ``mask`` says otherwise).  The final softcap applies.
    Returns (sum_loss, sum_count) as float32 0-d tensors, so callers can
    combine across microbatches."""
    S = hidden.shape[1]
    chunk = max(1, min(chunk, S))
    fn = functools.partial(_chunk_nll, vocab=cfg.vocab_size,
                           cap=cfg.final_softcap, plan=plan)
    if torch.is_grad_enabled():
        fn = functools.partial(checkpoint, fn, use_reentrant=False)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        lab = labels[:, c0:c0 + chunk]
        m = (lab >= 0) if mask is None else mask[:, c0:c0 + chunk]
        t, c = fn(hidden[:, c0:c0 + chunk], head, lab, m)
        tot = tot + t
        cnt = cnt + c
    return tot, cnt
