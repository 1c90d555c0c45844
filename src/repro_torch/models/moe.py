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

Under an enabled plan (x a DTensor) the port follows the reference's
constraints with DTensor placements.  The G groups are placed by
"tokens" (every mesh axis, in mesh order): each rank gathers its batch
rows whole over "model" and takes its slice of their tokens, and routes,
places and scatters its own groups under one ``local_map`` (the
reference's ``_over_groups``, which maps the groups device-locally only
under ``tp_mode="shard_map"`` and by ``vmap`` under "gspmd": the port
takes the device-local map in both modes, with the same numbers).  The
expert-major buffer (E, G·C, d) is then redistributed from the groups to
("experts", "batch"): E over "model" (the expert-parallel all-to-all)
or, when ``moe_rules_for`` flips to TP-within-expert, E whole and the
experts' FFN dim over "model".  The
expert FFN runs on those shards (the weights gathered over FSDP's
"data"), the buffer goes back to the groups, and the float32 combine
runs under a second ``local_map``, its result a partial sum over "model"
(each rank's tokens among zeros) reduce-scattered onto the sequence.
The aux losses are means over every group: each rank's sums, one
all-reduce, then ``lb_loss = E Σ me·ce`` of the global means (the mean of
the ranks' own lb_loss values is another number).  The groups must
split evenly over the ranks of "tokens" (``G`` divisible by their
count), else it raises.  Where the tokens do not fill whole groups
(``T % Sg``) the groups do not follow the batch's shards: x is gathered
whole, padded to whole groups as on one device, and each rank takes its
run of them.  Where no mesh dim splits the tokens (the serve plans'
decode, and their prefill below a global batch of 16), every rank
routes every group, and the experts stay sharded.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import activate
from repro_torch.sharding import is_dtensor, map_local, replicate


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


def _route_dispatch(xg, vg, router, cfg, C: int):
    """Route groups xg (G, Sg, d) (valid tokens vg (G, Sg)) and scatter
    their kept slots into the expert-major buffer.  Returns (logits,
    probs, gate values (G, Sg, K), expert ids, keep (G, Sg·K), each slot's
    buffer row (G·Sg·K,), the buffer (E, G·C, d))."""
    G, Sg, d = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    dev = xg.device
    # ---- router (the product in x's dtype, softmax in float32) ---- #
    logits = (xg @ router.to(xg.dtype)).float()               # (G, Sg, E)
    probs, gate_vals, expert_idx = route(logits, K)           # (G, Sg, K)

    # ---- capacity positions via masked cumsum, token-major ---- #
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
    return logits, probs, gate_vals, expert_idx, keep, rows, \
        buf.view(E, G * C, d)


def _expert_ffn(buf, w1, w3, w2, cfg):
    """Each expert's swiglu over its rows of buf (E, rows, d), batched
    over E."""
    g = torch.bmm(buf, w1.to(buf.dtype))                      # (E, GC, f)
    u = torch.bmm(buf, w3.to(buf.dtype))
    h = activate(g, u, cfg.activation)
    return torch.bmm(h, w2.to(h.dtype))                       # (E, GC, d)


def _combine(out, rows, keep, gate_vals):
    """(G, Sg, d) float32: each slot's row of out (E, G·C, d) gathered,
    gated and summed over k in a fixed order."""
    G, Sg, K = gate_vals.shape
    d = out.shape[-1]
    yk = out.reshape(-1, d)[rows].float().view(G, Sg, K, d)
    wk = (gate_vals.float() * keep.view(G, Sg, K).float())[..., None]
    return (yk * wk).sum(2)


def _aux_sums(logits, probs, expert_idx, keep, vg, E: int):
    """The sums the aux losses are means of, over these groups, as one
    float32 vector: the valid tokens' probabilities per expert (E), their
    top-1 counts per expert (E), the valid-token count, the sum of the
    squared log-sum-exps, the kept-slot count."""
    vmask = vg.float()[..., None]
    top1 = F.one_hot(expert_idx[..., 0], E).float() * vmask
    z = (torch.square(torch.logsumexp(logits, dim=-1)) * vmask[..., 0]).sum()
    return torch.cat([(probs * vmask).sum((0, 1)), top1.sum((0, 1)),
                      torch.stack([vmask.sum(), z, keep.float().sum()])])


def _aux(sums, E: int, n_tokens: int, n_slots: int):
    """{lb_loss, z_loss, drop_frac} from ``_aux_sums`` over every group:
    lb_loss = E Σ me·ce, the product of two global means."""
    me_sum, ce_sum = sums[:E], sums[E:2 * E]
    nvalid, z, kept = sums[2 * E], sums[2 * E + 1], sums[2 * E + 2]
    ntok = torch.clamp(nvalid, min=1.0)
    lb_loss = E * torch.sum((me_sum / ntok) * (ce_sum / ntok))
    # the mean as the reference's rounds it: the exact count of kept slots
    # times the float32 reciprocal of the slot count
    inv = torch.tensor(1.0 / n_slots, dtype=torch.float32,
                       device=sums.device)
    return {"lb_loss": lb_loss, "z_loss": z / n_tokens,
            "drop_frac": 1.0 - kept * inv}


def _group_size(T: int, plan) -> int:
    """Sg: groups adapt so there are >= moe_target_groups of them."""
    return min(plan.moe_group_size,
               max(1, T // max(1, plan.moe_target_groups)))


def moe_ffn(p, x: torch.Tensor, cfg, plan, *, valid=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y: (B, S, d), aux: {lb_loss, z_loss, drop_frac}).
    ``p`` holds ``router`` (d, E), ``w1`` / ``w3`` (E, d, f) and ``w2``
    (E, f, d); ``valid`` (B, S) bool masks tokens out of routing and of
    the aux losses (default: every token; under a plan every token is
    routed)."""
    if plan.enabled and is_dtensor(x):
        return _moe_ffn_sharded(p, x, cfg, plan, valid)
    Bsz, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = Bsz * S
    dev = x.device
    xt = x.reshape(T, d)
    vt = torch.ones((T,), dtype=torch.bool, device=dev) if valid is None \
        else torch.as_tensor(valid, device=dev).reshape(T).bool()
    Sg = _group_size(T, plan)
    pad = (-T) % Sg
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
        vt = F.pad(vt, (0, pad))
    G = xt.shape[0] // Sg
    xg = xt.reshape(G, Sg, d)
    vg = vt.reshape(G, Sg)
    C = _capacity(Sg, K, E, cfg.capacity_factor)
    logits, probs, gate_vals, expert_idx, keep, rows, buf = _route_dispatch(
        xg, vg, p["router"], cfg, C)
    out = _expert_ffn(buf, p["w1"], p["w3"], p["w2"], cfg)
    y = _combine(out, rows, keep, gate_vals)                  # (G, Sg, d)
    y = y.reshape(G * Sg, d)[:T].reshape(Bsz, S, d).to(x.dtype)
    aux = _aux(_aux_sums(logits, probs, expert_idx, keep, vg, E), E,
               G * Sg, keep.numel())
    return y, aux


def _moe_ffn_sharded(p, x, cfg, plan, valid):
    """``moe_ffn`` of a DTensor x under an enabled plan (module
    docstring): routing and dispatch on each rank's groups, the expert
    FFN on the experts' (or ff_expert's) shards, the combine on the
    groups again."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    Bsz, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = Bsz * S
    Sg = _group_size(T, plan)
    G = -(-T // Sg)
    tok = plan.placements(("tokens",), mesh)
    bat = plan.placements(("batch",), mesh)
    split = [i for i, t in enumerate(tok) if isinstance(t, Shard)]
    # the mesh dims that split the tokens beyond the batch (the model
    # axis): each rank of them takes its slice of its batch rows' tokens,
    # which is its run of groups when they are minor to the batch's dims
    sub = [i for i in split if not isinstance(bat[i], Shard)]
    n_tok = math.prod(mesh.size(i) for i in split)
    # the groups do not follow the batch's shards (the tokens padded to
    # whole groups, as on one device, or the batch split where the tokens
    # are not: a decode plan's from a batch of 16): x gathered whole,
    # each rank takes its run of the groups
    whole = bool(T % Sg) or any(b > i for i in sub for b in split
                                if b not in sub) or \
        any(isinstance(p_, Shard) and i not in split
            for i, p_ in enumerate(bat))
    if whole:
        sub = split
    if G % n_tok:
        raise NotImplementedError(
            f"{cfg.name}: {G} groups of {Sg} tokens do not split evenly "
            f"over the {n_tok} ranks of the 'tokens' axes")
    if valid is not None:
        raise NotImplementedError("moe_ffn under a plan routes every token "
                                  "(no path masks tokens there)")
    j = 0
    for i in sub:
        j = j * mesh.size(i) + mesh.get_local_rank(i)
    n_sub = math.prod(mesh.size(i) for i in sub)
    Gl, C = G // n_tok, _capacity(Sg, K, E, cfg.capacity_factor)
    Tl = Gl * Sg                            # this rank's tokens

    def dispatch(xl, router):
        xt = F.pad(xl.reshape(-1, d), (0, 0, 0, G * Sg - T))
        xg = xt[j * Tl:(j + 1) * Tl].reshape(Gl, Sg, d)
        vg = (torch.arange(j * Tl, (j + 1) * Tl, device=xg.device) < T
              ).reshape(Gl, Sg)
        logits, probs, gate_vals, expert_idx, keep, rows, buf = \
            _route_dispatch(xg, vg, router, cfg, C)
        return buf, rows, keep, gate_vals, _aux_sums(
            logits, probs, expert_idx, keep, vg, E)

    def combine(out, rows, keep, gate_vals):
        y = _combine(out, rows, keep, gate_vals).reshape(Tl, d)
        # this rank's slice among zeros: the sum over "model" places it
        y = F.pad(y.to(x.dtype), (0, 0, j * Tl, (n_sub - 1 - j) * Tl))
        return (y[:y.shape[0] - (G * Sg - T)].view(-1, S, d),)

    def on_split(pl):           # pl on the mesh dims that split the tokens
        return [pl if i in split else Replicate() for i in range(mesh.ndim)]

    on_groups = on_split(Shard(0))
    in_batch = [Replicate()] * mesh.ndim if whole else \
        plan.placements(("batch", None, None), mesh)
    buf, rows, keep, gate_vals, sums = map_local(
        dispatch, (x, p["router"]), (in_batch, [Replicate()] * mesh.ndim),
        (on_split(Shard(1)), on_groups, on_groups, on_groups,
         on_split(Partial())), mesh)
    # groups -> (batch, experts): the expert-parallel all-to-all (under
    # TP-within-expert, an all-gather of the groups over "model")
    buf = plan.constrain(buf, ("experts", "batch", None))
    w1, w3 = (plan.constrain(p[k], ("experts", None, "ff_expert"))
              for k in ("w1", "w3"))
    w2 = plan.constrain(p["w2"], ("experts", "ff_expert", None))
    out = _expert_ffn(buf, w1, w3, w2, cfg)
    # back to the groups: the all-to-all's reverse (under TP-within-expert
    # a reduce-scatter of the partial sums over ff_expert)
    out = plan.constrain(out, (None, "tokens", None))
    y, = map_local(combine, (out, rows, keep, gate_vals),
                   (out.placements, on_groups, on_groups, on_groups),
                   ([Partial() if i in sub else p_
                     for i, p_ in enumerate(in_batch)],), mesh)
    y = plan.constrain(y, ("batch", "seq", None))
    aux = _aux(replicate(sums), E, G * Sg, G * Sg * K)
    return y, aux


def moe_aux_total(aux: dict, cfg) -> torch.Tensor:
    return cfg.router_aux_coef * aux["lb_loss"] + \
        cfg.router_z_coef * aux["z_loss"]
