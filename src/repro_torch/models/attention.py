"""Attention for the port's model stack: single-token decode against a
cache, cross attention onto media, and the cache utilities (the port of
``repro.models.attention``).

The reference's blocked jnp ``flash_attention`` (masking by positions, -1
= invalid slot) was the CPU twin of its Pallas kernel; the port's prefill
calls ``kernels.ops.flash_attention`` instead, which masks by index like
the kernel does, or by the batch's own positions when it carries them
(``Model.forward``).  Decode stays plain torch (the reference has no
Pallas kernel for it), and so does cross attention (plain jnp in the
reference too, outside any Pallas kernel).

``write_cache`` lets only valid entries (position >= 0) write: an entry
at -1 clamps onto slot 0 (slot W - 1 of a rolling cache), where a valid
entry of a left-padded row also writes, and a scatter with duplicate
indices keeps an unspecified one of the writes on CUDA.  The reference's
scatter keeps the last write on the CPU, so a right-padded row loses its
position 0 there (ROADMAP §3); the port keeps the valid entry whatever
the order.

Under a serve plan the cache is sharded along its sequence ("kv_seq",
over one or several mesh dims; ``models.model``).  ``write_cache`` then
writes each rank's own slots, the slot clamped on the global length
(``write_chunk`` under ``map_local``, in place), and
``decode_attention`` attends with every head over each rank's slots,
reducing the softmax's max, its sum and the partial output over the
sequence's mesh dims: the partition GSPMD makes of the reference's
function, so the probabilities are cast to the cache dtype before the
product as on one device (a one-pass combine that rescales partial
outputs would round them after the rescale).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ops import local_kv_heads
from repro_torch.models.common import softcap
from repro_torch.sharding import (all_reduce, is_dtensor, map_local,
                                  placements_like, shard_range)

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, q_pos, slot_pos, *,
                     attn_softcap=None, window: Optional[int] = None):
    """Single-token attention over a cache.

    q: (B, 1, H, hd); caches: (B, S, KV, hd); q_pos: (B,) current position;
    slot_pos: (B, S) position stored in each slot (-1 = empty).  Works
    for both full caches (slot i holds position i) and rolling-window caches
    (slot i holds the latest position = i mod W).  A cache sharded along
    its sequence (DTensors) attends on each rank's slots
    (``_decode_attention_sharded``)."""
    if is_dtensor(k_cache):
        return _decode_attention_sharded(q, k_cache, v_cache, q_pos,
                                         slot_pos, attn_softcap, window)
    return _decode_attend(q, k_cache, v_cache, q_pos, slot_pos, attn_softcap,
                          window, lambda t, op: t)


def _decode_attend(q, k_cache, v_cache, q_pos, slot_pos, attn_softcap,
                   window, reduce):
    """``decode_attention`` over the slots of ``k_cache`` / ``v_cache`` /
    ``slot_pos``, which may be one chunk of the cache's sequence:
    ``reduce(t, op)`` ("max" or "sum") combines a chunk's partial result
    with the other chunks' (the identity on a whole cache).  The softmax's
    max, its sum and the output's (p / l) V product are each reduced, as
    GSPMD partitions the reference's over a sharded sequence, so the
    probabilities are cast to the cache dtype before the product in every
    chunk as on one device."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    # bf16 operands, float32 products and sums (preferred_element_type)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     k_cache.float()) * (hd ** -0.5)
    s = softcap(s, attn_softcap)
    rel = q_pos[:, None] - slot_pos                     # (B, S)
    mask = (slot_pos >= 0) & (rel >= 0)
    if window is not None:
        mask &= rel < window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True) if S else \
        s.new_full((B, KV, G, 1), NEG_INF)              # an empty chunk
    m = reduce(m, "max")
    p = torch.exp(s - m)
    l = reduce(p.sum(dim=-1, keepdim=True), "sum")
    out = torch.einsum("bkgs,bskd->bkgd",
                       (p / l).to(v_cache.dtype).float(), v_cache.float())
    return reduce(out, "sum").reshape(B, 1, H, hd).to(q.dtype)


def _decode_attention_sharded(q, k_cache, v_cache, q_pos, slot_pos,
                              attn_softcap, window):
    """``decode_attention`` of DTensors: caches (B, S, KV, hd) and
    slot_pos (B, S) sharded along S (a serve plan's "kv_seq", over one or
    several mesh dims) and along the batch.  q (one token, B x H x hd) is
    gathered whole over its heads, so each rank attends with every head
    over its own slots; the max, the sum and the partial output are
    all-reduced over the mesh dims of S (``_decode_attend``), and the
    output leaves replicated but for the batch."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = k_cache.device_mesh
    seq = [i for i, p in enumerate(k_cache.placements) if p == Shard(1)]
    batch = [Shard(0) if p == Shard(0) else Replicate()
             for p in k_cache.placements]

    def attend(ql, kl, vl, ql_pos, sl):
        return (_decode_attend(ql, kl, vl, ql_pos, sl, attn_softcap, window,
                               lambda t, op: all_reduce(t, op, mesh, seq)),)

    return map_local(attend, (q, k_cache, v_cache, q_pos, slot_pos),
                     (batch, k_cache.placements, v_cache.placements, batch,
                      slot_pos.placements), (batch,), mesh)[0]


def cross_attention(q, k, v, media_valid=None):
    """Full (unmasked) attention onto a small media sequence.

    q: (B, Sq, H, hd); k, v: (B, M, KV, hd); media_valid: optional (B, M)
    bool, False masks a media position.  Scores in float32 (q and k's
    products and sums), the softmax in float32, its probabilities cast to
    v's dtype, then float32 sums; the output in q's dtype.  DTensors run
    on each rank's heads (``_cross_attention_sharded``)."""
    if is_dtensor(q):
        if media_valid is not None:
            raise NotImplementedError("a media mask under a plan (the "
                                      "model never passes one)")
        return _cross_attention_sharded(q, k, v)
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bmkd->bkgqm", qg.float(),
                     k.float()) * (hd ** -0.5)
    if media_valid is not None:
        s = torch.where(media_valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqm,bmkd->bqkgd", p.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _cross_attention_sharded(q, k, v):
    """``cross_attention`` of DTensor q (B, Sq, H, hd), its batch and
    heads sharded (any other shard gathered), onto DTensor k, v (B, M, KV,
    hd): each rank attends from its own q heads onto the media K/V heads
    they read, picked as K7's sharded path picks them
    (``ops.local_kv_heads``) from K/V replicated over the heads' axis, or
    its own shard of them where that axis splits the KV heads evenly
    (``transformer.media_kv_for`` places them so).  The output is
    head-sharded like q."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    q_pl = placements_like(q, (0, 2), (0, 2))
    heads = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    if len(heads) > 1:
        raise NotImplementedError("q heads sharded over more than one mesh "
                                  "axis")
    split = bool(heads) and k.placements[heads[0]] == Shard(2)
    kv_pl = [p if i not in heads else (Shard(2) if split else Replicate())
             for i, p in enumerate(q_pl)]
    pick = slice(None) if split or not heads else local_kv_heads(
        q.shape[2], k.shape[2], mesh.size(heads[0]),
        mesh.get_local_rank(heads[0]))

    def attend(ql, kl, vl):
        if not ql.shape[2]:         # a rank that holds no heads
            return (ql.clone(),)
        return (cross_attention(ql, kl[:, :, pick], vl[:, :, pick]),)

    uneven = bool(heads) and q.shape[2] % mesh.size(heads[0])
    return map_local(attend, (q, k, v), (q_pl, kv_pl, kv_pl), (q_pl,),
                     mesh, (q.shape,) if uneven else None)[0]


# ------------------------------ cache utils ------------------------------- #

def write_cache(cache_k, cache_v, slot_pos, k_new, v_new, positions, *,
                rolling_window: Optional[int] = None):
    """Scatter new K/V rows into cache slots, in place (the reference
    returns updated copies; the port writes into the tensors it is given
    and returns them).

    cache_k/v: (B, S, KV, hd); k_new/v_new: (B, T, KV, hd);
    positions: (B, T) absolute positions being written, -1 for none.
    Full cache: slot = position.  Rolling: slot = position % window.
    Only valid entries write, whatever the scatter's order (module
    docstring), with no host sync: each invalid entry repeats its row's
    last valid entry (the same value into the same slot), or, in a row
    with none, writes back the old contents of its row's first slot.
    A cache sharded along its sequence (DTensors) is written on each
    rank's own slots (``_write_cache_sharded``)."""
    if is_dtensor(cache_k):
        return _write_cache_sharded(cache_k, cache_v, slot_pos, k_new, v_new,
                                    positions, rolling_window)
    B, S = cache_k.shape[:2]
    T = positions.shape[1]
    valid = positions >= 0
    if T > 1:
        idx = torch.arange(T, device=positions.device).expand(B, T)
        last = torch.where(valid, idx, -1).amax(dim=1, keepdim=True)
        src = torch.where(valid, idx, last.clamp(min=0))
        positions = positions.gather(1, src)
        gather = src[..., None, None].expand(-1, -1, *k_new.shape[2:])
        k_new, v_new = k_new.gather(1, gather), v_new.gather(1, gather)
        valid = (last >= 0).expand(B, T)
    slots = positions % rolling_window if rolling_window else positions
    b_idx = torch.arange(B, device=cache_k.device)[:, None]
    slots_c = torch.clamp(slots, 0, S - 1)
    sel = valid[..., None, None]
    cache_k[b_idx, slots_c] = torch.where(sel, k_new.to(cache_k.dtype),
                                          cache_k[b_idx, slots_c])
    cache_v[b_idx, slots_c] = torch.where(sel, v_new.to(cache_v.dtype),
                                          cache_v[b_idx, slots_c])
    slot_pos[b_idx, slots_c] = torch.where(
        valid, positions.to(slot_pos.dtype), slot_pos[b_idx, slots_c])
    return cache_k, cache_v, slot_pos


def write_chunk(cache_k, cache_v, slot_pos, k_new, v_new, positions,
                rolling_window, offset: int, total: int):
    """``write_cache`` into one chunk of a cache's sequence: the chunk
    holds global slots ``offset`` .. ``offset + S - 1`` of ``total``.  A
    slot is clamped on the global length, as on one device, and written
    only by the chunk that holds it, in place.  One position a row (a
    decode step) writes through ``where``; several (prefill) scatter each
    held entry's index into a (B, S + 1) map of the chunk's slots, the
    entries of other chunks and the invalid ones into the last column, so
    a ``where`` over clamped local slots never lets an entry of another
    chunk land on a held slot; where two entries hold one slot the later
    one wins, as the one-device write's.  No data-dependent shape and no
    host sync."""
    B, S = cache_k.shape[:2]
    if not S:                                   # an empty chunk
        return cache_k, cache_v, slot_pos
    slots = positions % rolling_window if rolling_window else positions
    slots = torch.clamp(slots, 0, total - 1) - offset
    own = (positions >= 0) & (slots >= 0) & (slots < S)
    if positions.shape[1] == 1:
        b_idx = torch.arange(B, device=cache_k.device)[:, None]
        loc = torch.clamp(slots, 0, S - 1)
        sel = own[..., None, None]
        cache_k[b_idx, loc] = torch.where(sel, k_new.to(cache_k.dtype),
                                          cache_k[b_idx, loc])
        cache_v[b_idx, loc] = torch.where(sel, v_new.to(cache_v.dtype),
                                          cache_v[b_idx, loc])
        slot_pos[b_idx, loc] = torch.where(
            own, positions.to(slot_pos.dtype), slot_pos[b_idx, loc])
        return cache_k, cache_v, slot_pos
    T = positions.shape[1]
    t = torch.arange(T, device=positions.device).expand(B, T)
    src = torch.full((B, S + 1), -1, dtype=torch.int64,
                     device=positions.device)
    src.scatter_reduce_(1, torch.where(own, slots, S).to(torch.int64),
                        torch.where(own, t, -1), "amax")
    src = src[:, :S]
    held = src >= 0
    src = src.clamp(min=0)
    rows = src[..., None, None].expand(-1, -1, *k_new.shape[2:])
    sel = held[..., None, None]
    cache_k.copy_(torch.where(sel, k_new.gather(1, rows).to(cache_k.dtype),
                              cache_k))
    cache_v.copy_(torch.where(sel, v_new.gather(1, rows).to(cache_v.dtype),
                              cache_v))
    slot_pos.copy_(torch.where(held, positions.gather(1, src).to(
        slot_pos.dtype), slot_pos))
    return cache_k, cache_v, slot_pos


def _write_cache_sharded(cache_k, cache_v, slot_pos, k_new, v_new,
                         positions, rolling_window):
    """``write_cache`` of DTensors: the cache sharded along its sequence
    (and the batch), the new rows and positions placed by the batch alone;
    each rank writes its own slots of its rows (``write_chunk``, its chunk
    from ``shard_range``) in place, so the cache's DTensors are
    returned."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache_k.device_mesh
    batch = [Shard(0) if p == Shard(0) else Replicate()
             for p in cache_k.placements]
    total = cache_k.shape[1]
    offset, _ = shard_range(total, mesh, cache_k.placements, 1)

    def write(kl, vl, sl, knl, vnl, pl):
        write_chunk(kl, vl, sl, knl, vnl, pl, rolling_window, offset, total)
        return ()

    map_local(write, (cache_k, cache_v, slot_pos, k_new, v_new, positions),
              (cache_k.placements, cache_v.placements, slot_pos.placements,
               batch, batch, batch), (), mesh)
    return cache_k, cache_v, slot_pos


def prefill_tail(k, v, positions, window: int):
    """For rolling caches, keep only the last `window` rows before scatter
    (deterministic; avoids duplicate-index scatter ordering)."""
    S = k.shape[1]
    if S <= window:
        return k, v, positions
    return k[:, -window:], v[:, -window:], positions[:, -window:]
