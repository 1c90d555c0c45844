"""Public wrappers for the model and join kernels (the port of
``repro.kernels.ops``: ``flash_attention``, ``selective_scan``,
``bhj_join`` and ``smj_join``).

``impl="cuda"`` (the default) is the deployment path: the hand-written
CUDA kernel for CUDA tensors, its plain version for CPU tensors (the
kernel wrappers decide by the tensors' device).  ``impl="ref"`` asks for
the plain version explicitly, as the reference's ``impl="ref"`` does;
``chip_smoke.py`` uses it to hold the kernels against it on the card.
The attention and the scan go through their ``torch.autograd.Function``
(``FlashAttention``, ``SelectiveScan``), so a training step
differentiates through the kernels' forward; ``impl="ref"``
differentiates through the plain versions by autograd.

``flash_attention`` takes the reference's block ``schedule`` ("dense",
"causal_skip", "window") and launches K7 the same way for each: its tile
loop already does causal_skip's work (``kernels/flash_attention.py``).

Under a multi-device plan the attention's q, k and v are DTensors:
``flash_attention`` then runs K7 on each rank's shard through
``torch.distributed.tensor.experimental.local_map`` (the kernel takes
raw pointers, so it never sees a DTensor): q sharded on its heads (over
"model") and its batch (over the data axes), k and v on the batch only,
replicated over the heads' axis as the reference keeps them, and each
rank hands the kernel the KV heads its own q heads read
(``local_kv_heads``); positions, when given, enter ("batch", None): the
batch's shards, replicated over the heads' axis, as the reference
constrains them.  Their gradients come back partial sums over the
heads' axis, which the autograd of the redistributions before reduces.
``selective_scan`` of a DTensor u runs K8 the same way on each rank's
channels (``_selective_scan_sharded``: u, dt, A and h0 sharded along
Mamba's d_inner, "inner" over "model", B and C whole in N with partial
gradients).  A DTensor on the card launches the kernel or raises: there
is no fallback to the plain version (``sharding.map_local``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hash_join as _hj
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import merge_join as _mj
from repro_torch.kernels import ref
from repro_torch.sharding import (is_dtensor, map_channels, map_local,
                                  placements_like)

IMPLS = ("cuda", "ref")
# the reference's flash block schedules (``repro.models.attention``)
SCHEDULES = ("dense", "causal_skip", "window")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    attn_softcap: Optional[float] = None,
                    schedule: str = "dense", impl: str = "cuda",
                    q_positions=None, kv_positions=None):
    """``schedule``: the reference's flash block schedule, one of
    SCHEDULES; K7 (and the plain version) compute the same for each.
    ``q_positions`` (B, S) and ``kv_positions`` (B, Skv), int64, mask by
    position instead of by index (``kernels.flash_attention``)."""
    _check_impl(impl)
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r}; expected one of "
                         f"{SCHEDULES}")
    if is_dtensor(q):
        return _flash_attention_sharded(q, k, v, causal, window,
                                        attn_softcap, schedule, impl,
                                        q_positions, kv_positions)
    if impl == "ref":
        _fa.check_positions(q, k, q_positions, kv_positions)
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 attn_softcap=attn_softcap,
                                 q_positions=q_positions,
                                 kv_positions=kv_positions)
    return _fa.FlashAttention.apply(q, k, v, causal, window, attn_softcap,
                                    q_positions, kv_positions)


def local_kv_heads(H: int, KV: int, tp: int, m: int):
    """The KV heads rank ``m`` of ``tp`` (holding q heads ``m * H / tp``
    .. ``(m + 1) * H / tp - 1``) needs, so that the kernel's own grouping
    of its local q heads onto them is the model's ``h // (H / KV)``: a
    ``slice`` when the local heads cover whole groups or lie inside one,
    else a list with one KV head per local q head (group size 1)."""
    if H % tp:
        raise NotImplementedError(
            f"{H} q heads do not split over a tensor-parallel degree of "
            f"{tp}: pick a tp that divides the head count")
    Hl, G = H // tp, H // KV
    h0 = m * Hl
    if Hl % G == 0 or G % Hl == 0:
        return slice(h0 // G, (h0 + Hl - 1) // G + 1)
    return [(h0 + j) // G for j in range(Hl)]


def _flash_attention_sharded(q, k, v, causal, window, attn_softcap,
                             schedule, impl, q_positions=None,
                             kv_positions=None):
    """K7 on each rank's shard of DTensor q, k, v (and positions: module
    docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    # q: batch and heads may stay sharded, anything else is gathered
    q_pl = placements_like(q, (0, 2), (0, 2))
    heads = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    if len(heads) > 1:
        raise NotImplementedError("q heads sharded over more than one mesh "
                                  "axis")
    kv_pl = [Replicate() if i in heads else p for i, p in enumerate(q_pl)]
    tp = mesh.size(heads[0]) if heads else 1
    m = mesh.get_local_rank(heads[0]) if heads else 0
    pick = local_kv_heads(q.shape[2], k.shape[2], tp, m)
    # the positions: ("batch", None), whole over the heads' axis
    pos = () if q_positions is None else (q_positions, kv_positions)
    pos_pl = [Shard(0) if p == Shard(0) else Replicate() for p in q_pl]

    def attend(ql, kl, vl, *pl):
        kl, vl = kl[:, :, pick], vl[:, :, pick]
        qp, kvp = (t.contiguous() for t in pl) if pl else (None, None)
        return (flash_attention(ql.contiguous(), kl.contiguous(),
                                vl.contiguous(), causal=causal, window=window,
                                attn_softcap=attn_softcap, schedule=schedule,
                                impl=impl, q_positions=qp,
                                kv_positions=kvp),)

    return map_local(attend, (q, k, v) + pos,
                     (q_pl, kv_pl, kv_pl) + (pos_pl,) * len(pos), (q_pl,),
                     mesh)[0]


def _selective_scan_sharded(u, dt, A, Bmat, Cmat, h0, impl, chunk):
    """K8 on each rank's channels of DTensor u, dt (B, S, D), A (D, N)
    and h0 (B, D, N), sharded along D where u is and along the batch where
    u is, every other shard (the sequence's) gathered; Bmat and Cmat (B,
    S, N) whole in N, their gradients partial sums over the channels'
    axis.  Returns y (B, S, D) and h_last (B, D, N) with D's shard."""
    args = (u, dt, A, Bmat, Cmat) + (() if h0 is None else (h0,))
    # each argument's (batch dim, channel dim)
    dims = ((0, 2), (0, 2), (None, 0), (0, None), (0, None), (0, 1))

    def scan(*local):
        return selective_scan(*(t.contiguous() for t in local), impl=impl,
                              chunk=chunk)

    return map_channels(scan, args, dims[:len(args)], ((0, 2), (0, 1)), u)


def selective_scan(u, dt, A, Bmat, Cmat, h0=None, impl: str = "cuda",
                   chunk: int = 256):
    """``chunk``: the time steps the backward recomputes at a time."""
    _check_impl(impl)
    if is_dtensor(u):
        return _selective_scan_sharded(u, dt, A, Bmat, Cmat, h0, impl, chunk)
    if impl == "ref":
        return ref.selective_scan_ref(u, dt, A, Bmat, Cmat, h0)
    return _ms.SelectiveScan.apply(u, dt, A, Bmat, Cmat, h0, chunk)


def bhj_join(probe_keys, build_keys, build_vals, *, impl: str = "cuda"):
    """Broadcast hash join (PK join): (S,) int32 values of the first
    matching build row, -1 on a miss.  The reference's ``block_probe`` /
    ``block_build`` tile sizes have no counterpart here."""
    _check_impl(impl)
    if impl == "ref":
        return ref.hash_join_ref(probe_keys, build_keys, build_vals)
    return _hj.hash_join(probe_keys, build_keys, build_vals)


def smj_join(probe_keys, build_keys, build_vals, *, impl: str = "cuda"):
    """Sort-merge join on ascending ``build_keys``; the same result as
    ``bhj_join``."""
    _check_impl(impl)
    if impl == "ref":
        return ref.merge_join_ref(probe_keys, build_keys, build_vals)
    return _mj.merge_join(probe_keys, build_keys, build_vals)


def reset_launch_counts() -> None:
    _fa.flash_attention.launches = 0
    _ms.selective_scan.launches = 0
    _hj.hash_join.launches = 0
    _mj.merge_join.launches = 0
