"""Forward flash attention on Hopper (K7) and its wrapper.

The counterpart of ``repro.kernels.flash_attention``: the hand-written
CUDA kernels in ``csrc/flash_attention.cu`` replace the Pallas ``_kernel``
(one block per (batch, head, query tile), a loop over 64-row kv tiles in
shared memory, float32 online softmax; see the source's note for what
bounds them).  bfloat16 with a head dim in ``TC_HEAD_DIMS`` runs on the
tensor cores (wgmma, TMA tiles, 64 query rows a block);
float32 and the other head dims run on the CUDA cores, bfloat16 at
zamba2's head dim 80 among them (the tensor-core kernel works in
64-column chunks of the head dim).
``flash_attention`` launches them for CUDA tensors and takes the plain
version, ``ref.attention_ref``, only for CPU tensors.  It keeps a plain
launch counter, ``flash_attention.launches``, bumped where a kernel
launches and nowhere else.

``FlashAttention`` puts it under autograd for training: its forward is
``flash_attention`` (the kernel on CUDA tensors), its backward
``attention_backward``, FlashAttention's backward equations in plain
torch (the reference has no backward kernel: ``jax.grad`` differentiates
its jnp twin).

Masking is by index (``kpos <= qpos``, ``qpos - kpos < window``), as in
the Pallas kernel, unless the caller gives ``q_positions`` (B, S) and
``kv_positions`` (B, Skv): then by those positions, as the reference's jnp
``flash_attention`` masks (-1 an invalid slot: a key at -1 is never kept,
and under ``causal`` a key is kept where ``0 <= q_pos - kv_pos <
window``).  Positions need not be ``arange``, so the kernels then visit
every kv tile (no tile skip) and mask every score; positions equal to
``arange`` give exactly the index path's output.  A row with no kept key
(a query at -1 in a left-padded batch) averages V over all Skv keys, as
the reference's online softmax does when Skv fits its kv block of 512
(beyond that it divides by its padded block length: ROADMAP §3).  S and
Skv may be ragged (no block-multiple padding).

The reference's block schedules are one launch here.  Its "dense"
schedule visits every (q block, kv block) pair and masks; "causal_skip"
scans only the pairs on or below the diagonal, about half the causal
work; "window" a static band.  K7's tile loop skips the kv tiles wholly
above the diagonal or wholly left of the window (the source's note), so
every launch does causal_skip's work, and the band's under a window,
with the same answers.  The plain torch backward computes the dense
masked scores under every schedule.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (check_launch, load_library, on_cuda,
                                       stream)
from repro_torch.kernels.ref import attention_mask, attention_ref

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the kernel's instantiations
TC_HEAD_DIMS = (64, 128)                 # bfloat16 on the tensor cores
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535                      # CUDA's bound on gridDim.y and .z


class _AttnArgs(ctypes.Structure):
    _fields_ = [("B", ctypes.c_int64), ("S", ctypes.c_int64),
                ("Skv", ctypes.c_int64), ("H", ctypes.c_int64),
                ("KV", ctypes.c_int64), ("hd", ctypes.c_int64),
                ("causal", ctypes.c_int), ("window", ctypes.c_int),
                ("has_cap", ctypes.c_int), ("cap", ctypes.c_float),
                ("scale", ctypes.c_float), ("q_pos", ctypes.c_void_p),
                ("kv_pos", ctypes.c_void_p)]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature (build.load_library)."""
    vp = ctypes.c_void_p
    lib.flash_attention.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp]
    lib.flash_attention.restype = ctypes.c_int
    return lib


def check_positions(q, k, q_positions, kv_positions) -> None:
    """Raise ``ValueError`` unless the positions are both None, or int64
    tensors of shapes (B, S) and (B, Skv) on q's device."""
    if q_positions is None and kv_positions is None:
        return
    B, S = q.shape[:2]
    want = ((q_positions, (B, S)), (kv_positions, (B, k.shape[1])))
    if any(p is None or p.dtype != torch.int64 or tuple(p.shape) != shape
           or p.device != q.device for p, shape in want):
        got = [None if p is None else (tuple(p.shape), p.dtype, p.device)
               for p, _ in want]
        raise ValueError(f"flash_attention takes int64 q_positions (B, S) "
                         f"= {(B, S)} and kv_positions (B, Skv) = "
                         f"{(B, k.shape[1])} on {q.device}, or neither; got "
                         f"{got}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    attn_softcap: Optional[float] = None,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, Skv, KV, hd) -> (B, S, H, hd) in q's
    dtype; masked by index, or by the int64 positions when given (module
    docstring).  CUDA tensors launch the kernel on the current stream
    without syncing; CPU tensors take ``attention_ref``."""
    B, S, H, hd = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or \
            k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} < 1")
    check_positions(q, k, q_positions, kv_positions)
    if not on_cuda("flash_attention", q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             attn_softcap=attn_softcap,
                             q_positions=q_positions,
                             kv_positions=kv_positions)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if hd not in HEAD_DIMS or H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"flash_attention kernel: head dim {hd} (takes "
                         f"{HEAD_DIMS}), H={H}, B={B}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q, k, v")
    if q.dtype == torch.bfloat16 and hd in TC_HEAD_DIMS and \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention tensor-core kernel takes 16-byte "
                         "aligned q, k, v")
    by_pos = q_positions is not None
    if by_pos and not (q_positions.is_contiguous() and
                       kv_positions.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous positions")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    args = _AttnArgs(B, S, k.shape[1], H, k.shape[2], hd, int(causal),
                     0 if window is None else int(window),
                     int(attn_softcap is not None),
                     0.0 if attn_softcap is None else float(attn_softcap),
                     hd ** -0.5,
                     q_positions.data_ptr() if by_pos else None,
                     kv_positions.data_ptr() if by_pos else None)
    lib = load_library("flash_attention")
    check_launch(lib.flash_attention(
        ctypes.addressof(args), DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), stream(q.device)), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention_backward(q, k, v, out, dout, *, causal: bool = True,
                       window: Optional[int] = None,
                       attn_softcap: Optional[float] = None,
                       q_positions=None, kv_positions=None):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v), given its output
    ``out`` and the output's gradient ``dout``: the softmax recomputed in
    float32 from q and k, masked by index or by the positions as the
    forward was, then FlashAttention's backward equations (D = rowsum(dout
    * out), dS = P * (dP - D), through the softcap's tanh), dS zero on
    every masked score (the reference's ``jnp.where`` passes no gradient
    there, also in a row with no kept key).  Each kv head's gradient sums
    over its group of query heads.  Returned in the inputs' dtypes."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf = q.float().reshape(B, S, KV, G, hd)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    if attn_softcap is not None:
        th = torch.tanh(s / attn_softcap)
        s = th * attn_softcap
    mask = attention_mask(S, Skv, q.device, causal=causal, window=window,
                          q_positions=q_positions, kv_positions=kv_positions)
    if mask is not None and mask.ndim == 3:     # (B, S, Skv): by position
        mask = mask[:, None, None]
    if mask is not None:
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)                         # (B, KV, G, S, Skv)
    d_row = (do * out.float().reshape(B, S, KV, G, hd)).sum(-1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    ds = torch.einsum("bqkgd,bskd->bkgqs", do, vf)
    ds = p * (ds - d_row.permute(0, 2, 3, 1)[..., None])
    if mask is not None:
        ds = torch.where(mask, ds, 0.0)
    if attn_softcap is not None:
        ds = ds * (1 - th * th)
    ds = ds * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, S, H, hd)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """K7 under autograd: ``FlashAttention.apply(q, k, v, causal, window,
    attn_softcap[, q_positions, kv_positions])``.  Only the forward
    launches the kernel; the positions take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, attn_softcap,
                q_positions=None, kv_positions=None):
        out = flash_attention(q, k, v, causal=causal, window=window,
                              attn_softcap=attn_softcap,
                              q_positions=q_positions,
                              kv_positions=kv_positions)
        ctx.save_for_backward(q, k, v, out, q_positions, kv_positions)
        ctx.opts = dict(causal=causal, window=window,
                        attn_softcap=attn_softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, qp, kvp = ctx.saved_tensors
        return attention_backward(q, k, v, out, dout, q_positions=qp,
                                  kv_positions=kvp, **ctx.opts) + \
            (None,) * 5
