"""Mamba1 selective scan on Hopper (K8) and its wrapper.

The counterpart of ``repro.kernels.mamba_scan``: the hand-written CUDA
kernel in ``csrc/mamba_scan.cu`` replaces the Pallas ``_kernel``.  It is
bound by instruction issue (~15 float32 instructions per state update
against 10-12 bytes per (t, d)), so it fills the card: each channel's N
states are spread over G lanes (``lanes(B, D, N)`` picks G), time runs in
order inside the lanes in chunks of 32 steps that ``cp.async``
double-buffers in shared memory, and y is summed over a channel's lanes by
xor shuffles and written back as coalesced rows (see the source's note).
``selective_scan`` launches it for CUDA tensors and takes the plain
version, ``ref.selective_scan_ref``, only for CPU tensors.  It keeps a
plain launch counter, ``selective_scan.launches``, bumped where the kernel
launches and nowhere else.

``SelectiveScan`` puts it under autograd for training: its forward is
``selective_scan`` (the kernel on CUDA tensors), its backward
``selective_scan_backward``, the scan's reverse-time adjoint in plain
torch (the reference has no backward kernel: ``jax.grad`` differentiates
its jnp twin).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import (check_launch, load_library, on_cuda,
                                       stream)
from repro_torch.kernels.ref import selective_scan_ref

STATE_SIZES = (4, 8, 16, 32, 64)         # the kernel's instantiations of N
LANES = (2, 4, 8, 16)                    # ... and of G, the lanes a channel
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_Y = 65535                       # CUDA's bound on gridDim.y
# the fewest lanes that put this many threads (1,024 warps, ~8 an SM of the
# H100) on the card: a sweep of every lane count on the H100 (PERF.md)
# found more lanes cost more instructions an update than the extra warps
# hide
FILL_THREADS = 32 * 1024


class _ScanArgs(ctypes.Structure):
    _fields_ = [("B", ctypes.c_int64), ("S", ctypes.c_int64),
                ("D", ctypes.c_int64), ("N", ctypes.c_int64),
                ("has_h0", ctypes.c_int), ("lanes", ctypes.c_int),
                ("vec", ctypes.c_int)]


def lanes(B: int, D: int, N: int) -> int:
    """G, the lanes a channel's N states are spread over: the fewest (so
    the most states a lane, the fewest instructions an update) that still
    put ``FILL_THREADS`` threads on the card, at most N and at most 16."""
    for g in LANES:
        if g == LANES[-1] or g * 2 > N or B * D * g >= FILL_THREADS:
            return g
    raise AssertionError("unreachable")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 4-byte aligned address (the kernel copies
    4-byte words)."""
    t = t.contiguous()
    return t if t.data_ptr() % 4 == 0 else t.clone()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature (build.load_library)."""
    vp = ctypes.c_void_p
    lib.selective_scan.argtypes = [vp, ctypes.c_int] + [vp] * 9
    lib.selective_scan.restype = ctypes.c_int
    return lib


def selective_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bmat: torch.Tensor, Cmat: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt: (B, S, D); A: (D, N); Bmat, Cmat: (B, S, N); h0: (B, D, N)
    or None.  Returns (y (B, S, D) f32, h_last (B, D, N) f32).  CUDA
    tensors launch the kernel on the current stream without syncing, with
    ``lanes(B, D, N)`` lanes a channel; CPU tensors take
    ``selective_scan_ref``."""
    Bsz, S, D = u.shape
    N = A.shape[1]
    if dt.shape != u.shape or A.shape != (D, N) or \
            Bmat.shape != (Bsz, S, N) or Cmat.shape != (Bsz, S, N) or \
            (h0 is not None and h0.shape != (Bsz, D, N)):
        raise ValueError(f"selective_scan: u {tuple(u.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bmat.shape)}, C {tuple(Cmat.shape)}")
    tensors = (u, dt, A, Bmat, Cmat) + (() if h0 is None else (h0,))
    if not on_cuda("selective_scan", *tensors):
        return selective_scan_ref(u, dt, A, Bmat, Cmat, h0)
    if u.dtype not in DTYPES or Bmat.dtype != u.dtype or \
            Cmat.dtype != u.dtype:
        raise ValueError(f"selective_scan kernel takes float32 or bfloat16 "
                         f"u, B, C of one dtype, got {u.dtype}, "
                         f"{Bmat.dtype}, {Cmat.dtype}")
    if N not in STATE_SIZES or Bsz > MAX_GRID_Y or D == 0:
        raise ValueError(f"selective_scan kernel: N={N} (takes "
                         f"{STATE_SIZES}), B={Bsz}, D={D}")
    # scratch: the kernel reads contiguous, 4-byte aligned rows, dt / A /
    # h0 in float32 (the same upcast the plain version makes) and, in
    # bfloat16, pairs of channels (an odd D takes float32, exactly); no-ops
    # on the model path except for B and C, which are column slices of one
    # projection
    if u.dtype == torch.bfloat16 and D % 2:
        u, Bmat, Cmat = u.float(), Bmat.float(), Cmat.float()
    u, Bmat, Cmat = _aligned(u), _aligned(Bmat), _aligned(Cmat)
    dt = _aligned(dt.float())
    A = _aligned(A.float())
    if h0 is not None:
        h0 = _aligned(h0.float())
    y = torch.empty((Bsz, S, D), dtype=torch.float32, device=u.device)
    h_last = torch.empty((Bsz, D, N), dtype=torch.float32, device=u.device)
    if Bsz == 0:
        return y, h_last
    # 16-byte copies when every row of u, dt, y, B and C starts on one
    vec = D % 8 == 0 and N * u.element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (u, dt, Bmat, Cmat, y))
    args = _ScanArgs(Bsz, S, D, N, int(h0 is not None), lanes(Bsz, D, N),
                     int(vec))
    lib = load_library("mamba_scan")
    check_launch(lib.selective_scan(
        ctypes.addressof(args), DTYPES[u.dtype], u.data_ptr(),
        dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), stream(u.device)), "selective_scan")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0


def _chunk_states(dA, dBu, h):
    """States h_t = dA_t * h_{t-1} + dBu_t of one chunk, time-major
    (T, B, D, N), from the state ``h`` before it; overwrites ``dBu``."""
    out = dBu
    for t in range(out.shape[0]):
        out[t].addcmul_(dA[t], h)
        h = out[t]
    return out


def selective_scan_backward(u, dt, A, Bmat, Cmat, h0, dy, dh_last,
                            chunk: int = 256):
    """Gradients (du, ddt, dA, dB, dC, dh0) of ``selective_scan`` at its
    inputs, given the gradients of its outputs y (``dy``) and h_last
    (``dh_last``): the reverse-time adjoint g_t = C_t dy_t + dA_{t+1}
    g_{t+1} (dA_t = exp(dt_t A)) over states recomputed in float32,
    vectorised over (B, D, N).  Time runs in chunks of ``chunk`` steps:
    one forward pass keeps the state at each chunk's start, then each
    chunk, last first, recomputes its states and runs its adjoint, so at
    most (chunk, B, D, N) float32 states live at once.  dh0 is None when
    h0 is."""
    Bsz, S, D = u.shape
    N = A.shape[1]
    chunk = max(1, min(chunk, S)) if S else 1
    Af = A.float()

    def inputs(c0, c1):          # time-major float32 slices of one chunk
        dtc = dt[:, c0:c1].float().transpose(0, 1)              # (T, B, D)
        dtu = dtc * u[:, c0:c1].float().transpose(0, 1)
        Bc = Bmat[:, c0:c1].float().transpose(0, 1)             # (T, B, N)
        dA = torch.exp(dtc[..., None] * Af)                     # (T, B, D, N)
        dBu = dtu[..., None] * Bc[:, :, None, :]
        return dtc, dtu, Bc, dA, dBu

    h = torch.zeros((Bsz, D, N), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    bounds = [(c0, min(c0 + chunk, S)) for c0 in range(0, S, chunk)]
    starts = [h]
    for c0, c1 in bounds[:-1]:
        _, _, _, dA, dBu = inputs(c0, c1)
        starts.append(_chunk_states(dA, dBu, starts[-1])[-1].clone())
        del dA, dBu
    du = torch.empty((Bsz, S, D), dtype=torch.float32, device=u.device)
    ddt = torch.empty_like(du)
    dB = torch.empty((Bsz, S, N), dtype=torch.float32, device=u.device)
    dC = torch.empty_like(dB)
    dAm = torch.zeros_like(Af)
    carry = torch.zeros_like(h) if dh_last is None else dh_last.float()
    for (c0, c1), start in zip(reversed(bounds), reversed(starts)):
        dtc, dtu, Bc, dA, dBu = inputs(c0, c1)
        H = _chunk_states(dA, dBu, start)
        dyc = dy[:, c0:c1].float().transpose(0, 1)              # (T, B, D)
        Cc = Cmat[:, c0:c1].float().transpose(0, 1)
        dC[:, c0:c1] = torch.einsum("tbd,tbdn->tbn", dyc, H).transpose(0, 1)
        g = dyc[..., None] * Cc[:, :, None, :]                  # C_t dy_t
        g[-1] += carry
        for t in range(g.shape[0] - 2, -1, -1):
            g[t].addcmul_(dA[t + 1], g[t + 1])
        carry = dA[0] * g[0]
        # h_{t-1} for each step of the chunk, then d(dt A) = g h_{t-1} dA
        H = torch.cat([start[None], H[:-1]])
        w = g * H
        w *= dA
        del H, dA
        gB = torch.einsum("tbdn,tbn->tbd", g, Bc)               # d(dt u)
        ddt[:, c0:c1] = (torch.einsum("tbdn,dn->tbd", w, Af) +
                         gB * u[:, c0:c1].float().transpose(0, 1)
                         ).transpose(0, 1)
        du[:, c0:c1] = (gB * dtc).transpose(0, 1)
        dAm += torch.einsum("tbdn,tbd->dn", w, dtc)
        dB[:, c0:c1] = torch.einsum("tbdn,tbd->tbn", g, dtu).transpose(0, 1)
        del g, w
    dh0 = None if h0 is None else carry.to(h0.dtype)
    return (du.to(u.dtype), ddt.to(dt.dtype), dAm.to(A.dtype),
            dB.to(Bmat.dtype), dC.to(Cmat.dtype), dh0)


class SelectiveScan(torch.autograd.Function):
    """K8 under autograd: ``SelectiveScan.apply(u, dt, A, Bmat, Cmat, h0,
    chunk)`` returns (y, h_last); ``chunk`` is the backward's time chunk.
    Only the forward launches the kernel."""

    @staticmethod
    def forward(ctx, u, dt, A, Bmat, Cmat, h0, chunk):
        y, h_last = selective_scan(u, dt, A, Bmat, Cmat, h0)
        ctx.save_for_backward(u, dt, A, Bmat, Cmat, h0)
        ctx.chunk = chunk
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        return selective_scan_backward(*ctx.saved_tensors, dy, dh_last,
                                       chunk=ctx.chunk) + (None,)
