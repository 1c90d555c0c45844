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
