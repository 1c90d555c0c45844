"""Sort-merge join on Hopper (K6) and its wrapper.

The counterpart of ``repro.kernels.merge_join``: the hand-written CUDA
kernel in ``csrc/merge_join.cu`` replaces the Pallas ``_rank_kernel`` and
the clip, key check and gather after it, in one launch.  A persistent
block holds a strided sample of ``SAMPLE`` build keys in shared memory and
takes a run of tiles of ``TILE`` consecutive probe keys: it finds the
build rows a tile's key range spans (predicted from the previous tile's,
as clustered probes allow), stages them in shared memory when there are
at most ``STAGE`` of them and ranks every probe there; otherwise each
probe narrows its search with the sample and finishes it in global
memory.  What bounds it (the chain of latencies a tile waits for, above
its bytes): the source's note.  ``merge_join`` launches it for CUDA tensors and takes
the plain version, ``ref.merge_join_ref``, only for CPU tensors.  It keeps
a plain launch counter, ``merge_join.launches``, bumped where the kernel
launches and nowhere else.

Like the reference it does not check that the build keys are sorted.
Unlike it, it takes no tile sizes and no multiple-of-tile lengths (TPU
constraints, not semantics), and on duplicate build keys it returns the
first matching row's value, as the oracles do.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (check_launch, load_library, on_cuda,
                                       stream)
from repro_torch.kernels.ref import check_join, merge_join_ref

# the kernel's compiled sizes (``merge_join_sizes`` in the source): probe
# keys a tile, build keys a tile may stage, sampled build keys a block holds
TILE, STAGE, SAMPLE = 2048, 2048, 4096


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature (build.load_library)."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.merge_join.argtypes = [vp, i64, vp, vp, i64, vp, vp]
    lib.merge_join.restype = ctypes.c_int
    lib.merge_join_sizes.argtypes = [vp]
    lib.merge_join_sizes.restype = None
    return lib


def merge_join(probe_keys: torch.Tensor, build_keys: torch.Tensor,
               build_vals: torch.Tensor) -> torch.Tensor:
    """probe_keys (S,), build_keys ascending and build_vals (R,), all
    int32.  Returns (S,) int32: for each probe key the value of the first
    build row whose key matches, or -1.  CUDA tensors launch the kernel on
    the current stream without syncing; CPU tensors take
    ``merge_join_ref``."""
    check_join(probe_keys, build_keys, build_vals)
    if not on_cuda("merge_join", probe_keys, build_keys, build_vals):
        return merge_join_ref(probe_keys, build_keys, build_vals)
    probe_keys = probe_keys.contiguous()
    build_keys, build_vals = build_keys.contiguous(), build_vals.contiguous()
    out = torch.empty_like(probe_keys)
    if probe_keys.shape[0] == 0:
        return out
    lib = load_library("merge_join")
    check_launch(lib.merge_join(
        probe_keys.data_ptr(), probe_keys.shape[0], build_keys.data_ptr(),
        build_vals.data_ptr(), build_keys.shape[0], out.data_ptr(),
        stream(probe_keys.device)), "merge_join")
    merge_join.launches += 1
    return out


merge_join.launches = 0
