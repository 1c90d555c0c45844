"""Broadcast hash join on Hopper (K5) and its wrapper.

The counterpart of ``repro.kernels.hash_join``: the hand-written CUDA
kernels in ``csrc/hash_join.cu`` replace the Pallas ``_kernel``.  One call
launches four: the build keys' min and max (taken in 64 bits on the
device, no host sync), a build into a direct-addressed array when the key
range fits ``dense_slots(R)`` words and into an open-addressing table
otherwise (the choice is made on the device), a pass that writes each key's
first-row value into its word or slot, and a probe that reads key and value
in one random access per probe key.  What bounds it (the L2's rate for
random sectors) and how the empty marker stays unambiguous (key -1 never
enters the table): the source's note.
``hash_join`` launches them for CUDA tensors and takes the plain version,
``ref.hash_join_ref``, only for CPU tensors.  It keeps a plain launch
counter, ``hash_join.launches``, bumped once a call where the kernels
launch and nowhere else.

Unlike the reference it takes no tile sizes and no multiple-of-tile
lengths: those were TPU constraints, not semantics.  On duplicate build
keys it returns the first matching row's value, as the oracles do.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (check_launch, load_library, on_cuda,
                                       stream)
from repro_torch.kernels.ref import check_join, hash_join_ref

MAX_BUILD_ROWS = (1 << 31) - 1           # a slot packs the row in 31 bits


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature (build.load_library)."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.hash_join.argtypes = [vp, i64, vp, vp, i64, vp, i64, i64, vp, vp]
    lib.hash_join.restype = ctypes.c_int
    return lib


def table_slots(R: int) -> int:
    """Slots of the open-addressing table for R build rows: the least
    power of two that is at least 2R, and at least 2."""
    return 1 << (2 * R - 1).bit_length()


def dense_slots(R: int) -> int:
    """The widest build-key range (max - min + 1) that takes the direct-
    addressed array: the 32-bit words of the table's memory, 2 x
    ``table_slots(R)``, so the array needs no scratch of its own."""
    return 2 * table_slots(R)


def hash_join(probe_keys: torch.Tensor, build_keys: torch.Tensor,
              build_vals: torch.Tensor) -> torch.Tensor:
    """probe_keys (S,), build_keys and build_vals (R,), all int32.
    Returns (S,) int32: for each probe key the value of the first build
    row whose key matches, or -1.  CUDA tensors launch the four kernels on
    the current stream without syncing; CPU tensors take
    ``hash_join_ref``."""
    check_join(probe_keys, build_keys, build_vals)
    if not on_cuda("hash_join", probe_keys, build_keys, build_vals):
        return hash_join_ref(probe_keys, build_keys, build_vals)
    S, R = probe_keys.shape[0], build_keys.shape[0]
    if R > MAX_BUILD_ROWS:
        raise ValueError(f"hash_join kernel: R={R} build rows exceed "
                         f"{MAX_BUILD_ROWS}")
    probe_keys = probe_keys.contiguous()
    build_keys, build_vals = build_keys.contiguous(), build_vals.contiguous()
    out = torch.empty_like(probe_keys)
    if S == 0:
        return out
    cap = table_slots(R)
    # scratch: a 2-word header, then the table (or the dense array), filled
    # with the empty marker by the C entry point
    scratch = torch.empty(cap + 2, dtype=torch.int64,
                          device=probe_keys.device)
    lib = load_library("hash_join")
    check_launch(lib.hash_join(
        probe_keys.data_ptr(), S, build_keys.data_ptr(),
        build_vals.data_ptr(), R, scratch.data_ptr(), cap, dense_slots(R),
        out.data_ptr(), stream(probe_keys.device)), "hash_join")
    hash_join.launches += 1
    return out


hash_join.launches = 0
