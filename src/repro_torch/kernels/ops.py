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
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hash_join as _hj
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import merge_join as _mj
from repro_torch.kernels import ref

IMPLS = ("cuda", "ref")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    attn_softcap: Optional[float] = None,
                    impl: str = "cuda"):
    _check_impl(impl)
    if impl == "ref":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 attn_softcap=attn_softcap)
    return _fa.FlashAttention.apply(q, k, v, causal, window, attn_softcap)


def selective_scan(u, dt, A, Bmat, Cmat, h0=None, impl: str = "cuda",
                   chunk: int = 256):
    """``chunk``: the time steps the backward recomputes at a time."""
    _check_impl(impl)
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
