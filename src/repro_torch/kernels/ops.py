"""Public wrappers for the model kernels (the port of
``repro.kernels.ops``'s ``flash_attention`` and ``selective_scan``).

``impl="cuda"`` (the default) is the deployment path: the hand-written
CUDA kernel for CUDA tensors, its plain version for CPU tensors (the
kernel wrappers decide by the tensors' device).  ``impl="ref"`` asks for
the plain version explicitly, as the reference's ``impl="ref"`` does;
``chip_smoke.py`` uses it to hold the kernels against it on the card.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _ms
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
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               attn_softcap=attn_softcap)


def selective_scan(u, dt, A, Bmat, Cmat, h0=None, impl: str = "cuda"):
    _check_impl(impl)
    if impl == "ref":
        return ref.selective_scan_ref(u, dt, A, Bmat, Cmat, h0)
    return _ms.selective_scan(u, dt, A, Bmat, Cmat, h0)


def reset_launch_counts() -> None:
    _fa.flash_attention.launches = 0
    _ms.selective_scan.launches = 0
