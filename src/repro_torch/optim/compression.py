"""Gradient compression with error feedback (the port of
``repro.optim.compression``).

Modes:

  bf16  : round-to-bf16 (2x wire)
  int8  : per-tensor max-abs int8 (4x wire), scale max(max|g|, 1e-12) / 127,
          round half to even (``torch.round``, as ``jnp.round``)

Error feedback: the quantization residual is carried in optimizer state
and added to the next step's gradient, so the accumulated compressed
gradient is unbiased.  On one device this is the numerics layer
(quantize -> dequantize + EF) of a compressed gradient reduction; the
quantizer and the error buffers are bit-equal to the reference's.

Gradients, parameters and error buffers are dicts of tensors keyed by
parameter name.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GradCompression:
    mode: str = "none"            # none | bf16 | int8
    error_feedback: bool = True

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    def init(self, params: Tensors) -> Optional[Tensors]:
        if not (self.enabled and self.error_feedback):
            return None
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    def _q(self, g: torch.Tensor) -> torch.Tensor:
        if self.mode == "bf16":
            return g.to(torch.bfloat16).float()
        if self.mode == "int8":
            scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(g / scale), -127, 127)
            return q * scale
        return g

    def apply(self, grads: Tensors, err: Optional[Tensors]
              ) -> Tuple[Tensors, Optional[Tensors]]:
        """Returns (compressed grads, new error buffers)."""
        if not self.enabled:
            return grads, err
        if err is None:
            return {k: self._q(g.float()) for k, g in grads.items()}, None
        comp, new_err = {}, {}
        for k, g in grads.items():
            acc = g.float() + err[k]
            comp[k] = self._q(acc)
            new_err[k] = acc - comp[k]
        return comp, new_err
