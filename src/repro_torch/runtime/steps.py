"""Step functions for serving: prefill and decode (the port of
``repro.runtime.steps``'s ``make_prefill_step`` and ``make_decode_step``;
the training steps wait for the training slice).  PyTorch runs eagerly, so
a step is the model call itself, under ``torch.no_grad``."""
from __future__ import annotations

from typing import Optional

import torch


def make_prefill_step(model, cache_len: Optional[int] = None):
    def prefill(batch):
        with torch.no_grad():
            return model.prefill(batch, cache_len=cache_len)
    return prefill


def make_decode_step(model):
    def decode(cache, inputs, q_pos):
        with torch.no_grad():
            return model.decode_step(cache, inputs, q_pos)
    return decode
