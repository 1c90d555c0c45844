"""LR schedules: functions of the integer step (the port of
``repro.optim.schedule``).  The step may be a Python int or an integer
tensor; the result is a float32 0-d tensor on the step's device, so a
schedule read inside a train step costs no host sync."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(peak: float, warmup_steps: int):
    def f(step):
        s = _step(step)
        return peak * torch.clamp(s / max(1, warmup_steps), max=1.0)
    return f


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def f(step):
        s = _step(step)
        warm = peak * torch.clamp(s / max(1, warmup_steps), max=1.0)
        prog = torch.clamp((s - warmup_steps) /
                           max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * \
            (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, peak * cos)
    return f
