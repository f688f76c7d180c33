"""LR schedules (a port of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step, warmup: int = 200, total: int = 10000,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Scale factor in [min_frac, 1] with linear warmup + cosine decay, a
    float32 scalar on ``step``'s device.  The Python constants meet the
    float32 step as the reference's weak-typed ones do: each is rounded
    to float32 and every operation rounds once."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
