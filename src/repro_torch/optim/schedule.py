"""LR schedule (port of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor_frac * peak_lr`` at ``total``.  ``step`` is an int or
    a 0-d tensor; the result is a float32 0-d tensor on its device (the
    host for an int), computed in float32 in the reference's order."""
    t = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)
