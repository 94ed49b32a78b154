"""Learning-rate schedules, step -> lr (counterpart of
`repro.optim.schedules`). `step` is the optimizer's int32 step tensor; each
schedule returns an fp32 scalar tensor on its device."""
from __future__ import annotations

import math

import torch


def constant(lr):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def linear(lr0, lr1, steps):
    def fn(step):
        t = torch.clamp(step.float() / steps, 0.0, 1.0)
        return lr0 * (1 - t) + lr1 * t
    return fn


def linear_warmup_cosine(peak, warmup_steps, total_steps, floor=0.0):
    def fn(step):
        s = step.float()
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, cos)
    return fn
