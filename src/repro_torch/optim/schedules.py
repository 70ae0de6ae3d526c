"""Learning-rate schedules: PyTorch port of ``repro.optim.schedules``,
plain functions of a step tensor returning an f32 tensor."""
from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def cosine(peak: float, total_steps: int, floor: float = 0.0):
    def sched(step):
        t = torch.clamp(torch.as_tensor(step).float() / total_steps, 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
    return sched


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def sched(step):
        s = torch.as_tensor(step).float()
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, cos)
    return sched
