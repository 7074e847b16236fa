"""Learning-rate schedules (port of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.03) -> torch.Tensor:
    """Multiplier in [min_ratio, 1] applied to the base lr, as an fp32
    0-dim tensor on ``step``'s device (the CPU for a Python int)."""
    step = torch.as_tensor(step).float()
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, value: float = 1.0) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32)
