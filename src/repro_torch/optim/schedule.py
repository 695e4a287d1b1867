"""Learning-rate schedules."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1):
    """The learning rate at ``step`` (a float32 0-d tensor): linear warm-up
    to ``base_lr``, then a cosine down to ``min_ratio`` x ``base_lr``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(1.0, warmup_steps)
    prog = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
