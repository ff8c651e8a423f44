"""LR schedules.

Port of ``repro/optim/schedules.py``: computed in f32 tensors, as the
reference's jitted step computes it, so both give the same lr bits.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    """The lr at ``step`` as a 0-d f32 tensor on the CPU: a linear warmup to
    ``base_lr`` over ``warmup_steps``, then a cosine decay to
    ``final_frac * base_lr`` at ``total_steps``."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32)
    warm = torch.tensor(base_lr, dtype=f32) * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = torch.tensor(base_lr, dtype=f32) * (
        final_frac + (1 - final_frac) * 0.5
        * (1 + torch.cos(torch.tensor(math.pi, dtype=f32) * prog)))
    return torch.where(step < warmup_steps, warm, cos)
