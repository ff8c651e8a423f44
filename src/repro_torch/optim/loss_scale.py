"""Dynamic loss scaling (mixed-precision training).

Port of ``repro/optim/loss_scale.py``.  The skip/update decision is made
on the host (a Python branch), exactly like PyTorch AMP: when gradients
overflow, the optimizer dispatch is skipped and the iteration's operator
sequence shortens, the paper's main real-world source of varying operator
sequences (§2.3).  The scale stays an exact power of two.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: float                # f32-representable power of two
    growth_count: int           # consecutive finite steps


def init_loss_scale(initial: float = 2.0 ** 15) -> LossScaleState:
    return LossScaleState(float(initial), 0)


def check_finite(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """A 0-d bool tensor: every gradient is finite."""
    return torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()


def update_loss_scale(state: LossScaleState, finite: bool,
                      growth_interval: int = 200, factor: float = 2.0,
                      min_scale: float = 1.0) -> LossScaleState:
    """Host-side arithmetic (plain Python floats/bools)."""
    scale = float(state.scale)
    count = int(state.growth_count)
    if finite:
        count += 1
        if count >= growth_interval:
            scale *= factor
            count = 0
    else:
        scale = max(scale / factor, min_scale)
        count = 0
    # the reference keeps the scale as an f32 scalar
    return LossScaleState(float(torch.tensor(scale, dtype=torch.float32)),
                          count)
