"""Schedules (port of ``hairci/train/schedules.py``): lightly's
``cosine_schedule`` and ``linear_warmup_schedule``, and the reference's
``margin_decay`` / ``linear_increase_alpha``. Pure Python: the same floats
as the JAX package's."""

from __future__ import annotations

import math


def cosine_schedule(step: int, max_steps: int, start_value: float,
                    end_value: float) -> float:
    """lightly cosine_schedule: cosine interpolation start -> end."""
    if max_steps == 1:
        return end_value
    step = min(step, max_steps - 1)
    cos = 0.5 * (1 + math.cos(math.pi * step / (max_steps - 1)))
    return end_value - (end_value - start_value) * cos


def linear_warmup_schedule(step: int, warmup_steps: int, start_value: float,
                           end_value: float) -> float:
    if warmup_steps <= 0 or step >= warmup_steps:
        return end_value
    return start_value + (end_value - start_value) * step / warmup_steps


def margin_decay(epoch: int, total_epochs: int, start: float = 0.7,
                 end: float = 0.5) -> float:
    """The reference's ``margin_decay``: linear from start to end."""
    if total_epochs <= 1:
        return end
    t = min(epoch / (total_epochs - 1), 1.0)
    return start + (end - start) * t


def linear_increase_alpha(epoch: int, total_epochs: int, start: float = 0.0,
                          end: float = 1.0) -> float:
    """The reference's ``linear_increase_alpha``: linear from start to end."""
    if total_epochs <= 1:
        return end
    t = min(epoch / (total_epochs - 1), 1.0)
    return start + (end - start) * t
