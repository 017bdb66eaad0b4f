"""LR schedules: step-wise cosine / linear / step with warmup (counterpart
of the JAX package's ``train/schedulers.py``), as ``step -> lr`` functions.

timm's ``CosineLRScheduler`` with ``warmup_prefix=False`` (what the
reference uses) runs the cosine over the *total* step count, warmup steps
included; so do these.
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["build_scheduler", "cosine_schedule", "linear_schedule",
           "step_schedule"]


def _warm(base_lr, warmup_lr, warmup_steps, step):
    return warmup_lr + step * ((base_lr - warmup_lr) / max(warmup_steps, 1))


def cosine_schedule(base_lr: float, min_lr: float, warmup_lr: float,
                    warmup_steps: int, total_steps: int) -> Callable:
    """timm CosineLRScheduler(t_in_epochs=False, cycle_limit=1) semantics."""

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return _warm(base_lr, warmup_lr, warmup_steps, step)
        return min_lr + 0.5 * (base_lr - min_lr) * (
            1 + math.cos(math.pi * step / total_steps))

    return schedule


def linear_schedule(base_lr: float, min_lr: float, warmup_lr: float,
                    warmup_steps: int, total_steps: int) -> Callable:
    """Reference ``LinearLRScheduler`` (``lr_scheduler.py:65-114``)."""

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return _warm(base_lr, warmup_lr, warmup_steps, step)
        t = step - warmup_steps
        return base_lr - (base_lr - min_lr) * (t / (total_steps - warmup_steps))

    return schedule


def step_schedule(base_lr: float, warmup_lr: float, warmup_steps: int,
                  decay_steps: int, decay_rate: float) -> Callable:
    """timm StepLRScheduler semantics (``lr_scheduler.py:52-60``)."""

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return _warm(base_lr, warmup_lr, warmup_steps, step)
        return base_lr * decay_rate ** math.floor(step / decay_steps)

    return schedule


def build_scheduler(config, n_steps_per_epoch: int) -> Callable:
    """Reference ``build_scheduler``: epoch counts become optimizer-step
    counts, divided by the accumulation steps."""
    accum = max(config.TRAIN.ACCUMULATION_STEPS, 1)
    steps = n_steps_per_epoch // accum if accum > 1 else n_steps_per_epoch
    total = config.TRAIN.EPOCHS * steps
    warmup = config.TRAIN.WARMUP_EPOCHS * steps
    name = config.TRAIN.LR_SCHEDULER.NAME
    t = config.TRAIN
    if name == "cosine":
        return cosine_schedule(t.BASE_LR, t.MIN_LR, t.WARMUP_LR, warmup, total)
    if name == "linear":
        return linear_schedule(t.BASE_LR, t.MIN_LR, t.WARMUP_LR, warmup, total)
    if name == "step":
        return step_schedule(t.BASE_LR, t.WARMUP_LR, warmup,
                             t.LR_SCHEDULER.DECAY_EPOCHS * steps,
                             t.LR_SCHEDULER.DECAY_RATE)
    raise NotImplementedError(f"Unknown scheduler: {name}")
