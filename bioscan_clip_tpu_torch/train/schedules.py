"""Learning-rate schedules as plain functions of the optimizer step.

Counterpart of bioscan_clip_tpu/train/schedules.py:22-81 (torch
lr_scheduler semantics of the reference, scripts/train_cl.py:153-181,
stepped once per training step). Each schedule maps the 0-based step count
to a learning rate; the first update uses `schedule(0)`, as optax does.
The JAX package evaluates them in float32, these in double.
"""

from __future__ import annotations

import math


def one_cycle(max_lr: float, total_steps: int, pct_start: float = 0.3,
              div_factor: float = 25.0, final_div_factor: float = 1e4):
    """OneCycleLR(max_lr, total_steps, pct_start, anneal_strategy='cos',
    cycle_momentum=False): cosine warm-up from max_lr / div_factor, then
    cosine decay to that over final_div_factor."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    # torch OneCycleLR: phase 1 ends at float(pct_start * total_steps) - 1
    warm = max(1.0, float(pct_start * total_steps) - 1)

    def sched(step):
        step = min(step, total_steps - 1)
        if step < warm:
            return initial_lr + (max_lr - initial_lr) * 0.5 * (
                1 - math.cos(math.pi * min(step / warm, 1.0)))
        down_t = (step - warm) / max(total_steps - 1 - warm, 1)
        return min_lr + (max_lr - min_lr) * 0.5 * (
            1 + math.cos(math.pi * down_t))

    return sched


def exponential(lr: float, gamma: float = 0.95):
    return lambda step: lr * gamma**step


def step_decay(lr: float, step_size: int = 10, gamma: float = 0.5):
    return lambda step: lr * gamma ** (step // step_size)


def cosine(lr: float, total_steps: int, min_lr: float = 1e-9):
    def sched(step):
        t = min(step, total_steps)
        return min_lr + (lr - min_lr) * 0.5 * (
            1 + math.cos(math.pi * t / total_steps))

    return sched


def constant(lr: float):
    return lambda step: lr


def build_schedule(model_config, total_steps: int):
    """Config-driven schedule: `model_config.lr_scheduler` (one_cycle,
    exponential, step, cosine; default constant) with `lr_config.lr`
    (default 1e-3), `max_lr` and `min_lr`."""
    lr = 1e-3
    lr_config = getattr(model_config, "lr_config", None)
    if lr_config is not None and hasattr(lr_config, "lr"):
        lr = lr_config.lr

    name = getattr(model_config, "lr_scheduler", None)
    if name is None:
        return constant(lr)
    if name == "one_cycle":
        max_lr = 1e-3
        if lr_config is not None and hasattr(lr_config, "max_lr"):
            max_lr = lr_config.max_lr
        return one_cycle(max_lr, total_steps)
    if name == "exponential":
        return exponential(lr)
    if name == "step":
        return step_decay(lr)
    if name == "cosine":
        min_lr = 1e-9
        if lr_config is not None and hasattr(lr_config, "min_lr"):
            min_lr = lr_config.min_lr
        return cosine(lr, total_steps, min_lr)
    raise ValueError(f"unknown lr_scheduler: {name}")
