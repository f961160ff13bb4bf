"""Learning-rate schedules used by the paper's training protocols.

The same ``step -> lr`` formulas as ``repro.core.schedules``, evaluated on
the host in Python floats and rounded to float32 (the JAX schedules compute
in float32).  The train step hands the value to the device as a tensor, so a
new lr never recompiles a kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]

__all__ = [
    "ScheduleConfig",
    "linear_scaled_lr",
    "warmup_cosine",
    "warmup_step_decay",
    "constant",
    "build_schedule",
]


def _f32(v: float) -> float:
    return float(np.float32(v))


def linear_scaled_lr(base_lr: float, batch_size: int, base_batch: int = 256) -> float:
    """Linear scaling rule: lr = base_lr * batch / base_batch."""
    return base_lr * batch_size / base_batch


def constant(lr: float) -> Schedule:
    def f(step):
        return _f32(lr)

    return f


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.0) -> Schedule:
    assert total_steps > warmup_steps >= 0

    def f(step):
        step = float(step)
        if step < warmup_steps:
            return _f32(peak_lr * (step + 1.0) / max(warmup_steps, 1))
        t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return _f32(
            peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))
        )

    return f


def warmup_step_decay(
    peak_lr: float,
    warmup_steps: int,
    boundaries: Sequence[int],
    factor: float = 0.1,
) -> Schedule:
    bounds = sorted(int(b) for b in boundaries)

    def f(step):
        if step < warmup_steps:
            return _f32(peak_lr * (step + 1.0) / max(warmup_steps, 1))
        n_decays = sum(int(step) >= b for b in bounds)
        return _f32(peak_lr * factor**n_decays)

    return f


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "warmup_cosine"  # constant | warmup_cosine | warmup_step
    peak_lr: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 10_000
    boundaries: tuple[int, ...] = ()
    decay_factor: float = 0.1
    final_frac: float = 0.0


def build_schedule(cfg: ScheduleConfig) -> Schedule:
    if cfg.kind == "constant":
        return constant(cfg.peak_lr)
    if cfg.kind == "warmup_cosine":
        return warmup_cosine(
            cfg.peak_lr, cfg.warmup_steps, cfg.total_steps, cfg.final_frac
        )
    if cfg.kind == "warmup_step":
        bounds = cfg.boundaries or (
            int(0.33 * cfg.total_steps),
            int(0.66 * cfg.total_steps),
            int(0.89 * cfg.total_steps),
        )
        return warmup_step_decay(cfg.peak_lr, cfg.warmup_steps, bounds, cfg.decay_factor)
    raise ValueError(f"unknown schedule {cfg.kind!r}")
