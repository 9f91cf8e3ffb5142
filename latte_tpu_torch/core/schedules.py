"""Noise-schedule tables and timestep respacing (the port's own copy of
``latte_tpu/core/schedules.py``).

All schedule math is float64 numpy: the tables are tiny (T entries), and the
diffusion engine gathers from them in fp32 on the device.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import numpy as np

__all__ = [
    "get_named_beta_schedule",
    "betas_for_alpha_bar",
    "space_timesteps",
]


def _linear_betas(beta_start: float, beta_end: float, n: int) -> np.ndarray:
    return np.linspace(beta_start, beta_end, n, dtype=np.float64)


def betas_for_alpha_bar(
    n: int, alpha_bar: Callable[[float], float], max_beta: float = 0.999
) -> np.ndarray:
    """Discretize a continuous alpha-bar function into per-step betas."""
    t = np.arange(n, dtype=np.float64)
    ab1 = np.array([alpha_bar(float(x) / n) for x in t])
    ab2 = np.array([alpha_bar(float(x + 1) / n) for x in t])
    return np.minimum(1.0 - ab2 / ab1, max_beta)


def get_named_beta_schedule(schedule_name: str, num_timesteps: int) -> np.ndarray:
    """Named schedules with behavior matching the reference library.

    - "linear": Ho et al. linear schedule, rescaled so the limit is invariant
      to the step count (scale = 1000/T).
    - "squaredcos_cap_v2": the iDDPM cosine schedule with beta capped at 0.999.
    - "quad": quadratic-in-sqrt schedule.
    - "const": constant beta.
    """
    if schedule_name == "linear":
        scale = 1000.0 / num_timesteps
        return _linear_betas(scale * 0.0001, scale * 0.02, num_timesteps)
    if schedule_name == "squaredcos_cap_v2":
        return betas_for_alpha_bar(
            num_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    if schedule_name == "quad":
        scale = 1000.0 / num_timesteps
        return (
            np.linspace(
                (scale * 0.0001) ** 0.5,
                (scale * 0.02) ** 0.5,
                num_timesteps,
                dtype=np.float64,
            )
            ** 2
        )
    if schedule_name == "const":
        scale = 1000.0 / num_timesteps
        return np.full(num_timesteps, scale * 0.02, dtype=np.float64)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def space_timesteps(
    num_timesteps: int, section_counts: Union[str, Sequence[int]]
) -> set:
    """Choose a subset of original timesteps to retain when respacing.

    Accepts "ddimN" (fixed DDIM striding) or a comma-separated list /
    sequence of per-section counts, as the reference's ``respace.py`` does.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]

    size_per, extra = divmod(num_timesteps, len(section_counts))
    start, taken = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            taken.append(start + round(cur))
            cur += stride
        start += size
    return set(taken)
