"""Train state: model, EMA and optimizer, and the reference's optimization
defaults (port of ``latte_tpu/train/state.py``): AdamW at lr 1e-4 with
weight decay 0, EMA 0.9999, warmup-then-constant or cosine learning rate.

AdamW is ``torch.optim.AdamW`` with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8, decoupled decay), as the JAX package uses ``optax.adamw``: a
library optimizer, with no Pallas kernel behind it on either side. The
learning rate follows optax's step semantics: the update of step ``n``
(counting from 0) uses ``schedule(n)``, so the first update under warmup
uses a learning rate of 0.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable

import torch
from torch import nn

__all__ = ["TrainState", "make_lr_schedule", "make_optimizer", "create_train_state", "update_ema"]

Schedule = Callable[[int], float]


@dataclasses.dataclass
class TrainState:
    """``step`` counts the optimizer updates taken; ``model`` holds the fp32
    master parameters, ``ema`` their exponential moving average (a frozen
    copy of the model), ``optimizer`` the AdamW moments, ``schedule`` the
    learning rate by step."""

    step: int
    model: nn.Module
    ema: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule


def make_lr_schedule(
    lr: float = 1e-4,
    warmup_steps: int = 0,
    schedule: str = "warmup",
    decay_steps: int = 0,
    lr_min: float = 0.0,
) -> Schedule:
    """The reference's two learning-rate schedules, as optax builds them:

    - ``"warmup"``: linear warmup from 0 to ``lr`` over ``warmup_steps``,
      then constant;
    - ``"cosine"``: ``lr_min + (lr - lr_min)·(1 + cos(π·min(t, T)/T))/2``
      over ``decay_steps`` = T, after the same linear warmup.
    """
    if schedule not in ("warmup", "cosine"):
        raise NotImplementedError(f"lr schedule {schedule!r}")
    if schedule == "cosine" and decay_steps <= 0:
        raise ValueError("cosine schedule requires decay_steps (T_max) > 0")
    alpha = lr_min / lr if lr else 0.0

    def after_warmup(t: int) -> float:
        if schedule == "warmup":
            return lr
        frac = min(t, decay_steps) / decay_steps
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    def fn(step: int) -> float:
        if step < warmup_steps:
            return lr * step / warmup_steps
        return after_warmup(step - max(warmup_steps, 0))

    return fn


def make_optimizer(model: nn.Module, weight_decay: float = 0.0) -> torch.optim.AdamW:
    """AdamW over every parameter with optax's defaults; the learning rate
    is set before each update from the schedule."""
    return torch.optim.AdamW(
        model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def create_train_state(
    model: nn.Module, optimizer: torch.optim.Optimizer, schedule: Schedule
) -> TrainState:
    """EMA starts as a copy of the parameters (the reference's
    ``update_ema(..., decay=0)`` at init)."""
    ema = copy.deepcopy(model).requires_grad_(False)
    return TrainState(step=0, model=model, ema=ema, optimizer=optimizer, schedule=schedule)


@torch.no_grad()
def update_ema(ema: nn.Module, model: nn.Module, decay: float = 0.9999) -> None:
    """``ema ← decay·ema + (1 − decay)·params``, an fp32 lerp in place."""
    torch._foreach_lerp_(list(ema.parameters()), list(model.parameters()), 1.0 - decay)
