"""Timestep samplers for training: uniform and importance sampling (port of
``latte_tpu/core/timestep_samplers.py``).

The loss history of the loss-aware resampler stays on the host in numpy, as
in the JAX package; the draws come from an explicit ``torch.Generator``.
The port trains on one device, so there is nothing to gather across
processes.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "ScheduleSampler",
    "UniformSampler",
    "LossAwareSampler",
    "LossSecondMomentResampler",
    "create_named_schedule_sampler",
]


def create_named_schedule_sampler(name: str, diffusion) -> "ScheduleSampler":
    if name == "uniform":
        return UniformSampler(diffusion)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(diffusion)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler(ABC):
    """Distribution over timesteps, with importance-sampling weights."""

    @abstractmethod
    def weights(self) -> np.ndarray:
        """Unnormalized weights, one per diffusion timestep."""

    def sample(
        self, generator: torch.Generator, batch_size: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Importance-sample timesteps on the generator's device: returns
        (t [B] int64, weights [B] fp32) with weights ``1 / (p·T)``."""
        w = np.asarray(self.weights(), dtype=np.float64)
        p = w / w.sum()
        device = generator.device
        probs = torch.as_tensor(p, dtype=torch.float32, device=device)
        t = torch.multinomial(probs, batch_size, replacement=True, generator=generator)
        inv_p = torch.as_tensor(1.0 / (p * len(p)), dtype=torch.float32, device=device)
        return t, inv_p[t]


class UniformSampler(ScheduleSampler):
    def __init__(self, diffusion):
        self.diffusion = diffusion
        self._weights = np.ones(diffusion.num_timesteps, dtype=np.float64)

    def weights(self) -> np.ndarray:
        return self._weights

    def sample(self, generator: torch.Generator, batch_size: int):
        t = torch.randint(
            0, self.diffusion.num_timesteps, (batch_size,), generator=generator,
            device=generator.device,
        )
        return t, torch.ones((batch_size,), dtype=torch.float32, device=generator.device)


class LossAwareSampler(ScheduleSampler):
    def update_with_local_losses(self, ts, losses) -> None:
        """Feed one step's (t, loss) pairs (tensors or arrays of shape [B])."""
        as_np = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)  # noqa: E731
        self.update_with_all_losses(as_np(ts), as_np(losses))

    def update_with_all_losses(self, ts: np.ndarray, losses: np.ndarray) -> None:
        raise NotImplementedError


class LossSecondMomentResampler(LossAwareSampler):
    """Importance-sample t proportional to sqrt(E[loss^2]) with a uniform floor."""

    def __init__(self, diffusion, history_per_term: int = 10, uniform_prob: float = 0.001):
        self.diffusion = diffusion
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros(
            (diffusion.num_timesteps, history_per_term), dtype=np.float64
        )
        self._loss_counts = np.zeros(diffusion.num_timesteps, dtype=np.int64)

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones(self.diffusion.num_timesteps, dtype=np.float64)
        w = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        w /= w.sum()
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_all_losses(self, ts, losses) -> None:
        for t, loss in zip(np.asarray(ts).ravel(), np.asarray(losses).ravel()):
            t = int(t)
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())
