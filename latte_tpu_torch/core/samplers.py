"""Sampling loops (port of ``latte_tpu/core/samplers.py``) as Python loops.

Each step's noise comes from ``noise_schedule[t]`` when given (the tests
inject the same numbers into the JAX loop), else from ``generator``, else
zeros, the order the JAX loops use. :func:`run_steps` is that loop over any
step function: the loops here, the sampler's and the loader of an exported
sampler step (``serve.aot``) run it. The step may be a
``core.step_graph.GraphedStep``, which replays it as a CUDA graph on static
buffers (``loop_mode: scan``, the counterpart of the JAX loops' ``loop``
argument); the generic loops here (``cond_fn`` differentiates,
``collect_trajectory`` keeps every x) run it eagerly. The loops run without
autograd: a ``cond_fn`` that differentiates a classifier enables grad itself.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from latte_tpu_torch.core.diffusion import GaussianDiffusion, ModelFn

__all__ = [
    "p_sample_loop", "ddim_sample_loop", "ddim_reverse_loop", "run_steps", "denoise_step", "cfg_combine",
    "cfg_model_fn",
]


def _noise_for(x, t_scalar, generator, noise_schedule):
    if noise_schedule is not None:
        return noise_schedule[t_scalar].to(x.device, x.dtype)
    if generator is not None:
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return torch.zeros_like(x)


@torch.no_grad()
def run_steps(
    step, diffusion: GaussianDiffusion, x_T: torch.Tensor, generator=None, noise_schedule=None,
    collect_trajectory: bool = False,
):
    """``x = step(x, t, noise)`` from t = T - 1 down to 0: t an int64 (B,)
    tensor, the noise drawn before each step (see the module docstring), x
    passed back as the step returned it (a ``GraphedStep``'s static x).
    With ``collect_trajectory``: ``(x, trajectory)``, every step's x
    stacked, (T, ...), of an eager step."""
    x, trajectory = x_T, []
    for t_scalar in range(diffusion.num_timesteps - 1, -1, -1):
        t = torch.full((x.shape[0],), t_scalar, dtype=torch.int64, device=x.device)
        x = step(x, t, _noise_for(x, t_scalar, generator, noise_schedule))
        if collect_trajectory:
            trajectory.append(x)
    return (x, torch.stack(trajectory)) if collect_trajectory else x


def denoise_step(
    diffusion: GaussianDiffusion, model_fn: ModelFn, method: str, x: torch.Tensor, t: torch.Tensor,
    noise: torch.Tensor, model_kwargs: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """One step of the sampler: DDIM at eta 0 (``method`` "ddim") or DDPM,
    with the x_0 clip; the next x."""
    fn = diffusion.ddim_sample if method == "ddim" else diffusion.p_sample
    return fn(model_fn, x, t, noise, clip_denoised=True, model_kwargs=model_kwargs)["sample"]


def p_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    denoised_fn=None,
    cond_fn=None,
    model_kwargs: Optional[Dict[str, Any]] = None,
    noise_schedule: Optional[torch.Tensor] = None,
    collect_trajectory: bool = False,
):
    """Ancestral DDPM sampling from pure noise x_T (``collect_trajectory``:
    also every step's x, as :func:`run_steps`)."""

    def step(x, t, noise):
        return diffusion.p_sample(
            model_fn, x, t, noise, clip_denoised=clip_denoised,
            denoised_fn=denoised_fn, cond_fn=cond_fn, model_kwargs=model_kwargs,
        )["sample"]

    return run_steps(step, diffusion, x_T, generator, noise_schedule, collect_trajectory)


def ddim_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    denoised_fn=None,
    cond_fn=None,
    model_kwargs: Optional[Dict[str, Any]] = None,
    eta: float = 0.0,
    noise_schedule: Optional[torch.Tensor] = None,
    collect_trajectory: bool = False,
):
    """DDIM sampling (deterministic at eta=0; ``collect_trajectory`` as in
    :func:`p_sample_loop`)."""

    def step(x, t, noise):
        return diffusion.ddim_sample(
            model_fn, x, t, noise, clip_denoised=clip_denoised,
            denoised_fn=denoised_fn, cond_fn=cond_fn, model_kwargs=model_kwargs, eta=eta,
        )["sample"]

    return run_steps(step, diffusion, x_T, generator, noise_schedule, collect_trajectory)


@torch.no_grad()
def ddim_reverse_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    x_0: torch.Tensor,
    clip_denoised: bool = True,
    model_kwargs: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Deterministic encoding x_0 -> x_T through the reverse ODE, over
    t = 0 ... T - 1."""
    x = x_0
    for t_scalar in range(diffusion.num_timesteps):
        t = torch.full((x.shape[0],), t_scalar, dtype=torch.int64, device=x.device)
        x = diffusion.ddim_reverse_sample(
            model_fn, x, t, clip_denoised=clip_denoised, model_kwargs=model_kwargs
        )["sample"]
    return x


def cfg_combine(model_out: torch.Tensor, cfg_scale: float, guidance_channels: int = 4) -> torch.Tensor:
    """Classifier-free guidance of a [cond | uncond] model output, on the
    first ``guidance_channels`` channels only (the reference's quirk); both
    halves get the guided eps."""
    eps, rest = model_out[:, :, :guidance_channels], model_out[:, :, guidance_channels:]
    cond_eps, uncond_eps = eps.chunk(2, dim=0)
    half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
    return torch.cat([torch.cat([half_eps, half_eps], dim=0), rest], dim=2)


def cfg_model_fn(
    model_apply: Callable[..., torch.Tensor], cfg_scale: float, guidance_channels: int = 4
) -> ModelFn:
    """Classifier-free guidance over a [cond | uncond] batch: the model runs
    on the cond half twice (the labels tell the halves apart), then
    :func:`cfg_combine`."""

    def fn(x, t, **kwargs):
        half = x[: x.shape[0] // 2]
        return cfg_combine(model_apply(torch.cat([half, half], dim=0), t, **kwargs), cfg_scale,
                           guidance_channels)

    return fn
