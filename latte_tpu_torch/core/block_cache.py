"""Block-cache sampling (port of ``latte_tpu/core/block_cache.py``).

A training-free approximation of the Δ-DiT / BlockDance family: the front
``cache_pairs`` (spatial, temporal) pairs of the model are recomputed only
every ``cache_interval``-th step, and the steps between resume the block
list at pair k from the activation the last full forward left there
(``Latte.forward``'s ``return_front`` / ``front_state`` hooks).

The JAX loop is one ``lax.scan`` whose body takes a ``lax.cond`` between the
full and the partial forward; here it is a Python loop and an ``if``, so a
partial step launches only the back pairs' kernels. Under the sampler's
``loop_mode: scan`` the step is a ``core.step_graph.GraphedStep`` holding
two CUDA graphs, the full and the partial forward, which the ``if`` picks.
``cache_interval=1`` reproduces the standard sampler exactly; larger
intervals change the trajectory (the entry point's ``block_cache_interval``
opts in).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from latte_tpu_torch.core.diffusion import GaussianDiffusion
from latte_tpu_torch.core.samplers import _noise_for, cfg_combine

__all__ = ["cached_sample_loop", "cached_step", "run_cached_steps"]


def cached_step(
    diffusion: GaussianDiffusion,
    model,
    x: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    front: Optional[torch.Tensor] = None,
    *,
    cache_pairs: int,
    y: Optional[torch.Tensor] = None,
    cfg_scale: float = 1.0,
    ddim: bool = True,
):
    """One step of the cached loop: with ``front`` None the full forward,
    which also returns the activation after pair ``cache_pairs`` - 1; else
    the partial forward from ``front`` at pair ``cache_pairs``. Returns
    ``(next x, front)``. ``model`` is called as ``model(x, t, y=...,
    return_front=k)`` / ``model(x, t, y=..., front_state=..., start_pair=k)``."""
    use_cfg = y is not None and cfg_scale > 1.0
    xx = x
    if use_cfg:
        half = x[: x.shape[0] // 2]
        xx = torch.cat([half, half], dim=0)
    # the model sees the original schedule's timestep, as the step's own
    # call would (p_mean_variance maps t before calling model_fn)
    t_model = diffusion.map_t(t)
    if front is None:
        out, front = model(xx, t_model, y=y, return_front=cache_pairs)
    else:
        out = model(xx, t_model, y=y, front_state=front, start_pair=cache_pairs)
    if use_cfg:
        out = cfg_combine(out, float(cfg_scale))
    step_fn = diffusion.ddim_sample if ddim else diffusion.p_sample
    return step_fn(lambda *a, **kw: out, x, t, noise)["sample"], front


@torch.no_grad()
def run_cached_steps(
    step, diffusion: GaussianDiffusion, x_T: torch.Tensor, cache_interval: int, ddim: bool,
    generator: Optional[torch.Generator] = None, noise_schedule: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The cached loop's schedule over ``x, front = step(x, t, noise,
    front)``: step i (i = 0 at t = T - 1) passes ``front=None`` (a full
    forward) when ``i % cache_interval == 0``, else the last full forward's
    front (a ``GraphedStep`` returns its static x and front, passed back
    in). DDIM steps take zeros; DDPM draws each step's noise by the
    standard loops' rule."""
    x, front = x_T, None
    for i, t_scalar in enumerate(range(diffusion.num_timesteps - 1, -1, -1)):
        t = torch.full((x.shape[0],), t_scalar, dtype=torch.int64, device=x.device)
        noise = torch.zeros_like(x) if ddim else _noise_for(x, t_scalar, generator, noise_schedule)
        x, front = step(x, t, noise, None if i % cache_interval == 0 else front)
    return x


@torch.no_grad()
def cached_sample_loop(
    diffusion: GaussianDiffusion,
    model,
    x_T: torch.Tensor,
    *,
    cache_pairs: int,
    cache_interval: int,
    y: Optional[torch.Tensor] = None,
    cfg_scale: float = 1.0,
    sample_method: str = "ddim",
    generator: Optional[torch.Generator] = None,
    noise_schedule: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The denoising trajectory from ``x_T`` (B, F, C, H, W) with the block
    cache. Under CFG (``y`` given and ``cfg_scale`` > 1) the batch carries
    [cond | uncond] halves, as in the standard sampler, and the front holds
    both. Step i (i = 0 at t = T - 1) is a full forward when ``i %
    cache_interval == 0``, else a partial one from pair ``cache_pairs``.
    DDIM steps take no noise; DDPM draws it per step from ``noise_schedule[t]``,
    else ``generator`` (the standard loops' rule), so interval 1 reproduces
    ``p_sample_loop`` given the same generator."""
    n_pairs = model.depth // 2
    k = int(cache_pairs)
    if not 1 <= k < n_pairs:
        raise ValueError(f"cache_pairs must be in [1, {n_pairs}), got {k}")
    interval = int(cache_interval)
    if interval < 1:
        raise ValueError(f"cache_interval must be >= 1, got {interval}")
    step = functools.partial(
        cached_step, diffusion, model, cache_pairs=k, y=y, cfg_scale=cfg_scale, ddim=sample_method == "ddim"
    )
    return run_cached_steps(step, diffusion, x_T, interval, sample_method == "ddim", generator, noise_schedule)
