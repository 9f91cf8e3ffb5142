"""Block-cache sampling (port of ``latte_tpu/core/block_cache.py``).

A training-free approximation of the Δ-DiT / BlockDance family: the front
``cache_pairs`` (spatial, temporal) pairs of the model are recomputed only
every ``cache_interval``-th step, and the steps between resume the block
list at pair k from the activation the last full forward left there
(``Latte.forward``'s ``return_front`` / ``front_state`` hooks).

The JAX loop is one ``lax.scan`` whose body takes a ``lax.cond`` between the
full and the partial forward; here it is a Python loop and an ``if``, so a
partial step launches only the back pairs' kernels. ``cache_interval=1``
reproduces the standard sampler exactly; larger intervals change the
trajectory (the entry point's ``block_cache_interval`` opts in).
"""

from __future__ import annotations

from typing import Optional

import torch

from latte_tpu_torch.core.diffusion import GaussianDiffusion
from latte_tpu_torch.core.samplers import _noise_for, cfg_combine

__all__ = ["cached_sample_loop"]


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
    use_cfg = y is not None and cfg_scale > 1.0
    ddim = sample_method == "ddim"
    step_fn = diffusion.ddim_sample if ddim else diffusion.p_sample

    x, front = x_T, None
    for i, t_scalar in enumerate(range(diffusion.num_timesteps - 1, -1, -1)):
        t = torch.full((x.shape[0],), t_scalar, dtype=torch.int64, device=x.device)
        xx = x
        if use_cfg:
            half = x[: x.shape[0] // 2]
            xx = torch.cat([half, half], dim=0)
        # the model sees the original schedule's timestep, as the step's own
        # call would (p_mean_variance maps t before calling model_fn)
        t_model = diffusion.map_t(t)
        if i % interval == 0:
            out, front = model(xx, t_model, y=y, return_front=k)
        else:
            out = model(xx, t_model, y=y, front_state=front, start_pair=k)
        if use_cfg:
            out = cfg_combine(out, float(cfg_scale))
        noise = torch.zeros_like(x) if ddim else _noise_for(x, t_scalar, generator, noise_schedule)
        x = step_fn(lambda *a, **kw: out, x, t, noise)["sample"]
    return x
