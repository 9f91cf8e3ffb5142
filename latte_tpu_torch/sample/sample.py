"""Single-device sampling entry point (port of ``latte_tpu/sample/sample.py``).

Builds the model from a config, loads a reference-format checkpoint (or
initialises it from a seed when ``ckpt`` is null), runs the respaced DDPM or
DDIM loop and saves the latents as ``<save_video_path stem>_latents.npz``.
Decoding latents to frames (a configured VAE) comes with a later slice and
raises ``NotImplementedError`` here.

Runs on ``cuda`` unless asked for the CPU::

    python -m latte_tpu_torch.sample.sample --config configs/ffs/ffs_sample.yaml \
        [--device cpu] [key=value ...]
"""

from __future__ import annotations

import argparse
import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from latte_tpu_torch.config import Config, load_config
from latte_tpu_torch.convert import load_reference_checkpoint
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.core.samplers import ddim_sample_loop, p_sample_loop
from latte_tpu_torch.models import Latte, get_models
from latte_tpu_torch.utils import create_logger, resolve_device


def build_model(config: Config, device: torch.device) -> Latte:
    """The configured model on ``device`` in the config's dtype, from ``ckpt``
    (a reference ``.pt``) or, when ``ckpt`` is null, the reference init drawn
    from ``torch.Generator`` seed 0."""
    with torch.device(device):
        model = get_models(config)
    ckpt = getattr(config, "ckpt", None)
    if ckpt:
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"ckpt {ckpt!r} does not exist")
        sd = load_reference_checkpoint(ckpt, prefer_ema=bool(getattr(config, "prefer_ema", True)))
        model.load_state_dict(sd, strict=True)
    else:
        model.initialize_weights(torch.Generator(device=device).manual_seed(0))
    # the reference's use_fp16 switch maps to bf16, as in the JAX sampler
    dtype = torch.bfloat16 if getattr(config, "use_fp16", False) else torch.float32
    return model.to(device=device, dtype=dtype).eval()


def sample_latents(
    model: Latte, config: Config, device: torch.device
) -> torch.Tensor:
    """One video's final latents (1, F, 4, L, L), fp32, from ``config.seed``."""
    latent = int(getattr(config, "latent_size", 0) or int(config.image_size) // 8)
    frames = int(getattr(config, "num_frames", 16))
    generator = torch.Generator(device=device).manual_seed(int(getattr(config, "seed", 0) or 0))
    n = 1
    z = torch.randn((n, frames, 4, latent, latent), generator=generator, device=device)
    diffusion = create_diffusion(str(config.num_sampling_steps))

    cfg_scale = float(getattr(config, "cfg_scale", 1.0))
    use_cfg = int(getattr(config, "extras", 1)) == 2 and cfg_scale > 1.0
    model_fn, kwargs = model, {}
    if int(getattr(config, "extras", 1)) == 2:
        y = torch.full((n,), int(getattr(config, "sample_class", 0)), device=device)
        if use_cfg:
            # cond ∥ null-class halves
            z = torch.cat([z, z], dim=0)
            y = torch.cat([y, torch.full((n,), model.num_classes, device=device)], dim=0)
            model_fn = functools.partial(model.forward_with_cfg, cfg_scale=cfg_scale)
        kwargs["y"] = y

    method = str(getattr(config, "sample_method", "ddpm")).lower()
    loop = ddim_sample_loop if method == "ddim" else p_sample_loop
    with torch.inference_mode():
        latents = loop(diffusion, model_fn, z, generator=generator, model_kwargs=kwargs)
    return latents[:n]


def main(config: Config, device: Optional[str] = None) -> str:
    """Sample one video's latents; return the path of the saved ``.npz``."""
    logger = create_logger()
    if str(getattr(config, "vae", "") or "") or getattr(config, "vae_ckpt", None):
        raise NotImplementedError("VAE decode: next slice")
    dev = resolve_device(device)
    model = build_model(config, dev)
    if not getattr(config, "ckpt", None):
        logger.info("WARNING: no checkpoint given — sampling from random init")

    t0 = time.perf_counter()
    latents = sample_latents(model, config, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    logger.info(f"sampled in {time.perf_counter() - t0:.2f}s on {dev}")

    out_path = getattr(config, "save_video_path", None) or "./sample_videos/sample.mp4"
    out_path = os.path.splitext(out_path)[0] + "_latents.npz"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, latents=latents.float().cpu().numpy())
    logger.info(f"no VAE configured — saved latents to {out_path}")
    return out_path


def cli(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--save_video_path", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    cfg = load_config(a.config, a.overrides)
    if a.ckpt:
        cfg.ckpt = a.ckpt
    if a.save_video_path:
        cfg.save_video_path = a.save_video_path
    return main(cfg, device=a.device)


if __name__ == "__main__":
    cli()
