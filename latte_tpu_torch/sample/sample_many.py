"""Batch sampling for FVD evaluation (port of ``latte_tpu/sample/sample_many.py``)
in one process on one device.

Writes ``num_fvd_samples`` videos (rounded up to a whole number of batches)
under ``save_video_path`` as ``{idx:04d}.mp4``, or as ``{idx:04d}.npz``
latents when no VAE is configured, with the reference's interleaved global
index ``idx = it·global_batch + p·n_dev + s`` (position p within shard s),
here at ``n_dev = 1``. The model comes from ``sample.build_model`` and the
sampler from ``sample.sample_loop``, so the int8 modes and the block cache
apply as in the single-video entry point. Under ``WORLD_SIZE > 1`` it
raises ``NotImplementedError``: the multi-process form comes with the
multi-GPU slice. Runs on ``cuda`` unless asked for the CPU::

    python -m latte_tpu_torch.sample.sample_many --config configs/ffs/ffs_sample.yaml \
        [--device cpu] [key=value ...]
"""

from __future__ import annotations

import argparse
import glob
import math
import os
from typing import Optional

import numpy as np
import torch

from latte_tpu_torch.config import Config, load_config
from latte_tpu_torch.sample import sample
from latte_tpu_torch.utils import create_logger, read_video, resolve_device, save_video

__all__ = ["BatchGenerator", "create_npz_from_sample_folder", "main", "cli", "stream_seed"]

# the generator streams of one run (the JAX generator folds the same
# indices into PRNGKey(seed), PRNGKey(seed + 1) and PRNGKey(seed + 2))
Z_STREAM, LABEL_STREAM, NOISE_STREAM = 0, 1, 2


def stream_seed(seed: int, stream: int, index: int) -> int:
    """The seed of the ``torch.Generator`` that draws item ``index`` of
    ``stream`` in a run seeded ``seed``: numpy's ``SeedSequence`` of the
    three, as a 63-bit integer. The z of shard s at iteration it is index
    ``it·n_dev + s`` of ``Z_STREAM``; the labels and DDPM's noise of
    iteration it are index ``it`` of ``LABEL_STREAM`` and ``NOISE_STREAM``."""
    return int(np.random.SeedSequence([seed, stream, index]).generate_state(1, np.uint64)[0] >> 1)


class BatchGenerator:
    """One batch of ``per_proc_batch_size`` videos a call, behind the gen_fn
    protocol (uint8 clips, for a metric stack that streams features instead
    of reading files), and used by :func:`main`, which writes the files."""

    def __init__(self, config: Config, logger=None, device: Optional[str] = None):
        world = int(os.environ.get("WORLD_SIZE", "1") or 1)
        if world > 1:
            raise NotImplementedError(
                f"WORLD_SIZE={world}: sample_many runs in one process on one device; the "
                "multi-process form comes with the multi-GPU slice"
            )
        sample.block_cache_interval(config)  # a bad block-cache setting fails before the build
        self.config = config
        self.device = resolve_device(device)
        self.model = sample.build_model(config, self.device)
        if logger and not getattr(config, "ckpt", None):
            logger.info("WARNING: no checkpoint given — sampling from random init")
        self.vae = sample.load_vae(config, self.device)
        self.n_dev = 1
        self.per_dev = int(getattr(config, "per_proc_batch_size", 2))
        self.global_batch = self.per_dev * self.n_dev
        self.seed = int(getattr(config, "seed", 0) or 0)
        self.it = 0

    def _generator(self, stream: int, index: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(stream_seed(self.seed, stream, index))

    def draw(self, it: int):
        """Iteration ``it``'s noise z (global_batch, F, 4, L, L), shard by
        shard, and, under ``extras: 2``, its labels (global_batch,) in
        [0, num_classes), else None."""
        shape = sample.latent_shape(self.config, self.per_dev)
        z = torch.cat([
            torch.randn(shape, generator=self._generator(Z_STREAM, it * self.n_dev + s), device=self.device)
            for s in range(self.n_dev)
        ])
        y = None
        if int(getattr(self.config, "extras", 1)) == 2:
            y = torch.randint(0, self.model.num_classes, (self.global_batch,),
                              generator=self._generator(LABEL_STREAM, it), device=self.device)
        return z, y

    def sample_latents(self) -> torch.Tensor:
        """The next batch's final latents (global_batch, F, 4, L, L), fp32, on
        the device."""
        z, y = self.draw(self.it)
        latents = sample.sample_loop(self.model, self.config, z, y, self._generator(NOISE_STREAM, self.it))
        self.it += 1
        return latents

    def decode_to_uint8(self, latents: torch.Tensor) -> np.ndarray:
        """(B, F, 4, h, w) latents -> uint8 (B, F, H, W, 3) videos, one video
        (its F frames in one batch) a decode, in fp32 with TF32 off."""
        if self.vae is None:
            raise ValueError("the generator was built without a VAE")
        return np.stack([sample.decode_video(self.vae, latents[b : b + 1]) for b in range(latents.shape[0])])

    def __call__(self, n: int = 0) -> np.ndarray:
        """gen_fn protocol: one batch of uint8 clips a call (``n`` is advisory)."""
        return self.decode_to_uint8(self.sample_latents())


def main(config: Config, device: Optional[str] = None) -> str:
    """Write the run's videos (or latents) under ``save_video_path``; return
    that directory."""
    logger = create_logger()
    gen = BatchGenerator(config, logger=logger, device=device)
    global_batch, per_dev, n_dev = gen.global_batch, gen.per_dev, gen.n_dev
    total = int(getattr(config, "num_fvd_samples", 2048))
    total = int(math.ceil(total / global_batch) * global_batch)
    iterations = total // global_batch
    logger.info(f"sampling {total} videos on {gen.device} ({per_dev} a batch, {iterations} iterations)")

    out_dir = getattr(config, "save_video_path", None) or "./sampled_videos"
    os.makedirs(out_dir, exist_ok=True)
    for it in range(iterations):
        latents = gen.sample_latents()
        for b in range(global_batch):
            # the reference's interleave: rank-minor, position-major; the
            # batch is shard-major, b = s·per_dev + p
            s, p = divmod(b, per_dev)
            idx = it * global_batch + p * n_dev + s
            if gen.vae is not None:
                video = gen.decode_to_uint8(latents[b : b + 1])[0]
                save_video(os.path.join(out_dir, f"{idx:04d}.mp4"), video, fps=8)
            else:
                np.savez(os.path.join(out_dir, f"{idx:04d}.npz"), latents=latents[b].float().cpu().numpy())
        logger.info(f"iteration {it + 1}/{iterations} done")
    return out_dir


def create_npz_from_sample_folder(sample_dir: str, num: int = 2048) -> str:
    """Stack the folder's first ``num`` mp4s (uint8 (N, F, H, W, 3)), or its
    latents when it holds no mp4, into ``samples_{N}.npz`` (key ``arr_0``)
    in the same folder; return its path."""
    files = sorted(glob.glob(os.path.join(sample_dir, "*.mp4")))[:num]
    if files:
        samples = [read_video(f) for f in files]
    else:
        samples = [np.load(f)["latents"] for f in sorted(glob.glob(os.path.join(sample_dir, "[0-9]*.npz")))[:num]]
    arr = np.stack(samples)
    out = os.path.join(sample_dir, f"samples_{len(arr)}.npz")
    np.savez(out, arr_0=arr)
    return out


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
