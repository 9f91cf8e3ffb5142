"""Batch sampling for FVD evaluation (port of ``latte_tpu/sample/sample_many.py``),
in one process or in one process per GPU.

Writes ``num_fvd_samples`` videos (rounded up to a whole number of batches)
under ``save_video_path`` as ``{idx:04d}.mp4``, or as ``{idx:04d}.npz``
latents when no VAE is configured, with the reference's interleaved global
index ``idx = it·global_batch + p·n_dev + s`` (position p within shard s).
``n_dev`` is the world size (torchrun, or ``coordinator_address``/
``num_processes``/``process_id``); rank s samples shard s, draws its z from
``stream_seed(seed, 0, it·n_dev + s)`` and writes its own indices. The
labels and DDPM's noise of iteration ``it`` are drawn for the global batch,
as the JAX program draws them, and each rank takes its rows, so any world
size writes what one process writes for the concatenated shards. With
``create_npz: true`` rank 0 bundles the folder (``samples_N.npz``) after a
barrier. An MoE model's dispatch groups span the shards of the global
batch, as in the JAX program: over several processes each rank places its
tokens by the routing choices all-gathered over the world (``models/moe.py``,
whose rows are then this run's dp split, and under CFG the [cond | uncond]
halves of the global batch). ``tensor_parallel`` is ignored, as the JAX
generator ignores it. The model comes from ``sample.build_model`` and the sampler
from ``sample.build_sample_fn``, built once and called for every batch (as
the JAX generator does), so the int8 modes, the block cache and
``loop_mode`` apply as in the single-video entry point: under ``scan`` each
batch replays the CUDA graphs the first one captured (an MoE model over
several processes, whose step holds collectives, runs the eager loop).
Runs on ``cuda`` unless asked for the CPU::

    python -m latte_tpu_torch.sample.sample_many --config configs/ffs/ffs_sample.yaml \
        [--device cpu] [key=value ...]
    torchrun --nproc_per_node=4 -m latte_tpu_torch.sample.sample_many \
        --config configs/ffs/ffs_sample.yaml
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
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.dist.mesh import DistContext, MeshConfig, barrier, initialize_distributed, is_main_process, make_mesh
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
        sample.block_cache_interval(config)  # a bad block-cache setting fails before the build
        dev = initialize_distributed(
            getattr(config, "coordinator_address", None), getattr(config, "num_processes", None),
            getattr(config, "process_id", None), device,
        )
        self.n_dev = torch.distributed.get_world_size() if dev is not None else 1
        self.shard = torch.distributed.get_rank() if dev is not None else 0
        self.config = config
        self.device = dev if dev is not None else resolve_device(device)
        self.cfg = int(getattr(config, "extras", 1)) == 2 and float(getattr(config, "cfg_scale", 1.0)) > 1.0
        moe_mesh = None
        if self.n_dev > 1 and int(getattr(config, "moe_experts", 0) or 0) > 1:
            # the experts' dispatch groups span the shards: the rows are split over dp
            moe_mesh = DistContext(make_mesh(MeshConfig(dp=self.n_dev), self.device.type), self.device,
                                   cfg_halves=self.cfg)
        self.model = sample.build_model(config, self.device, moe_mesh=moe_mesh)
        self.sample_fn = sample.build_sample_fn(self.model, config, create_diffusion(str(config.num_sampling_steps)))
        if logger and not getattr(config, "ckpt", None):
            logger.info("WARNING: no checkpoint given — sampling from random init")
        self.vae = sample.load_vae(config, self.device)
        self.per_dev = int(getattr(config, "per_proc_batch_size", 2))
        self.global_batch = self.per_dev * self.n_dev
        self.seed = int(getattr(config, "seed", 0) or 0)
        self.it = 0

    def _generator(self, stream: int, index: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(stream_seed(self.seed, stream, index))

    def _rows(self) -> slice:
        return slice(self.shard * self.per_dev, (self.shard + 1) * self.per_dev)

    def draw(self, it: int):
        """Iteration ``it``'s noise z of this process's shard
        (per_proc_batch_size, F, 4, L, L), and, under ``extras: 2``, its
        labels in [0, num_classes), drawn for the global batch, else None."""
        shape = sample.latent_shape(self.config, self.per_dev)
        z = torch.randn(shape, generator=self._generator(Z_STREAM, it * self.n_dev + self.shard), device=self.device)
        y = None
        if int(getattr(self.config, "extras", 1)) == 2:
            y = torch.randint(0, self.model.num_classes, (self.global_batch,),
                              generator=self._generator(LABEL_STREAM, it), device=self.device)
            if self.n_dev > 1:
                y = y[self._rows()]
        return z, y

    def sample_latents(self) -> torch.Tensor:
        """This shard's next final latents (per_proc_batch_size, F, 4, L, L),
        fp32, on the device."""
        z, y = self.draw(self.it)
        generator = self._generator(NOISE_STREAM, self.it)
        noise = None
        if self.n_dev > 1:
            noise = ShardNoise(generator, (self.global_batch,) + tuple(z.shape[1:]), self._rows(), self.cfg)
        latents = self.sample_fn(z, y, generator, noise_schedule=noise)
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


class ShardNoise:
    """DDPM's per-step noise of one shard, as ``noise_schedule``: each step
    draws the noise of the global x (``global_shape``; twice the rows under
    CFG, [cond | uncond]) from ``generator`` and returns the shard's
    ``rows`` of each half. The loops read it outside a graph, per step."""

    def __init__(self, generator: torch.Generator, global_shape, rows: slice, cfg: bool):
        self.generator, self.rows, self.cfg = generator, rows, cfg
        self.shape = ((2 if cfg else 1) * global_shape[0],) + tuple(global_shape[1:])

    def __getitem__(self, t: int) -> torch.Tensor:
        full = torch.randn(self.shape, generator=self.generator, device=self.generator.device)
        if not self.cfg:
            return full[self.rows]
        half = self.shape[0] // 2
        return torch.cat([full[self.rows], full[half:][self.rows]])


def main(config: Config, device: Optional[str] = None) -> str:
    """Write the run's videos (or latents) under ``save_video_path``; return
    that directory."""
    gen = BatchGenerator(config, device=device)
    logger = create_logger(enabled=is_main_process())
    if not getattr(config, "ckpt", None):
        logger.info("WARNING: no checkpoint given — sampling from random init")
    global_batch, per_dev, n_dev = gen.global_batch, gen.per_dev, gen.n_dev
    total = int(getattr(config, "num_fvd_samples", 2048))
    total = int(math.ceil(total / global_batch) * global_batch)
    iterations = total // global_batch
    logger.info(f"sampling {total} videos on {n_dev} x {gen.device.type} ({per_dev} a batch each, "
                f"{iterations} iterations)")

    out_dir = getattr(config, "save_video_path", None) or "./sampled_videos"
    os.makedirs(out_dir, exist_ok=True)
    for it in range(iterations):
        latents = gen.sample_latents()
        for b in range(latents.shape[0]):
            # the reference's interleave: rank-minor, position-major; the
            # batch is shard-major, b = s·per_dev + p
            s, p = divmod(b, per_dev)
            s += gen.shard
            idx = it * global_batch + p * n_dev + s
            if gen.vae is not None:
                video = gen.decode_to_uint8(latents[b : b + 1])[0]
                save_video(os.path.join(out_dir, f"{idx:04d}.mp4"), video, fps=8)
            else:
                np.savez(os.path.join(out_dir, f"{idx:04d}.npz"), latents=latents[b].float().cpu().numpy())
        logger.info(f"iteration {it + 1}/{iterations} done")
    barrier()
    if getattr(config, "create_npz", False) and is_main_process():
        logger.info(f"wrote {create_npz_from_sample_folder(out_dir, total)}")
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
