"""Encode a video dataset once into a latent cache (port of
``latte_tpu/tools/cache_latents.py``).

Usage::

    python -m latte_tpu_torch.tools.cache_latents --config configs/ffs/ffs_train.yaml \\
        [--out DIR] [--device cuda|cpu] [key=value ...]

Walks the config's dataset in order (no shuffle), VAE-encodes
``cache_batch_size`` clips at a time with the trainer's frozen VAE
(``train.build_encode_fn_raw``: fp32, cuDNN's TF32 off), and writes one
``{index:06d}.npz`` a clip with the posterior moments ``latent_mean`` and
``latent_std`` (F, 4, h, w) fp32 and its labels, and ``latent_cache.json``
(the layout of ``data/latents.py``, which the port's and the JAX package's
``LatentCacheDataset`` both read). Point the train config's ``data_path``
at the cache and the trainer draws a fresh posterior sample from the
moments each step, without the encode. ``--out`` defaults to
``<data_path>_latents``; the device to ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from latte_tpu_torch.data.latents import METADATA_FILE

__all__ = ["main", "cli"]


def main(config, out_dir: str, device: Optional[str] = None) -> str:
    """Write the cache of ``config``'s dataset to ``out_dir``; return it."""
    from latte_tpu_torch.data import get_dataset
    from latte_tpu_torch.train.train import build_encode_fn_raw
    from latte_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    dataset = get_dataset(config)
    n = len(dataset)
    if n == 0:
        raise ValueError(
            f"dataset {getattr(config, 'data_path', '?')!r} yielded 0 items — refusing to write "
            "an empty latent cache"
        )
    encode = build_encode_fn_raw(config, dev)
    os.makedirs(out_dir, exist_ok=True)
    batch = int(getattr(config, "cache_batch_size", 8) or 8)
    meta = None
    for lo in range(0, n, batch):
        items = [dataset[i] for i in range(lo, min(lo + batch, n))]
        video = torch.from_numpy(np.stack([np.asarray(s["video"], np.float32) for s in items])).to(dev)
        # (N, F, 3, H, W) -> moments, the frames folded into the batch as
        # the train step's fused encode folds them
        N, F = video.shape[:2]
        post = encode(video.reshape(N * F, *video.shape[2:]))
        mean = post.mean.reshape(N, F, *post.mean.shape[1:]).cpu().numpy()
        std = post.std.reshape(N, F, *post.std.shape[1:]).cpu().numpy()
        for j, s in enumerate(items):
            rec = {"latent_mean": mean[j], "latent_std": std[j]}
            if "y" in s:
                rec["y"] = np.asarray(s["y"], np.int32)
            if "y_image" in s:
                rec["y_image"] = np.asarray(s["y_image"], np.int32)
            np.savez(os.path.join(out_dir, f"{lo + j:06d}.npz"), **rec)
        if meta is None:
            meta = {
                "num_items": n,
                "frames": int(mean.shape[1]),
                "latent_shape": list(mean.shape[2:]),
                "vae_scale": float(getattr(config, "vae_scale", 0.18215)),
                "dataset": str(getattr(config, "dataset", "")),
                "extras": int(getattr(config, "extras", 1)),
            }
        print(f"cached {min(lo + batch, n)}/{n}", flush=True)
    with open(os.path.join(out_dir, METADATA_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"latent cache written to {out_dir} ({n} items)")
    return out_dir


def cli(argv=None) -> str:
    from latte_tpu_torch.config import load_config

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--out", default=None, help="cache dir (default: <data_path>_latents)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    config = load_config(a.config, a.overrides)
    out = a.out or (str(config.data_path).rstrip("/") + "_latents")
    return main(config, out, device=a.device)


if __name__ == "__main__":
    cli()
