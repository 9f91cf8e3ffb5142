"""Latent-cache dataset (port of ``latte_tpu/data/latents.py``): train from
posterior moments that were VAE-encoded once, offline. The cache stores the
MOMENTS (mean, std), not samples, so every step still draws a fresh
posterior sample (``latte_tpu_torch/train/step.py``), keeping the training
distribution that of online encoding.

Cache layout::

    <dir>/latent_cache.json      metadata (frames, latent shape, vae_scale,
                                 source dataset, num items)
    <dir>/{index:06d}.npz        latent_mean, latent_std (F, C, h, w) fp32
                                 [+ y int label, y_image (I,) labels]
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

METADATA_FILE = "latent_cache.json"


def is_latent_cache(path: str) -> bool:
    return os.path.isfile(os.path.join(str(path), METADATA_FILE))


class LatentCacheDataset:
    """Reads a latent-cache directory (the layout above)."""

    def __init__(self, path: str):
        self.path = str(path)
        with open(os.path.join(self.path, METADATA_FILE)) as f:
            self.meta = json.load(f)
        self._n = int(self.meta["num_items"])

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.path, f"{i:06d}.npz")) as z:
            out = {
                "latent_mean": z["latent_mean"].astype(np.float32),
                "latent_std": z["latent_std"].astype(np.float32),
            }
            if "y" in z:
                out["y"] = z["y"].astype(np.int32)
            if "y_image" in z:
                out["y_image"] = z["y_image"].astype(np.int32)
        return out
