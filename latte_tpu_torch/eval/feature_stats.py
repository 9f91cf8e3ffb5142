"""Streaming feature statistics for the metrics (port of
``latte_tpu/eval/feature_stats.py``): fp64 running mean and covariance,
optional capture of the raw features up to ``max_items``, save/load in the
same pickle layout, and the md5-keyed cache path. Features computed on
several processes are gathered over ``torch.distributed``'s default group.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional

import numpy as np
import torch.distributed as dist


def world_size() -> int:
    """Processes in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if world_size() > 1 else 0


class FeatureStats:
    def __init__(
        self,
        capture_all: bool = False,
        capture_mean_cov: bool = False,
        max_items: Optional[int] = None,
    ):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features: Optional[int] = None
        self.all_features: Optional[list] = None
        self.raw_mean: Optional[np.ndarray] = None
        self.raw_cov: Optional[np.ndarray] = None

    def set_num_features(self, num_features: int) -> None:
        if self.num_features is not None:
            assert num_features == self.num_features
            return
        self.num_features = num_features
        self.all_features = []
        self.raw_mean = np.zeros(num_features, dtype=np.float64)
        self.raw_cov = np.zeros((num_features, num_features), dtype=np.float64)

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x: np.ndarray) -> None:
        x = np.asarray(x, dtype=np.float32)
        assert x.ndim == 2
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            x = x[: self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def append_sharded(self, x: Optional[np.ndarray]) -> None:
        """Append features computed on this process, gathered from every
        process of the default group and concatenated rank after rank, so
        every process holds the same stats; at world 1 :meth:`append`. A
        process with no rows passes None."""
        if world_size() > 1:
            parts = [None] * world_size()
            dist.all_gather_object(parts, None if x is None else np.asarray(x, np.float32))
            parts = [p for p in parts if p is not None]
            if not parts:
                return
            x = np.concatenate(parts, axis=0)
        if x is not None:
            self.append(x)

    def get_all(self) -> np.ndarray:
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    # -- persistence & caching ------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.__dict__, f)
        os.replace(tmp, path)  # atomic, like the reference cache

    @classmethod
    def load(cls, path: str) -> "FeatureStats":
        with open(path, "rb") as f:
            state = pickle.load(f)
        obj = cls()
        obj.__dict__.update(state)
        return obj


def cache_path(cache_dir: str, *key_parts) -> str:
    """md5-keyed stats cache file (the reference's key; the JAX package's
    files and the port's are the same)."""
    tag = hashlib.md5(repr(sorted(map(repr, key_parts))).encode()).hexdigest()
    return os.path.join(cache_dir, f"stats-{tag}.pkl")
