"""Metric math (port of ``latte_tpu/eval/scores.py``): Fréchet distance,
kernel (MMD) distance and inception score, in numpy/scipy fp64 on the host.

- FID/FVD: Fréchet distance through ``scipy.linalg.sqrtm``;
- KID: polynomial-kernel MMD averaged over random subsets, scaled x1000;
- IS: exp(mean KL) over splits, with the reference's plain ``np.log``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg


def frechet_distance(mu_real, cov_real, mu_gen, cov_gen) -> float:
    m = np.square(mu_gen - mu_real).sum()
    s = scipy.linalg.sqrtm(np.dot(cov_gen, cov_real))
    if isinstance(s, tuple):  # older scipy returns (sqrtm, errest)
        s = s[0]
    dist = m + np.trace(cov_gen + cov_real - s * 2)
    return float(np.real(dist))


def kernel_distance(
    real_features: np.ndarray,
    gen_features: np.ndarray,
    num_subsets: int = 100,
    max_subset_size: int = 1000,
    seed: int = 0,
) -> float:
    """Polynomial-kernel MMD averaged over random subsets, x1000 (the scale
    of every published KID)."""
    n = real_features.shape[1]
    m = min(min(real_features.shape[0], gen_features.shape[0]), max_subset_size)
    rng = np.random.default_rng(seed)
    t = 0.0
    for _ in range(num_subsets):
        x = gen_features[rng.choice(gen_features.shape[0], m, replace=False)]
        y = real_features[rng.choice(real_features.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m) * 1000.0


def inception_score(
    probs: np.ndarray, num_splits: int = 10, shuffle_seed: "int | None" = None
) -> Tuple[float, float]:
    """exp(E KL(p(y|x) || p(y))) over splits -> (mean, std). The video
    variant shuffles first with ``RandomState(42)``: pass ``shuffle_seed=42``."""
    probs = np.asarray(probs, np.float64)
    if shuffle_seed is not None:
        probs = probs.copy()
        np.random.RandomState(shuffle_seed).shuffle(probs)
    scores = []
    n = probs.shape[0]
    for i in range(num_splits):
        part = probs[i * n // num_splits : (i + 1) * n // num_splits]
        # x*log(x) -> 0 as x->0+: the reference's value wherever it is
        # finite, and no NaN from probabilities that underflowed to zero
        with np.errstate(divide="ignore", invalid="ignore"):
            kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
        kl = np.where(part > 0, kl, 0.0)
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))
