"""Metric registry and protocols (port of ``latte_tpu/eval/metrics.py``).

The reference's metrics ``fvd2048_16f``, ``fvd2048_128f``,
``fvd2048_128f_subsample8f``, ``isv2048_ucf``, ``fid50k_full``,
``kid50k_full`` and ``is50k`` with its budgets (2048 clips, real subsample
3 for the 16-frame FVD; 50k images for FID/KID/IS) and its JSONL records.
The options: ``real_path``, ``fake_path`` or ``fake_gen`` (a ``gen_fn(n)``
yielding uint8 (B, F, H, W, 3) clips, such as
``sample_many.BatchGenerator``), ``detector`` (a callable; else loaded by
:func:`.detectors.load_detector` on ``device``), ``max_real``,
``max_fake``, ``gen_batch_size``, ``num_frames``, ``cache_dir``, ``seed``.

Over several processes (``torch.distributed``'s default group) every
process reads every clip, as in JAX, and runs the detector on its
contiguous share of each batch's rows; the shares are gathered in rank
order, so the stats equal one process's at any world size. A generator's
call returns the process's own rows (``BatchGenerator``'s shard), which
the gather puts in shard order. Rank 0 alone appends the JSONL record.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np

from latte_tpu_torch.dist.mesh import barrier
from latte_tpu_torch.eval.dataset import MetricImageDataset, MetricVideoDataset
from latte_tpu_torch.eval.detectors import (
    c3d_probs,
    i3d_features,
    inception_features,
    inception_probs,
    load_detector,
)
from latte_tpu_torch.eval.feature_stats import FeatureStats, cache_path, rank, world_size
from latte_tpu_torch.eval.scores import frechet_distance, inception_score, kernel_distance

_REGISTRY: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    _REGISTRY[fn.__name__] = fn
    return fn


def list_metrics():
    return sorted(_REGISTRY)


def is_valid_metric(name: str) -> bool:
    return name in _REGISTRY


def _append_share(stats: FeatureStats, detector, feature_fn, batch: np.ndarray) -> None:
    """This process's contiguous share of ``batch`` (every process's items)
    through the detector, gathered into ``stats``."""
    w, r, n = world_size(), rank(), len(batch)
    mine = batch[r * n // w : (r + 1) * n // w]
    stats.append_sharded(np.asarray(feature_fn(detector, mine), np.float32) if len(mine) else None)


def _save(stats: FeatureStats, path: str) -> None:
    """Rank 0 writes the cache file; every rank waits for it, so a later
    call finds it on every rank (or on none)."""
    if rank() == 0:
        stats.save(path)
    barrier()


def _video_stats(
    path: str,
    detector,
    feature_fn,
    num_frames: int,
    max_items: int,
    subsample_factor: int = 1,
    batch_size: int = 16,
    capture_all: bool = False,
    cache_dir: Optional[str] = None,
    seed: int = 0,
) -> FeatureStats:
    if cache_dir:
        cp = cache_path(cache_dir, path, num_frames, max_items, subsample_factor, capture_all)
        if os.path.exists(cp):
            return FeatureStats.load(cp)
    ds = MetricVideoDataset(path, num_frames=num_frames, subsample_factor=subsample_factor,
                            max_items=max_items, seed=seed)
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=True, max_items=max_items)
    batch = []
    for i in range(len(ds)):
        batch.append(ds[i])
        if len(batch) == batch_size or i == len(ds) - 1:
            _append_share(stats, detector, feature_fn, np.stack(batch))
            batch = []
            if stats.is_full():
                break
    if cache_dir:
        _save(stats, cp)
    return stats


def _frame_stats(
    path: str,
    detector,
    max_items: int,
    batch_size: int = 64,
    capture_all: bool = False,
    cache_dir: Optional[str] = None,
    seed: int = 0,
    feature_fn=inception_features,
) -> FeatureStats:
    """Per-frame Inception stats for FID/KID/IS: every frame of every clip
    is an item (the reference's video-to-image dataset); mp4s are decoded
    once, streamed."""
    if cache_dir:
        cp = cache_path(cache_dir, path, 1, max_items, 1, capture_all, feature_fn.__name__)
        if os.path.exists(cp):
            return FeatureStats.load(cp)
    ds = MetricImageDataset(path)
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=True, max_items=max_items)
    batch = []
    for frame in ds:
        batch.append(frame)
        if len(batch) == batch_size:
            _append_share(stats, detector, feature_fn, np.stack(batch))
            batch = []
            if stats.is_full():
                break
    if batch and not stats.is_full():
        _append_share(stats, detector, feature_fn, np.stack(batch))
    if cache_dir:
        _save(stats, cp)
    return stats


def generator_stats(
    gen_fn,
    detector,
    feature_fn,
    max_items: int,
    batch_size: int = 16,
    capture_all: bool = False,
    frames_only: bool = False,
    num_frames=None,
) -> FeatureStats:
    """Features streamed straight from a generator callable, no file on
    disk (the reference's ``compute_feature_stats_for_generator``).

    ``gen_fn(n) -> uint8 (n, F, H, W, 3)`` clips, this process's rows;
    with ``frames_only`` the clips are flattened to frames before the
    detector (image metrics). ``num_frames``: when given, the clips must
    have the metric's temporal protocol (the real features come from
    ``num_frames``-frame clips)."""
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=True, max_items=max_items)
    while not stats.is_full():
        clips = np.asarray(gen_fn(batch_size))
        assert clips.dtype == np.uint8 and clips.ndim == 5, (
            f"gen_fn must yield uint8 (B,F,H,W,3); got {clips.dtype} {clips.shape}"
        )
        if num_frames is not None and clips.shape[1] != num_frames:
            raise ValueError(
                f"fake_gen yielded {clips.shape[1]}-frame clips but this metric's protocol is "
                f"{num_frames} frames — generate {num_frames}-frame clips (real features use that length)"
            )
        x = clips.reshape(-1, *clips.shape[2:]) if frames_only else clips
        stats.append_sharded(np.asarray(feature_fn(detector, x), np.float32))
    return stats


def _fake_video_stats(opts, detector, feature_fn, num_frames, capture_all=False):
    """Generated-side stats: from ``fake_gen`` when given (streamed, no
    files), else from ``fake_path``."""
    if opts.get("fake_gen") is not None:
        return generator_stats(
            opts["fake_gen"], detector, feature_fn,
            max_items=opts.get("max_fake", 2048),
            batch_size=opts.get("gen_batch_size", 16),
            capture_all=capture_all,
            num_frames=num_frames,
        )
    return _video_stats(
        opts["fake_path"], detector, feature_fn, num_frames,
        max_items=opts.get("max_fake", 2048), capture_all=capture_all,
        seed=opts.get("seed", 0),
    )


def _detector(opts, name: str):
    return opts.get("detector") or load_detector(name, device=opts.get("device"))


def _fvd(opts, num_frames: int, real_subsample: int) -> float:
    detector = _detector(opts, "i3d")
    real = _video_stats(
        opts["real_path"], detector, i3d_features, num_frames,
        max_items=opts.get("max_real", 2048), subsample_factor=real_subsample,
        cache_dir=opts.get("cache_dir"), seed=opts.get("seed", 0),
    )
    fake = _fake_video_stats(opts, detector, i3d_features, num_frames)
    mu_r, cov_r = real.get_mean_cov()
    mu_f, cov_f = fake.get_mean_cov()
    return frechet_distance(mu_r, cov_r, mu_f, cov_f)


@register_metric
def fvd2048_16f(opts) -> Dict[str, float]:
    """2048 real (subsample 3) + 2048 fake clips x 16 frames, I3D."""
    return {"fvd2048_16f": _fvd(opts, num_frames=16, real_subsample=3)}


@register_metric
def fvd2048_128f(opts) -> Dict[str, float]:
    return {"fvd2048_128f": _fvd(opts, num_frames=128, real_subsample=1)}


@register_metric
def fvd2048_128f_subsample8f(opts) -> Dict[str, float]:
    """16 frames strided by 8 out of 128-frame windows."""
    detector = _detector(opts, "i3d")
    real = _video_stats(
        opts["real_path"], detector, i3d_features, 16,
        max_items=opts.get("max_real", 2048), subsample_factor=8,
        cache_dir=opts.get("cache_dir"), seed=opts.get("seed", 0),
    )
    fake = _video_stats(
        opts["fake_path"], detector, i3d_features, 16,
        max_items=opts.get("max_fake", 2048), subsample_factor=8,
        seed=opts.get("seed", 0),
    )
    mu_r, cov_r = real.get_mean_cov()
    mu_f, cov_f = fake.get_mean_cov()
    return {"fvd2048_128f_subsample8f": frechet_distance(mu_r, cov_r, mu_f, cov_f)}


@register_metric
def isv2048_ucf(opts) -> Dict[str, float]:
    """Video inception score: 2048 clips, C3D-UCF101, 10 splits, shuffled
    first with RandomState(42)."""
    detector = _detector(opts, "c3d")
    fake = _fake_video_stats(opts, detector, c3d_probs, opts.get("num_frames", 16), capture_all=True)
    mean, std = inception_score(fake.get_all(), num_splits=10, shuffle_seed=42)
    return {"isv2048_ucf_mean": mean, "isv2048_ucf_std": std}


def _fake_frame_stats(opts, detector, max_items, capture_all=False, feature_fn=inception_features):
    if opts.get("fake_gen") is not None:
        return generator_stats(
            opts["fake_gen"], detector, feature_fn,
            max_items=max_items, batch_size=opts.get("gen_batch_size", 16),
            capture_all=capture_all, frames_only=True,
        )
    return _frame_stats(
        opts["fake_path"], detector, max_items=max_items, capture_all=capture_all,
        feature_fn=feature_fn,
    )


@register_metric
def fid50k_full(opts) -> Dict[str, float]:
    detector = _detector(opts, "inception")
    real = _frame_stats(
        opts["real_path"], detector, max_items=opts.get("max_real", 50000),
        cache_dir=opts.get("cache_dir"),
    )
    fake = _fake_frame_stats(opts, detector, max_items=opts.get("max_fake", 50000))
    mu_r, cov_r = real.get_mean_cov()
    mu_f, cov_f = fake.get_mean_cov()
    return {"fid50k_full": frechet_distance(mu_r, cov_r, mu_f, cov_f)}


@register_metric
def kid50k_full(opts) -> Dict[str, float]:
    detector = _detector(opts, "inception")
    real = _frame_stats(
        opts["real_path"], detector, max_items=opts.get("max_real", 50000),
        capture_all=True, cache_dir=opts.get("cache_dir"),
    )
    fake = _fake_frame_stats(opts, detector, max_items=opts.get("max_fake", 50000), capture_all=True)
    return {"kid50k_full": kernel_distance(real.get_all(), fake.get_all())}


@register_metric
def is50k(opts) -> Dict[str, float]:
    # IS runs on class probabilities (the detector called with
    # no_output_bias=True), not on the pool3 features FID/KID use
    detector = _detector(opts, "inception")
    fake = _fake_frame_stats(
        opts, detector, max_items=opts.get("max_fake", 50000), capture_all=True,
        feature_fn=inception_probs,
    )
    mean, std = inception_score(fake.get_all(), num_splits=10)
    return {"is50k_mean": mean, "is50k_std": std}


def calc_metric(name: str, report_dir: Optional[str] = None, **opts) -> Dict:
    """Run a registered metric; with ``report_dir``, rank 0 appends the
    record to ``metric-<name>.jsonl`` there."""
    assert is_valid_metric(name), f"unknown metric {name}; known: {list_metrics()}"
    t0 = time.time()
    results = _REGISTRY[name](opts)
    record = {
        "results": results,
        "metric": name,
        "total_time": time.time() - t0,
        "real_path": opts.get("real_path"),
        "fake_path": opts.get("fake_path"),
    }
    if report_dir and rank() == 0:
        os.makedirs(report_dir, exist_ok=True)
        with open(os.path.join(report_dir, f"metric-{name}.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")
    return record
