"""Video transforms on the host (port of ``latte_tpu/data/video_transforms.py``).

Pure functions over uint8 (F, H, W, C) numpy frames, with OpenCV for the
resize; the clip stays numpy until the loader ships a batch to the device.
The random draws come from the ``random.Random`` a dataset passes in, in the
JAX package's order, so one seed gives the same clip to the bit.

Output convention: float32 (F, C, H, W) in [-1, 1].
"""

from __future__ import annotations

import random
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "to_tensor_video",
    "normalize_video",
    "random_horizontal_flip",
    "center_crop",
    "resize",
    "resize_scale",
    "ucf_center_crop",
    "center_crop_resize",
    "make_reference_transform",
    "TemporalRandomCrop",
    "Compose",
]


def to_tensor_video(video: np.ndarray) -> np.ndarray:
    """(F, H, W, C) uint8, or float32 in [0, 255] after a resize, ->
    float32 (F, C, H, W) in [0, 1]."""
    return (video.astype(np.float32) / 255.0).transpose(0, 3, 1, 2)


def normalize_video(video: np.ndarray, mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """[0, 1] -> [-1, 1], the same mean and std for every channel."""
    return (video - mean) / std


def random_horizontal_flip(video: np.ndarray, p: float = 0.5, rng: Optional[random.Random] = None) -> np.ndarray:
    """Flip every frame of an (F, H, W, C) clip along W with probability p
    (one draw from ``rng`` a clip)."""
    r = (rng or random).random()
    if r < p:
        return np.ascontiguousarray(video[:, :, ::-1])
    return video


def resize(video: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of every frame of (F, H, W, C) to (h, w), in float32
    (resizing uint8 would round every output pixel to the uint8 grid)."""
    import cv2

    h, w = size
    v = video.astype(np.float32)
    return np.stack(
        [cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR) for f in v]
    )


def resize_scale(video: np.ndarray, target: int) -> np.ndarray:
    """Scale so that the shorter side equals ``target``, keeping the aspect.

    The longer side is floor(dim * scale), as torch's interpolate with a
    scale factor gives it; the shorter side is pinned to ``target`` (a
    floor(min * (target / min)) lands on target - 1 for some sizes, by fp
    rounding, and the center crop after it would then fail)."""
    _, H, W, _ = video.shape
    scale = target / min(H, W)
    if H <= W:
        nh, nw = target, max(target, int(W * scale))
    else:
        nh, nw = max(target, int(H * scale)), target
    return resize(video, (nh, nw))


def center_crop(video: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    _, H, W, _ = video.shape
    th, tw = size
    assert H >= th and W >= tw, f"crop {size} larger than video {(H, W)}"
    i = int(round((H - th) / 2.0))
    j = int(round((W - tw) / 2.0))
    return video[:, i : i + th, j : j + tw]


def ucf_center_crop(video: np.ndarray, size: int) -> np.ndarray:
    """Scale the shorter side to ``size``, then center crop a square."""
    return center_crop(resize_scale(video, size), (size, size))


def center_crop_resize(video: np.ndarray, size: int) -> np.ndarray:
    """Center crop the largest square, then resize it to ``size``."""
    _, H, W, _ = video.shape
    s = min(H, W)
    return resize(center_crop(video, (s, s)), (size, size))


def make_reference_transform(dataset: str, image_size: int):
    """The transform stack of each dataset:

    - ffs / ucf101 (and ``_img``): a random horizontal flip, then scale the
      shorter side and center crop;
    - taichi (and ``_img``): the random flip only, no spatial crop;
    - sky (and ``_img``): crop the largest square and resize it, no flip.

    Returns ``transform(video_uint8_FHWC, rng) -> float32 (F, C, H, W) in
    [-1, 1]``; the flip draws from ``rng``.
    """
    base = dataset.replace("_img", "")
    if base not in ("ffs", "ucf101", "taichi", "sky"):
        raise NotImplementedError(dataset)

    def transform(video: np.ndarray, rng: Optional[random.Random] = None) -> np.ndarray:
        if base in ("ffs", "ucf101"):
            video = random_horizontal_flip(video, rng=rng)
            video = ucf_center_crop(video, image_size)
        elif base == "taichi":
            video = random_horizontal_flip(video, rng=rng)
        else:  # sky
            video = center_crop_resize(video, image_size)
        return normalize_video(to_tensor_video(video))

    return transform


class TemporalRandomCrop:
    """A random contiguous window of ``size`` frames: the first frame is
    drawn from [0, total - size - 1]."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, total_frames: int, rng: Optional[random.Random] = None) -> Tuple[int, int]:
        r = rng or random
        rand_end = max(0, total_frames - self.size - 1)
        begin = r.randint(0, rand_end)
        return begin, min(begin + self.size, total_frames)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, video: np.ndarray) -> np.ndarray:
        for t in self.transforms:
            video = t(video)
        return video
