"""Logging, experiment directories, device choice, video reading and
writing, and construction by dotted name for the port's entry points
(counterpart of ``latte_tpu/utils.py``)."""

from __future__ import annotations

import importlib
import logging
import math
import os
from typing import Optional

import numpy as np
import torch


def create_logger(logging_dir: Optional[str] = None, enabled: bool = True) -> logging.Logger:
    """Logger to stdout, and to ``<logging_dir>/log.txt`` when a dir is given;
    ``enabled=False`` (a rank other than 0) drops every record."""
    logger = logging.getLogger("latte_tpu_torch")
    logger.handlers.clear()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not enabled:
        logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logging_dir is not None:
        os.makedirs(logging_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(logging_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def create_experiment_dir(results_dir: str, config) -> str:
    """Auto-indexed experiment dir ``NNN-<model>[-flags]`` under ``results_dir``."""
    os.makedirs(results_dir, exist_ok=True)
    existing = [d for d in os.listdir(results_dir) if "-" in d and d.split("-")[0].isdigit()]
    index = max([int(d.split("-")[0]) for d in existing], default=-1) + 1
    name = str(getattr(config, "model", "model")).replace("/", "-")
    for flag, suffix in (("gradient_checkpointing", "gc"), ("mixed_precision", "amp")):
        if getattr(config, flag, None):
            name += f"-{suffix}"
    path = os.path.join(results_dir, f"{index:03d}-{name}")
    os.makedirs(path, exist_ok=True)
    return path


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``cuda`` unless the caller names another device; never a silent
    fallback. A bare ``cuda`` is ``cuda:LOCAL_RANK`` in a process that a
    launcher gave a ``LOCAL_RANK`` (one GPU per process)."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


def save_video(path: str, video: np.ndarray, fps: int = 8) -> None:
    """Write (F, H, W, 3) uint8 RGB frames to mp4 (OpenCV, ``mp4v``)."""
    import cv2

    if video.ndim != 4 or video.shape[-1] != 3:
        raise ValueError(f"expected (F, H, W, 3) frames, got {video.shape}")
    h, w = video.shape[1:3]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for frame in video:
            writer.write(np.ascontiguousarray(frame[:, :, ::-1]))  # RGB->BGR
    finally:
        writer.release()


def save_image(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image to png (OpenCV)."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, np.ascontiguousarray(image[:, :, ::-1]))


def read_video(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Read a video file into (F, H, W, 3) uint8 RGB frames (OpenCV); raises
    ``IOError`` when no frame decodes."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok or (max_frames is not None and len(frames) >= max_frames):
                break
            frames.append(frame[:, :, ::-1])  # BGR->RGB
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


def to_uint8(video: np.ndarray) -> np.ndarray:
    """[-1, 1] float video -> uint8 (truncating, as the JAX package does)."""
    return (np.clip((video + 1.0) / 2.0, 0, 1) * 255).astype(np.uint8)


def save_video_grid(path: str, videos: np.ndarray, fps: int = 8, ncols: Optional[int] = None) -> None:
    """(B, F, H, W, 3) uint8 videos -> one mp4 of a grid of them, ``ncols``
    wide (default ceil(sqrt(B))), the empty cells black."""
    b, f, h, w, c = videos.shape
    ncols = ncols or int(math.ceil(math.sqrt(b)))
    nrows = int(math.ceil(b / ncols))
    pad = nrows * ncols - b
    if pad:
        videos = np.concatenate([videos, np.zeros((pad, f, h, w, c), videos.dtype)], axis=0)
    grid = videos.reshape(nrows, ncols, f, h, w, c)
    grid = grid.transpose(2, 0, 3, 1, 4, 5).reshape(f, nrows * h, ncols * w, c)
    save_video(path, grid, fps=fps)


def get_obj_by_name(name: str):
    """The object at a dotted path such as ``latte_tpu_torch.models.Latte``;
    raises ``ImportError`` when no module prefix and attribute chain resolve."""
    parts = name.split(".")
    for split in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:split]))
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError:
            continue
    raise ImportError(f"cannot resolve {name!r}")


def construct_class_by_name(class_name: str, *args, **kwargs):
    """Instantiate a class from its dotted name (config-driven construction)."""
    return get_obj_by_name(class_name)(*args, **kwargs)
