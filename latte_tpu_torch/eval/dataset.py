"""Metric-input datasets (port of ``latte_tpu/eval/dataset.py``): frame
folders, flat mp4 directories or zip archives of frame folders.

Each clip is a subdirectory of frames (or an mp4); loading takes N
consecutive frames at a random offset from ``random.Random(seed)``, with an
optional subsample factor, padded by repeating the last frame. Per-video
labels come from a ``dataset.json`` ``{"labels": [[fname, label], ...]}``.
"""

from __future__ import annotations

import json
import os
import random
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from latte_tpu_torch.data.datasets import IMG_EXTS, VIDEO_EXTS, _numeric_key, _walk_files
from latte_tpu_torch.utils import read_video


def _decode_image_bytes(data: bytes) -> np.ndarray:
    import cv2

    arr = np.frombuffer(data, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
    return img[:, :, ::-1]


class MetricVideoDataset:
    """Yields uint8 (F, H, W, 3) clips for metric feature extraction.

    ``path`` may be a directory (frame-folder tree and/or flat mp4s) or a
    ``.zip`` archive of frame folders. When a ``dataset.json`` with a
    ``labels`` map is present, per-clip labels are exposed via
    :meth:`get_label` (one label per video dir, SG2-ADA format).
    """

    def __init__(
        self,
        path: str,
        num_frames: int,
        subsample_factor: int = 1,
        max_items: Optional[int] = None,
        seed: int = 0,
        random_offset: bool = True,
    ):
        self.path = path
        self.num_frames = num_frames
        self.subsample_factor = subsample_factor
        self.random_offset = random_offset
        self.rng = random.Random(seed)
        self._zippath: Optional[str] = None
        self._zipfile: Optional[zipfile.ZipFile] = None
        self._labels: Optional[Dict[str, float]] = None

        self.clips: List[Tuple[str, object]] = []
        if os.path.isfile(path) and path.lower().endswith(".zip"):
            self._zippath = path
            names = self._zip().namelist()
            by_dir: Dict[str, List[str]] = {}
            for n in names:
                if n.lower().endswith(IMG_EXTS):
                    by_dir.setdefault(os.path.dirname(n), []).append(n)
            for d in sorted(by_dir):
                self.clips.append(("zipframes", sorted(by_dir[d], key=_numeric_key)))
            label_files = [n for n in names if n.endswith("dataset.json")]
            if label_files:
                with self._zip().open(label_files[0]) as f:
                    self._labels = self._parse_labels(json.load(f))
        else:
            # frame-folder layout
            for dirpath, dirnames, files in os.walk(path, followlinks=True):
                imgs = sorted((f for f in files if f.lower().endswith(IMG_EXTS)), key=_numeric_key)
                if imgs:
                    self.clips.append(("frames", [os.path.join(dirpath, f) for f in imgs]))
            # flat mp4 layout
            for v in _walk_files(path, VIDEO_EXTS):
                self.clips.append(("video", v))
            label_path = os.path.join(path, "dataset.json")
            if os.path.isfile(label_path):
                with open(label_path) as f:
                    self._labels = self._parse_labels(json.load(f))
        if not self.clips:
            raise FileNotFoundError(f"no clips under {path}")
        self.clips.sort(key=lambda c: c[1] if isinstance(c[1], str) else c[1][0])
        if max_items is not None and len(self.clips) > max_items:
            idx = self.rng.sample(range(len(self.clips)), max_items)
            self.clips = [self.clips[i] for i in sorted(idx)]

    # -- labels (the reference's SG2-ADA dataset.json) ------------------------
    @staticmethod
    def _parse_labels(payload) -> Optional[Dict[str, float]]:
        labels = payload.get("labels")
        if labels is None:
            return None
        per_video: Dict[str, float] = {}
        for fname, label in dict(labels).items():
            d = os.path.basename(os.path.dirname(fname)) or os.path.splitext(os.path.basename(fname))[0]
            if d in per_video:
                assert per_video[d] == label, f"conflicting labels for {d}"
            else:
                per_video[d] = label
        return per_video

    def get_label(self, index: int):
        """Per-video label from dataset.json, or None."""
        if self._labels is None:
            return None
        kind, src = self.clips[index]
        name = src if isinstance(src, str) else src[0]
        # keyed by the path relative to the dataset root, as _parse_labels'
        # keys: a flat mp4's key is its file stem, not the root's name
        if self._zippath is None and os.path.isabs(name):
            name = os.path.relpath(name, self.path)
        d = os.path.basename(os.path.dirname(name)) or os.path.splitext(os.path.basename(name))[0]
        return self._labels.get(d)

    @property
    def has_labels(self) -> bool:
        return self._labels is not None

    # -- IO ----------------------------------------------------------------
    def _zip(self) -> zipfile.ZipFile:
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._zippath)
        return self._zipfile

    def __getstate__(self):
        return dict(self.__dict__, _zipfile=None)  # zip handles don't pickle

    def __len__(self) -> int:
        return len(self.clips)

    def _offset(self, total: int) -> int:
        """The reference's offset range, the full valid window
        ``[0, total - n*sub + sub - 1]``."""
        span = self.num_frames * self.subsample_factor
        hi = max(0, total - span + self.subsample_factor - 1)
        return self.rng.randint(0, hi) if self.random_offset else 0

    def _read_first_frame(self, path: str) -> np.ndarray:
        """num_frames=1 without a random offset: decode one frame, not the mp4."""
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            ok, frame = cap.read()
        finally:
            cap.release()
        if not ok:
            raise IOError(f"cannot read a frame from {path}")
        return frame[:, :, ::-1][None]

    def __getitem__(self, index: int) -> np.ndarray:
        kind, src = self.clips[index]
        if kind == "video":
            if self.num_frames == 1 and not self.random_offset:
                return self._read_first_frame(src)
            frames = read_video(src)
            total = len(frames)
            offset = self._offset(total)
            idx = np.arange(self.num_frames) * self.subsample_factor + offset
            clip = frames[np.clip(idx, 0, total - 1)]
            return self._pad(clip)
        paths = src
        total = len(paths)
        offset = self._offset(total)
        idx = np.arange(self.num_frames) * self.subsample_factor + offset
        idx = np.clip(idx, 0, total - 1)
        if kind == "zipframes":
            z = self._zip()
            clip = np.stack([_decode_image_bytes(z.read(paths[i])) for i in idx])
        else:
            import cv2

            clip = np.stack([cv2.imread(paths[i])[:, :, ::-1] for i in idx])
        return self._pad(clip)

    def _pad(self, clip: np.ndarray) -> np.ndarray:
        if len(clip) < self.num_frames:
            pad = np.repeat(clip[-1:], self.num_frames - len(clip), axis=0)
            clip = np.concatenate([clip, pad], axis=0)
        return clip


class MetricImageDataset:
    """Per-frame stream for FID/KID/IS: every frame of every clip is an item
    (the reference's video-to-image dataset). Iterating decodes each mp4
    once, streamed, never per-frame random access."""

    def __init__(self, path: str):
        self._images: List[object] = []  # file paths or zip member names
        self._videos: List[str] = []
        self._zippath: Optional[str] = None
        self._zipfile: Optional[zipfile.ZipFile] = None
        if os.path.isfile(path) and path.lower().endswith(".zip"):
            self._zippath = path
            for n in sorted(self._zip().namelist(), key=_numeric_key):
                if n.lower().endswith(IMG_EXTS):
                    self._images.append(n)
        else:
            self._images = _walk_files(path, IMG_EXTS)
            self._videos = _walk_files(path, VIDEO_EXTS)
        if not self._images and not self._videos:
            raise FileNotFoundError(f"no frames under {path}")

    def _zip(self) -> zipfile.ZipFile:
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._zippath)
        return self._zipfile

    def __iter__(self):
        import cv2

        for img in self._images:
            if self._zippath is not None:
                yield _decode_image_bytes(self._zip().read(img))
            else:
                yield cv2.imread(img)[:, :, ::-1]
        for v in self._videos:
            cap = cv2.VideoCapture(v)
            try:
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    yield frame[:, :, ::-1]
            finally:
                cap.release()
