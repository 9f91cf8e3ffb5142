"""Video datasets on the host (port of ``latte_tpu/data/datasets.py``): mp4
folders, frame folders, and joint video + image sets.

- flat mp4 folders (FaceForensics), and mp4 trees whose class is the parent
  directory's name (UCF101);
- frame-folder trees, one numerically sorted folder of frames a clip (Sky,
  Taichi);
- the ``*_img`` variants, which add ``use_image_num`` still frames from a
  ``train_list.txt`` with a label each;
- ``get_dataset(config)``, which picks one by ``config.dataset``.

Every item is a dict of numpy arrays; the decode is OpenCV's. A clip takes
``num_frames`` frames spread by linspace over a random window of
``num_frames * frame_interval`` frames. The random draws come from the
dataset's ``random.Random(seed)`` in the JAX package's order, so the same
calls in the same order give the same items to the bit.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Tuple

import numpy as np

from latte_tpu_torch.data import video_transforms as vt
from latte_tpu_torch.utils import read_video

__all__ = [
    "IMG_EXTS",
    "VIDEO_EXTS",
    "find_classes",
    "VideoFolderDataset",
    "FrameFolderDataset",
    "JointVideoImageDataset",
    "get_dataset",
]

IMG_EXTS = (".jpg", ".jpeg", ".png")
VIDEO_EXTS = (".mp4", ".avi", ".mov")


def _numeric_key(name: str):
    stem = os.path.splitext(os.path.basename(name))[0]
    digits = "".join(ch for ch in stem if ch.isdigit())
    return (int(digits) if digits else 0, stem)


def find_classes(root: str) -> Tuple[List[str], Dict[str, int]]:
    """Sorted class name -> index, from the immediate subdirectories."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    return classes, {c: i for i, c in enumerate(classes)}


def _walk_files(root: str, exts) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root, followlinks=True):
        for f in files:
            if f.lower().endswith(exts):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _select_frame_indices(begin: int, end: int, num_frames: int) -> np.ndarray:
    """``num_frames`` indices spread by linspace over [begin, end)."""
    return np.linspace(begin, end - 1, num_frames).astype(int)


def _apply_transform(transform, clip: np.ndarray, rng) -> np.ndarray:
    """Call ``transform(clip, rng)``, or ``transform(clip)`` when it takes
    one argument. The arity comes from the signature, not from catching a
    TypeError: one raised inside a two-argument transform must propagate,
    not retry without the seeded rng."""
    import inspect

    try:
        n_params = len(inspect.signature(transform).parameters)
    except (TypeError, ValueError):  # builtins and partials without a signature
        n_params = 2
    if n_params >= 2:
        return transform(clip, rng)
    return transform(clip)


class VideoFolderDataset:
    """A folder of video files; with ``use_labels``, the class of each is
    its parent directory's name."""

    def __init__(
        self,
        data_path: str,
        num_frames: int = 16,
        frame_interval: int = 3,
        image_size: int = 256,
        use_labels: bool = False,
        transform=None,
        seed: int = 0,
    ):
        self.videos = _walk_files(data_path, VIDEO_EXTS)
        if not self.videos:
            raise FileNotFoundError(f"no videos under {data_path}")
        self.num_frames = num_frames
        self.temporal_crop = vt.TemporalRandomCrop(num_frames * frame_interval)
        self.image_size = image_size
        # by default the ffs/ucf101 stack (flip, scale, crop)
        self.transform = transform or vt.make_reference_transform("ffs", image_size)
        self.use_labels = use_labels
        if use_labels:
            self.classes, self.class_to_idx = find_classes(data_path)
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.videos)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        path = self.videos[index]
        frames = read_video(path)  # (F, H, W, 3) uint8
        begin, end = self.temporal_crop(len(frames), self.rng)
        clip = frames[_select_frame_indices(begin, end, self.num_frames)]
        out = {"video": _apply_transform(self.transform, clip, self.rng).astype(np.float32)}
        if self.use_labels:
            label = self.class_to_idx[os.path.basename(os.path.dirname(path))]
            out["y"] = np.int32(label)
        return out


class FrameFolderDataset:
    """One directory of numerically sorted frames a clip; a clip takes every
    ``frame_interval``-th frame from a random start."""

    def __init__(
        self,
        data_path: str,
        num_frames: int = 16,
        frame_interval: int = 3,
        image_size: int = 256,
        transform=None,
        seed: int = 0,
    ):
        self.clips: List[List[str]] = []
        for dirpath, _, files in os.walk(data_path, followlinks=True):
            imgs = sorted(
                (f for f in files if f.lower().endswith(IMG_EXTS)), key=_numeric_key
            )
            if len(imgs) >= num_frames:
                self.clips.append([os.path.join(dirpath, f) for f in imgs])
        if not self.clips:
            raise FileNotFoundError(f"no frame folders under {data_path}")
        self.num_frames = num_frames
        self.frame_interval = frame_interval
        self.image_size = image_size
        # by default the sky stack (crop, then resize; no flip)
        self.transform = transform or vt.make_reference_transform("sky", image_size)
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.clips)

    def _read_image(self, path: str) -> np.ndarray:
        import cv2

        img = cv2.imread(path)
        return img[:, :, ::-1]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        files = self.clips[index]
        span = self.num_frames * self.frame_interval
        start = self.rng.randint(0, max(0, len(files) - span))
        chosen = files[start : start + span : self.frame_interval][: self.num_frames]
        # a short folder repeats its last frame
        while len(chosen) < self.num_frames:
            chosen.append(chosen[-1])
        clip = np.stack([self._read_image(f) for f in chosen])
        return {"video": _apply_transform(self.transform, clip, self.rng).astype(np.float32)}


class JointVideoImageDataset:
    """``*_img`` training: a video clip and ``use_image_num`` random still
    frames from a frame list, concatenated on the frame axis, with a label
    for each image."""

    def __init__(
        self,
        video_dataset,
        frame_list_path: str,
        use_image_num: int,
        image_size: int = 256,
        seed: int = 0,
    ):
        self.video_dataset = video_dataset
        self.use_image_num = use_image_num
        self.image_size = image_size
        with open(frame_list_path) as f:
            self.frame_list = [ln.strip() for ln in f if ln.strip()]
        self.root = os.path.dirname(os.path.abspath(frame_list_path))
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.video_dataset)

    def _load_image(self, rel: str) -> Tuple[np.ndarray, int]:
        """One line of the list: ``relative/path/frame.jpg [label]``. Each
        still goes through the video's transform stack, with a flip draw of
        its own."""
        parts = rel.split()
        path = parts[0] if os.path.isabs(parts[0]) else os.path.join(self.root, parts[0])
        label = int(parts[1]) if len(parts) > 1 else 0
        import cv2

        img = cv2.imread(path)[:, :, ::-1][None]  # (1, H, W, 3)
        img = np.ascontiguousarray(img)
        transform = getattr(self.video_dataset, "transform", None) or (
            vt.make_reference_transform("ffs", self.image_size)
        )
        return _apply_transform(transform, img, self.rng)[0], label

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        # a failed item is replaced by a random other one, ten tries at most
        for _ in range(10):
            try:
                out = dict(self.video_dataset[index])
                imgs, labels = [], []
                for _ in range(self.use_image_num):
                    rel = self.frame_list[self.rng.randrange(len(self.frame_list))]
                    img, label = self._load_image(rel)
                    imgs.append(img)
                    labels.append(label)
                out["video"] = np.concatenate(
                    [out["video"], np.stack(imgs)], axis=0
                ).astype(np.float32)
                if "y" in out:
                    out["y_image"] = np.asarray(labels, np.int32)
                return out
            except Exception:
                index = self.rng.randrange(len(self))
        raise RuntimeError("too many failed samples")


def get_dataset(args):
    """The dataset that ``args.dataset`` names: ffs, ucf101, sky, taichi, or
    one of them with ``_img``."""
    name = str(args.dataset)
    num_frames = int(getattr(args, "num_frames", 16))
    frame_interval = int(getattr(args, "frame_interval", 3))
    image_size = int(getattr(args, "image_size", 256))
    base = name.replace("_img", "")
    common = dict(
        num_frames=num_frames,
        frame_interval=frame_interval,
        image_size=image_size,
        transform=vt.make_reference_transform(name, image_size),
    )
    if base in ("ffs", "ucf101"):
        ds = VideoFolderDataset(
            args.data_path, use_labels=(base == "ucf101"), **common
        )
    elif base in ("sky", "taichi"):
        ds = FrameFolderDataset(args.data_path, **common)
    else:
        raise NotImplementedError(f"unknown dataset {name}")

    if name.endswith("_img"):
        ds = JointVideoImageDataset(
            ds,
            frame_list_path=args.frame_data_txt,
            use_image_num=int(getattr(args, "use_image_num", 0)),
            image_size=image_size,
        )
    return ds
