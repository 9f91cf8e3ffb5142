"""mp4 -> frame folders for the metrics (port of
``latte_tpu/tools/convert_videos_to_frames.py``): a process pool over the
videos, each frame written as ``{i:06d}.jpg`` under the video's relative
path without its extension, optionally centre-cropped to a square and
resized (``INTER_AREA``).

Usage: ``python -m latte_tpu_torch.tools.convert_videos_to_frames -s VIDEOS_DIR
-t FRAMES_DIR [--target_size 256] [--workers 8]``
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
from functools import partial
from typing import List, Optional

VIDEO_EXTS = (".mp4", ".avi", ".mov")


def convert_one(video_path: str, source_dir: str, target_dir: str, target_size: Optional[int] = None) -> int:
    """Write one video's frames; returns how many."""
    import cv2

    rel = os.path.relpath(video_path, source_dir)
    out_dir = os.path.join(target_dir, os.path.splitext(rel)[0])
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    i = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if target_size:
                h, w = frame.shape[:2]
                s = min(h, w)
                y0, x0 = (h - s) // 2, (w - s) // 2
                frame = cv2.resize(frame[y0 : y0 + s, x0 : x0 + s], (target_size, target_size),
                                   interpolation=cv2.INTER_AREA)
            cv2.imwrite(os.path.join(out_dir, f"{i:06d}.jpg"), frame)
            i += 1
    finally:
        cap.release()
    return i


def find_videos(source_dir: str) -> List[str]:
    videos = []
    for dirpath, _, files in os.walk(source_dir):
        videos += [os.path.join(dirpath, f) for f in files if f.lower().endswith(VIDEO_EXTS)]
    return sorted(videos)


def convert(source_dir: str, target_dir: str, target_size: Optional[int] = None, workers: int = 8) -> List[int]:
    """Every video under ``source_dir`` to frame folders under
    ``target_dir`` over ``workers`` spawned processes; the frame counts in
    the sorted videos' order."""
    videos = find_videos(source_dir)
    fn = partial(convert_one, source_dir=source_dir, target_dir=target_dir, target_size=target_size)
    with mp.get_context("spawn").Pool(workers) as pool:
        return pool.map(fn, videos)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("-s", "--source_dir", required=True)
    p.add_argument("-t", "--target_dir", required=True)
    p.add_argument("--target_size", type=int, default=None)
    p.add_argument("--workers", type=int, default=8)
    a = p.parse_args(argv)
    counts = convert(a.source_dir, a.target_dir, a.target_size, a.workers)
    print(f"converted {len(counts)} videos, {sum(counts)} frames")


if __name__ == "__main__":
    main()
