"""Threaded prefetching data loader on the host (port of
``latte_tpu/data/loader.py``): worker threads read samples while the GPU
computes, and batches are collated to numpy. The port trains on one
device, so every epoch walks the whole shuffled index space. With
``pixel_uint8`` the workers ship videos as uint8 (``quantize_video_u8``),
a quarter of the fp32 bytes, and the train step dequantizes on the device.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, Optional

import numpy as np

_PREFETCH = 4  # batches held ready ahead of the consumer


def _collate(samples) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k in samples[0]:
        out[k] = np.stack([s[k] for s in samples])
    return out


def quantize_video_u8(video: np.ndarray) -> np.ndarray:
    """fp32 [-1, 1] -> uint8 by round((x + 1) * 127.5).

    Lossless on transform stacks without a resize (crop, flip): a source
    pixel v becomes v / 127.5 - 1, which rounds back to v. A resize lands
    off the uint8 grid, and the transport then moves a pixel by at most
    0.5 / 127.5."""
    return np.clip(np.rint((video + 1.0) * 127.5), 0, 255).astype(np.uint8)


class DataLoader:
    """Infinite shuffled loader with worker threads and bounded prefetch.

    ``shard_id`` / ``num_shards`` give DistributedSampler-style splitting
    (one loader per process, as the JAX loader): each epoch's shuffled order
    is cut into ``num_shards`` disjoint strided shards that cover it."""

    def __init__(
        self, dataset, batch_size: int, num_workers: int = 4, seed: int = 0,
        pixel_uint8: bool = False, shard_id: int = 0, num_shards: int = 1,
    ):
        self.pixel_uint8 = pixel_uint8
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._batch_q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        self._index_q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH * batch_size * 2)
        self._threads: list = []

    def _index_producer(self):
        epoch = 0
        n = len(self.dataset)
        while not self._stop.is_set():
            rng = random.Random(self.seed + epoch)
            order = list(range(n))
            rng.shuffle(order)
            for i in order[self.shard_id :: self.num_shards]:
                if self._stop.is_set():
                    return
                self._index_q.put(i)
            epoch += 1

    def _worker(self, wid: int):
        failures = 0
        while not self._stop.is_set():
            try:
                i = self._index_q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                sample = self.dataset[i]
                if self.pixel_uint8 and "video" in sample:
                    # quantize on the worker thread, where it overlaps the step
                    sample = dict(sample)
                    sample["video"] = quantize_video_u8(sample["video"])
                failures = 0
            except Exception as e:
                # skip bad samples like the reference retry loops — but a
                # fully-broken dataset must surface ON THE CONSUMING THREAD
                # (raising here would die silently in a daemon worker and
                # leave the consumer blocked forever)
                failures += 1
                if failures >= 20:
                    self._error = e
                    self._stop.set()
                    return
                continue
            self._sample_buffer.put(sample)

    def _batcher(self):
        while not self._stop.is_set():
            samples = []
            while len(samples) < self.batch_size and not self._stop.is_set():
                try:
                    samples.append(self._sample_buffer.get(timeout=0.2))
                except queue.Empty:
                    continue
            if samples and not self._stop.is_set():
                self._batch_q.put(_collate(samples))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._sample_buffer = queue.Queue(maxsize=_PREFETCH * self.batch_size)
        t = threading.Thread(target=self._index_producer, daemon=True)
        t.start()
        self._threads = [t]
        for w in range(self.num_workers):
            t = threading.Thread(target=self._worker, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._batcher, daemon=True)
        t.start()
        self._threads.append(t)
        try:
            while True:
                try:
                    batch = self._batch_q.get(timeout=0.5)
                except queue.Empty:
                    if self._error is not None:
                        raise RuntimeError(
                            "DataLoader worker failed 20 consecutive times — "
                            "dataset appears fully broken"
                        ) from self._error
                    if self._stop.is_set():
                        return
                    continue
                yield batch
        finally:
            self.close()

    def close(self):
        self._stop.set()
