"""Cross-process training statistics (port of ``latte_tpu/stats.py``).

``report()`` / ``report0()`` accumulate values into named fp64 (count, sum,
sum of squares) moments; a :class:`Collector` takes the deltas since its
last update, filtered by a regex, and gives their num, mean and std. Over
several processes every process calls ``update`` with the same counters,
and one ``all_reduce`` over the default ``torch.distributed`` group (gloo
on the CPU, NCCL on the card) sums them, where JAX gathers them with
``process_allgather``.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

_counters: Dict[str, np.ndarray] = {}


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _moments(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().double().cpu().numpy()
    arr = np.asarray(value, dtype=np.float64).ravel()
    if arr.size == 0:
        return np.zeros(3)
    return np.array([arr.size, arr.sum(), np.square(arr).sum()], dtype=np.float64)


def report(name: str, value) -> None:
    """Accumulate value(s) (a number, an array or a tensor) into the named counter."""
    _counters.setdefault(name, np.zeros(3, dtype=np.float64))
    _counters[name] += _moments(value)


def report0(name: str, value) -> None:
    """Accumulate only on rank 0 (still creates the counter elsewhere)."""
    if _rank() == 0:
        report(name, value)
    else:
        _counters.setdefault(name, np.zeros(3, dtype=np.float64))


def _sync(names: List[str]) -> Dict[str, np.ndarray]:
    """Sum the counters over the processes and reset the local deltas."""
    local = np.stack([_counters.get(n, np.zeros(3)) for n in names]) if names else np.zeros((0, 3))
    for n in names:
        _counters[n] = np.zeros(3, dtype=np.float64)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
        total = torch.from_numpy(local).to(device)
        dist.all_reduce(total)
        local = total.cpu().numpy()
    return {n: local[i] for i, n in enumerate(names)}


class Collector:
    """Snapshot-and-query view over the global counters."""

    def __init__(self, regex: str = ".*", keep_previous: bool = True):
        self._regex = re.compile(regex)
        self._keep_previous = keep_previous
        self._cumulative: Dict[str, np.ndarray] = {}
        self._moments: Dict[str, np.ndarray] = {}

    def names(self) -> List[str]:
        return [n for n in _counters if self._regex.fullmatch(n)]

    def update(self) -> None:
        deltas = _sync(self.names())
        for name, delta in deltas.items():
            cum = self._cumulative.setdefault(name, np.zeros(3))
            cum += delta
            if delta[0] > 0 or not self._keep_previous:
                self._moments[name] = delta if delta[0] > 0 else np.zeros(3)

    def _get(self, name: str) -> np.ndarray:
        return self._moments.get(name, np.zeros(3))

    def num(self, name: str) -> int:
        return int(self._get(name)[0])

    def mean(self, name: str) -> float:
        m = self._get(name)
        return float(m[1] / m[0]) if m[0] > 0 else float("nan")

    def std(self, name: str) -> float:
        m = self._get(name)
        if m[0] <= 1:
            return 0.0
        mean = m[1] / m[0]
        var = max(m[2] / m[0] - mean * mean, 0.0)
        return float(np.sqrt(var))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            n: {"num": self.num(n), "mean": self.mean(n), "std": self.std(n)}
            for n in self.names()
        }


def reset() -> None:
    _counters.clear()
