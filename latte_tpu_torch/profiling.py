"""Profiling and cost analysis (port of ``latte_tpu/profiling.py``):
``trace`` (``torch.profiler`` to a Chrome trace), ``profiled_function``
(a ``record_function`` range, and an NVTX range on CUDA), ``cost_analysis``
(flops from ``FlopCounterMode``, bytes from every aten op's tensor inputs
and outputs), and a ``Timer`` and ``benchmark`` that synchronize the
result's device.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["trace", "profiled_function", "cost_analysis", "Timer", "benchmark", "TRACE_FILE"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (CPU, and CUDA when there is a GPU) and
    write ``<logdir>/trace.json`` (Chrome trace format). Yields the
    profiler, whose ``key_averages()`` and ``events()`` the caller may read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def profiled_function(fn: Callable) -> Callable:
    """Annotate a function so it shows up as a named range in traces."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        nvtx = torch.cuda.nvtx.range(fn.__name__) if torch.cuda.is_available() else contextlib.nullcontext()
        with torch.profiler.record_function(fn.__name__), nvtx:
            return fn(*args, **kwargs)

    return wrapper


class _BytesAccessed(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs (views
    included: XLA's "bytes accessed" counts each instruction's operands and
    result the same way)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs or {}, out)):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def cost_analysis(fn: Callable, *example_args, **example_kwargs) -> Dict[str, float]:
    """Flops (``torch.utils.flop_counter.FlopCounterMode``: 2 per
    multiply-add of the matmuls, convolutions and attention products) and
    bytes accessed of one call of ``fn`` on the example inputs."""
    from torch.utils.flop_counter import FlopCounterMode

    flops, moved = FlopCounterMode(display=False), _BytesAccessed()
    with flops, moved:
        fn(*example_args, **example_kwargs)
    return {"flops": float(flops.get_total_flops()), "bytes_accessed": float(moved.bytes)}


def _sync(result: Any) -> None:
    """Wait for the devices of ``result``'s tensors."""
    for t in tree_leaves(result):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


class Timer:
    """Wall-clock timer whose ``elapsed(result)`` first waits for the device
    of ``result`` (the launches are asynchronous)."""

    def __init__(self):
        self.start = time.perf_counter()

    def elapsed(self, result: Optional[Any] = None) -> float:
        if result is not None:
            _sync(result)
        return time.perf_counter() - self.start


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> float:
    """Mean seconds per call over ``iters`` calls after ``warmup``, the device
    synchronized before and after."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters
