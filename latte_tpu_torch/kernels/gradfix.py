"""The reference's autograd-fix ops (port of ``latte_tpu/kernels/gradfix.py``):
``conv2d`` and its transpose with ``no_weight_gradients``, a bilinear
``grid_sample`` differentiable to any order, and ``fma``. The reference
carries custom ``autograd.Function``s for these; torch's autograd of the
plain ops below gives the same gradients, and ``grid_sample`` is written
from gathers because ``F.grid_sample``'s backward is not differentiable
again in the grid.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_weight_gradients_disabled = False


@contextlib.contextmanager
def no_weight_gradients(disable: bool = True):
    """Inside this context :func:`conv2d` passes no gradient to its weights
    (the reference's regularizer passes)."""
    global _weight_gradients_disabled
    old = _weight_gradients_disabled
    if disable:
        _weight_gradients_disabled = True
    try:
        yield
    finally:
        _weight_gradients_disabled = old


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1, transpose: bool = False, output_padding: int = 0) -> torch.Tensor:
    """NCHW conv (OIHW weights) or transposed conv (IOHW weights)."""
    if _weight_gradients_disabled:
        w = w.detach()
    if not transpose:
        return F.conv2d(x, w, None, stride, padding, dilation, groups)
    return F.conv_transpose2d(x, w, None, stride, padding, output_padding, groups, dilation)


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of NCHW ``x`` at (N, Hg, Wg, 2) ``grid`` points in
    [-1, 1], ``align_corners=False``, zeros outside; differentiable to any
    order in both arguments."""
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w / 2.0) - 0.5
    gy = (grid[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0
    flat = x.reshape(n, c, h * w)

    def tap(ix, iy, weight):
        inside = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long().reshape(n, 1, -1).expand(n, c, -1)
        vals = torch.gather(flat, 2, idx).reshape(n, c, *ix.shape[1:])
        return vals * (inside.to(x.dtype) * weight)[:, None]

    return (tap(x0, y0, (1 - wx) * (1 - wy)) + tap(x0 + 1, y0, wx * (1 - wy))
            + tap(x0, y0 + 1, (1 - wx) * wy) + tap(x0 + 1, y0 + 1, wx * wy))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c (autograd unbroadcasts the gradients)."""
    return a * b + c
