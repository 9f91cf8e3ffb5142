"""upfirdn2d (upsample, FIR filter, downsample), port of
``latte_tpu/kernels/upfirdn.py``: ``upfirdn2d`` and the ``setup_filter`` /
``filter2d`` / ``upsample2d`` / ``downsample2d`` helpers with the
reference's padding conventions. Plain torch: the zero-stuffed input
through one grouped ``F.conv2d`` (cuDNN on the card), as the JAX code is
one ``lax.conv_general_dilated``. No Pallas kernel stands behind it.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

IntPair = Union[int, Tuple[int, int], Sequence[int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        assert len(v) == 2
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _padding4(v) -> Tuple[int, int, int, int]:
    if isinstance(v, int):
        return v, v, v, v
    v = tuple(int(x) for x in v)
    if len(v) == 2:
        # the reference's [padx, pady] -> (padx0, padx1, pady0, pady1)
        return v[0], v[0], v[1], v[1]
    assert len(v) == 4
    return v


def _filter_hw(f) -> Tuple[int, int]:
    f = torch.as_tensor(f)
    return (f.shape[0], f.shape[0]) if f.ndim == 1 else tuple(f.shape)


def setup_filter(f, normalize: bool = True, flip_filter: bool = False, gain: float = 1.0,
                 separable=None) -> torch.Tensor:
    """A FIR filter as a 2D fp32 kernel: 1D taps become their outer product,
    normalized to sum 1, optionally flipped, times ``gain``."""
    f = torch.as_tensor(f, dtype=torch.float32)
    if f.ndim == 0:
        f = f[None]
    if f.ndim == 1:
        f = torch.outer(f, f)
    assert f.ndim == 2
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip((0, 1))
    return f * (gain ** (f.ndim / 2))


def upfirdn2d(x: torch.Tensor, f, up: IntPair = 1, down: IntPair = 1, padding=0,
              flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """(N, C, H, W): zero-stuff by ``up`` (to H·up, W·up), pad (negative
    crops), correlate with the flipped filter (``flip_filter``: the filter
    as given), keep every ``down``-th sample, times ``gain``."""
    upx, upy = _pair(up)
    downx, downy = _pair(down)
    padx0, padx1, pady0, pady1 = _padding4(padding)
    f = torch.ones((1, 1)) if f is None else torch.as_tensor(f, dtype=torch.float32)
    if f.ndim == 1:
        f = torch.outer(f, f)
    if not flip_filter:  # convolution is correlation with the flipped kernel
        f = f.flip((0, 1))
    n, c, h, w = x.shape
    if upx > 1 or upy > 1:
        stuffed = x.new_zeros((n, c, h * upy, w * upx))
        stuffed[:, :, ::upy, ::upx] = x
        x = stuffed
    x = F.pad(x, (padx0, padx1, pady0, pady1))
    kernel = f.to(x)[None, None].repeat(c, 1, 1, 1)  # (C, 1, fh, fw)
    return F.conv2d(x, kernel, stride=(downy, downx), groups=c) * gain


def filter2d(x, f, padding=0, flip_filter=False, gain: float = 1.0):
    """Filter without resampling; the default padding keeps the size."""
    fh, fw = _filter_hw(f)
    padx0, padx1, pady0, pady1 = _padding4(padding)
    return upfirdn2d(x, f, padding=(padx0 + fw // 2, padx1 + (fw - 1) // 2, pady0 + fh // 2,
                                    pady1 + (fh - 1) // 2), flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up: IntPair = 2, padding=0, flip_filter=False, gain: float = 1.0):
    upx, upy = _pair(up)
    fh, fw = _filter_hw(f)
    padx0, padx1, pady0, pady1 = _padding4(padding)
    return upfirdn2d(x, f, up=up, padding=(padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
                                           pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2),
                     flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down: IntPair = 2, padding=0, flip_filter=False, gain: float = 1.0):
    downx, downy = _pair(down)
    fh, fw = _filter_hw(f)
    padx0, padx1, pady0, pady1 = _padding4(padding)
    return upfirdn2d(x, f, down=down, padding=(padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
                                               pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2),
                     flip_filter=flip_filter, gain=gain)
