"""2D convolution with FIR up/downsampling (port of
``latte_tpu/kernels/conv2d_resample.py``), the reference's generic
composition: the user's padding and the filter offsets fold into the FIR
stage before a valid convolution (padding at the conv stage would zero the
border pixels that the reference fills with FIR-filtered bleed), then a FIR
downsample.
"""

from __future__ import annotations

from typing import Optional

import torch

from latte_tpu_torch.kernels.gradfix import conv2d
from latte_tpu_torch.kernels.upfirdn import _filter_hw, _padding4, upfirdn2d


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f: Optional[torch.Tensor] = None, up: int = 1,
                    down: int = 1, padding: int = 0, groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    """(N, C, H, W) conv with optional FIR up/downsampling: ``up``
    FIR-upsamples before the conv, ``down`` FIR-downsamples after it;
    ``flip_weight=False`` is true convolution (the weights flipped)."""
    fh, fw = _filter_hw(f) if f is not None else (1, 1)
    px0, px1, py0, py1 = _padding4(padding)
    # the resampling filter's offsets fold into the padding
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    ones = torch.ones((1, 1))
    x = upfirdn2d(x, f if (up > 1 and f is not None) else ones, up=up, padding=(px0, px1, py0, py1), gain=up**2)
    if not flip_weight:
        w = w.flip((2, 3))
    x = conv2d(x, w, padding=0, groups=groups)
    if down > 1:
        x = upfirdn2d(x, f if f is not None else ones, down=down)
    return x
