"""InceptionV3 in its FID pool3 form, the FID/KID/IS detector, as a torch
module (port of ``latte_tpu/eval/inception.py``).

The reference computes FID/KID/IS with the Inception-2015 torchscript
(``inception-2015-12-05.pt``); its portable form is the pytorch-fid layout:
torchvision's InceptionV3 module names with the TF pooling quirks (average
pools exclude the padding; the last block's pool branch is a max pool).

- :class:`FIDInceptionV3`: input (B, 3, 299, 299) in [-1, 1], output the
  pool3 features (B, 2048) and the 1008 logits.
- :func:`convert_inception_state_dict`: a torchvision / pytorch-fid
  ``state_dict`` -> this module's.
- :func:`inception_detector`: numpy in, numpy out, with the torchscript
  calling convention (``return_features``, ``no_output_bias``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from latte_tpu_torch.eval.i3d import _BN_LEAVES, EvalBatchNorm, _cpu, _strip, resize_bilinear, run_batches
from latte_tpu_torch.utils import resolve_device


class ConvBN(nn.Module):
    """Conv2d (no bias) + BN (eps 1e-3) + ReLU; symmetric padding (ph, pw)."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1), strides=(1, 1), padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, strides, padding, bias=False)
        self.bn = EvalBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_excl(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, padding 1, divided by the valid taps (the
    TF-matching quirk of pytorch-fid)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64)
        self.branch5x5_1 = ConvBN(cin, 48)
        self.branch5x5_2 = ConvBN(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = ConvBN(cin, 64)
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = ConvBN(cin, pool_features)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_3x3_excl(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, (3, 3), (2, 2))
        self.branch3x3dbl_1 = ConvBN(cin, 64)
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), (2, 2))

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 192)
        self.branch7x7_1 = ConvBN(cin, c7)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(cin, c7)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(cin, 192)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for name in ("branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5"):
            bd = getattr(self, name)(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_3x3_excl(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192)
        self.branch3x3_2 = ConvBN(192, 320, (3, 3), (2, 2))
        self.branch7x7x3_1 = ConvBN(cin, 192)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, (3, 3), (2, 2))

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    """pytorch-fid's quirk: Mixed_7b pools with the padding-excluding
    average, Mixed_7c (the block that feeds pool3) with max."""

    def __init__(self, cin: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = ConvBN(cin, 320)
        self.branch3x3_1 = ConvBN(cin, 384)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(cin, 448)
        self.branch3x3dbl_2 = ConvBN(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(cin, 192)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool_mode == "max" else _avg_pool_3x3_excl(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class FIDInceptionV3(nn.Module):
    """Input (B, 3, 299, 299) in [-1, 1] -> (pool3 (B, 2048), logits (B, n));
    ``num_logits=1008``, the 2015 graph's softmax width. The logits carry
    ``fc``'s bias unless ``output_bias=False`` (the IS protocol's call)."""

    def __init__(self, num_logits: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBN(3, 32, (3, 3), (2, 2))
        self.Conv2d_2a_3x3 = ConvBN(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = ConvBN(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = ConvBN(64, 80)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, num_logits)

    def forward(self, x: torch.Tensor, output_bias: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
                     "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool3 = x.mean(dim=(2, 3))  # global average pool -> (B, 2048)
        return pool3, F.linear(pool3, self.fc.weight, self.fc.bias if output_bias else None)


def convert_inception_state_dict(sd) -> dict:
    """A torchvision / pytorch-fid ``state_dict`` -> :class:`FIDInceptionV3`'s.
    Keys like ``Mixed_5b.branch1x1.conv.weight`` and ``...bn.{weight, bias,
    running_mean, running_var}``, and ``fc.weight`` / ``fc.bias``; a
    ``module.`` / ``inception.`` / ``net.`` / ``model.`` prefix is stripped.
    Other keys (torchvision's ``AuxLogits``, ``num_batches_tracked``) are
    dropped."""
    out = {}
    for k, v in sd.items():
        parts = _strip(k, ("module.", "inception.", "net.", "model.")).split(".")
        leaf, mid = parts[-1], parts[:-1]
        keep = (parts[0] == "fc" and leaf in ("weight", "bias")) or (
            parts[0] != "AuxLogits" and mid and ((mid[-1] == "conv" and leaf == "weight")
                                                 or (mid[-1] == "bn" and leaf in _BN_LEAVES)))
        if keep:
            out[".".join(parts)] = _cpu(v)
    return out


def inception_detector(model: FIDInceptionV3, device: Optional[str] = None, batch_size: int = 32) -> Callable:
    """A numpy-in, numpy-out detector running ``model`` on ``device``
    (``cuda`` unless named; it raises without a GPU), with the torchscript
    calling convention: input (B, C, H, W) float in [0, 255], scaled to
    [-1, 1] and resized to 299x299 (:func:`resize_bilinear`);
    ``return_features=True`` returns pool3 (B, 2048), otherwise the softmax
    probabilities, without the output layer's bias under
    ``no_output_bias=True`` (the IS protocol's call)."""
    device = resolve_device(device)
    model = model.to(device).eval()

    def run(x: np.ndarray, return_features=False, no_output_bias=False, **kwargs) -> np.ndarray:
        def forward(v: torch.Tensor) -> torch.Tensor:
            v = resize_bilinear(v * (2.0 / 255.0) - 1.0, (299, 299))
            pool3, logits = model(v, output_bias=not no_output_bias)
            return pool3 if return_features else torch.softmax(logits, dim=1)

        return run_batches(forward, x, batch_size, device)

    return run
