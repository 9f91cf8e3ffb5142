"""C3D-UCF101, the video-Inception-Score detector, as a torch module (port
of ``latte_tpu/eval/c3d.py``).

The reference scores video IS with a torchscript C3D (``c3d_ucf101.pt``),
tgan2's chainer ``C3DVersion1UCF101``, the C3D graph of Tran et al. 2015
fine-tuned on UCF-101::

    conv1a(3->64)   - relu - pool1 (1,2,2)
    conv2a(64->128) - relu - pool2 (2,2,2)
    conv3a, conv3b (256)  - relu each - pool3 (2,2,2)
    conv4a, conv4b (512)  - relu each - pool4 (2,2,2)
    conv5a, conv5b (512)  - relu each - pool5 (2,2,2, spatial pad 1)
    fc6 (8192->4096) relu, fc7 (4096->4096) relu, fc8 (4096->101), softmax

All convs are 3x3x3, stride 1, pad 1. A 16-frame 112x112 clip flattens to
512·1·4·4 = 8192 in torch's (C, T, H, W) order. The detector resizes the
frames to 112x112 and subtracts the Sports-1M channel means (RGB order), or
the full mean tensor a checkpoint exports under ``mean``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from latte_tpu_torch.eval.i3d import _cpu, _strip, resize_bilinear, run_batches
from latte_tpu_torch.utils import resolve_device

# Sports-1M pixel means (caffe BGR order 90.25/97.66/101.41) in RGB
_C3D_MEAN_RGB = (101.41, 97.66, 90.25)
_CONVS = (("conv1a", 3, 64), ("conv2a", 64, 128), ("conv3a", 128, 256), ("conv3b", 256, 256),
          ("conv4a", 256, 512), ("conv4b", 512, 512), ("conv5a", 512, 512), ("conv5b", 512, 512))
# the pool after each conv that has one: (window = strides, spatial padding)
_POOLS = {"conv1a": ((1, 2, 2), 0), "conv2a": ((2, 2, 2), 0), "conv3b": ((2, 2, 2), 0),
          "conv4b": ((2, 2, 2), 0), "conv5b": ((2, 2, 2), 1)}


class C3D(nn.Module):
    """C3D-UCF101: input (B, 3, F, 112, 112), mean-subtracted; output (B,
    101) logits (the detector applies the softmax)."""

    def __init__(self, num_classes: int = 101):
        super().__init__()
        for name, cin, cout in _CONVS:
            setattr(self, name, nn.Conv3d(cin, cout, 3, 1, 1))
        self.fc6 = nn.Linear(8192, 4096)
        self.fc7 = nn.Linear(4096, 4096)
        self.fc8 = nn.Linear(4096, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name, _, _ in _CONVS:
            x = F.relu(getattr(self, name)(x))
            if name in _POOLS:
                window, pad = _POOLS[name]
                # pool5 pads H and W by 1; max_pool3d pads with -inf
                x = F.max_pool3d(x, window, window, (0, pad, pad))
        x = F.relu(self.fc6(x.flatten(1)))  # (C, T, H, W) order, no transpose
        return self.fc8(F.relu(self.fc7(x)))


def convert_c3d_state_dict(sd) -> Tuple[dict, np.ndarray]:
    """A torch C3D ``state_dict`` -> (:class:`C3D`'s state dict, the mean).
    Keys ``conv1a.weight`` / ``fc6.bias``, with a ``module.`` / ``model.`` /
    ``net.`` / ``c3d.`` prefix stripped. The mean is the checkpoint's
    ``mean`` tensor when it exports one (a (3,) vector or a (C, F, H, W)
    image), else the Sports-1M channel means."""
    out = {}
    mean = np.asarray(_C3D_MEAN_RGB, np.float32)
    for k, v in sd.items():
        k = _strip(k, ("module.", "model.", "net.", "c3d."))
        v = _cpu(v)
        if k == "mean":
            mean = v.numpy().astype(np.float32)
            continue
        name, leaf = k.rsplit(".", 1)
        if name.startswith(("conv", "fc")) and leaf in ("weight", "bias"):
            out[k] = v
    return out, mean


def c3d_detector(model: C3D, mean: Optional[np.ndarray] = None, device: Optional[str] = None,
                 batch_size: int = 16) -> Callable:
    """A numpy-in, numpy-out C3D detector running ``model`` on ``device``
    (``cuda`` unless named; it raises without a GPU): input (B, C, F, H, W)
    float in [0, 255]; the frames resized to 112x112
    (:func:`resize_bilinear`), the mean subtracted; returns the softmax
    class probabilities (B, 101)."""
    device = resolve_device(device)
    model = model.to(device).eval()
    mean = np.asarray(_C3D_MEAN_RGB if mean is None else mean, np.float32)
    # channel means broadcast over (B, C, F, H, W); a full mean is (C, F, H, W)
    mean_t = torch.from_numpy(mean.reshape(1, 3, 1, 1, 1) if mean.ndim == 1 else mean[None]).to(device)

    def run(x: np.ndarray, **kwargs) -> np.ndarray:
        def forward(v: torch.Tensor) -> torch.Tensor:
            b, c, f, h, w = v.shape
            v = resize_bilinear(v.transpose(1, 2).reshape(b * f, c, h, w), (112, 112))
            v = v.reshape(b, f, c, 112, 112).transpose(1, 2) - mean_t
            return torch.softmax(model(v.contiguous()), dim=1)

        return run_batches(forward, x, batch_size, device)

    return run
