"""I3D (Inflated 3D Inception, Kinetics-400), the FVD detector, as a torch
module (port of ``latte_tpu/eval/i3d.py``).

The reference computes FVD with StyleGAN-V's torchscript I3D
(``i3d_torchscript.pt``), the standard InceptionI3d graph in the
pytorch-i3d layout: Unit3D = Conv3d (no bias, TF-SAME) + BatchNorm (eps
1e-3) + ReLU, four-branch inception modules, and a 400-way logits head
whose output FVD takes as the feature vector (``return_features=True``).

- :class:`InceptionI3d`: the network, NCDHW, eval mode, under the
  pytorch-i3d module names (``Mixed_4b.b1a.conv3d.weight``, ...).
- :func:`convert_i3d_state_dict`: a pytorch-i3d or torchscript
  ``state_dict`` -> this module's.
- :func:`i3d_detector`: numpy in, numpy out, with the torchscript calling
  convention (``rescale``, ``resize``, ``return_features``), on a device.

The pieces the three detectors share live here too: :class:`EvalBatchNorm`,
:func:`resize_bilinear` and :func:`run_batches`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from latte_tpu_torch.utils import resolve_device


class EvalBatchNorm(nn.Module):
    """BatchNorm in eval mode: ``weight``, ``bias``, ``running_mean`` and
    ``running_var`` under BatchNorm's names, without ``num_batches_tracked``
    (the detectors only run inference from converted weights)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


def _interpolate(x: torch.Tensor, size: Tuple[int, int], antialias: bool) -> torch.Tensor:
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=antialias)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, *size) as ``jax.image.resize(..., "bilinear")``
    computes it, which the JAX detectors use: the triangle filter with
    half-pixel centres, widened along an axis that shrinks (antialiasing)
    and not along one that grows. ``F.interpolate`` has one antialias flag
    for both axes, so an image that shrinks along one and grows along the
    other is resized one axis at a time (the filter is separable)."""
    (h, w), (oh, ow) = x.shape[-2:], size
    if (oh, ow) == (h, w):
        return x
    if (oh < h and ow > w) or (oh > h and ow < w):
        return _interpolate(_interpolate(x, (oh, w), oh < h), (oh, ow), ow < w)
    return _interpolate(x, (oh, ow), oh < h or ow < w)


def run_batches(forward: Callable, x: np.ndarray, batch_size: int, device: torch.device) -> np.ndarray:
    """``forward`` over ``x`` (numpy) in chunks of ``batch_size`` rows on
    ``device``, in fp32 with cuDNN's TF32 off, without autograd; the rows'
    outputs concatenated as fp32 numpy. No chunk is padded: under eval
    BatchNorm the rows are independent."""
    from latte_tpu_torch.vae import cudnn_tf32

    x = np.asarray(x, np.float32)
    outs = []
    with torch.inference_mode(), cudnn_tf32(False):
        for i in range(0, x.shape[0], batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(x[i : i + batch_size])).to(device)
            outs.append(forward(chunk).float().cpu().numpy())
    return np.concatenate(outs, axis=0).astype(np.float32)


def same_pads(sizes: Sequence[int], kernel: Sequence[int], strides: Sequence[int]):
    """TF-SAME padding (low, high) a dimension: total = max((ceil(n/s) - 1)
    s + k - n, 0), low = total // 2, the rest high (as Flax's "SAME")."""
    pads = []
    for n, k, s in zip(sizes, kernel, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _f_pad(pads) -> Tuple[int, ...]:
    """Per-dimension (low, high) pairs -> ``F.pad``'s last-dimension-first list."""
    return tuple(p for lo_hi in reversed(pads) for p in lo_hi)


class Unit3D(nn.Module):
    """Conv3d (TF-SAME, no bias) + BN (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), strides=(1, 1, 1), use_bn: bool = True,
                 activation: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.strides, self.activation = tuple(kernel), tuple(strides), activation
        self.conv3d = nn.Conv3d(cin, cout, self.kernel, self.strides, bias=use_bias)
        self.bn = EvalBatchNorm(cout) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = same_pads(x.shape[2:], self.kernel, self.strides)
        if all(lo == hi for lo, hi in pads):  # the conv pads symmetric cases itself
            x = F.conv3d(x, self.conv3d.weight, self.conv3d.bias, self.strides, [lo for lo, _ in pads])
        else:
            x = self.conv3d(F.pad(x, _f_pad(pads)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


def max_pool_same(x: torch.Tensor, window: Sequence[int], strides: Sequence[int]) -> torch.Tensor:
    """3D max pool, TF-SAME, padding with -inf (as Flax's ``max_pool``)."""
    pads = same_pads(x.shape[2:], window, strides)
    if any(lo != hi for lo, hi in pads):
        x = F.pad(x, _f_pad(pads), value=float("-inf"))
        pads = [(0, 0)] * 3
    return F.max_pool3d(x, tuple(window), tuple(strides), [lo for lo, _ in pads])


class InceptionModule(nn.Module):
    """Four-branch 3D inception block; ``out`` = [b0, b1a, b1b, b2a, b2b, b3b]."""

    def __init__(self, cin: int, out: Sequence[int]):
        super().__init__()
        self.b0 = Unit3D(cin, out[0])
        self.b1a = Unit3D(cin, out[1])
        self.b1b = Unit3D(out[1], out[2], kernel=(3, 3, 3))
        self.b2a = Unit3D(cin, out[3])
        self.b2b = Unit3D(out[3], out[4], kernel=(3, 3, 3))
        self.b3b = Unit3D(cin, out[5])
        self.out_channels = out[0] + out[2] + out[4] + out[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.b0(x),
            self.b1b(self.b1a(x)),
            self.b2b(self.b2a(x)),
            self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1))),
        ], dim=1)


_MIXED_SPECS = {
    "Mixed_3b": [64, 96, 128, 16, 32, 32],
    "Mixed_3c": [128, 128, 192, 32, 96, 64],
    "Mixed_4b": [192, 96, 208, 16, 48, 64],
    "Mixed_4c": [160, 112, 224, 24, 64, 64],
    "Mixed_4d": [128, 128, 256, 24, 64, 64],
    "Mixed_4e": [112, 144, 288, 32, 64, 64],
    "Mixed_4f": [256, 160, 320, 32, 128, 128],
    "Mixed_5b": [256, 160, 320, 32, 128, 128],
    "Mixed_5c": [384, 192, 384, 48, 128, 128],
}
# the pools between the inception stages: (before endpoint, window, strides)
_POOLS = {"Mixed_4b": ((3, 3, 3), (2, 2, 2)), "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class InceptionI3d(nn.Module):
    """Kinetics-400 I3D; input (B, 3, F, H, W) in [-1, 1], output (B, 400)
    logits, the FVD feature vector."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, kernel=(7, 7, 7), strides=(2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, kernel=(3, 3, 3))
        cin = 192
        for name, spec in _MIXED_SPECS.items():
            module = InceptionModule(cin, spec)
            setattr(self, name, module)
            cin = module.out_channels
        self.logits = Unit3D(cin, num_classes, use_bn=False, activation=False, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_2a_3x3
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_3a_3x3
        for name in _MIXED_SPECS:
            if name in _POOLS:  # MaxPool3d_4a_3x3, MaxPool3d_5a_2x2
                x = max_pool_same(x, *_POOLS[name])
            x = getattr(self, name)(x)
        # the logits head: VALID avg pool (2, 7, 7) stride 1, a 1x1x1 conv
        # with bias (no BN, no ReLU), the mean over what remains
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        return self.logits(x).mean(dim=(2, 3, 4))


def _cpu(v) -> torch.Tensor:
    """A state dict's value (a tensor on any device, or an array) on the CPU."""
    return torch.as_tensor(v).detach().cpu()


def _strip(key: str, prefixes: Sequence[str]) -> str:
    for pre in prefixes:
        if key.startswith(pre):
            key = key[len(pre):]
    return key


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")  # num_batches_tracked is dropped


def convert_i3d_state_dict(sd) -> dict:
    """A torch I3D ``state_dict`` (``torch.jit.load(path).state_dict()`` or
    an eager pytorch-i3d model) -> :class:`InceptionI3d`'s. Accepts the
    JAX converter's variants: a ``module.`` / ``i3d.`` / ``net.`` /
    ``model.`` prefix on every key, the eager head's ``Logits.conv3d``;
    keys of neither a conv nor a BatchNorm are dropped."""
    out = {}
    for k, v in sd.items():
        parts = _strip(k, ("module.", "i3d.", "net.", "model.")).split(".")
        if parts[0] == "Logits":
            parts[0] = "logits"
        leaf, mid = parts[-1], parts[1:-1]
        if mid and ((mid[-1] == "conv3d" and leaf in ("weight", "bias")) or (mid[-1] == "bn" and leaf in _BN_LEAVES)):
            out[".".join(parts)] = _cpu(v)
    return out


def i3d_detector(model: InceptionI3d, device: Optional[str] = None, batch_size: int = 16) -> Callable:
    """A numpy-in, numpy-out detector running ``model`` on ``device``
    (``cuda`` unless the caller names another; without a GPU it raises).
    The torchscript convention: input (B, C, F, H, W) float; ``rescale``
    maps [0, 255] to [-1, 1]; ``resize`` resizes the frames to 224x224
    (:func:`resize_bilinear`); ``return_features`` returns the 400 logits,
    else their softmax."""
    device = resolve_device(device)
    model = model.to(device).eval()

    def run(x: np.ndarray, rescale=False, resize=False, return_features=True) -> np.ndarray:
        def forward(v: torch.Tensor) -> torch.Tensor:
            if rescale:
                v = v * (2.0 / 255.0) - 1.0
            if resize:
                b, c, f, h, w = v.shape
                v = resize_bilinear(v.transpose(1, 2).reshape(b * f, c, h, w), (224, 224))
                v = v.reshape(b, f, c, 224, 224).transpose(1, 2).contiguous()
            logits = model(v)
            return logits if return_features else torch.softmax(logits, dim=1)

        return run_batches(forward, x, batch_size, device)

    return run
