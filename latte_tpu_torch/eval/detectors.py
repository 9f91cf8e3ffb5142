"""Feature detectors for the metrics (port of ``latte_tpu/eval/detectors.py``).

The reference downloads three torchscript detectors: I3D Kinetics-400
(FVD), Inception-2015 (FID/KID/IS) and C3D-UCF101 (video IS). Here they
load from a local directory (``LATTE_TPU_DETECTORS`` or an explicit path):
each file's ``state_dict`` goes into the port's own module (:mod:`.i3d`,
:mod:`.inception`, :mod:`.c3d`), which runs on a device, the card unless
the caller names another. The metrics take any injected callable too.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

DETECTOR_FILES = {
    "i3d": "i3d_torchscript.pt",
    "inception": "inception-2015-12-05.pt",
    "c3d": "c3d_ucf101.pt",
}


def detectors_dir() -> Optional[str]:
    return os.environ.get("LATTE_TPU_DETECTORS")


def _detector_path(name: str, path: Optional[str]) -> str:
    if path is not None:
        return path
    d = detectors_dir()
    if d is None:
        raise FileNotFoundError(
            f"detector {name!r} unavailable: set LATTE_TPU_DETECTORS to a directory containing "
            f"{DETECTOR_FILES[name]} (the reference downloads it; the repository does not carry it)"
        )
    return os.path.join(d, DETECTOR_FILES[name])


def load_detector(name: str, path: Optional[str] = None, device: Optional[str] = None) -> Callable:
    """The detector ``name`` (i3d, inception or c3d) on ``device``, the card
    unless named: the reference's torchscript file's ``state_dict`` through
    the converter into the port's own module (:mod:`.i3d`,
    :mod:`.inception`, :mod:`.c3d`)."""
    sd = torch.jit.load(_detector_path(name, path), map_location="cpu").state_dict()
    if name == "i3d":
        from latte_tpu_torch.eval.i3d import InceptionI3d, convert_i3d_state_dict, i3d_detector

        model = InceptionI3d()
        model.load_state_dict(convert_i3d_state_dict(sd))
        return i3d_detector(model, device)
    if name == "c3d":
        from latte_tpu_torch.eval.c3d import C3D, c3d_detector, convert_c3d_state_dict

        params, mean = convert_c3d_state_dict(sd)
        model = C3D()
        model.load_state_dict(params)
        return c3d_detector(model, mean, device)
    from latte_tpu_torch.eval.inception import FIDInceptionV3, convert_inception_state_dict, inception_detector

    params = convert_inception_state_dict(sd)
    model = FIDInceptionV3(num_logits=params["fc.weight"].shape[0])
    model.load_state_dict(params)
    return inception_detector(model, device)


def i3d_features(detector: Callable, videos: np.ndarray) -> np.ndarray:
    """(B, F, H, W, 3) uint8 -> I3D logits/features (B, 400); the
    torchscript I3D takes (B, C, F, H, W) float and the canonical kwargs."""
    x = videos.astype(np.float32).transpose(0, 4, 1, 2, 3)
    return detector(x, rescale=True, resize=True, return_features=True)


def inception_features(detector: Callable, images: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 -> pool3 features (B, 2048)."""
    x = images.transpose(0, 3, 1, 2)
    return detector(x, return_features=True)


def inception_probs(detector: Callable, images: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 -> class probabilities. The IS protocol calls the
    Inception detector with ``no_output_bias=True`` (the original OpenAI
    implementation's probabilities), not for the pool3 features."""
    x = images.transpose(0, 3, 1, 2)
    return detector(x, no_output_bias=True)


def c3d_probs(detector: Callable, videos: np.ndarray) -> np.ndarray:
    """(B, F, H, W, 3) uint8 -> class probabilities (B, 101)."""
    x = videos.astype(np.float32).transpose(0, 4, 1, 2, 3)
    return detector(x)


def standin_detector(feature_dim: int = 400, seed: int = 0) -> Callable:
    """The deterministic stand-in detector (numpy, the JAX package's): a
    fixed-seed random projection of a pooled 8x8x8 grid of the pixels, so
    the whole metric chain (frames -> dataset windows -> fp64 stats ->
    cache -> Fréchet/KID/IS -> JSONL) runs without the real detectors.
    Its numbers are protocol artifacts, not comparable to published
    FVD/FID.

    Takes video (B, C, F, H, W) or image (B, C, H, W) float arrays and
    ignores the torchscript kwargs but ``return_features``; returns (B,
    feature_dim) float32 features (tanh) or softmax probabilities."""
    rng = np.random.default_rng(seed)
    grid = 8  # pooled (F, H, W) -> (grid, grid, grid)
    proj = rng.standard_normal((3 * grid**3, feature_dim)).astype(np.float64)
    proj /= np.sqrt(proj.shape[0])

    def run(x: np.ndarray, **kwargs) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if x.ndim == 4:  # image: fake a single frame
            x = x[:, :, None]
        B, C, F, H, W = x.shape
        if x.max() > 2.0:  # raw 0..255 input (rescale=True semantics)
            x = x / 255.0
        fi = np.linspace(0, F - 1, grid).round().astype(int)
        hi = np.linspace(0, H - 1, grid).round().astype(int)
        wi = np.linspace(0, W - 1, grid).round().astype(int)
        sub = x[:, :, fi][:, :, :, hi][:, :, :, :, wi]  # (B, C, g, g, g)
        flat = sub.reshape(B, -1) - 0.5
        logits = flat @ proj
        if kwargs.get("return_features"):
            return np.tanh(logits).astype(np.float32)
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)

    return run


def get_detector(spec: str, role: str, device: Optional[str] = None) -> Callable:
    """A CLI detector spec: 'auto' (the file in LATTE_TPU_DETECTORS),
    'standin' / 'standin:<seed>', or a torchscript file path."""
    if spec in (None, "", "auto"):
        return load_detector(role, device=device)
    if spec == "standin" or spec.startswith("standin:"):
        seed = int(spec.split(":", 1)[1]) if ":" in spec else 0
        return standin_detector(seed=seed)
    return load_detector(role, path=spec, device=device)
