"""The SD VAE of the port (counterpart of ``latte_tpu/vae``)."""

import contextlib

import torch

from latte_tpu_torch.vae.autoencoder_kl import (  # noqa: F401
    AttnBlock,
    AutoencoderKL,
    Decoder,
    DiagonalGaussianDistribution,
    Downsample,
    Encoder,
    ResnetBlock,
    Upsample,
    tiny_vae,
)


@contextlib.contextmanager
def cudnn_tf32(allow: bool):
    """cuDNN's TF32 set to ``allow`` for the block and restored after it.
    Every other cuDNN setting stays as the caller left it, which
    ``torch.backends.cudnn.flags()`` would not do: it sets all of them, to
    its defaults where not given."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def make_decode_fn(vae: AutoencoderKL):
    """The plain-VAE decode: (N, 4, h, w) latents (already /0.18215-scaled
    by the caller) -> (N, 3, H, W), under ``torch.inference_mode`` and with
    cuDNN's TF32 off for the call alone (``cudnn.allow_tf32`` defaults to
    True), so an fp32 VAE computes in fp32 as the JAX decode does."""

    def decode(z: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), cudnn_tf32(False):
            return vae.decode(z)

    return decode
