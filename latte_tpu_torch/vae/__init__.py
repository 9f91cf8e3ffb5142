"""The SD VAE of the port (counterpart of ``latte_tpu/vae``): the module,
the constructor that the sampler and the trainer share, the sampler's decode
and the trainer's encode; and SVD's temporal decoder
(:mod:`latte_tpu_torch.vae.temporal_decoder`)."""

import contextlib
import os

import torch

from latte_tpu_torch.convert import load_vae_state_dict

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
from latte_tpu_torch.vae.temporal_decoder import TemporalDecoder, tiny_temporal_decoder  # noqa: F401


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


def build_vae(vae_ckpt: str, device, tiny: bool = False) -> AutoencoderKL:
    """The VAE in fp32 and eval mode on ``device``: ``tiny`` (a tiny VAE) or
    ``vae_ckpt == "random"`` (the full SD architecture) with seeded random
    weights from ``torch.Generator`` seed 0, else ``vae_ckpt``, a diffusers
    ``AutoencoderKL`` state dict file, loaded with ``strict=True``. A
    directory (the JAX package's orbax VAE, or a diffusers model folder)
    raises ``NotImplementedError`` naming the conversion."""
    if not tiny and vae_ckpt != "random" and os.path.isdir(vae_ckpt):
        raise NotImplementedError(
            f"vae_ckpt {vae_ckpt!r} is a directory; the port reads a diffusers AutoencoderKL "
            "state dict file. For the JAX package's orbax VAE, convert its params in a "
            "process that has JAX with latte_tpu_torch.convert.flax_vae_to_state_dict and "
            "torch.save the state dict it returns; for a diffusers model folder, give its "
            "diffusion_pytorch_model.bin"
        )
    with torch.device(device):
        vae = tiny_vae() if tiny else AutoencoderKL()
    if tiny or vae_ckpt == "random":
        vae.initialize_weights(torch.Generator(device=device).manual_seed(0))
    else:
        vae.load_state_dict(load_vae_state_dict(vae_ckpt), strict=True)
    return vae.eval()


def make_encode_fn(vae: AutoencoderKL):
    """The trainer's encode: (N, 3, H, W) pixels in [-1, 1] -> the posterior
    (``DiagonalGaussianDistribution``), in fp32 under ``torch.no_grad`` and
    with cuDNN's TF32 off for the call alone, as the JAX encode computes.
    Not ``inference_mode``: the latents feed the loss, whose backward saves
    products of them with the model's outputs, and an inference tensor
    cannot be saved for backward."""

    def encode(x: torch.Tensor) -> DiagonalGaussianDistribution:
        with torch.no_grad(), cudnn_tf32(False):
            return vae.encode(x.float())

    return encode


def make_decode_fn(vae: AutoencoderKL):
    """The plain-VAE decode: (N, 4, h, w) latents (already /0.18215-scaled
    by the caller) -> (N, 3, H, W), under ``torch.inference_mode`` and with
    cuDNN's TF32 off for the call alone (``cudnn.allow_tf32`` defaults to
    True), so an fp32 VAE computes in fp32 as the JAX decode does."""

    def decode(z: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), cudnn_tf32(False):
            return vae.decode(z)

    return decode
