"""Stable-Diffusion AutoencoderKL (f8, KL-regularized) in PyTorch (port of
``latte_tpu/vae/autoencoder_kl.py``).

Works in NCHW throughout. Module names follow diffusers' ``AutoencoderKL``
(``encoder.down_blocks.{i}.resnets.{j}``, ``decoder.up_blocks.{i}.upsamplers.0``,
``{side}.mid_block.attentions.0.to_q``, ``quant_conv``, ...), so a diffusers
state dict loads with ``strict=True`` (:func:`latte_tpu_torch.convert.load_vae_state_dict`).
Decoder block 0 is the deepest (512 channels), as in diffusers.

Each conv and projection computes in the type of its parameters (cast the
module with ``.to(torch.bfloat16)`` for bf16 compute, as the JAX module's
``dtype``); every GroupNorm (eps 1e-6) and the attention's logits and
softmax run in fp32 whatever that type is, as in the JAX module. Its
convolutions and GroupNorms are cuDNN's and PyTorch's (no Pallas kernel
lies on the JAX VAE either).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

__all__ = [
    "DiagonalGaussianDistribution",
    "ResnetBlock",
    "AttnBlock",
    "Downsample",
    "Upsample",
    "Encoder",
    "Decoder",
    "AutoencoderKL",
    "tiny_vae",
]

# the std of a standard normal truncated to [-2, 2]: flax's lecun_normal
# divides by it so the truncated draw keeps a variance of 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class DiagonalGaussianDistribution:
    """Posterior q(z|x) with diagonal covariance; moments (B, 2C, H, W)."""

    def __init__(self, moments: torch.Tensor, dim: int = 1):
        self.mean, self.logvar = torch.chunk(moments, 2, dim=dim)
        self.logvar = self.logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        return 0.5 * torch.sum(
            self.mean**2 + torch.exp(self.logvar) - 1.0 - self.logvar,
            dim=tuple(range(1, self.mean.dim())),
        )


class GroupNorm(nn.GroupNorm):
    """GroupNorm computed in fp32 (its output too), whatever the type of its
    input and parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps)


class Conv2d(nn.Conv2d):
    """Conv2d that casts its input to the type of its weight."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class Linear(nn.Linear):
    """Linear that casts its input to the type of its weight."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


def _norm(channels: int, groups: int) -> GroupNorm:
    return GroupNorm(groups, channels, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = _norm(in_channels, groups)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _norm(out_channels, groups)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over H·W tokens (VAE mid block)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = _norm(channels, groups)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        # C^-0.5 rounded to q's type, as JAX multiplies a low-precision q by
        # its weakly typed scale in that type
        scale = torch.tensor(C**-0.5, dtype=q.dtype).item()
        logits = torch.bmm((q * scale).float(), k.float().transpose(1, 2))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = self.to_out[0](torch.bmm(probs, v))
        return x + out.transpose(1, 2).reshape(B, C, H, W)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # SD pads (0, 1) on H and W before a stride-2 conv with no padding
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([AttnBlock(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Block(nn.Module):
    """``resnets`` then, unless it is the last block, a resampler named
    ``downsamplers`` or ``upsamplers`` (diffusers' names)."""

    def __init__(self, in_ch: int, out_ch: int, n: int, groups: int, sampler: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_ch if j == 0 else out_ch, out_ch, groups) for j in range(n)]
        )
        self.sampler = sampler
        if sampler == "downsamplers":
            self.downsamplers = nn.ModuleList([Downsample(out_ch)])
        elif sampler == "upsamplers":
            self.upsamplers = nn.ModuleList([Upsample(out_ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if self.sampler is not None:
            x = getattr(self, self.sampler)[0](x)
        return x


class Encoder(nn.Module):
    def __init__(
        self,
        block_out_channels: Sequence[int] = (128, 256, 512, 512),
        layers_per_block: int = 2,
        latent_channels: int = 4,
        in_channels: int = 3,
        groups: int = 32,
    ):
        super().__init__()
        ch = list(block_out_channels)
        self.conv_in = Conv2d(in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _Block(ch[max(i - 1, 0)], c, layers_per_block, groups,
                   "downsamplers" if i != len(ch) - 1 else None)
            for i, c in enumerate(ch)
        ])
        self.mid_block = MidBlock(ch[-1], groups)
        self.conv_norm_out = _norm(ch[-1], groups)
        self.conv_out = Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(
        self,
        block_out_channels: Sequence[int] = (128, 256, 512, 512),
        layers_per_block: int = 2,
        latent_channels: int = 4,
        out_channels: int = 3,
        groups: int = 32,
    ):
        super().__init__()
        ch = list(reversed(block_out_channels))  # (512, 512, 256, 128)
        self.conv_in = Conv2d(latent_channels, ch[0], 3, padding=1)
        self.mid_block = MidBlock(ch[0], groups)
        self.up_blocks = nn.ModuleList([
            _Block(ch[max(i - 1, 0)], c, layers_per_block + 1, groups,
                   "upsamplers" if i != len(ch) - 1 else None)
            for i, c in enumerate(ch)
        ])
        self.conv_norm_out = _norm(ch[-1], groups)
        self.conv_out = Conv2d(ch[-1], out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """SD VAE, NCHW. ``scaling_factor`` (0.18215) is exposed but NOT applied
    internally: callers multiply/divide exactly like the reference does."""

    def __init__(
        self,
        block_out_channels: Sequence[int] = (128, 256, 512, 512),
        layers_per_block: int = 2,
        latent_channels: int = 4,
        in_channels: int = 3,
        groups: int = 32,
        scaling_factor: float = 0.18215,
    ):
        super().__init__()
        self.scaling_factor = scaling_factor
        self.encoder = Encoder(block_out_channels, layers_per_block, latent_channels, in_channels, groups)
        self.decoder = Decoder(block_out_channels, layers_per_block, latent_channels, in_channels, groups)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1)

    def initialize_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's default initializers, so a random VAE has the JAX one's
        output scale: truncated-normal LeCun (``fan_in``) conv and projection
        weights, zero biases, GroupNorm scale 1 and bias 0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    std = (m.weight[0].numel() ** -0.5) / _TRUNC_STD
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, nn.GroupNorm):
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        """(B, 3, H, W) -> posterior over (B, C_lat, H/8, W/8)."""
        return DiagonalGaussianDistribution(self.quant_conv(self.encoder(x)), dim=1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, C_lat, h, w) -> (B, 3, 8h, 8w)."""
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """Decode a sample of the posterior, or its mode without a generator."""
        post = self.encode(x)
        z = post.sample(generator) if generator is not None else post.mode()
        return self.decode(z), post


def tiny_vae(**overrides) -> AutoencoderKL:
    """Small config for tests and CPU runs."""
    cfg = dict(block_out_channels=(8, 16), layers_per_block=1, groups=4)
    cfg.update(overrides)
    return AutoencoderKL(**cfg)
