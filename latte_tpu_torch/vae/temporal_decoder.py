"""SVD's temporal VAE decoder (the decoder of diffusers'
``AutoencoderKLTemporalDecoder``) in PyTorch (port of
``latte_tpu/vae/temporal_decoder.py``).

The SD decoder's spatial resnets are each blended with a temporal resnet
over the frame axis, ``(1 − σ(mix))·spatial + σ(mix)·temporal`` with a
learned ``mix_factor`` (σ taken in fp32, the blend in fp32 as in JAX), and
a (3, 1, 1) convolution over the output frames (``time_conv_out``) follows
``conv_out``. The temporal convolutions see the ``num_frames`` frames of
one clip: the input is (B·F, C, h, w) with F = ``num_frames``, and nothing
crosses from one clip to the next.

Module names are diffusers' (``conv_in``, ``mid_block.resnets.{0,1}.
{spatial_res_block,temporal_res_block,time_mixer.mix_factor}``,
``mid_block.attentions.0``, ``up_blocks.{i}.resnets.{j}``,
``up_blocks.{i}.upsamplers.0.conv``, ``conv_norm_out``, ``conv_out``,
``time_conv_out``), as ``latte_tpu/tools/convert_vae.py`` reads them, so a
diffusers state dict loads with ``strict=True``
(:func:`latte_tpu_torch.convert.load_temporal_decoder_state_dict`). It
reuses the SD VAE's ``ResnetBlock``, ``AttnBlock`` and ``Upsample``: every
GroupNorm runs in fp32, each convolution in the type of its weights (cuDNN;
the JAX decoder is XLA convolutions, no Pallas kernel).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from latte_tpu_torch.models.layers import _Fp32Scales
from latte_tpu_torch.vae.autoencoder_kl import _TRUNC_STD, AttnBlock, Conv2d, ResnetBlock, Upsample, _norm

__all__ = ["TemporalResnetBlock", "SpatioTemporalResBlock", "TemporalDecoder", "tiny_temporal_decoder"]


class Conv3d(nn.Conv3d):
    """Conv3d that casts its input to the type of its weight."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


def _frames(x: torch.Tensor, num_frames: int) -> torch.Tensor:
    """(B·F, C, H, W) -> (B, C, F, H, W)."""
    BF, C, H, W = x.shape
    return x.view(BF // num_frames, num_frames, C, H, W).transpose(1, 2)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, C, F, H, W) -> (B·F, C, H, W)."""
    B, C, Fr, H, W = x.shape
    return x.transpose(1, 2).reshape(B * Fr, C, H, W)


class TemporalResnetBlock(nn.Module):
    """Resnet over the frame axis of (B, C, F, H, W): GroupNorm (fp32), SiLU,
    a (3, 1, 1) conv with (1, 0, 0) padding, twice; a (1, 1, 1) shortcut
    where the widths differ."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = _norm(in_channels, groups)
        self.conv1 = Conv3d(in_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))
        self.norm2 = _norm(out_channels, groups)
        self.conv2 = Conv3d(out_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))
        self.conv_shortcut = Conv3d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AlphaBlender(_Fp32Scales):
    """The learned mix factor (diffusers' ``time_mixer``); it stays fp32 when
    the decoder is cast, as the JAX decoder keeps its parameters fp32."""

    FP32_BUFFERS = ("mix_factor",)

    def __init__(self, merge_factor: float = 0.0):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor([merge_factor]))


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32, merge_factor: float = 0.0):
        super().__init__()
        self.spatial_res_block = ResnetBlock(in_channels, out_channels, groups)
        self.temporal_res_block = TemporalResnetBlock(out_channels, out_channels, groups)
        self.time_mixer = AlphaBlender(merge_factor)

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        spatial = _frames(self.spatial_res_block(x), num_frames)
        temporal = self.temporal_res_block(spatial)
        dtype = torch.promote_types(spatial.dtype, torch.float32)  # fp32, or fp64 in an fp64 decoder
        alpha = torch.sigmoid(self.time_mixer.mix_factor.to(dtype))[0]
        return _flat((1.0 - alpha) * spatial.to(dtype) + alpha * temporal.to(dtype))


class MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([SpatioTemporalResBlock(channels, channels, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([AttnBlock(channels, groups)])

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        x = self.resnets[0](x, num_frames)
        return self.resnets[1](self.attentions[0](x), num_frames)


class UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n: int, groups: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(in_ch if j == 0 else out_ch, out_ch, groups) for j in range(n)]
        )
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample(out_ch)])

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        for r in self.resnets:
            x = r(x, num_frames)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class TemporalDecoder(nn.Module):
    """(B·F, C_lat, h, w) latents -> (B·F, 3, 8h, 8w) pixels (with 4 blocks;
    one upsampling fewer per block fewer)."""

    def __init__(
        self,
        in_channels: int = 4,
        out_channels: int = 3,
        block_out_channels: Sequence[int] = (128, 256, 512, 512),
        layers_per_block: int = 3,
        groups: int = 32,
    ):
        super().__init__()
        ch = list(reversed(block_out_channels))  # (512, 512, 256, 128)
        self.conv_in = Conv2d(in_channels, ch[0], 3, padding=1)
        self.mid_block = MidBlock(ch[0], groups)
        self.up_blocks = nn.ModuleList([
            UpBlock(ch[max(i - 1, 0)], c, layers_per_block, groups, i != len(ch) - 1)
            for i, c in enumerate(ch)
        ])
        self.conv_norm_out = _norm(ch[-1], groups)
        self.conv_out = Conv2d(ch[-1], out_channels, 3, padding=1)
        self.time_conv_out = Conv3d(out_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's default initializers (as ``AutoencoderKL.initialize_weights``):
        truncated-normal LeCun conv and projection weights, zero biases,
        GroupNorm 1 and 0, mix factors 0 (σ = 0.5, both branches alike)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                std = (m.weight[0].numel() ** -0.5) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, AlphaBlender):
                nn.init.zeros_(m.mix_factor)

    def decode(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        """(B·F, C_lat, h, w), F = ``num_frames`` -> (B·F, 3, H, W), in the
        type of ``conv_out``'s output (fp32 GroupNorm before it)."""
        h = self.mid_block(self.conv_in(z), num_frames)
        for blk in self.up_blocks:
            h = blk(h, num_frames)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return _flat(self.time_conv_out(_frames(h, num_frames)))

    def forward(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        return self.decode(z, num_frames)


def tiny_temporal_decoder(**overrides) -> TemporalDecoder:
    """Small config for tests and CPU runs (the JAX package's)."""
    cfg = dict(block_out_channels=(8, 16), layers_per_block=1, groups=4)
    cfg.update(overrides)
    return TemporalDecoder(**cfg)
