"""Transformer building blocks of the Latte DiT family (port of
``latte_tpu/models/layers.py``, floating-point path).

Module and parameter names follow the reference state dict
(``blocks.{i}.attn.qkv``, ``blocks.{i}.adaLN_modulation.1``, ...), and the
fused qkv projection keeps the reference's ``[q|k|v]`` row layout.

Attention and the block's LayerNorm/modulate/residual glue always go through
the hand-written kernels' wrappers (:mod:`latte_tpu_torch.kernels`), which
launch the CUDA kernels for CUDA tensors and run the plain versions for CPU
tensors. ``plain=True`` runs the plain versions on any device (for attention
both its forward and its backward); it exists so a run on the card can hold
the kernel path against the plain one.
The int8, ring-attention and MoE branches of the JAX blocks are not ported.

Every projection is a :class:`Linear` that computes in the type of its
input: its weights are cast per call, so a model with fp32 parameters and
bf16 activations computes in bf16 and its gradients reach the fp32
parameters (the JAX modules' ``dtype`` against ``param_dtype``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from latte_tpu_torch.kernels import (
    attention_qkv,
    ln_modulate,
    ln_modulate_reference,
    residual_ln_modulate,
    residual_ln_modulate_reference,
)

__all__ = [
    "Linear",
    "modulate",
    "layer_norm",
    "Mlp",
    "Attention",
    "AdaLNBlock",
    "FinalLayer",
    "PatchEmbed",
    "unpatchify",
]


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation; shift/scale are (B, D), x is (B, N, D)."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine terms: fp32 two-pass statistics, result in x's type."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's type (a no-op cast when the
    parameters already have it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Mlp(nn.Module):
    """Linear -> gelu(tanh) -> Linear."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Attention(nn.Module):
    """Multi-head self-attention through the flash-attention kernels."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, plain: bool = False):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.plain = plain
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        # [q|k|v] rows: q, k, v are strided (B, N, H, hd) views of one tensor,
        # which the kernels read in place; the backward writes its gradient
        # back as one (B, N, 3, H, hd) tensor
        qkv = self.qkv(x).view(B, N, 3, self.num_heads, self.head_dim)
        out = attention_qkv(qkv, plain=self.plain)
        return self.proj(out.reshape(B, N, C))


class AdaLNBlock(nn.Module):
    """DiT block with adaLN-Zero conditioning and the fused glue kernels:
    ``ln_modulate`` before attention, ``residual_ln_modulate`` after it
    (the JAX block's ``fused_adaln=True`` path)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0, plain: bool = False):
        super().__init__()
        self.plain = plain
        self.attn = Attention(hidden_size, num_heads, qkv_bias=True, plain=plain)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), hidden_size)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(hidden_size, 6 * hidden_size))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            self.adaLN_modulation(c).chunk(6, dim=-1)
        )
        if self.plain:
            ln_mod, res_ln_mod = ln_modulate_reference, residual_ln_modulate_reference
        else:
            ln_mod, res_ln_mod = ln_modulate, residual_ln_modulate
        attn_out = self.attn(ln_mod(x, shift_msa, scale_msa))
        x, ff_in = res_ln_mod(x, attn_out, gate_msa, shift_mlp, scale_mlp)
        return x + gate_mlp[:, None, :] * self.mlp(ff_in)


class FinalLayer(nn.Module):
    """adaLN-modulated output projection."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.linear = Linear(hidden_size, patch_size * patch_size * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(hidden_size, 2 * hidden_size))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(layer_norm(x), shift, scale))


class PatchEmbed(nn.Module):
    """Patchify: the reference's strided conv, computed as reshape + matmul.

    The weight keeps the conv's (D, C, p, p) shape (``x_embedder.proj``), so
    reference checkpoints load as they are; patches flatten in (C, p, p) order.
    """

    def __init__(self, patch_size: int, in_channels: int, hidden_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """(B, C, H, W) -> (B, H/p * W/p, D), computed in ``dtype`` (default:
        the weight's)."""
        B, C, H, W = x.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"input {H}x{W} not divisible by patch size {p}")
        x = x.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(B, (H // p) * (W // p), C * p * p)
        w = self.proj.weight
        dtype = dtype or w.dtype
        return F.linear(x.to(dtype), w.reshape(w.shape[0], -1).to(dtype), self.proj.bias.to(dtype))


def unpatchify(x: torch.Tensor, patch_size: int, out_channels: int) -> torch.Tensor:
    """(B, T, p²·C) -> (B, C, H, W) with T = (H/p)·(W/p), square grid."""
    B, T, _ = x.shape
    p, c = patch_size, out_channels
    h = w = int(round(T**0.5))
    if h * w != T:
        raise ValueError(f"unpatchify expects a square token grid; got T = {T}")
    x = x.reshape(B, h, w, p, p, c)
    x = torch.einsum("nhwpqc->nchpwq", x)
    return x.reshape(B, c, h * p, w * p)
