"""Positional, timestep and label embeddings (port of
``latte_tpu/models/embeddings.py``).

The sin-cos tables are fp64 numpy, computed once; the model keeps them as
non-persistent buffers, so they are not part of the state dict.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from latte_tpu_torch.models.layers import Linear

__all__ = [
    "get_1d_sincos_pos_embed",
    "get_2d_sincos_pos_embed",
    "timestep_embedding",
    "TimestepEmbedder",
    "LabelEmbedder",
]


def _sincos_from_positions(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, D) [sin | cos] embedding (fp64)."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even; got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_1d_sincos_pos_embed(embed_dim: int, length: int) -> np.ndarray:
    """Temporal (frame-axis) table, shape (length, D)."""
    return _sincos_from_positions(embed_dim, np.arange(length))


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """Spatial patch-grid table, shape (grid², D), patch (h, w) at h*grid + w.

    As in the reference, the first D/2 dims encode the WIDTH position and
    the second D/2 the height.
    """
    grid = np.arange(grid_size, dtype=np.float64)
    ww, hh = np.meshgrid(grid, grid)
    emb_first = _sincos_from_positions(embed_dim // 2, ww.reshape(-1))
    emb_second = _sincos_from_positions(embed_dim // 2, hh.reshape(-1))
    return np.concatenate([emb_first, emb_second], axis=1)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep features: (N,) -> (N, dim) fp32, [cos | sin] order."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """MLP over sinusoidal timestep features (``t_embedder.mlp.{0,2}``)."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            Linear(frequency_embedding_size, hidden_size),
            nn.SiLU(),
            Linear(hidden_size, hidden_size),
        )

    def forward(self, t: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """(N,) timesteps -> (N, hidden), computed in ``dtype`` (default: the
        weights')."""
        x = timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(x.to(dtype or self.mlp[0].weight.dtype))


class LabelEmbedder(nn.Module):
    """Class-label embedding with the extra null-class row used by CFG.

    Training drops each label to the null class with ``dropout_prob``
    (how classifier-free guidance is learned), as the JAX module does under
    ``train=True``. The drop is keyed on the explicit ``train`` argument,
    never on ``nn.Module.training``: a model left in ``.train()`` mode
    embeds every label as given unless its caller asks for training.
    """

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float = 0.1):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.embedding_table = nn.Embedding(num_classes + int(dropout_prob > 0), hidden_size)

    def forward(
        self,
        labels: torch.Tensor,
        train: bool = False,
        force_drop_ids: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``force_drop_ids`` (1 = drop) decides the drop when given;
        otherwise under ``train`` one uniform draw a label from
        ``generator`` (the JAX module's ``label_dropout`` stream)."""
        if force_drop_ids is not None:
            labels = torch.where(force_drop_ids == 1, self.num_classes, labels)
        elif train and self.dropout_prob > 0:
            u = torch.rand(labels.shape, generator=generator, device=labels.device)
            labels = torch.where(u < self.dropout_prob, self.num_classes, labels)
        return self.embedding_table(labels)
