"""LatteIMG: the joint video-image Latte (port of ``latte_tpu/models/dit_img.py``).

The input's frame axis holds ``num_frames`` video frames followed by
``use_image_num`` still images, (B, F + I, C, H, W). Under ``train`` the
spatial blocks run on all B·(F + I) frames and the temporal blocks on the
F video frames only, with the images' tokens passed through; the temporal
embedding then has length F. Otherwise (sampling) every frame is a video
frame and the model is :class:`~latte_tpu_torch.models.dit.Latte` over
F + I frames. Class-conditional training (``extras: 2``) conditions each
image's spatial blocks on its own label ``y_image`` (B, I), drawn through
the label dropout after ``y``.

The parameters and their names are ``Latte``'s, so
:func:`latte_tpu_torch.convert.flax_to_state_dict` carries the JAX
LatteIMG's over unchanged; so are the MoE options, ``return_aux`` and
tensor parallelism (``mesh.tp``). Sequence parallelism is not: the JAX
LatteIMG has no ``activation_sharding``, so a mesh with ``sp > 1`` raises
``ValueError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from latte_tpu_torch.models.dit import Latte
from latte_tpu_torch.models.layers import unpatchify
from latte_tpu_torch.models.moe import collect_loss, loss_columns, pair_losses

__all__ = ["LatteIMG"]


class LatteIMG(Latte):
    """Joint video + image Latte; ``Latte``'s arguments plus
    ``use_image_num``. No block-cache staging hooks (the JAX model has
    none)."""

    # extras: 78 projects each frame's (768,) CLIP row (latte_tpu/models/dit_img.py:205-219)
    TEXT_EMBEDDING_WIDTH = 768

    def __init__(self, *args, use_image_num: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        if self.sp_mesh is not None:
            raise ValueError(
                f"LatteIMG with sequence_parallel={self.sp_mesh.sp}: the JAX LatteIMG has no "
                "activation_sharding (latte_tpu/models/dit_img.py), so neither package splits its rows over sp"
            )
        self.use_image_num = use_image_num

    def _joint_pair(self, x, c_spatial, c_temp, temp_embed, i: int, B: int, F: int, Fv: int):
        """Blocks i (spatial, all F frames) and i + 1 (temporal, the first Fv
        frames) on (B·F, T, D) tokens: ``(x, aux)`` as ``Latte._pair``'s. The
        video frames go to the
        (b t) f d layout in one copy, so the kernels get a contiguous block;
        the images' tokens stay where they are and the concatenation on the
        way back writes both into a new contiguous (B·F, T, D) tensor."""
        if Fv == F:
            return self._pair(x, c_spatial, c_temp, temp_embed, i, B, F)
        T, D = x.shape[1], x.shape[2]
        aux = []
        x = collect_loss(self.blocks[i](x, c_spatial), aux).view(B, F, T, D)
        video = x[:, :Fv].transpose(1, 2).contiguous().view(B * T, Fv, D)
        if temp_embed is not None:
            video = video + temp_embed
        video = collect_loss(self.blocks[i + 1](video, c_temp), aux)
        out = torch.cat([video.view(B, T, Fv, D).transpose(1, 2), x[:, Fv:]], dim=1)
        return out.view(B * F, T, D), pair_losses(aux)

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: Optional[torch.Tensor] = None,
        y_image: Optional[torch.Tensor] = None,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        force_drop_ids: Optional[torch.Tensor] = None,
        force_drop_ids_image: Optional[torch.Tensor] = None,
        return_aux: bool = False,
        text_embedding: Optional[torch.Tensor] = None,
    ):
        """(B, F + I, C, H, W), (B,) -> (B, F + I, C', H, W). Under ``train``
        the last ``use_image_num`` frames are still images, labelled by
        ``y_image`` (B, I) when the model is class-conditional.
        ``return_aux``: ``(out, aux)`` as ``Latte.forward``'s. A
        text-conditioned model (``extras: 78``) takes per-frame CLIP features
        ``text_embedding`` (B, 1 + I, 768): row 0 conditions every video
        frame's spatial block and every temporal block, rows 1..I the
        images' spatial blocks."""
        B, F, C, H, W = x.shape
        in_dtype = x.dtype
        dtype = self.compute_dtype or self.x_embedder.proj.weight.dtype
        p = self.patch_size
        Fv = F - (self.use_image_num if train else 0)

        x = self.x_embedder(x.reshape(B * F, C, H, W), dtype)  # (B·F, T, D)
        x = x + self._pos_embed(H // p, dtype)
        T = x.shape[1]
        t_emb = self.t_embedder(t, dtype)
        c_spatial = t_emb.repeat_interleave(F, dim=0)
        c_temp = t_emb.repeat_interleave(T, dim=0)
        if self.extras == 2:
            y_emb = self._embed_labels(y, train, force_drop_ids, generator, dtype)  # (B, D)
            if train and self.use_image_num > 0:
                y_img = self._embed_labels(y_image, train, force_drop_ids_image, generator, dtype)  # (B, I, D)
                y_spatial = torch.cat([y_emb[:, None].expand(B, Fv, -1), y_img], dim=1).reshape(B * F, -1)
            else:
                y_spatial = y_emb.repeat_interleave(F, dim=0)
            c_spatial = c_spatial + y_spatial
            c_temp = c_temp + y_emb.repeat_interleave(T, dim=0)
        elif self.extras == 78:
            txt = self._embed_text(text_embedding, dtype)  # (B, 1 + I, D)
            txt_spatial = torch.cat([txt[:, :1].expand(B, Fv, -1), txt[:, 1:]], dim=1)
            c_spatial = c_spatial + txt_spatial.reshape(B * F, -1)
            c_temp = c_temp + txt[:, 0].repeat_interleave(T, dim=0)

        temp_embed = self._temp_embed(Fv, dtype)
        aux = []
        for i in range(0, self.depth, 2):
            x, pair_aux = self._run_pair(
                self._joint_pair, x, c_spatial, c_temp, temp_embed if i == 0 else None, i, B, F, Fv
            )
            aux.append(pair_aux)
        x = self.final_layer(x, c_spatial)
        x = unpatchify(x, p, self.out_channels)
        out = x.reshape(B, F, self.out_channels, H, W).to(in_dtype)
        return (out, loss_columns(aux)) if return_aux else out
