"""Latte: factorized spatio-temporal video DiT (port of ``latte_tpu/models/dit.py``).

Input (B, F, C, H, W) and timesteps (B,) -> (B, F, C', H, W), with C' = 2C
under ``learn_sigma``. The blocks alternate spatial (tokens of one frame)
and temporal (one patch across frames); they are a plain list, where the
JAX model scans over stacked (spatial, temporal) pairs. The temporal
position embedding is added before the first temporal block only.

The model computes in ``compute_dtype``, by default the type of its
parameters: ``model.to(torch.bfloat16)`` is the port of the JAX model's
``dtype=bfloat16`` with bf16 weights (the sampler), and ``compute_dtype=
torch.bfloat16`` over fp32 parameters the port of ``model.clone(dtype=
bfloat16)`` in training, where the weights are cast per forward and the
gradients reach the fp32 masters. Sincos tables and inputs follow; the
output comes back in the input's type.

``gradient_checkpointing`` recomputes each spatial/temporal pair in the
backward under ``remat_policy`` "full" or "dots"
(:mod:`latte_tpu_torch.models.remat`), as ``nn.remat`` does around the JAX
model's scanned pair.

Class labels (``extras: 2``) are dropped to the null class only under
``train=True``, from the caller's ``generator`` (see
:class:`~latte_tpu_torch.models.embeddings.LabelEmbedder`).

``quantized`` and ``int8_attention`` select the W8A8 int8 modes of the
blocks (see :mod:`latte_tpu_torch.models.layers`); ``attention_mode`` routes
the int8 attention core as the JAX model does (the floating-point attention
always runs the flash kernel).

``forward`` also carries the block-cache staging hooks of the JAX model
(``return_front``, ``front_state``/``start_pair``), which
:mod:`latte_tpu_torch.core.block_cache` drives.

``moe_experts > 1`` gives every block the Mixture-of-Experts feed-forward
(:mod:`latte_tpu_torch.models.moe`, ``moe_top_k`` experts a token at
``moe_capacity_factor``). ``forward(..., return_aux=True)`` then also
returns the blocks' Switch losses, (2, n_pairs): row 0 the spatial blocks',
row 1 the temporal blocks' (the JAX model's per-column stacks sown under
``intermediates``), which the train step weights by ``moe_aux_weight``.
Each pair hands its two losses out as outputs of the (checkpointed) pair
function, so a recomputed pair never leaves a second copy behind. Under
"dots" the router's product is an ``aten.mm`` and is saved, while the
expert products (``baddbmm``, batched) are recomputed: what JAX's
``dots_with_no_batch_dims_saveable`` does with them, so the policy needs
nothing of its own for MoE.

Over several ranks (``mesh``, a :class:`~latte_tpu_torch.dist.mesh.
DistContext`):

- tensor parallelism (``mesh.tp > 1``): each block holds its rank's heads
  and MLP columns (:mod:`latte_tpu_torch.models.layers`,
  :mod:`latte_tpu_torch.dist.tp`); everything else is replicated and runs
  whole on every rank;
- sequence parallelism (``mesh.sp > 1``, the JAX model's
  ``activation_sharding=("dp", "sp")``): the model takes the rank's dp rows
  of the batch whole, patchifies only its sp block of the (b f) rows, runs
  the spatial blocks on its (b f) rows and the temporal blocks on its (b t)
  rows, with one all-to-all for each relayout, and all-gathers the output
  projection's rows, so unpatchify and the loss see the whole video
  (:mod:`latte_tpu_torch.dist.seq`). The conditioning rows are cut to the
  rank's. The block-cache hooks do not run under it.

Pipeline parallelism (``pp > 1``): the model holds stage ``pp_rank``'s
block pairs alone, under their one-process names
(:class:`~latte_tpu_torch.dist.pipeline.StageBlocks`), and the embedders and
the final layer; ``initialize_weights`` draws what the whole model draws for
them. Such a model runs through ``dist.pipeline.pipelined_latte_forward``;
its own ``forward`` needs every block.

``attention_mode: "ring"`` with ``ring_mesh`` runs every self-attention as
ring attention over the ring's ranks (:mod:`latte_tpu_torch.dist.ring`),
which hold the same activations; a sequence the ring's size does not divide
falls back to the standard attention, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from latte_tpu_torch.dist.pipeline import block_list, init_modules
from latte_tpu_torch.dist.seq import Relayout, gather_rows, local_rows
from latte_tpu_torch.models.embeddings import (
    LabelEmbedder,
    TimestepEmbedder,
    get_1d_sincos_pos_embed,
    get_2d_sincos_pos_embed,
)
from latte_tpu_torch.models.layers import AdaLNBlock, FinalLayer, Linear, PatchEmbed, unpatchify
from latte_tpu_torch.models.moe import MoEMlp, collect_loss, loss_columns, pair_losses
from latte_tpu_torch.models.remat import check_remat_policy, run_pair

__all__ = ["Latte"]


class Latte(nn.Module):
    """Video DiT. ``extras``: 1 = unconditional, 2 = class-conditional, 78 =
    text-conditioned on CLIP features (``text_embedding`` (B, 77, 768)).

    ``plain=True`` runs the kernels' plain PyTorch versions on any device
    (see :mod:`latte_tpu_torch.models.layers`).
    """

    # the input width of text_embedding_projection: the flattened (77, 768)
    # CLIP features of the JAX package's uses (sample.py:316, train.py:194-196),
    # which Flax's Dense infers and torch needs at construction
    TEXT_EMBEDDING_WIDTH = 77 * 768

    def __init__(
        self,
        input_size: int = 32,
        patch_size: int = 2,
        in_channels: int = 4,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        num_frames: int = 16,
        class_dropout_prob: float = 0.1,
        num_classes: int = 1000,
        learn_sigma: bool = True,
        extras: int = 1,
        plain: bool = False,
        gradient_checkpointing: bool = False,
        remat_policy: str = "full",
        compute_dtype: Optional[torch.dtype] = None,
        quantized=False,
        int8_attention=False,
        attention_mode: str = "auto",
        moe_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity_factor: float = 1.25,
        moe_mesh=None,
        mesh=None,
        ring_mesh=None,
        pp: int = 1,
        pp_rank: int = 0,
    ):
        super().__init__()
        if extras not in (1, 2, 78):
            raise ValueError(f"extras={extras}: expected 1 (unconditional), 2 (class) or 78 (text)")
        if depth % 2:
            raise ValueError(f"depth must be even (spatial/temporal pairs); got {depth}")
        check_remat_policy(remat_policy)
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.num_frames = num_frames
        self.num_classes = num_classes
        self.extras = extras
        self.gradient_checkpointing = gradient_checkpointing
        self.remat_policy = remat_policy
        self.compute_dtype = compute_dtype
        self.quantized = quantized
        self.moe_experts = moe_experts
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        # tensor parallelism over mesh's tp, sequence parallelism over its sp
        self.tp = mesh.tp if mesh is not None else 1
        self.sp_mesh = mesh if mesh is not None and mesh.sp > 1 else None

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        if extras == 2:
            self.y_embedder = LabelEmbedder(num_classes, hidden_size, class_dropout_prob)
        elif extras == 78:
            self.text_embedding_projection = Linear(self.TEXT_EMBEDDING_WIDTH, hidden_size)
        # pipeline parallelism: stage pp_rank's pairs alone
        self.pp, self.pp_rank = pp, pp_rank
        self.blocks = block_list(
            lambda i: AdaLNBlock(
                hidden_size, num_heads, mlp_ratio, plain=plain, quantized=quantized,
                int8_attention=int8_attention, attention_mode=attention_mode,
                moe_experts=moe_experts, moe_top_k=moe_top_k, moe_capacity_factor=moe_capacity_factor,
                moe_mesh=moe_mesh, tp=self.tp, tp_mesh=mesh if self.tp > 1 else None, ring_mesh=ring_mesh,
            ),
            depth, 2, pp, pp_rank,
        )
        self.final_layer = FinalLayer(hidden_size, patch_size, self.out_channels)
        grid = input_size // patch_size
        self.register_buffer(
            "pos_embed",
            torch.tensor(get_2d_sincos_pos_embed(hidden_size, grid), dtype=torch.float32)[None],
            persistent=False,
        )
        self.register_buffer(
            "temp_embed",
            torch.tensor(get_1d_sincos_pos_embed(hidden_size, num_frames), dtype=torch.float32)[None],
            persistent=False,
        )

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference's init (as the JAX modules' initializers): xavier-uniform
        linears and patch embedding with zero biases, N(0, 0.02) timestep MLP and
        label table, zero adaLN modulations and output layer (adaLN-Zero);
        the experts' own init (``MoEMlp.reset_parameters``). A pipeline
        stage draws, for its blocks, what the whole model draws. An int8
        serving model has no fp weights to draw: it loads the output of
        ``quant.quantize_params``."""
        if self.quantized in (True, "static"):
            raise ValueError("an int8 model loads quantize_params' output; initialise its fp twin")
        for m in init_modules(self):
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, MoEMlp):
                m.reset_parameters(generator)
        w = self.x_embedder.proj.weight
        nn.init.xavier_uniform_(w.view(w.shape[0], -1), generator=generator)
        nn.init.zeros_(self.x_embedder.proj.bias)
        for lin in (self.t_embedder.mlp[0], self.t_embedder.mlp[2]):
            nn.init.normal_(lin.weight, std=0.02, generator=generator)
        if self.extras == 2:
            nn.init.normal_(self.y_embedder.embedding_table.weight, std=0.02, generator=generator)
        for blk in self.blocks:
            nn.init.zeros_(blk.adaLN_modulation[1].weight)
            nn.init.zeros_(blk.adaLN_modulation[1].bias)
        for lin in (self.final_layer.adaLN_modulation[1], self.final_layer.linear):
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)

    def _pos_embed(self, grid: int, dtype: torch.dtype) -> torch.Tensor:
        if self.pos_embed.shape[1] == grid * grid:
            return self.pos_embed.to(dtype)
        return self._sincos(get_2d_sincos_pos_embed, grid, self.pos_embed.device, dtype)

    def _temp_embed(self, frames: int, dtype: torch.dtype) -> torch.Tensor:
        if self.temp_embed.shape[1] == frames:
            return self.temp_embed.to(dtype)
        return self._sincos(get_1d_sincos_pos_embed, frames, self.temp_embed.device, dtype)

    def _sincos(self, table_fn, n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """The sincos table of another size than the built one, made on the
        device at its first use and kept there, so that a forward copies
        nothing from the host (a CUDA graph of the sampler's step could not
        capture the copy)."""
        cache = self.__dict__.setdefault("_sincos_tables", {})
        key = (table_fn.__name__, n, device, dtype)
        if key not in cache:
            with torch.inference_mode(False), torch.no_grad():
                cache[key] = torch.from_numpy(table_fn(self.hidden_size, n)).to(device, dtype)[None]
        return cache[key]

    def _pair(self, x, c_spatial, c_temp, temp_embed, i: int, B: int, F: int, relayout: Optional[Relayout] = None):
        """Blocks i (spatial) and i + 1 (temporal) on (B·F, T, D) tokens:
        ``(x, aux)``, aux the two blocks' Switch losses (2,) or None.

        The relayouts copy: the kernels take contiguous activations (at B = 1
        a reshape of the transposed view would otherwise stay strided).
        Under sequence parallelism (``relayout``) x is the rank's block of
        the rows and each relayout is an all-to-all over sp."""
        T, D = x.shape[1], x.shape[2]
        aux = []
        x = collect_loss(self.blocks[i](x, c_spatial), aux)
        # (b f) t d -> (b t) f d
        if relayout is not None:
            x = relayout.to_temporal(x)
        else:
            x = x.reshape(B, F, T, D).transpose(1, 2).contiguous().view(B * T, F, D)
        if temp_embed is not None:
            x = x + temp_embed
        x = collect_loss(self.blocks[i + 1](x, c_temp), aux)
        # (b t) f d -> (b f) t d
        if relayout is not None:
            return relayout.to_spatial(x), pair_losses(aux)
        return x.reshape(B, T, F, D).transpose(1, 2).contiguous().view(B * F, T, D), pair_losses(aux)

    def _run_pair(self, fn, *args):
        """``fn(*args)``, under gradient checkpointing with the remat policy
        when the graph is recorded."""
        return run_pair(self.gradient_checkpointing, self.remat_policy, fn, *args)

    def _embed_labels(self, y, train: bool, force_drop_ids, generator, dtype) -> torch.Tensor:
        return self.y_embedder(y, train=train, force_drop_ids=force_drop_ids, generator=generator).to(dtype)

    def _embed_text(self, text_embedding: torch.Tensor, dtype) -> torch.Tensor:
        """The projection of SiLU of the features cast to the compute type
        (in that order, as in JAX); (B, ..., 768) rows of LatteIMG keep
        their leading axes."""
        return self.text_embedding_projection(nn.functional.silu(text_embedding.to(dtype)))

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: Optional[torch.Tensor] = None,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        force_drop_ids: Optional[torch.Tensor] = None,
        return_front: int = 0,
        front_state: Optional[torch.Tensor] = None,
        start_pair: int = 0,
        return_aux: bool = False,
        text_embedding: Optional[torch.Tensor] = None,
    ):
        """The forward (``train``, ``generator`` and ``force_drop_ids``
        reach the label embedder; ``text_embedding`` (B, 77, 768) is the
        ``extras: 78`` model's conditioning, projected and added to every
        block's, the final layer keeping the timestep's alone, as in the
        reference); ``return_aux`` also returns the MoE
        blocks' Switch losses, ``(out, aux)`` with aux (2, n_pairs), or None
        for a dense model. Plus the block-cache staging hooks of the JAX
        model:

        - ``return_front=k`` (full forward): also return the (B·F, T, D)
          activation after pair k - 1 (block 2k - 1), in the compute type,
          as ``(out, front)``. It is a tensor of its own: no later block
          writes into it.
        - ``front_state=front, start_pair=k`` (partial forward): skip the
          patch and position embeddings and pairs 0..k-1, and resume the
          block list at block 2k from ``front``. No temporal embedding is
          added (it belongs to pair 0). The timestep and label embedders
          still run. The blocks are a plain list, so no view of the back
          pairs' parameters is needed (the JAX package slices its stacked
          pair parameters to ``[k:]``): the loop starts at pair k.
        """
        if return_front and front_state is not None:
            raise ValueError("return_front and front_state are exclusive")
        if (front_state is None) != (start_pair == 0):
            raise ValueError("front_state and start_pair must be set together")
        if return_aux and (return_front or front_state is not None):
            raise ValueError("return_aux is the train step's: no staging hook goes with it")
        B, F, C, H, W = x.shape
        in_dtype = x.dtype
        dtype = self.compute_dtype or self.x_embedder.proj.weight.dtype
        p = self.patch_size
        relayout, rows_s, rows_t = None, slice(None), slice(None)
        if self.sp_mesh is not None:
            if return_front or front_state is not None:
                raise ValueError("the block-cache staging hooks run without sequence parallelism")
            mesh = self.sp_mesh
            T = (H // p) * (W // p)
            relayout = Relayout(mesh, B, F, T)
            rows_s, rows_t = local_rows(B * F, mesh.sp, mesh.sp_rank), local_rows(B * T, mesh.sp, mesh.sp_rank)

        if front_state is None:
            x = self.x_embedder(x.reshape(B * F, C, H, W)[rows_s], dtype)  # (B·F, T, D), or the rank's rows
            x = x + self._pos_embed(H // p, dtype)
        else:
            x = front_state
        T = x.shape[1]

        t_emb = self.t_embedder(t, dtype)
        # per-frame conditioning for spatial blocks, per-patch for temporal
        c_spatial = t_emb.repeat_interleave(F, dim=0)
        c_temp = t_emb.repeat_interleave(T, dim=0)
        if self.extras == 2:
            y_emb = self._embed_labels(y, train, force_drop_ids, generator, dtype)
            c_spatial = c_spatial + y_emb.repeat_interleave(F, dim=0)
            c_temp = c_temp + y_emb.repeat_interleave(T, dim=0)
        elif self.extras == 78:
            txt = self._embed_text(text_embedding.reshape(B, -1), dtype)
            c_spatial = c_spatial + txt.repeat_interleave(F, dim=0)
            c_temp = c_temp + txt.repeat_interleave(T, dim=0)
        c_final = c_spatial if self.extras == 2 else t_emb.repeat_interleave(F, dim=0)
        c_spatial, c_temp, c_final = c_spatial[rows_s], c_temp[rows_t], c_final[rows_s]

        temp_embed = self._temp_embed(F, dtype)
        front, aux = None, []
        for i in range(2 * start_pair, self.depth, 2):
            x, pair_aux = self._run_pair(
                self._pair, x, c_spatial, c_temp, temp_embed if i == 0 else None, i, B, F, relayout
            )
            aux.append(pair_aux)
            if i == 2 * return_front - 2:
                front = x

        x = self.final_layer(x, c_final)
        if relayout is not None:
            x = gather_rows(x, self.sp_mesh)
        x = unpatchify(x, p, self.out_channels)
        out = x.reshape(B, F, self.out_channels, H, W).to(in_dtype)
        if return_aux:
            return out, loss_columns(aux)
        return (out, front) if return_front else out

    def forward_with_cfg(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: Optional[torch.Tensor] = None,
        cfg_scale: float = 7.0,
        text_embedding: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """CFG forward: the batch is [cond | uncond]; guidance applies to the
        first 4 (eps) channels only, as in the reference."""
        half = x[: x.shape[0] // 2]
        model_out = self.forward(torch.cat([half, half], dim=0), t, y=y, text_embedding=text_embedding)
        eps, rest = model_out[:, :, :4], model_out[:, :, 4:]
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([half_eps, half_eps], dim=0), rest], dim=2)
