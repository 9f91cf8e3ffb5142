"""LatteT2V: the text-to-video transformer (port of ``latte_tpu/models/t2v.py``).

Input (B, C, F(+I), H, W) latents, (B,) timesteps (fp32, possibly
fractional) and (B, L, C_text) caption states -> (B, C_out, F(+I), H, W).
Pairs of a spatial block (self-attention, cross-attention to the projected
caption, feed-forward) and a temporal block (self-attention, feed-forward),
each modulated adaLN-single style: a per-block ``scale_shift_table`` (6, D)
plus the shared timestep projection, and an adaLN-single output layer with
a (2, D) table. The temporal position embedding is added before pair 0's
temporal block only, and only for more than one video frame.

Module names are the reference's diffusers names
(``transformer_blocks.{i}.attn1.to_q``, ``temporal_transformer_blocks.{i}``,
``pos_embed.proj``, ``adaln_single.emb.timestep_embedder.linear_1``,
``caption_projection.linear_1``, ``scale_shift_table``, ``proj_out``), so a
reference state dict loads with ``strict=True`` once the two frozen buffers
the JAX converter drops are left out (:func:`latte_tpu_torch.convert.
load_t2v_state_dict`). The JAX model's stacked ``blocks/spatial`` and
``blocks/temporal`` parameters are two plain module lists here.

Where the kernels run: every self-attention (``attn1``, spatial and temporal)
goes through :func:`latte_tpu_torch.kernels.flash_attention` (the JAX model
picks its flash kernel only on a TPU and only for N >= 512; the port always
takes the kernel). ``norm1`` of each block and ``norm_out`` are
LayerNorm-then-modulate, the ``ln_modulate`` kernel; each ``norm3`` with the
residual before it is ``residual_ln_modulate``: the temporal block's
``x + gate_msa·attn``, and the spatial block's ``x + attn2`` with a unit
gate (exact in IEEE arithmetic). The gated residual after the spatial
self-attention and the feed-forward's stay plain, as do the cross-attention
(the JAX package computes it outside any Pallas kernel, ``t2v.py:199-211``)
and its additive ``(1 - mask)·(-10000)`` key bias on fp32 logits: a caption
with no valid token keeps a finite row, the unmasked one up to the rounding
of logits near -10000.

The adaLN vectors are ``scale_shift_table + t_mod`` summed in fp32 (the
table stays fp32 when the model is cast to bf16, as the JAX model keeps its
params fp32) and cast once to the compute type, as the JAX model does.

The model computes in the type of its parameters (``model.to(torch.
bfloat16)`` is the JAX model at ``dtype=bfloat16``). ``plain=True`` runs the
kernels' plain versions on any device. ``quantized=True`` makes the attention
projections and the feed-forward W8A8 int8 :class:`QLinear` layers, which
load ``quant.quantize_params``'s output. ``forward`` carries the JAX model's
block-cache staging hooks (``return_front``, ``front_state``/``start_pair``).

``moe_experts > 1`` replaces every block's feed-forward by the
Mixture-of-Experts feed-forward (:class:`~latte_tpu_torch.models.moe.MoEMlp`
under ``moe`` with the block's ``activation_fn``; it replaces
``feed_forward_chunk_size`` outright, as in the JAX model's ``_make_ff``),
which groups the block's tokens in the (B·F, T, D) or (B·T, F, D) order the
JAX model sees; ``forward(..., return_aux=True)`` also returns the blocks'
Switch losses, (columns, n_pairs) with the spatial blocks' first. A
quantized model with MoE raises, as in JAX.

``attention_mode: "ring"`` with ``ring_mesh`` (a ``DistContext``, whose sp
group is the ring, or a process group) runs each self-attention whose
length the ring's size divides as ring attention
(:mod:`latte_tpu_torch.dist.ring`); the cross-attention and any other
self-attention take their usual route, as in JAX. Without a ring it raises
the JAX model's ``ValueError``.

Pipeline parallelism (``pp > 1``): the model holds stage ``pp_rank``'s
pairs of both block lists alone, under their one-process names
(:class:`~latte_tpu_torch.dist.pipeline.StageBlocks`), and everything
else; it runs through ``dist.pipeline.pipelined_t2v_forward``.

``gradient_checkpointing`` recomputes each pair in the backward under
``remat_policy`` "full" or "dots" (:mod:`latte_tpu_torch.models.remat`, as
Latte's), only while grad is enabled: serving runs each pair once.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from latte_tpu_torch.dist.pipeline import block_list, init_modules, init_named_parameters
from latte_tpu_torch.dist.ring import ring_attention_sharded, ring_size
from latte_tpu_torch.kernels import (
    attention_reference,
    flash_attention,
    ln_modulate,
    ln_modulate_reference,
    residual_ln_modulate,
    residual_ln_modulate_reference,
)
from latte_tpu_torch.models.embeddings import (
    get_1d_sincos_pos_embed,
    get_2d_sincos_pos_embed,
    timestep_embedding,
)
from latte_tpu_torch.models.layers import (
    MOE_INT8_REFUSAL,
    Linear,
    PatchEmbed,
    QLinear,
    _Fp32Scales,
    unpatchify,
)
from latte_tpu_torch.models.moe import MoEMlp, collect_loss, loss_columns, pair_losses
from latte_tpu_torch.models.remat import check_remat_policy, run_pair

__all__ = [
    "T2VFeedForward",
    "MultiHeadCrossAttention",
    "T2VSpatialBlock",
    "T2VTemporalBlock",
    "AdaLayerNormSingle",
    "CaptionProjection",
    "LatteT2V",
    "cross_attention",
]

ATTENTION_MODES = ("auto", "xla", "flash", "ring")
# the key bias of a masked caption token, as in the JAX model
MASK_BIAS = -10000.0


def cross_attention(q, k, v, mask_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention of (B, N, H, hd) queries over (B, M, H, hd) keys with
    an additive fp32 key bias ``mask_bias`` (B, 1, M): the JAX model's "xla"
    route. Scores in fp32 from the scaled q in its own type; the
    probabilities cast to v's type for P·V."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", (q * scale).float(), k.float())
    if mask_bias is not None:
        logits = logits + mask_bias[:, None]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)


class _ProjIn(nn.Module):
    """diffusers' ``GELU``/``GEGLU`` module: only its ``proj`` carries weights."""

    def __init__(self, dim: int, out: int, quantized):
        super().__init__()
        self.proj = QLinear(dim, out, quantized=quantized)


class T2VFeedForward(nn.Module):
    """diffusers ``FeedForward`` (``net.0.proj``, ``net.2``): gelu-approximate
    or geglu. ``chunk_size`` runs it over slices of the token axis, which
    must divide it (``ValueError`` otherwise, as in JAX)."""

    def __init__(self, dim: int, activation_fn: str = "gelu-approximate",
                 chunk_size: Optional[int] = None, quantized=False):
        super().__init__()
        inner = 4 * dim
        if activation_fn not in ("geglu", "gelu-approximate"):
            raise NotImplementedError(activation_fn)
        self.activation_fn = activation_fn
        self.chunk_size = chunk_size
        width = 2 * inner if activation_fn == "geglu" else inner
        self.net = nn.ModuleList([_ProjIn(dim, width, quantized), nn.Identity(),
                                  QLinear(inner, dim, quantized=quantized)])

    def _ff(self, h: torch.Tensor) -> torch.Tensor:
        h = self.net[0].proj(h)
        if self.activation_fn == "geglu":
            h, gate = h.chunk(2, dim=-1)
            h = h * F.gelu(gate)
        else:
            h = F.gelu(h, approximate="tanh")
        return self.net[2](h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.chunk_size is None:
            return self._ff(x)
        T = x.shape[1]
        if T % self.chunk_size:
            raise ValueError(f"token axis {T} not divisible by feed-forward chunk size {self.chunk_size}")
        return torch.cat([self._ff(c) for c in x.split(self.chunk_size, dim=1)], dim=1)


class MultiHeadCrossAttention(nn.Module):
    """diffusers-style attention (``to_q``, ``to_k``, ``to_v``, ``to_out.0``).
    Self-attention (no context, no mask) runs the flash-attention kernel on
    the (B, N, H, hd) views of the projections; attention to a context runs
    :func:`cross_attention`."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, quantized=False, plain: bool = False,
                 ring_mesh=None):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim, self.plain = num_heads, head_dim, plain
        self.ring_mesh = ring_mesh
        self.to_q = QLinear(dim, inner, quantized=quantized)
        self.to_k = QLinear(dim, inner, quantized=quantized)
        self.to_v = QLinear(dim, inner, quantized=quantized)
        self.to_out = nn.ModuleList([QLinear(inner, dim, quantized=quantized), nn.Identity()])

    def forward(self, x, context=None, mask_bias=None) -> torch.Tensor:
        B, N, _ = x.shape
        kv = x if context is None else context
        M = kv.shape[1]
        H, hd = self.num_heads, self.head_dim
        q = self.to_q(x).view(B, N, H, hd)
        k = self.to_k(kv).view(B, M, H, hd)
        v = self.to_v(kv).view(B, M, H, hd)
        if context is not None or mask_bias is not None:
            out = cross_attention(q, k, v, mask_bias)
        elif self.ring_mesh is not None and N % ring_size(self.ring_mesh) == 0:
            out = ring_attention_sharded(q, k, v, self.ring_mesh)
        elif self.plain:
            out = attention_reference(q, k, v)
        else:
            out = flash_attention(q, k, v)
        return self.to_out[0](out.reshape(B, N, H * hd))


def _modulation(table: torch.Tensor, t_mod: torch.Tensor, dtype, unit_gate: bool = False) -> torch.Tensor:
    """The block's adaLN vectors (B, 6, D) in ``dtype``: ``table + t_mod``
    in fp32, cast once. With ``unit_gate`` a seventh row of ones, the unit
    gate of the spatial block's ``residual_ln_modulate``: the kernel reads
    every vector at one row stride."""
    B, D = t_mod.shape[0], table.shape[1]
    mods = torch.empty((B, 7 if unit_gate else 6, D), dtype=dtype, device=t_mod.device)
    mods[:, :6] = table.float()[None] + t_mod.float().view(B, 6, D)
    if unit_gate:
        mods[:, 6] = 1
    return mods


class _AdaLNSingleBlock(_Fp32Scales):
    """What the spatial and temporal blocks share: the (6, D) table, kept
    fp32, self-attention, the feed-forward (``ff``, or the experts ``moe``
    when ``moe[0] > 1``; an MoE block returns ``(x, aux)``), and the adaLN
    kernels or their plain versions."""

    FP32_BUFFERS = ("scale_shift_table",)

    def __init__(self, dim, num_heads, head_dim, activation_fn, ff_chunk_size, quantized, plain, moe,
                 ring_mesh=None):
        super().__init__()
        self.plain = plain
        self.scale_shift_table = nn.Parameter(torch.randn(6, dim) / dim**0.5)
        self.attn1 = MultiHeadCrossAttention(dim, num_heads, head_dim, quantized=quantized, plain=plain,
                                             ring_mesh=ring_mesh)
        experts, top_k, capacity_factor, mesh = moe
        self.is_moe = experts > 1
        if self.is_moe:
            if quantized:
                raise NotImplementedError(MOE_INT8_REFUSAL)
            self.moe = MoEMlp(dim, 4 * dim, dim, experts, top_k, capacity_factor, activation_fn, mesh=mesh)
        else:
            self.ff = T2VFeedForward(dim, activation_fn=activation_fn, chunk_size=ff_chunk_size,
                                     quantized=quantized)

    def _norms(self):
        if self.plain:
            return ln_modulate_reference, residual_ln_modulate_reference
        return ln_modulate, residual_ln_modulate

    def _feed_forward(self, x, h, gate, shape):
        """``x + gate·FF(h)`` back in ``shape``; with MoE ``(that, aux)``."""
        if self.is_moe:
            y, aux = self.moe(h.view(shape))
            return (x + gate * y.view(x.shape)).view(shape), aux
        return (x + gate * self.ff(h.view(shape)).view(x.shape)).view(shape)


class T2VSpatialBlock(_AdaLNSingleBlock):
    """adaLN-single block over the tokens of one frame: self-attention, then
    cross-attention to the caption (no norm before it, the PixArt quirk),
    then the feed-forward."""

    def __init__(self, dim, num_heads, head_dim, activation_fn="gelu-approximate",
                 ff_chunk_size=None, quantized=False, plain=False, moe=(0, 2, 1.25, None), ring_mesh=None):
        super().__init__(dim, num_heads, head_dim, activation_fn, ff_chunk_size, quantized, plain, moe, ring_mesh)
        self.attn2 = MultiHeadCrossAttention(dim, num_heads, head_dim, quantized=quantized, plain=plain)

    def forward(self, x, t_mod, context, mask_bias) -> torch.Tensor:
        """x (B·F, T, D); t_mod (B, 6D); context (B·F, L, D). The adaLN
        steps see x as (B, F·T, D), one vector row per video."""
        shape, B = x.shape, t_mod.shape[0]
        mods = _modulation(self.scale_shift_table, t_mod, x.dtype, unit_gate=True)
        ln_mod, res_ln_mod = self._norms()
        x = x.view(B, -1, shape[2])
        h = ln_mod(x, mods[:, 0], mods[:, 1]).view(shape)
        x = x + mods[:, 2, None] * self.attn1(h).view(x.shape)
        cross = self.attn2(x.view(shape), context, mask_bias).view(x.shape)
        x, h = res_ln_mod(x, cross, mods[:, 6], mods[:, 3], mods[:, 4])
        return self._feed_forward(x, h, mods[:, 5, None], shape)


class T2VTemporalBlock(_AdaLNSingleBlock):
    """adaLN-single self-attention block over the frames of one patch. Its
    feed-forward is never chunked (the JAX model chunks the spatial token
    axis only)."""

    def __init__(self, dim, num_heads, head_dim, activation_fn="gelu-approximate",
                 quantized=False, plain=False, moe=(0, 2, 1.25, None), ring_mesh=None):
        super().__init__(dim, num_heads, head_dim, activation_fn, None, quantized, plain, moe, ring_mesh)

    def forward(self, x, t_mod) -> torch.Tensor:
        """x (B·T, F, D); t_mod (B, 6D). The adaLN steps see x as
        (B, T·F, D), one vector row per video."""
        shape, B = x.shape, t_mod.shape[0]
        mods = _modulation(self.scale_shift_table, t_mod, x.dtype)
        ln_mod, res_ln_mod = self._norms()
        x = x.view(B, -1, shape[2])
        h = ln_mod(x, mods[:, 0], mods[:, 1]).view(shape)
        x, h = res_ln_mod(x, self.attn1(h).view(x.shape), mods[:, 2], mods[:, 3], mods[:, 4])
        return self._feed_forward(x, h, mods[:, 5, None], shape)


class _TimestepEmbedding(nn.Module):
    """diffusers' ``TimestepEmbedding`` (``linear_1``, silu, ``linear_2``)
    over the port's sinusoidal features ([cos | sin], 256 wide)."""

    FREQUENCIES = 256

    def __init__(self, dim: int):
        super().__init__()
        self.linear_1 = Linear(self.FREQUENCIES, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, t: torch.Tensor, dtype) -> torch.Tensor:
        x = timestep_embedding(t, self.FREQUENCIES).to(dtype)
        return self.linear_2(F.silu(self.linear_1(x)))


class _CombinedEmbeddings(nn.Module):
    """diffusers' ``PixArtAlphaCombinedTimestepSizeEmbeddings`` without
    resolution conditioning: only ``timestep_embedder`` carries weights."""

    def __init__(self, dim: int):
        super().__init__()
        self.timestep_embedder = _TimestepEmbedding(dim)

    def forward(self, t, dtype):
        return self.timestep_embedder(t, dtype)


class AdaLayerNormSingle(nn.Module):
    """Shared timestep conditioning: sincos(256) -> MLP(D) -> silu ->
    Linear(6D). Returns ``(t_mod, emb)``."""

    def __init__(self, dim: int):
        super().__init__()
        self.emb = _CombinedEmbeddings(dim)
        self.linear = Linear(dim, 6 * dim)

    def forward(self, t: torch.Tensor, dtype):
        emb = self.emb(t, dtype)
        return self.linear(F.silu(emb)), emb


class CaptionProjection(nn.Module):
    """Caption (T5) states -> D: Linear, gelu(tanh), Linear."""

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.linear_1 = Linear(in_features, hidden_size)
        self.linear_2 = Linear(hidden_size, hidden_size)

    def forward(self, caption: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(caption), approximate="tanh"))


class LatteT2V(_Fp32Scales):
    """Text-to-video transformer; the defaults are the published Latte-1's.
    ``cross_attention_dim`` is accepted for the JAX model's signature: the
    cross-attention reads the caption projected to the model's width."""

    FP32_BUFFERS = ("scale_shift_table",)

    def __init__(
        self,
        num_attention_heads: int = 16,
        attention_head_dim: int = 72,
        in_channels: int = 4,
        out_channels: int = 8,
        num_layers: int = 28,
        patch_size: int = 2,
        sample_size: int = 64,
        cross_attention_dim: int = 1152,
        caption_channels: int = 4096,
        video_length: int = 16,
        activation_fn: str = "gelu-approximate",
        attention_mode: str = "auto",
        enable_temporal_attentions: bool = True,
        feed_forward_chunk_size: Optional[int] = None,
        quantized=False,
        moe_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity_factor: float = 1.25,
        moe_mesh=None,
        gradient_checkpointing: bool = False,
        remat_policy: str = "full",
        plain: bool = False,
        ring_mesh=None,
        pp: int = 1,
        pp_rank: int = 0,
    ):
        super().__init__()
        if attention_mode == "ring" and ring_mesh is None:
            raise ValueError(
                "attention_mode='ring' requires constructing the model with ring_mesh=<a DistContext or a "
                "process group>"
            )
        if attention_mode not in ATTENTION_MODES:
            raise ValueError(f"attention_mode {attention_mode!r}; expected one of {ATTENTION_MODES}")
        check_remat_policy(remat_policy)
        D = num_attention_heads * attention_head_dim
        self.inner_dim = D
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_layers = num_layers
        self.patch_size = patch_size
        self.enable_temporal_attentions = enable_temporal_attentions
        self.quantized = quantized
        self.moe_experts = moe_experts
        self.plain = plain
        self.gradient_checkpointing = gradient_checkpointing
        self.remat_policy = remat_policy

        self.pos_embed = PatchEmbed(patch_size, in_channels, D)
        self.adaln_single = AdaLayerNormSingle(D)
        self.caption_projection = CaptionProjection(caption_channels, D)
        block = dict(activation_fn=activation_fn, quantized=quantized, plain=plain,
                     moe=(moe_experts, moe_top_k, moe_capacity_factor, moe_mesh),
                     ring_mesh=ring_mesh if attention_mode == "ring" else None)
        # pipeline parallelism: stage pp_rank's pairs alone
        self.pp, self.pp_rank = pp, pp_rank
        self.transformer_blocks = block_list(
            lambda i: T2VSpatialBlock(D, num_attention_heads, attention_head_dim,
                                      ff_chunk_size=feed_forward_chunk_size, **block),
            num_layers, 1, pp, pp_rank,
        )
        if enable_temporal_attentions:
            self.temporal_transformer_blocks = block_list(
                lambda i: T2VTemporalBlock(D, num_attention_heads, attention_head_dim, **block),
                num_layers, 1, pp, pp_rank,
            )
        self.scale_shift_table = nn.Parameter(torch.randn(2, D) / D**0.5)
        self.proj_out = Linear(D, patch_size * patch_size * out_channels)
        self.register_buffer(
            "pos_table",
            torch.tensor(get_2d_sincos_pos_embed(D, sample_size // patch_size), dtype=torch.float32)[None],
            persistent=False,
        )
        self.register_buffer(
            "temp_table",
            torch.tensor(get_1d_sincos_pos_embed(D, video_length), dtype=torch.float32)[None],
            persistent=False,
        )

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX modules' initializers: xavier-uniform linears and patch
        embedding with zero biases, N(0, 0.02²) timestep MLP and caption
        projection, N(0, 1/D) adaLN tables, the experts' own init; a
        pipeline stage draws, for its blocks, what the whole model draws. An
        int8 model loads ``quant.quantize_params``' output instead."""
        if self.quantized:
            raise ValueError("an int8 model loads quantize_params' output; initialise its fp twin")
        for m in init_modules(self):
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, MoEMlp):
                m.reset_parameters(generator)
        w = self.pos_embed.proj.weight
        nn.init.xavier_uniform_(w.view(w.shape[0], -1), generator=generator)
        nn.init.zeros_(self.pos_embed.proj.bias)
        te = self.adaln_single.emb.timestep_embedder
        for lin in (te.linear_1, te.linear_2, self.caption_projection.linear_1,
                    self.caption_projection.linear_2):
            nn.init.normal_(lin.weight, std=0.02, generator=generator)
        std = self.inner_dim**-0.5
        for name, p in init_named_parameters(self):
            if name.endswith("scale_shift_table"):
                nn.init.normal_(p, std=std, generator=generator)

    def _table(self, buf: torch.Tensor, fn, n: int, rows: int, dtype) -> torch.Tensor:
        """The sincos table ``fn(D, n)`` of ``rows`` rows: the buffer when it
        has that size, else computed for this input."""
        if buf.shape[1] == rows:
            return buf.to(dtype)
        return torch.from_numpy(fn(self.inner_dim, n)).to(buf.device, dtype)[None]

    def _pair(self, i, x, t_mod, ctx, ctx_bias, temp, B, F, Fv):
        """Pair i on (B·F, T, D) tokens: the spatial block, then the temporal
        block on the Fv video frames of each patch (the image frames of a
        joint batch skip it). Returns ``(x, aux)``, aux the blocks' Switch
        losses or None. The relayouts copy: the kernels take contiguous
        activations."""
        aux = []
        x = collect_loss(self.transformer_blocks[i](x, t_mod, ctx, ctx_bias), aux)
        if not self.enable_temporal_attentions:
            return x, pair_losses(aux)
        T, D = x.shape[1], x.shape[2]
        x = x.view(B, F, T, D).transpose(1, 2).contiguous()  # (b t) f d
        video = x[:, :, :Fv].contiguous().view(B * T, Fv, D) if Fv < F else x.view(B * T, F, D)
        if temp is not None:
            video = video + temp
        video = collect_loss(self.temporal_transformer_blocks[i](video, t_mod), aux).view(B, T, Fv, D)
        if Fv < F:
            video = torch.cat([video, x[:, :, Fv:]], dim=2)
        return video.transpose(1, 2).contiguous().view(B * F, T, D), pair_losses(aux)

    def _run_pair(self, fn, *args):
        """``fn(*args)``, under gradient checkpointing with the remat policy
        when the graph is recorded."""
        return run_pair(self.gradient_checkpointing, self.remat_policy, fn, *args)

    def _head(self, x: torch.Tensor, emb: torch.Tensor, B: int) -> torch.Tensor:
        """The adaLN-single output layer, (2, D) table + the timestep
        embedding, then unpatchify: (B·F, T, D) -> (B·F, C_out, H, W)."""
        mods = (self.scale_shift_table.float()[None] + emb.float()[:, None]).to(x.dtype)
        ln_mod = ln_modulate_reference if self.plain else ln_modulate
        x = self.proj_out(ln_mod(x.view(B, -1, x.shape[2]), mods[:, 0], mods[:, 1]).view(x.shape))
        return unpatchify(x, self.patch_size, self.out_channels)

    def forward(
        self,
        hidden_states: torch.Tensor,
        timestep: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        encoder_attention_mask: Optional[torch.Tensor] = None,
        use_image_num: int = 0,
        train: bool = False,
        *,
        front_state: Optional[torch.Tensor] = None,
        start_pair: int = 0,
        return_front: int = 0,
        return_aux: bool = False,
    ):
        """``encoder_hidden_states`` (B, L, C_text), and its mask (B, L)
        (1 = keep); with ``use_image_num`` and ``train``, the joint form:
        (B, 1 + I, L, C_text) and (B, 1 + I, L), caption 0 for every video
        frame and one caption per image. The staging hooks, as in the JAX
        model: ``return_front=k`` also returns the (B·F, T, D) activation
        after pair k - 1, as ``(out, front)``; ``front_state=front,
        start_pair=k`` resumes at pair k from ``front`` (no patch, position
        or temporal embedding). ``return_aux``: ``(out, aux)``, the MoE
        blocks' Switch losses (columns, n_pairs), None for dense blocks."""
        if return_front and front_state is not None:
            raise ValueError("return_front and front_state are exclusive")
        if (front_state is None) != (start_pair == 0):
            raise ValueError("front_state and start_pair must be set together")
        if return_aux and (return_front or front_state is not None):
            raise ValueError("return_aux goes with no staging hook")
        B, _, F, H, W = hidden_states.shape
        Fv = F - use_image_num
        p = self.patch_size
        in_dtype = hidden_states.dtype
        dtype = self.proj_out.weight.dtype

        if front_state is None:
            x = hidden_states.transpose(1, 2).reshape(B * F, -1, H, W)
            x = self.pos_embed(x, dtype)
            x = x + self._table(self.pos_table, get_2d_sincos_pos_embed, H // p, (H // p) ** 2, dtype)
        else:
            x = front_state

        t_mod, emb = self.adaln_single(timestep, dtype)
        ctx = self.caption_projection(encoder_hidden_states.to(dtype))
        if use_image_num and train:
            # (B, 1+I, L, D): caption 0 for the Fv video frames, then one per image
            ctx = torch.cat([ctx[:, :1].expand(-1, Fv, -1, -1), ctx[:, 1:]], dim=1)
            ctx = ctx.reshape(B * F, *ctx.shape[2:])
        else:
            ctx = ctx.repeat_interleave(F, dim=0)
        ctx_bias = None
        if encoder_attention_mask is not None:
            bias = (1.0 - encoder_attention_mask.float()) * MASK_BIAS
            if bias.dim() == 2:
                ctx_bias = bias[:, None, :].repeat_interleave(F, dim=0)
            else:
                bias = torch.cat([bias[:, :1].expand(-1, Fv, -1), bias[:, 1:]], dim=1)
                ctx_bias = bias.reshape(B * F, 1, -1)

        temp = self._table(self.temp_table, get_1d_sincos_pos_embed, Fv, Fv, dtype) if Fv > 1 else None
        front, aux = None, []
        for i in range(start_pair, self.num_layers):
            x, pair_aux = self._run_pair(self._pair, i, x, t_mod, ctx, ctx_bias, temp if i == 0 else None, B, F,
                                         Fv)
            aux.append(pair_aux)
            if i == return_front - 1:
                front = x

        x = self._head(x, emb, B)
        out = x.view(B, F, *x.shape[1:]).transpose(1, 2).to(in_dtype)
        if return_aux:
            return out, loss_columns(aux)
        return (out, front) if return_front else out
