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
``moe_experts > 1`` swaps a block's MLP for the Mixture-of-Experts
feed-forward (:mod:`latte_tpu_torch.models.moe`), as in the JAX block.

Tensor parallelism (``tp > 1``, :mod:`latte_tpu_torch.dist.tp`): the
block's attention holds H/tp heads (its ``qkv`` the rows of those heads of
q, k and v, its ``proj`` those columns) and its MLP 4D/tp hidden columns;
each runs its partial product (``partial``) between ``tp_enter`` and
``tp_reduce``, and the row-parallel bias is added once after the sum. The
adaLN modulation and the glue kernels run on the whole, replicated rows, as
in JAX. The weights are the rank's part of the one-process model's
(``dist.sharding.tp_shard``).

``attention_mode: "ring"`` (:mod:`latte_tpu_torch.dist.ring`) runs the
self-attention as ring attention over the ``ring`` group (a ``DistContext``,
whose ``sp`` group it takes, or a process group), falling back to the
standard attention when the group's size does not divide N; without a group
it raises the JAX model's ``ValueError``. The ring has no int8 core: with
``int8_attention`` a warning says so and the ring runs in the model's type.

W8A8 int8 (``quantized``, the JAX ``QDense`` modes): the block's qkv, proj,
fc1, fc2 and adaLN modulation are :class:`QLinear` layers, and with
``int8_attention`` the attention core runs int8 too
(:func:`latte_tpu_torch.kernels.flash_attention_int8`). The int8 weights and
their fp32 scales are buffers, loaded from
:func:`latte_tpu_torch.quant.quantize_params`; the scales stay fp32 when the
model is cast to bf16, as the JAX model keeps its scale params fp32.

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
    flash_attention_int8,
    flash_scale_block,
    ln_modulate,
    ln_modulate_reference,
    residual_ln_modulate,
    residual_ln_modulate_reference,
)
from latte_tpu_torch.dist.tp import tp_amax, tp_enter, tp_reduce
from latte_tpu_torch.quant.int8 import (
    int8_attention,
    int8_matmul,
    int8_matmul_static,
    int8_matmul_ste,
)

__all__ = [
    "Linear",
    "QLinear",
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


QUANT_MODES = (False, True, "static", "calib", "train")
MOE_INT8_REFUSAL = (
    "quantized (W8A8/QAT) + moe_experts is not supported: MoEMlp has no int8 expert path"
)
INT8_ATTENTION = (False, True, "full", "qk")
ATTENTION_MODES = ("auto", "xla", "flash", "math", "ring")
RING_NEEDS_GROUP = (
    "attention_mode='ring' requires constructing the model with ring_mesh=<a DistContext or a process "
    "group> (the ring runs over its sp group)"
)
# "auto" gives the int8 core the flash arithmetic from this many tokens on,
# as the JAX model routes N >= 512 to its flash kernel
FLASH_MIN_N = 512


class _Fp32Scales(nn.Module):
    """Keeps the buffers and parameters named in ``FP32_BUFFERS`` in fp32
    when the module is cast (``model.to(torch.bfloat16)``); device moves
    apply as usual."""

    FP32_BUFFERS: tuple = ()

    def _apply(self, fn, recurse=True):
        # a parameter's cast may rewrite its .data in place: keep the tensor
        kept = {
            n: (store, store[n].detach())
            for n in self.FP32_BUFFERS
            for store in (self._buffers, self._parameters)
            if store.get(n) is not None
        }
        super()._apply(fn, recurse)
        for name, (store, old) in kept.items():
            moved = store[name]
            if moved.dtype != old.dtype:
                old = old.to(moved.device)
                store[name] = nn.Parameter(old, moved.requires_grad) if store is self._parameters else old
        return self


class QLinear(_Fp32Scales, Linear):
    """:class:`Linear` with the W8A8 modes of the JAX ``QDense``
    (``latte_tpu/models/layers.py:25-111``):

    - ``False``: the fp layer (``weight``, ``bias``);
    - ``True``: int8 ``weight_i8`` (out, in) at the fp32 per-channel
      ``weight_scale`` (out, 1), dynamic per-token activation scales;
    - ``"static"``: the same with a calibrated activation amax ``act_scale``;
    - ``"calib"``: the fp layer, recording the amax of its input into
      ``calib["act_amax"]`` (see ``quant.calibrate_act_amax``);
    - ``"train"``: quantized training, a W8A8 forward from the fp master
      ``weight`` with a straight-through backward (``quant.int8_matmul_ste``).

    The int8 products give their result in the input's type, and the bias is
    added after that cast, as in JAX.
    """

    FP32_BUFFERS = ("weight_scale", "act_scale")

    def __init__(self, in_features: int, out_features: int, bias: bool = True, quantized=False):
        super().__init__(in_features, out_features, bias=bias)
        if quantized not in QUANT_MODES:
            raise ValueError(f"quantized={quantized!r}; expected one of {QUANT_MODES}")
        self.quantized = quantized
        self.calib = {} if quantized == "calib" else None
        # a row-parallel layer's DistContext: its input axis is split over its tp
        self.tp_mesh = None
        if quantized in (True, "static"):
            self.weight = None  # the fp weight is replaced by its int8 form
            self.register_buffer("weight_i8", torch.zeros((out_features, in_features), dtype=torch.int8))
            self.register_buffer("weight_scale", torch.ones((out_features, 1)))
            if quantized == "static":
                self.register_buffer("act_scale", torch.ones(()))

    def _calibrate(self, x: torch.Tensor) -> None:
        if self.quantized == "calib":
            _record_max(self.calib, "act_amax", tp_amax(x.detach().abs().amax().float(), self.amax_group))

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The layer without its bias (a row-parallel layer's partial
        product under tp)."""
        mode = self.quantized
        if mode is False or mode == "calib":
            self._calibrate(x)
            return F.linear(x, self.weight.to(x.dtype))
        if mode == "train":
            return int8_matmul_ste(x, self.weight, x.dtype, self.amax_group)
        if mode == "static":
            return int8_matmul_static(x, self.weight_i8, self.weight_scale, self.act_scale, x.dtype)
        return int8_matmul(x, self.weight_i8, self.weight_scale, x.dtype, self.amax_group)

    @property
    def amax_group(self):
        return _tp_group(self.tp_mesh)

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantized is False or self.quantized == "calib":
            self._calibrate(x)
            return super().forward(x)
        return self.add_bias(self.product(x))


def _tp_group(mesh):
    """The tp group of a ``DistContext`` (None without one, or at tp = 1).
    Modules keep the context, which a deep copy (the EMA) shares, and not
    the process group, which cannot be copied."""
    return mesh.tp_group if mesh is not None and mesh.tp > 1 else None


def _record_max(record: dict, key: str, value: torch.Tensor) -> None:
    """``record[key] = max(record[key], value)`` (the JAX ``sow`` with a max)."""
    prev = record.get(key)
    record[key] = value if prev is None else torch.maximum(prev, value)


class Mlp(nn.Module):
    """Linear -> gelu(tanh) -> Linear; under ``tp`` the rank's ``hidden/tp``
    columns (``fc1`` column-parallel, ``fc2`` row-parallel)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int, quantized=False,
                 tp: int = 1, tp_mesh=None):
        super().__init__()
        if hidden_features % tp:
            raise ValueError(f"tensor_parallel={tp} does not divide the MLP's {hidden_features} columns")
        self.tp, self.tp_mesh = tp, tp_mesh
        self.fc1 = QLinear(in_features, hidden_features // tp, quantized=quantized)
        self.fc2 = QLinear(hidden_features // tp, out_features, quantized=quantized)
        self.fc2.tp_mesh = tp_mesh

    @property
    def tp_group(self):
        return _tp_group(self.tp_mesh)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns through both layers, without fc2's bias."""
        return self.fc2.product(F.gelu(self.fc1(x), approximate="tanh"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
        return self.fc2.add_bias(tp_reduce(self.partial(tp_enter(x, self.tp_group)), self.tp_group))


class Attention(_Fp32Scales):
    """Multi-head self-attention through the flash-attention kernels.

    ``int8_attention`` (``True``/"full": QKᵀ and P·V int8; "qk": QKᵀ only)
    runs the int8 core at calibrated per-head scales ``q_scale``, ``k_scale``,
    ``v_scale`` (H,) under ``quantized="static"``, and records the per-head
    amax of q, k, v under ``quantized="calib"``; with any other ``quantized``
    but ``False`` (the fp model a serving run starts from) it raises. The
    int8 core takes the route of the JAX model: ``attention_mode`` "flash",
    or "auto" at N ≥ ``FLASH_MIN_N``, is the flash kernel's arithmetic, any
    other the fused core's; both run the same CUDA kernel here.
    """

    FP32_BUFFERS = ("q_scale", "k_scale", "v_scale")

    def __init__(
        self,
        dim: int,
        num_heads: int,
        qkv_bias: bool = True,
        plain: bool = False,
        quantized=False,
        int8_attention=False,
        attention_mode: str = "auto",
        tp: int = 1,
        tp_mesh=None,
        ring_mesh=None,
    ):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        if num_heads % tp:
            raise ValueError(f"tensor_parallel={tp} does not divide num_heads {num_heads}")
        if int8_attention not in INT8_ATTENTION:
            raise ValueError(
                f"int8_attention={int8_attention!r}; expected False, True/'full' "
                "(QKᵀ and P·V int8) or 'qk' (QKᵀ only)"
            )
        if int8_attention and quantized and quantized not in ("static", "calib"):
            raise ValueError(
                "int8_attention requires quantized='static' (serving, with params from "
                "quantize_params(act_amax=...)) or 'calib' (the calibration pass); got "
                f"quantized={quantized!r}"
            )
        if tp > 1 and quantized == "calib":
            raise ValueError("calibrate the one-process model (quantized='calib' at tensor_parallel 1), then shard")
        if attention_mode == "ring" and ring_mesh is None:
            raise ValueError(RING_NEEDS_GROUP)
        self.num_heads = num_heads // tp  # this rank's heads
        self.head_dim = dim // num_heads
        self.tp, self.tp_mesh = tp, tp_mesh
        self.ring_mesh = ring_mesh
        self.plain = plain
        self.attention_mode = attention_mode
        self.int8 = bool(int8_attention) and quantized == "static"
        self.pv_int8 = int8_attention != "qk"
        self.calib = {} if int8_attention and quantized == "calib" else None
        local = self.num_heads * self.head_dim
        self.qkv = QLinear(dim, local * 3, bias=qkv_bias, quantized=quantized)
        self.proj = QLinear(local, dim, quantized=quantized)
        self.proj.tp_mesh = tp_mesh
        if self.int8:
            for name in ("q_scale", "k_scale", "v_scale"):
                self.register_buffer(name, torch.ones(self.num_heads))

    @property
    def tp_group(self):
        return _tp_group(self.tp_mesh)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's heads through qkv, the attention and its columns of
        proj, without proj's bias (the whole layer at tp = 1, bias aside)."""
        return self.proj.product(self._core(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return self.proj(self._core(x))
        return self.proj.add_bias(tp_reduce(self.partial(tp_enter(x, self.tp_group)), self.tp_group))

    def _core(self, x: torch.Tensor) -> torch.Tensor:
        """qkv and the attention: (B, N, C) -> (B, N, H·hd) of this rank's heads."""
        B, N, _ = x.shape
        # [q|k|v] rows: q, k, v are strided (B, N, H, hd) views of one tensor,
        # which the kernels read in place; the backward writes its gradient
        # back as one (B, N, 3, H, hd) tensor
        qkv = self.qkv(x).view(B, N, 3, self.num_heads, self.head_dim)
        if self.calib is not None:
            for name, t in zip(("q_amax", "k_amax", "v_amax"), qkv.detach().unbind(2)):
                _record_max(self.calib, name, t.float().abs().amax(dim=(0, 1, 3)))
        mode = self.attention_mode
        if mode == "ring":
            mode = self._ring_mode(N)
        if mode == "ring":
            from latte_tpu_torch.dist.ring import ring_attention_sharded

            out = ring_attention_sharded(*qkv.unbind(2), self.ring_mesh)
        elif self.int8:
            out = self._int8_core(qkv, mode)
        else:
            out = attention_qkv(qkv, plain=self.plain)
        return out.reshape(B, N, self.num_heads * self.head_dim)

    def _ring_mode(self, N: int) -> str:
        """"ring", or "xla" (the standard attention) when the ring's size
        does not divide N, as in JAX; a warning when int8 attention was asked
        for, which the ring does not have."""
        from latte_tpu_torch.dist.ring import ring_size

        if self.int8:
            import warnings

            warnings.warn(
                f"int8_attention: resolved attention mode 'ring' at N={N} has no int8 core — this "
                "attention call runs bf16; use attention_mode='xla'/'flash' to keep int8 attention",
                stacklevel=3,
            )
        return "xla" if N % ring_size(self.ring_mesh) else "ring"

    def _int8_core(self, qkv: torch.Tensor, mode: str) -> torch.Tensor:
        q, k, v = qkv.unbind(2)
        N = q.shape[1]
        if mode == "auto":
            mode = "flash" if N >= FLASH_MIN_N else "xla"
        scale_block = flash_scale_block(N) if mode == "flash" else None
        scales = (self.q_scale, self.k_scale, self.v_scale)
        if self.plain:
            return int8_attention(q, k, v, *scales, q.dtype, self.pv_int8, scale_block)
        return flash_attention_int8(q, k, v, *scales, self.pv_int8, scale_block)


class AdaLNBlock(nn.Module):
    """DiT block with adaLN-Zero conditioning and the fused glue kernels:
    ``ln_modulate`` before attention, ``residual_ln_modulate`` after it
    (the JAX block's ``fused_adaln=True`` path). The adaLN modulation is
    quantized for int8 serving and its calibration, not for quantized
    training (it is zero-init sensitive), as in JAX.

    With ``moe_experts > 1`` the feed-forward is :class:`~latte_tpu_torch.
    models.moe.MoEMlp` (``self.moe`` in place of ``self.mlp``, fed by the
    same ``residual_ln_modulate``) and the block returns ``(x, aux)``, its
    Switch loss beside the output. It has no int8 expert path: a quantized
    block with MoE raises ``NotImplementedError``, as in JAX."""

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        plain: bool = False,
        quantized=False,
        int8_attention=False,
        attention_mode: str = "auto",
        moe_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity_factor: float = 1.25,
        moe_mesh=None,
        tp: int = 1,
        tp_mesh=None,
        ring_mesh=None,
    ):
        super().__init__()
        self.plain = plain
        self.tp, self.tp_mesh = tp, tp_mesh
        # virtual tensor parallelism (dist.tp.virtual_tp): every shard of this
        # block, whose partial products the forward sums by hand
        self.tp_peers = None
        self.attn = Attention(
            hidden_size, num_heads, qkv_bias=True, plain=plain, quantized=quantized,
            int8_attention=int8_attention, attention_mode=attention_mode, tp=tp, tp_mesh=tp_mesh,
            ring_mesh=ring_mesh,
        )
        hidden = int(hidden_size * mlp_ratio)
        self.is_moe = moe_experts > 1
        if self.is_moe:
            from latte_tpu_torch.models.moe import MoEMlp

            if quantized:
                raise NotImplementedError(MOE_INT8_REFUSAL)
            # the experts are replicated over tp: every tp rank runs them on the same rows
            self.moe = MoEMlp(hidden_size, hidden, hidden_size, moe_experts, moe_top_k, moe_capacity_factor,
                              mesh=moe_mesh)
        else:
            self.mlp = Mlp(hidden_size, hidden, hidden_size, quantized=quantized, tp=tp, tp_mesh=tp_mesh)
        mod_quantized = quantized if quantized in (True, "static", "calib") else False
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), QLinear(hidden_size, 6 * hidden_size, quantized=mod_quantized)
        )

    def _row_parallel(self, name: str, h: torch.Tensor) -> torch.Tensor:
        """The attention or MLP (``name``) on h: the layer itself (whose tp
        shards all-reduce their partial products), or under virtual tp the
        sum of every shard's partial product, and the bias once."""
        if self.tp_peers is None:
            return getattr(self, name)(h)
        layer = getattr(self, name)
        total = sum(getattr(b, name).partial(h) for b in self.tp_peers)
        return (layer.proj if name == "attn" else layer.fc2).add_bias(total)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            self.adaLN_modulation(c).chunk(6, dim=-1)
        )
        if self.plain:
            ln_mod, res_ln_mod = ln_modulate_reference, residual_ln_modulate_reference
        else:
            ln_mod, res_ln_mod = ln_modulate, residual_ln_modulate
        attn_out = self._row_parallel("attn", ln_mod(x, shift_msa, scale_msa))
        x, ff_in = res_ln_mod(x, attn_out, gate_msa, shift_mlp, scale_mlp)
        if self.is_moe:
            ff, aux = self.moe(ff_in)
            return x + gate_mlp[:, None, :] * ff, aux
        return x + gate_mlp[:, None, :] * self._row_parallel("mlp", ff_in)


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
