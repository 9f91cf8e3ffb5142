"""W8A8 int8 serving path and quantized training (port of
``latte_tpu/quant/int8.py``).

- Weights: symmetric per-output-channel int8, quantized once from the fp32
  masters by :func:`quantize_params` (``weight_i8`` and its ``weight_scale``).
- Activations: symmetric int8, per token at run time (:func:`int8_matmul`,
  ``quantized: true``) or per tensor at a calibrated amax
  (:func:`int8_matmul_static`, ``quantized: static``).
- The products run int8×int8→int32 through ``torch._int_mm`` (cuBLASLt on
  the card; the JAX package left them to XLA too) and are rescaled in fp32,
  the result in the model's type.
- The attention core: :func:`int8_attention` with per-head q/k/v scales,
  whose CUDA kernel is ``kernels.flash_attention_int8``.

Conditioning and embedding layers (the final layer, the patch, timestep and
label embedders) stay in floating point. Every division of a scale is one
correctly rounded division, as in JAX (``kernels.attention_int8.ieee_div``),
so the int8 weights and scales match the JAX package's bit for bit.

Usage::

    masters = fp_model.state_dict()                       # fp32
    amax = calibrate_act_amax(calib_model, x, t)           # quantized="calib"
    sd = quantize_params(masters, act_amax=amax)
    get_model(..., quantized="static").load_state_dict(sd, strict=True)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from latte_tpu_torch.kernels.attention_int8 import (
    int8_attention,
    quant_scale,
    quantize_int8,
)

__all__ = [
    "QUANT_TARGETS_BY_PARENT",
    "quantize_weight",
    "int8_matmul",
    "int8_matmul_static",
    "int8_attention",
    "int8_matmul_ste",
    "quantize_params",
    "calibrate_act_amax",
    "merge_amax",
]

# Linear layers that carry the per-token FLOPs, keyed by their parent module
# inside a block (``<blocks>.{i}.<parent>.<layer>.weight``, the layer's name
# possibly dotted); every other weight stays fp. The block's adaLN modulation
# (``adaLN_modulation.1``, the Sequential's Linear) streams as many weight
# bytes per step as the four others together; the final layer's modulation
# is not inside a block and stays fp, as in the JAX model. LatteT2V's
# diffusers-named blocks: the self- and cross-attention projections and the
# feed-forward (the JAX package's ``to_out`` is ``to_out.0`` here, its
# ``net_0_proj`` and ``net_2`` are ``net.0.proj`` and ``net.2``).
QUANT_TARGETS_BY_PARENT = {
    "attn": ("qkv", "proj"),
    "mlp": ("fc1", "fc2"),
    "adaLN_modulation": ("1",),
    "attn1": ("to_q", "to_k", "to_v", "to_out.0"),
    "attn2": ("to_q", "to_k", "to_v", "to_out.0"),
    "ff": ("net.0.proj", "net.2"),
}
# the module lists whose entries are blocks: Latte's, and LatteT2V's spatial
# and temporal ones
BLOCK_LISTS = ("blocks", "transformer_blocks", "temporal_transformer_blocks")
_ATTN_AMAX_KEYS = ("q_amax", "k_amax", "v_amax")

# cuBLASLt's int8 product takes more than 16 rows only (torch._int_mm's own
# check on CUDA); fewer rows are padded with zeros and sliced off
_INT_MM_MIN_ROWS = 17


def quantize_weight(w: torch.Tensor, amax_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a torch (..., out, in) weight:
    the scale is taken over the contraction (in) axis, shape (..., out, 1),
    so it broadcasts back exactly. ``amax_group``: the tp group over which a
    row-parallel weight's contraction axis is split (its amax is the MAX
    over the group, as over the whole axis)."""
    from latte_tpu_torch.dist.tp import tp_amax

    wf = w.detach().float()
    scale = quant_scale(tp_amax(wf.abs().amax(dim=-1, keepdim=True), amax_group))
    return quantize_int8(wf, scale).to(torch.int8), scale


def _int_mm(x_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """(..., in) int8 @ (out, in)ᵀ int8 -> (..., out) int32, exact."""
    lead, k = x_i8.shape[:-1], x_i8.shape[-1]
    x2 = x_i8.reshape(-1, k)
    rows = x2.shape[0]
    if x2.is_cuda and rows < _INT_MM_MIN_ROWS:
        x2 = torch.cat([x2, x2.new_zeros((_INT_MM_MIN_ROWS - rows, k))])
    return torch._int_mm(x2, w_i8.t())[:rows].reshape(*lead, -1)


def int8_matmul(
    x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype, amax_group=None
) -> torch.Tensor:
    """W8A8 product with dynamic per-token activation scales:
    x (..., in) @ w_i8 (out, in)ᵀ · scale (out, 1) -> (..., out).
    ``amax_group``: the tp group over which a row-parallel layer's input
    axis is split; each token's amax is then the MAX over the group, the
    whole row's (``dist.tp.tp_amax``)."""
    from latte_tpu_torch.dist.tp import tp_amax

    xf = x.float()
    ax = quant_scale(tp_amax(xf.abs().amax(dim=-1, keepdim=True), amax_group))
    acc = _int_mm(quantize_int8(xf, ax).to(torch.int8), w_i8)
    return (acc.float() * ax * scale.reshape(-1)).to(out_dtype)


def int8_matmul_static(
    x: torch.Tensor,
    w_i8: torch.Tensor,
    scale: torch.Tensor,
    act_scale: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """W8A8 product with a calibrated per-tensor activation amax
    (``act_scale``, from :func:`calibrate_act_amax`): no amax pass at run time."""
    ax = quant_scale(act_scale)
    acc = _int_mm(quantize_int8(x, ax).to(torch.int8), w_i8)
    return (acc.float() * ax * scale.reshape(-1)).to(out_dtype)


class _Int8MatmulSTE(torch.autograd.Function):
    """W8A8 forward from the fp master weight, straight-through backward."""

    @staticmethod
    def forward(ctx, x, w, out_dtype, amax_group):
        ctx.save_for_backward(x, w)
        w_i8, scale = quantize_weight(w, amax_group)
        return int8_matmul(x, w_i8, scale, out_dtype, amax_group)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        # the quantizers pass gradients through unchanged: the fp products
        # in g's type with fp32 sums, each cast back to its primal's type
        dx = torch.matmul(g, w.to(g.dtype)).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1]).to(g.dtype).float()
        dw = torch.matmul(g.reshape(-1, g.shape[-1]).float().t(), x2).to(w.dtype)
        return dx, dw, None, None


def int8_matmul_ste(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype, amax_group=None) -> torch.Tensor:
    """Quantized-training product: the forward runs exactly the serving
    arithmetic (quantize the fp master ``w`` (out, in) per channel and ``x``
    per token, int32 sums); the backward is the fp one, ``dx = g·w`` and
    ``dw = gᵀ·x`` (the straight-through estimator), so the optimizer updates
    fp masters and checkpoints stay interchangeable with the fp path.
    ``amax_group`` as in :func:`int8_matmul`, for the weight's scales too."""
    return _Int8MatmulSTE.apply(x, w, out_dtype, amax_group)


def _is_target(key: str) -> bool:
    """``blocks.{i}.attn.qkv.weight``, ``transformer_blocks.{i}.ff.net.0.proj.weight``
    and the like; ``x_embedder.proj``, ``pos_embed.proj`` and the output
    layers are not inside a block."""
    parts = key.split(".")
    return (
        len(parts) >= 5
        and parts[0] in BLOCK_LISTS
        and parts[-1] == "weight"
        and ".".join(parts[3:-1]) in QUANT_TARGETS_BY_PARENT.get(parts[2], ())
    )


def quantize_params(
    state_dict: Dict[str, torch.Tensor], act_amax: Optional[Dict[str, torch.Tensor]] = None
) -> Dict[str, torch.Tensor]:
    """fp state dict -> the state dict of a ``quantized=True`` model, or with
    ``act_amax`` (from :func:`calibrate_act_amax`) of a ``quantized="static"``
    one.

    Each targeted ``<layer>.weight`` becomes ``<layer>.weight_i8`` (int8) and
    ``<layer>.weight_scale`` (fp32 (out, 1)); with ``act_amax`` the layer also
    gets ``<layer>.act_scale``, its calibrated input amax, and each attention
    that recorded per-head amax gets ``q_scale``, ``k_scale`` and ``v_scale``
    (the amax, fp32 (H,)). Everything else passes through unchanged.
    """
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if not _is_target(key):
            out[key] = value
            continue
        layer = key[: -len(".weight")]
        out[f"{layer}.weight_i8"], out[f"{layer}.weight_scale"] = quantize_weight(value)
        if act_amax is not None:
            if f"{layer}.act_amax" not in act_amax:
                raise KeyError(
                    f"the calibration has no entry for {layer}; run the model with "
                    "quantized='calib' over representative inputs first"
                )
            out[f"{layer}.act_scale"] = act_amax[f"{layer}.act_amax"].float()
    for key, value in (act_amax or {}).items():
        name = key.rsplit(".", 1)[-1]
        if name in _ATTN_AMAX_KEYS:
            out[key[: -len("_amax")] + "_scale"] = value.float()
    return out


@torch.no_grad()
def calibrate_act_amax(model: torch.nn.Module, *args, **kwargs) -> Dict[str, torch.Tensor]:
    """One calibration forward of a ``quantized="calib"`` model; returns the
    amax it recorded, keyed ``<layer>.act_amax`` (a target's input, a scalar)
    and ``<attention>.{q,k,v}_amax`` (per head, over batch, tokens and
    head_dim). Call over representative inputs (e.g. several timesteps) and
    merge with :func:`merge_amax`."""
    recorders = {name: m for name, m in model.named_modules() if getattr(m, "calib", None) is not None}
    if not recorders:
        raise ValueError("the model records no amax: build it with quantized='calib'")
    for m in recorders.values():
        m.calib.clear()
    model(*args, **kwargs)
    return {f"{name}.{k}": v for name, m in recorders.items() for k, v in m.calib.items()}


def merge_amax(a: Optional[Dict[str, torch.Tensor]], b: Dict[str, torch.Tensor]):
    """Elementwise max of two calibrations (``a`` may be None)."""
    if a is None:
        return dict(b)
    return {k: torch.maximum(a[k], b[k]) for k in a}
