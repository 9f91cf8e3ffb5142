"""Weight carry-over: JAX/Flax Latte params -> the port's state dict.

The port's own copy of ``latte_tpu/tools/convert.py``
(``flax_to_reference_state_dict``), plus the two steps that make its output
load into :class:`latte_tpu_torch.models.Latte` with ``strict=True``: the
patch-embedding weight is reshaped from (D, C·p·p) to the conv's
(D, C, p, p), and the leaves become torch tensors. The qkv projection goes
from the JAX head-major (H, 3, hd) column layout to the reference's
``[q|k|v]`` rows. The frozen sincos tables are not carried: the model
computes them. Works on any nested mapping of arrays (``np.asarray`` is
applied to every leaf), so it needs neither JAX nor Flax. The map is linear
(transposes, reshapes and the qkv permutation), so it carries a tree shaped
like the params, such as a gradient tree of ``jax.grad`` or a train state's
EMA, onto the same parameter names.

A quantized tree (``latte_tpu.quant.quantize_params``) carries over too:
``kernel_i8`` becomes ``weight_i8`` (int8, transposed; for qkv with the same
permutation of its output channels), ``kernel_scale`` (1, out) becomes
``weight_scale`` (out, 1) (permuted alike), and ``act_scale`` and the
attention's ``{q,k,v}_scale`` keep their names. :func:`flax_calib_to_amax`
carries the ``"calib"`` collection of a JAX calibration run onto the keys of
``latte_tpu_torch.quant.calibrate_act_amax``.

The SD VAE: :func:`flax_vae_to_state_dict` carries the JAX VAE's params onto
the port's (diffusers') keys, the inverse of
``latte_tpu/tools/convert_vae.py``'s ``convert_vae_state_dict``, and
:func:`load_vae_state_dict` reads a diffusers ``AutoencoderKL`` state dict,
the legacy attention names included.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = [
    "qkv_to_reference",
    "flax_to_state_dict",
    "flax_calib_to_amax",
    "load_flax_params",
    "load_reference_checkpoint",
    "flax_vae_to_state_dict",
    "load_vae_state_dict",
]

# frozen sincos tables in reference checkpoints; the port recomputes them
FROZEN_BUFFERS = ("pos_embed", "temp_embed")


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def qkv_to_reference(kernel, bias, num_heads: int):
    """Flax qkv ``kernel`` (D, 3D) and ``bias`` (3D,), columns head-major
    (H, 3, hd) -> torch ``weight`` (3D, D) and ``bias`` with ``[q|k|v]`` rows."""
    k = np.asarray(kernel)
    d = k.shape[0]
    hd = d // num_heads
    w = k.reshape(d, num_heads, 3, hd).transpose(2, 1, 3, 0).reshape(3 * d, d)
    b = None if bias is None else np.asarray(bias).reshape(num_heads, 3, hd).transpose(1, 0, 2)
    return np.ascontiguousarray(w), None if b is None else np.ascontiguousarray(b.reshape(-1))


def flax_to_state_dict(
    params: Mapping[str, Any], depth: int, num_heads: int, patch_size: int
) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (the tree under ``"params"``), or any tree of that
    shape such as its gradient, -> the port's state dict."""
    sd: Dict[str, np.ndarray] = {}

    def put_linear(prefix: str, p: Mapping[str, Any]) -> None:
        if "kernel_i8" in p:
            sd[f"{prefix}.weight_i8"] = _t(p["kernel_i8"])
            sd[f"{prefix}.weight_scale"] = np.asarray(p["kernel_scale"]).reshape(-1, 1)
        else:
            sd[f"{prefix}.weight"] = _t(p["kernel"])
        for key in ("act_scale", "bias"):
            if key in p:
                sd[f"{prefix}.{key}"] = np.asarray(p[key])

    def put_qkv(prefix: str, p: Mapping[str, Any]) -> None:
        if "kernel_i8" in p:
            w, b = qkv_to_reference(p["kernel_i8"], p.get("bias"), num_heads)
            _, scale = qkv_to_reference(p["kernel_i8"], np.asarray(p["kernel_scale"]).reshape(-1), num_heads)
            sd[f"{prefix}.weight_i8"], sd[f"{prefix}.weight_scale"] = w, scale.reshape(-1, 1)
            if "act_scale" in p:
                sd[f"{prefix}.act_scale"] = np.asarray(p["act_scale"])
        else:
            w, b = qkv_to_reference(p["kernel"], p.get("bias"), num_heads)
            sd[f"{prefix}.weight"] = w
        if b is not None:
            sd[f"{prefix}.bias"] = b

    k = np.asarray(params["x_embedder"]["proj"]["kernel"])  # (C·p·p, D)
    D = k.shape[1]
    C = k.shape[0] // (patch_size * patch_size)
    sd["x_embedder.proj.weight"] = _t(k).reshape(D, C, patch_size, patch_size)
    sd["x_embedder.proj.bias"] = np.asarray(params["x_embedder"]["proj"]["bias"])
    put_linear("t_embedder.mlp.0", params["t_embedder"]["mlp_0"])
    put_linear("t_embedder.mlp.2", params["t_embedder"]["mlp_2"])
    if "y_embedder" in params:
        sd["y_embedder.embedding_table.weight"] = np.asarray(
            params["y_embedder"]["embedding_table"]
        )

    for i in range(depth // 2):
        for kind, idx in (("spatial", 2 * i), ("temporal", 2 * i + 1)):
            blk = _unstack(params["blocks"][kind], i)
            put_qkv(f"blocks.{idx}.attn.qkv", blk["attn"]["qkv"])
            put_linear(f"blocks.{idx}.attn.proj", blk["attn"]["proj"])
            put_linear(f"blocks.{idx}.mlp.fc1", blk["mlp"]["fc1"])
            put_linear(f"blocks.{idx}.mlp.fc2", blk["mlp"]["fc2"])
            put_linear(f"blocks.{idx}.adaLN_modulation.1", blk["adaLN_modulation"])
            for name in _ATTN_SCALES:
                if name in blk["attn"]:
                    sd[f"blocks.{idx}.attn.{name}"] = np.asarray(blk["attn"][name])
    put_linear("final_layer.adaLN_modulation.1", params["final_layer"]["adaLN_modulation"])
    put_linear("final_layer.linear", params["final_layer"]["linear"])
    return {key: _tensor(v) for key, v in sd.items()}


_ATTN_SCALES = ("q_scale", "k_scale", "v_scale")


def _tensor(a) -> torch.Tensor:
    """int8 stays int8; every other leaf becomes fp32."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, dtype=np.int8 if a.dtype == np.int8 else np.float32))


def _unstack(tree, i):
    if isinstance(tree, Mapping):
        return {key: _unstack(v, i) for key, v in tree.items()}
    return np.asarray(tree)[i]


def flax_calib_to_amax(calib: Mapping[str, Any], depth: int) -> Dict[str, torch.Tensor]:
    """The ``"calib"`` collection of a JAX ``quantized="calib"`` run (amax
    stacked over the scanned pairs) -> the port's amax dict: ``.../act_amax``
    -> ``blocks.{i}.<layer>.act_amax`` and ``attn/{q,k,v}_amax`` ->
    ``blocks.{i}.attn.{q,k,v}_amax``. The attention amax are per head, so
    the qkv permutation does not touch them."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, v in tree.items():
            name = "adaLN_modulation.1" if key == "adaLN_modulation" else key
            if isinstance(v, Mapping):
                walk(v, f"{prefix}.{name}")
            else:
                out[f"{prefix}.{name}"] = _tensor(v)

    for i in range(depth // 2):
        for kind, idx in (("spatial", 2 * i), ("temporal", 2 * i + 1)):
            walk(_unstack(calib["blocks"][kind], i), f"blocks.{idx}")
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping[str, Any]) -> torch.nn.Module:
    """Load Flax ``params`` into ``model`` (strict: every key must match)."""
    sd = flax_to_state_dict(
        params, model.depth, model.num_heads, model.patch_size
    )
    model.load_state_dict(sd, strict=True)
    return model


def load_reference_checkpoint(path: str, prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A reference-format ``.pt`` (a state dict, or ``{"model", "ema"}`` of
    them; "ema" preferred as by the reference loader) -> the port's state
    dict, without the frozen sincos tables."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(ckpt, dict) and ("ema" in ckpt or "model" in ckpt):
        ckpt = ckpt["ema"] if prefer_ema and "ema" in ckpt else ckpt["model"]
    return {k: v for k, v in ckpt.items() if k not in FROZEN_BUFFERS}


# the JAX VAE's module names -> diffusers' (the port's), one path segment at a time
_VAE_NAMES = (
    (re.compile(r"^(down|up)_blocks_(\d+)_resnets_(\d+)$"), r"\1_blocks.\2.resnets.\3"),
    (re.compile(r"^down_blocks_(\d+)_downsample$"), r"down_blocks.\1.downsamplers.0"),
    (re.compile(r"^up_blocks_(\d+)_upsample$"), r"up_blocks.\1.upsamplers.0"),
    (re.compile(r"^mid_resnet_(\d+)$"), r"mid_block.resnets.\1"),
    (re.compile(r"^mid_attn$"), "mid_block.attentions.0"),
    (re.compile(r"^to_out$"), "to_out.0"),
)
# Dense layers of the JAX VAE that are 1x1 convs in diffusers
_VAE_1X1 = ("quant_conv", "post_quant_conv")
# diffusers < 0.18 names of the attention projections, stored as 1x1 convs
_VAE_LEGACY_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def flax_vae_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX VAE's params (the tree under ``"params"``; a submodule's tree
    works too) -> the port's state dict: conv kernels (kh, kw, I, O) ->
    (O, I, kh, kw), Dense kernels (I, O) -> (O, I) (attention) or
    (O, I, 1, 1) (quant convs), GroupNorm ``scale`` -> ``weight``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, v in tree.items():
            if isinstance(v, Mapping):
                name = key
                for pattern, repl in _VAE_NAMES:
                    name = pattern.sub(repl, name)
                walk(v, path + [name])
                continue
            a = np.asarray(v)
            if key == "kernel" and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif key == "kernel":
                a = a.T[:, :, None, None] if path[-1] in _VAE_1X1 else a.T
            name = {"kernel": "weight", "scale": "weight"}.get(key, key)
            sd[".".join(path + [name])] = _tensor(np.ascontiguousarray(a))

    walk(params, [])
    return sd


def load_vae_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``torch.load``-able diffusers ``AutoencoderKL`` state dict (or one
    under ``"state_dict"``) -> the port's keys. Legacy attention names
    (``query``/``key``/``value``/``proj_attn``) are renamed, and attention
    projections stored as 1x1 convs (O, I, 1, 1) become (O, I)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for key, v in sd.items():
        parts = key.split(".")
        if ".attentions." in key and parts[-2] in _VAE_LEGACY_ATTN:
            key = ".".join(parts[:-2] + [_VAE_LEGACY_ATTN[parts[-2]], parts[-1]])
        if ".attentions." in key and v.dim() == 4:
            v = v[:, :, 0, 0]
        out[key] = v
    return out
