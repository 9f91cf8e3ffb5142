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

LatteT2V: :func:`flax_t2v_to_state_dict` carries the JAX model's params
(pair-stacked ``blocks/spatial`` and ``blocks/temporal``, quantized leaves
too) onto the port's diffusers names, and :func:`load_t2v_state_dict`
reads the reference's ``.pt`` / ``.bin`` or ``.safetensors`` (through
:func:`read_safetensors`, plain Python: the machine with the card has no
``safetensors`` package), refusing keys that the model does not have, as
``latte_tpu/tools/convert_t2v.py`` does.

Mixture-of-Experts blocks: the JAX ``moe`` leaves (``router``, ``wi``,
``bi``, ``wo``, ``bo``, stacked (n_pairs, E, ...) a block column) keep
their names and layouts, under ``blocks.{i}.moe.*``,
``transformer_blocks.{i}.moe.*`` and ``temporal_transformer_blocks.{i}.moe.*``.
No reference checkpoint holds expert weights (the JAX converter maps none),
so :func:`load_t2v_state_dict` for an MoE model names them as missing.

Latte's ``extras: 78`` text conditioning: ``text_embedding_projection``
(a Dense of the flattened (77, 768) CLIP features in ``Latte``, of 768 in
``LatteIMG``) carries over as a linear; :func:`load_flax_params` names the
width when it is not the model's.

The text encoders: :func:`flax_t5_to_state_dict` and
:func:`flax_clip_to_state_dict` carry transformers' ``FlaxT5EncoderModel``
and ``FlaxCLIPTextModel`` params onto Hugging Face's torch names (the
port's), and :func:`load_hf_weights` streams a Hugging Face directory's
weights (``model.safetensors``, sharded safetensors with their index,
``pytorch_model.bin`` and its shards) into a model one file at a time.

The SVD temporal decoder: :func:`flax_temporal_decoder_to_state_dict`
carries the JAX ``TemporalDecoder``'s params onto diffusers' names, and
:func:`load_temporal_decoder_state_dict` loads a diffusers
``AutoencoderKLTemporalDecoder`` state dict (``decoder.``-prefixed or bare)
strictly.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from latte_tpu_torch.dist.pipeline import stage_range

__all__ = [
    "qkv_to_reference",
    "flax_to_state_dict",
    "flax_calib_to_amax",
    "load_flax_params",
    "load_reference_checkpoint",
    "flax_vae_to_state_dict",
    "load_vae_state_dict",
    "flax_t2v_to_state_dict",
    "t2v_keys",
    "load_t2v_state_dict",
    "read_safetensors",
    "flax_t5_to_state_dict",
    "flax_clip_to_state_dict",
    "hf_weight_files",
    "load_hf_weights",
    "flax_temporal_decoder_to_state_dict",
    "load_temporal_decoder_state_dict",
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
    params: Mapping[str, Any], depth: int, num_heads: int, patch_size: int, pp: int = 1, pp_rank: int = 0
) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (the tree under ``"params"``), or any tree of that
    shape such as its gradient, -> the port's state dict. ``pp > 1``: the
    pairs of pipeline stage ``pp_rank`` alone (the stacked leading
    ``n_pairs`` axis split as ``pp_param_shardings`` splits it), under their
    one-process names."""
    sd: Dict[str, np.ndarray] = {}

    def put_linear(prefix: str, p: Mapping[str, Any]) -> None:
        _put_linear(sd, prefix, p)

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
    if "text_embedding_projection" in params:
        put_linear("text_embedding_projection", params["text_embedding_projection"])

    for i in stage_range(depth // 2, pp, pp_rank):
        for kind, idx in (("spatial", 2 * i), ("temporal", 2 * i + 1)):
            blk = _unstack(params["blocks"][kind], i)
            put_qkv(f"blocks.{idx}.attn.qkv", blk["attn"]["qkv"])
            put_linear(f"blocks.{idx}.attn.proj", blk["attn"]["proj"])
            if "moe" in blk:
                _put_moe(sd, f"blocks.{idx}.moe", blk["moe"])
            else:
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
# the MoE feed-forward's parameters, in the JAX layer's names and layouts
MOE_PARAMS = ("router", "wi", "bi", "wo", "bo")


def _put_moe(sd: Dict[str, np.ndarray], prefix: str, p: Mapping[str, Any]) -> None:
    for name in MOE_PARAMS:
        sd[f"{prefix}.{name}"] = np.asarray(p[name])


def _put_linear(sd: Dict[str, np.ndarray], prefix: str, p: Mapping[str, Any]) -> None:
    """A Flax Dense (or quantized ``QDense``) -> ``<prefix>.weight`` (out, in)
    or ``.weight_i8`` and ``.weight_scale`` (out, 1), with its bias and
    ``act_scale``."""
    if "kernel_i8" in p:
        sd[f"{prefix}.weight_i8"] = _t(p["kernel_i8"])
        sd[f"{prefix}.weight_scale"] = np.asarray(p["kernel_scale"]).reshape(-1, 1)
    else:
        sd[f"{prefix}.weight"] = _t(p["kernel"])
    for key in ("act_scale", "bias"):
        if key in p:
            sd[f"{prefix}.{key}"] = np.asarray(p[key])


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
    """Load Flax ``params`` into ``model`` (strict: every key must match); a
    pipeline stage's model takes its pairs."""
    sd = flax_to_state_dict(
        params, model.depth, model.num_heads, model.patch_size, model.pp, model.pp_rank
    )
    proj = getattr(model, "text_embedding_projection", None)
    key = "text_embedding_projection.weight"
    if proj is not None and key in sd and sd[key].shape != proj.weight.shape:
        raise ValueError(
            f"text_embedding_projection takes {sd[key].shape[1]} features; the model's takes "
            f"{proj.in_features} (extras: 78 conditions Latte on (77, 768) CLIP features, flattened, "
            "and LatteIMG on (1 + I, 768))"
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
    return _vae_attention_names(sd)


def _vae_attention_names(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Legacy attention names renamed, 1x1-conv projections made (O, I)."""
    out = {}
    for key, v in sd.items():
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        parts = key.split(".")
        if ".attentions." in key and parts[-2] in _VAE_LEGACY_ATTN:
            key = ".".join(parts[:-2] + [_VAE_LEGACY_ATTN[parts[-2]], parts[-1]])
        if ".attentions." in key and v.dim() == 4:
            v = v[:, :, 0, 0]
        out[key] = v
    return out


# LatteT2V: the JAX module names inside a block -> the port's (diffusers')
_T2V_ATTN = (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0"))
_T2V_FF = (("net_0_proj", "net.0.proj"), ("net_2", "net.2"))
# frozen buffers of the reference checkpoint that the JAX converter drops:
# temp_pos_embed is recomputed, caption_projection.y_embedding is the unused
# negative-prompt embedding table
T2V_BUFFERS = ("temp_pos_embed", "caption_projection.y_embedding")


def flax_t2v_to_state_dict(params: Mapping[str, Any], patch_size: int = 2, pp: int = 1,
                           pp_rank: int = 0) -> Dict[str, torch.Tensor]:
    """The JAX LatteT2V's params (the tree under ``"params"``; a t2i model
    has no ``blocks/temporal``), or a quantized tree, -> the port's state
    dict; ``pp > 1``: pipeline stage ``pp_rank``'s pairs alone, as
    :func:`flax_to_state_dict`."""
    sd: Dict[str, np.ndarray] = {}
    k = np.asarray(params["pos_embed"]["proj"]["kernel"])  # (C·p·p, D)
    p = patch_size
    sd["pos_embed.proj.weight"] = _t(k).reshape(k.shape[1], k.shape[0] // (p * p), p, p)
    sd["pos_embed.proj.bias"] = np.asarray(params["pos_embed"]["proj"]["bias"])
    ada = params["adaln_single"]
    _put_linear(sd, "adaln_single.emb.timestep_embedder.linear_1", ada["emb"]["mlp_0"])
    _put_linear(sd, "adaln_single.emb.timestep_embedder.linear_2", ada["emb"]["mlp_2"])
    _put_linear(sd, "adaln_single.linear", ada["linear"])
    for name in ("linear_1", "linear_2"):
        _put_linear(sd, f"caption_projection.{name}", params["caption_projection"][name])
    blocks = params["blocks"]
    n = np.asarray(blocks["spatial"]["scale_shift_table"]).shape[0]
    for kind, prefix, attns in (("spatial", "transformer_blocks", ("attn1", "attn2")),
                                ("temporal", "temporal_transformer_blocks", ("attn1",))):
        if kind not in blocks:
            continue
        for i in stage_range(n, pp, pp_rank):
            blk = _unstack(blocks[kind], i)
            sd[f"{prefix}.{i}.scale_shift_table"] = np.asarray(blk["scale_shift_table"])
            for attn in attns:
                for src, dst in _T2V_ATTN:
                    _put_linear(sd, f"{prefix}.{i}.{attn}.{dst}", blk[attn][src])
            if "moe" in blk:
                _put_moe(sd, f"{prefix}.{i}.moe", blk["moe"])
                continue
            for src, dst in _T2V_FF:
                _put_linear(sd, f"{prefix}.{i}.ff.{dst}", blk["ff"][src])
    sd["scale_shift_table"] = np.asarray(params["scale_shift_table"])
    _put_linear(sd, "proj_out", params["proj_out"])
    return {key: _tensor(v) for key, v in sd.items()}


def t2v_keys(num_layers: int, moe_experts: int = 0) -> set:
    """The keys of a reference LatteT2V state dict (frozen buffers aside);
    with ``moe_experts > 1`` each block's ``moe.*`` in place of its ``ff``."""
    moe = moe_experts > 1
    linears = [
        "pos_embed.proj", "adaln_single.emb.timestep_embedder.linear_1",
        "adaln_single.emb.timestep_embedder.linear_2", "adaln_single.linear",
        "caption_projection.linear_1", "caption_projection.linear_2", "proj_out",
    ]
    keys = {"scale_shift_table"}
    for prefix, attns in (("transformer_blocks", ("attn1", "attn2")),
                          ("temporal_transformer_blocks", ("attn1",))):
        for i in range(num_layers):
            keys.add(f"{prefix}.{i}.scale_shift_table")
            linears += [f"{prefix}.{i}.{a}.{dst}" for a in attns for _, dst in _T2V_ATTN]
            if moe:
                keys.update(f"{prefix}.{i}.moe.{name}" for name in MOE_PARAMS)
            else:
                linears += [f"{prefix}.{i}.ff.{dst}" for _, dst in _T2V_FF]
    return keys | {f"{name}.{w}" for name in linears for w in ("weight", "bias")}


# safetensors' dtype names -> torch's, for the types model weights come in
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> CPU tensors, without the package: an
    8-byte little-endian header length, the JSON header (name -> dtype,
    shape and [begin, end) byte offsets into the data after the header),
    then the data, little-endian. The tensors share one buffer of the file's
    bytes."""
    import json

    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; expected one of "
                             f"{sorted(_SAFETENSORS_DTYPES)}")
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin) if count else torch.empty(0, dtype=dtype)
        out[name] = t.view(info["shape"])
    return out


def load_t2v_state_dict(path: str, num_layers: int = 28, moe_experts: int = 0) -> Dict[str, torch.Tensor]:
    """A reference LatteT2V checkpoint (``.safetensors``, or a
    ``torch.load``-able ``.pt`` / ``.bin`` state dict, or one under
    ``"state_dict"``) -> the port's state dict, without the frozen buffers.
    A key the model does not have raises ``ValueError`` (it would be
    dropped silently); a missing key raises ``KeyError``. For an MoE model
    (``moe_experts > 1``) missing expert weights are named first."""
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    expected = t2v_keys(num_layers, moe_experts)
    missing_moe = sorted(k for k in expected - set(sd) if ".moe." in k)
    if missing_moe:
        raise KeyError(
            f"T2V checkpoint lacks the expert weights of a moe_experts={moe_experts} model "
            f"(no converter maps MoE leaves): {missing_moe[:10]}"
        )
    unmapped = set(sd) - expected - set(T2V_BUFFERS)
    if unmapped:
        raise ValueError(
            "T2V checkpoint contains keys the model does not have (they would be silently "
            f"dropped): {sorted(unmapped)[:10]}" + ("..." if len(unmapped) > 10 else "")
        )
    missing = expected - set(sd)
    if missing:
        raise KeyError(f"T2V checkpoint lacks {sorted(missing)[:10]}")
    return {k: sd[k] for k in expected}


# Hugging Face's Flax leaf names -> its torch names
_HF_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "weight", "weight": "weight", "bias": "bias"}


def _flax_hf_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A transformers Flax params tree -> its torch state dict: the path
    joined with dots, Dense kernels (I, O) -> weights (O, I), embeddings and
    norm scales -> ``weight``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + [key])
                continue
            a = np.asarray(v)
            if key == "kernel":
                a = a.T
            sd[".".join(path + [_HF_LEAVES[key]])] = _tensor(np.ascontiguousarray(a))

    walk(params, [])
    return sd


def flax_t5_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``FlaxT5EncoderModel.params`` -> the port's
    :class:`~latte_tpu_torch.text.t5.T5EncoderModel` state dict."""
    return _flax_hf_to_state_dict(params)


def flax_clip_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``FlaxCLIPTextModel.params`` -> the port's
    :class:`~latte_tpu_torch.text.clip.CLIPTextModel` state dict."""
    return _flax_hf_to_state_dict(params)


def hf_weight_files(path: str) -> list:
    """The weight files of a Hugging Face model directory: the shards an
    index names (``model.safetensors.index.json``, else
    ``pytorch_model.bin.index.json``), else ``model.safetensors``, else
    ``pytorch_model.bin``."""
    import json
    import os

    for index in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        f = os.path.join(path, index)
        if os.path.exists(f):
            with open(f) as fh:
                shards = sorted(set(json.load(fh)["weight_map"].values()))
            return [os.path.join(path, s) for s in shards]
    for name in ("model.safetensors", "pytorch_model.bin"):
        f = os.path.join(path, name)
        if os.path.exists(f):
            return [f]
    raise FileNotFoundError(f"{path!r} holds no model.safetensors, pytorch_model.bin or their index")


@torch.no_grad()
def load_hf_weights(model: torch.nn.Module, path: str, rename: Mapping[str, str] = None,
                    skip: tuple = ()) -> torch.nn.Module:
    """Copy the weights of the Hugging Face directory ``path`` into
    ``model``'s parameters (already on their device, in their type), one
    file at a time: only one shard is in host memory at once, and each
    tensor converts to its parameter's type as it is copied. Keys are
    renamed by ``rename``, and those starting with a prefix in ``skip`` are
    ignored. A key the model lacks raises ``ValueError``, a parameter no file
    holds ``KeyError``, a shape apart ``ValueError``."""
    params = dict(model.named_parameters())
    loaded, unexpected = set(), []
    for f in hf_weight_files(path):
        if f.endswith(".safetensors"):
            sd = read_safetensors(f)
        else:
            sd = torch.load(f, map_location="cpu", weights_only=True, mmap=True)
        for key, v in sd.items():
            key = (rename or {}).get(key, key)
            if key.startswith(skip) or key in loaded:
                continue
            if key not in params:
                unexpected.append(key)
                continue
            if tuple(v.shape) != tuple(params[key].shape):
                raise ValueError(f"{f}: {key} has shape {tuple(v.shape)}, the model's {tuple(params[key].shape)}")
            params[key].copy_(v)
            loaded.add(key)
        del sd
    if unexpected:
        raise ValueError(f"{path}: keys the model does not have: {sorted(unexpected)[:10]}")
    missing = set(params) - loaded
    if missing:
        raise KeyError(f"{path}: no weights for {sorted(missing)[:10]}")
    return model


def flax_temporal_decoder_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``TemporalDecoder``'s params -> the port's (diffusers') state
    dict: the SD VAE's renames, ``mix_factor`` under ``time_mixer``, and the
    (kt, kh, kw, I, O) kernels of the temporal convolutions -> (O, I, kt, kh, kw)."""
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
            if key == "kernel" and a.ndim == 5:
                a = a.transpose(4, 3, 0, 1, 2)
            elif key == "kernel" and a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif key == "kernel":
                a = a.T
            name = {"kernel": "weight", "scale": "weight", "mix_factor": "time_mixer.mix_factor"}.get(key, key)
            sd[".".join(path + [name])] = _tensor(np.ascontiguousarray(a))

    walk(params, [])
    return sd


def load_temporal_decoder_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]) -> torch.nn.Module:
    """Load a diffusers ``AutoencoderKLTemporalDecoder`` state dict into the
    port's :class:`~latte_tpu_torch.vae.temporal_decoder.TemporalDecoder`
    with ``strict=True``: the whole autoencoder's (its ``decoder.*`` keys
    taken) or the decoder's own. Legacy attention names and 1x1-conv
    attention projections are mapped as for the SD VAE."""
    if any(k.startswith("decoder.") for k in sd):
        sd = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    model.load_state_dict(_vae_attention_names(sd), strict=True)
    return model


# the eval detectors: Flax leaf names -> torch's, and the inception head
_DETECTOR_LEAVES = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
_INCEPTION_HEAD = {"fc_w": "fc.weight", "fc_b": "fc.bias"}


def _flax_detector_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX eval detector's params (``latte_tpu/eval/{i3d,inception,c3d}.py``)
    -> the port's state dict under the same module names: conv kernels
    (kt, kh, kw, I, O) / (kh, kw, I, O) -> (O, I, ...), Dense kernels (and
    Inception's ``fc_w``) (I, O) -> (O, I), ``EvalBatchNorm``'s ``scale`` /
    ``mean`` / ``var`` -> ``weight`` / ``running_mean`` / ``running_var``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + [key])
                continue
            a = np.asarray(v)
            if key in ("kernel", "fc_w"):
                a = a.transpose(tuple(range(a.ndim - 1, a.ndim - 3, -1)) + tuple(range(a.ndim - 2)))
            name = _INCEPTION_HEAD.get(key) if not path and key in _INCEPTION_HEAD else None
            name = name or ".".join(path + [_DETECTOR_LEAVES.get(key, key)])
            sd[name] = _tensor(np.ascontiguousarray(a))

    walk(params, [])
    return sd


def flax_i3d_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``InceptionI3d``'s params -> ``eval.i3d.InceptionI3d``'s state dict."""
    return _flax_detector_to_state_dict(params)


def flax_inception_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``FIDInceptionV3``'s params -> ``eval.inception.FIDInceptionV3``'s."""
    return _flax_detector_to_state_dict(params)


def flax_c3d_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``C3D``'s params -> ``eval.c3d.C3D``'s state dict."""
    return _flax_detector_to_state_dict(params)
