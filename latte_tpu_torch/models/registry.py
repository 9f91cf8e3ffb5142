"""Model registry: named Latte and LatteIMG configurations (XL/L/B/S x
patch 2/4/8).

Port of ``latte_tpu/models/registry.py``. ``moe_experts`` (> 0, with
``moe_top_k`` and ``moe_capacity_factor`` when set) gives the blocks the
Mixture-of-Experts feed-forward, as the JAX factory passes it.
``attention_mode: ring`` builds ring attention over the ``ring_mesh`` the
caller passes (without one the model raises the JAX model's ``ValueError``,
as the JAX factory passes no mesh either); ``mesh`` splits the model over
its tp and sp axes (``models/dit.py``). Execution hints for the JAX compiler (scan
unrolling, the fused-adaLN switch) have no counterpart here, since the port
always runs its fused kernels. ``gradient_checkpointing`` recomputes each
spatial/temporal pair in the backward under ``remat_policy`` ("full", the
default, or "dots").

``int8_attention`` is checked here, as in the JAX factory: it must be true,
"full" or "qk", and it needs ``quantized: static`` (or ``calib``), or the
config would serve floating-point attention under an int8 flag. The
``quantized`` mode itself is the entry point's to set (the JAX sampler's
and trainer's ``model.clone(quantized=...)``): ``get_models(args,
quantized=...)``.
"""

from __future__ import annotations

from typing import Any, Dict

from latte_tpu_torch.models.dit import Latte
from latte_tpu_torch.models.dit_img import LatteIMG

_SIZES: Dict[str, Dict[str, Any]] = {
    "XL": dict(depth=28, hidden_size=1152, num_heads=16),
    "L": dict(depth=24, hidden_size=1024, num_heads=16),
    "B": dict(depth=12, hidden_size=768, num_heads=12),
    "S": dict(depth=12, hidden_size=384, num_heads=6),
}
_PATCHES = (2, 4, 8)

Latte_models: Dict[str, Dict[str, Any]] = {
    f"Latte-{s}/{p}": dict(patch_size=p, **cfg) for s, cfg in _SIZES.items() for p in _PATCHES
}
LatteIMG_models: Dict[str, Dict[str, Any]] = {
    f"LatteIMG-{s}/{p}": dict(patch_size=p, **cfg) for s, cfg in _SIZES.items() for p in _PATCHES
}

_ATTENTION_MODES = ("auto", "xla", "flash", "math", "ring")


def get_model(name: str, **overrides) -> Latte:
    """Build a model by registry name, e.g. ``Latte-XL/2`` or ``LatteIMG-XL/2``."""
    if name in Latte_models:
        return Latte(**{**Latte_models[name], **overrides})
    if name in LatteIMG_models:
        return LatteIMG(**{**LatteIMG_models[name], **overrides})
    raise ValueError(f"unknown model {name!r}; known: {sorted(Latte_models) + sorted(LatteIMG_models)}")


def get_models(args, quantized=False, moe_mesh=None, mesh=None, ring_mesh=None) -> Latte:
    """Config-object factory: ``args`` needs ``model``, ``image_size``,
    ``num_frames``, ``learn_sigma``, ``extras``, and optionally
    ``num_classes``, ``attention_mode``, ``int8_attention`` (checked against
    ``args.quantized``) and ``model_overrides`` (explicit depth/width
    changes), ``gradient_checkpointing`` with ``remat_policy``, and for a
    LatteIMG name ``use_image_num``, and ``moe_experts`` with
    ``moe_top_k`` and ``moe_capacity_factor``. ``quantized`` is the blocks'
    int8 mode (see ``models.layers``); ``moe_mesh`` the ``DistContext`` the
    experts are split over (``models.moe``), ``mesh`` the one whose tp and sp
    axes split the model and whose pp axis picks the stage's pairs
    (``dist.pipeline``), ``ring_mesh`` ring attention's."""
    mode = str(getattr(args, "attention_mode", None) or "auto")
    if mode not in _ATTENTION_MODES:
        raise NotImplementedError(
            f"attention_mode={mode!r}: the port runs its flash kernel for {_ATTENTION_MODES[:4]} "
            "and ring attention for 'ring'"
        )
    latent_size = int(
        getattr(args, "latent_size", 0) or int(getattr(args, "image_size", 256)) // 8
    )
    common = dict(
        input_size=latent_size,
        num_frames=int(getattr(args, "num_frames", 16)),
        learn_sigma=bool(getattr(args, "learn_sigma", True)),
        extras=int(getattr(args, "extras", 1)),
        attention_mode=mode,
        quantized=quantized,
    )
    if mesh is not None:
        common["mesh"] = mesh
        if getattr(mesh, "pp", 1) > 1:  # a pipeline stage's pairs alone
            common.update(pp=mesh.pp, pp_rank=mesh.pp_rank)
    if ring_mesh is not None:
        common["ring_mesh"] = ring_mesh
    ia = getattr(args, "int8_attention", False)
    if ia:
        if ia not in (True, "full", "qk"):
            raise ValueError(f"int8_attention: {ia!r}; expected true, 'full' or 'qk'")
        q = getattr(args, "quantized", None)
        if str(q) not in ("static", "calib"):
            raise ValueError(
                "int8_attention requires quantized: static (the calibrated-scale W8A8 "
                f"serving path); got quantized: {q!r} — fp, dynamic int8 and QAT have "
                "no calibrated attention scales"
            )
        common["int8_attention"] = ia
    if getattr(args, "num_classes", None):
        common["num_classes"] = int(args.num_classes)
    if getattr(args, "gradient_checkpointing", False):
        common["gradient_checkpointing"] = True
        if getattr(args, "remat_policy", None):
            common["remat_policy"] = str(args.remat_policy)
    if getattr(args, "model_overrides", None):
        common.update(dict(args.model_overrides))
    if getattr(args, "moe_experts", 0):
        common["moe_experts"] = int(args.moe_experts)
        if getattr(args, "moe_top_k", None):
            common["moe_top_k"] = int(args.moe_top_k)
        if getattr(args, "moe_capacity_factor", None):
            common["moe_capacity_factor"] = float(args.moe_capacity_factor)
        if moe_mesh is not None:
            common["moe_mesh"] = moe_mesh
    if args.model in LatteIMG_models:
        common["use_image_num"] = int(getattr(args, "use_image_num", 0) or 0)
    return get_model(args.model, **common)
