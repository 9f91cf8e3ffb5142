"""Model registry: named Latte configurations (XL/L/B/S x patch 2/4/8).

Port of ``latte_tpu/models/registry.py`` for the video model. Options of
the JAX factory that select work this port has not taken on yet (int8,
MoE, ring attention, the image model, the "dots" remat policy) raise
``NotImplementedError``; execution hints for the JAX compiler (scan
unrolling, the fused-adaLN switch) have no counterpart here, since the port
always runs its fused kernels. ``gradient_checkpointing`` recomputes each
spatial/temporal pair in the backward (the "full" remat policy).
"""

from __future__ import annotations

from typing import Any, Dict

from latte_tpu_torch.models.dit import Latte

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

_ATTENTION_MODES = ("auto", "xla", "flash", "math")


def get_model(name: str, **overrides) -> Latte:
    """Build a model by registry name, e.g. ``Latte-XL/2``."""
    if name in Latte_models:
        return Latte(**{**Latte_models[name], **overrides})
    if name.startswith("LatteIMG-"):
        raise NotImplementedError(f"{name}: the image model comes with the T2V/image slice")
    raise ValueError(f"unknown model {name!r}; known: {sorted(Latte_models)}")


def get_models(args) -> Latte:
    """Config-object factory: ``args`` needs ``model``, ``image_size``,
    ``num_frames``, ``learn_sigma``, ``extras``, and optionally
    ``num_classes`` and ``model_overrides`` (explicit depth/width changes)."""
    for key in ("quantized", "int8_attention", "moe_experts"):
        if getattr(args, key, None):
            raise NotImplementedError(f"{key}: not ported yet (int8 / MoE slices)")
    mode = str(getattr(args, "attention_mode", None) or "auto")
    if mode not in _ATTENTION_MODES:
        raise NotImplementedError(
            f"attention_mode={mode!r}: the port runs one attention (its flash "
            f"kernel) for {_ATTENTION_MODES}; ring attention comes with multi-GPU"
        )
    latent_size = int(
        getattr(args, "latent_size", 0) or int(getattr(args, "image_size", 256)) // 8
    )
    common = dict(
        input_size=latent_size,
        num_frames=int(getattr(args, "num_frames", 16)),
        learn_sigma=bool(getattr(args, "learn_sigma", True)),
        extras=int(getattr(args, "extras", 1)),
    )
    if getattr(args, "num_classes", None):
        common["num_classes"] = int(args.num_classes)
    if getattr(args, "gradient_checkpointing", False):
        policy = getattr(args, "remat_policy", None) or "full"
        if policy != "full":
            raise NotImplementedError(
                f"remat_policy={policy!r}: the port recomputes whole pairs ('full'); "
                "saving the matmul outputs ('dots') comes with a later training slice"
            )
        common["gradient_checkpointing"] = True
    if getattr(args, "model_overrides", None):
        common.update(dict(args.model_overrides))
    return get_model(args.model, **common)
