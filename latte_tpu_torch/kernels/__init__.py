"""Hand-written CUDA kernels of the port, each beside its plain version; and
the metric tools' ops, which the JAX package writes in XLA, as plain torch
(``upfirdn``, ``bias_act``, ``gradfix``, ``conv2d_resample``)."""

from latte_tpu_torch.kernels.adaln import (
    ln_modulate,
    ln_modulate_reference,
    residual_ln_modulate,
    residual_ln_modulate_reference,
)
from latte_tpu_torch.kernels.attention import (
    attention_qkv,
    attention_backward_reference,
    attention_bwd_dkv_reference,
    attention_bwd_dq_reference,
    attention_delta,
    attention_reference,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)
from latte_tpu_torch.kernels.attention_int8 import (
    flash_attention_int8,
    flash_scale_block,
    int8_attention,
)

__all__ = [
    "flash_attention",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv",
    "attention_qkv",
    "attention_reference",
    "attention_backward_reference",
    "attention_bwd_dq_reference",
    "attention_bwd_dkv_reference",
    "attention_delta",
    "flash_attention_int8",
    "flash_scale_block",
    "int8_attention",
    "ln_modulate",
    "ln_modulate_reference",
    "residual_ln_modulate",
    "residual_ln_modulate_reference",
]
