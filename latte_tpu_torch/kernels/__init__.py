"""Hand-written CUDA kernels of the port, each beside its plain version."""

from latte_tpu_torch.kernels.adaln import (
    ln_modulate,
    ln_modulate_reference,
    residual_ln_modulate,
    residual_ln_modulate_reference,
)
from latte_tpu_torch.kernels.attention import attention_reference, flash_attention

__all__ = [
    "flash_attention",
    "attention_reference",
    "ln_modulate",
    "ln_modulate_reference",
    "residual_ln_modulate",
    "residual_ln_modulate_reference",
]
