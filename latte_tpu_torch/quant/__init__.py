"""W8A8 int8 serving and quantized training (port of ``latte_tpu/quant``)."""

from latte_tpu_torch.quant.int8 import (  # noqa: F401
    QUANT_TARGETS_BY_PARENT,
    calibrate_act_amax,
    int8_attention,
    int8_matmul,
    int8_matmul_static,
    int8_matmul_ste,
    merge_amax,
    quantize_params,
    quantize_weight,
)
