from latte_tpu_torch.core.diffusion import GaussianDiffusion, LossType, create_diffusion
from latte_tpu_torch.core.samplers import cfg_model_fn, ddim_reverse_loop, ddim_sample_loop, p_sample_loop

__all__ = [
    "GaussianDiffusion",
    "LossType",
    "create_diffusion",
    "cfg_model_fn",
    "ddim_reverse_loop",
    "ddim_sample_loop",
    "p_sample_loop",
]
