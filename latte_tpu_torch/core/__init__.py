from latte_tpu_torch.core.diffusion import GaussianDiffusion, create_diffusion
from latte_tpu_torch.core.samplers import cfg_model_fn, ddim_sample_loop, p_sample_loop

__all__ = [
    "GaussianDiffusion",
    "create_diffusion",
    "cfg_model_fn",
    "ddim_sample_loop",
    "p_sample_loop",
]
