"""Port parity for Mixture-of-Experts serving against the JAX package on the
CPU: ``sample.main`` on ``configs/ffs/ffs_sample.yaml`` with ``moe_experts``
(DDIM-10, exactly and with the block cache) against the JAX sampler's
``build_sample_fn`` from the same checkpoint and z, and the port's
``LattePipeline`` with an MoE LatteT2V against the JAX pipeline (exactly and
with the block cache); then ``sample_t2x.main`` with ``moe_experts`` and the
int8 refusals of both samplers.

The JAX models run with attention_mode "xla"; the port on CPU tensors runs
the kernels' plain versions. Tolerance: ``close``'s defaults (relative L2
1e-5, each element within 1e-4 of the largest magnitude), the same fp32
function summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline_t2v import PROMPT, SIZE, pipelines, same_z
from test_torch_sample import FFS
from test_torch_sample_t2x import T2V, tiny
from torch_port_util import RouterMargins, close, randomize

from latte_tpu.config import load_config as jax_load_config
from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.models import get_models as jax_get_models
from latte_tpu.models.t2v import LatteT2V as JaxLatteT2V
from latte_tpu.sample.sample import build_sample_fn
from latte_tpu_torch.config import load_config
from latte_tpu_torch.convert import flax_t2v_to_state_dict, flax_to_state_dict
from latte_tpu_torch.models.t2v import LatteT2V
from latte_tpu_torch.sample import sample, sample_t2x

TINY = [
    "model_overrides={depth: 6, hidden_size: 32, num_heads: 2}", "image_size=32", "num_frames=2",
    "use_fp16=false", "sample_method=ddim", "num_sampling_steps=10",
    "moe_experts=4", "moe_top_k=2", "moe_capacity_factor=1.0",
]


@pytest.mark.parametrize("cache", [[], ["block_cache_interval=2"]], ids=["exact", "block_cache"])
def test_moe_sampler_matches_the_jax_sampler(tmp_path, cache):
    """DDIM-10 latents of an MoE Latte (4 experts, top-2, tokens dropping at
    capacity factor 1.0) through ``sample.main`` from a checkpoint, against
    the JAX ``build_sample_fn`` on the same config, weights and z."""
    over = TINY + cache + [f"save_video_path={tmp_path}/v.mp4"]
    cfg, jcfg = load_config(FFS, over), jax_load_config(FFS, over)
    jm = jax_get_models(jcfg)
    assert jm.moe_experts == 4
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 4, 4, 4)), jnp.zeros((1,), jnp.int32))["params"]
    params = randomize(params, seed=3, std=0.1)
    torch.save({"ema": flax_to_state_dict(params, 6, 2, 2)}, tmp_path / "c.pt")
    cfg.ckpt = str(tmp_path / "c.pt")
    with RouterMargins(f"sample.main {cache}"):
        got = np.load(sample.main(cfg, device="cpu"))["latents"]
    fn, _ = build_sample_fn(jm, {"params": params}, jcfg, jax_create_diffusion("10"))
    z = jnp.asarray(torch.randn((1, 2, 4, 4, 4), generator=torch.Generator().manual_seed(0)).numpy())
    want = np.asarray(fn(z, None, jax.random.PRNGKey(1)))
    assert got.shape == (1, 2, 4, 4, 4) and np.isfinite(got).all()
    close(got, want)


@pytest.fixture(scope="module")
def moe_models():
    """The pipeline tests' tiny LatteT2V with 4 geglu experts, in both
    packages."""
    arch = dict(num_attention_heads=2, attention_head_dim=8, num_layers=3, patch_size=2, sample_size=4,
                cross_attention_dim=16, caption_channels=64, video_length=4, activation_fn="geglu",
                moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
    jm = JaxLatteT2V(**arch, attention_mode="xla")
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 4, 4, 8, 8)),
                     jnp.zeros((2,)), jnp.zeros((2, 10, 64)), None)
    params = randomize(params["params"], seed=4, std=0.1)
    tm = LatteT2V(**arch)
    tm.load_state_dict(flax_t2v_to_state_dict(params), strict=True)
    return jm, {"params": params}, tm.eval()


@pytest.mark.parametrize("interval", [0, 2], ids=["exact", "block_cache"])
def test_moe_pipeline_matches_jax(moe_models, interval):
    """DDIM-4 under CFG (batch 2 through the model) against the JAX
    LattePipeline, exactly and with the block cache at interval 2."""
    kw = dict(block_cache_interval=interval) if interval else {}
    jp, tp = pipelines(moe_models, "DDIM", **kw)
    same_z(jp, 1, seed=7)
    run = dict(**SIZE, num_inference_steps=4, guidance_scale=4.0, seed=7)
    want = jp(PROMPT, output_type="latents", **run).video
    with RouterMargins(f"LattePipeline interval {interval}"):
        got = tp.sample_latents(PROMPT, **run)
    assert got.shape == (1, 4, 4, 8, 8)
    close(got, want)


def test_sample_t2x_serves_moe(tmp_path):
    """``moe_experts`` (with top-k and capacity factor) reaches LatteT2V
    through the entry point, which serves finite latents."""
    cfg = tiny(T2V, tmp_path, "video_length=4", "moe_experts=4", "moe_top_k=1", "moe_capacity_factor=2.0",
               "text_prompt=[a cat]")
    kw = sample_t2x.transformer_kwargs(cfg)
    assert (kw["moe_experts"], kw["moe_top_k"], kw["moe_capacity_factor"]) == (4, 1, 2.0)
    with RouterMargins("sample_t2x.main"):
        (record,) = sample_t2x.main(cfg, device="cpu")
    assert record["latents"].shape == (1, 4, 4, 4, 4) and torch.isfinite(record["latents"]).all()


def test_quantized_moe_serving_is_refused_before_anything_is_built(tmp_path):
    """Neither package has an int8 expert path: both samplers raise before
    they build a model or write a file."""
    for q in ("static", "true"):
        cfg = load_config(FFS, TINY + [f"quantized={q}", f"save_video_path={tmp_path}/v.mp4"])
        with pytest.raises(NotImplementedError, match="MoEMlp has no int8 expert path"):
            sample.main(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="MoEMlp has no int8 expert path"):
        sample_t2x.main(tiny(T2V, tmp_path, "video_length=4", "quantized=true", "moe_experts=2"), device="cpu")
    assert not any(tmp_path.iterdir())
