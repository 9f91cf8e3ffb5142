"""The port's LattePipeline (latte_tpu_torch/sample/pipeline_t2v.py) against
the JAX LattePipeline on the CPU, with a tiny LatteT2V (2 heads of 8, three
pairs, 8x8 latents), the hash-embedding stub as text encoder on both sides
and the same z: the port draws it from its ``torch.Generator`` and the JAX
pipeline's ``prepare_latents`` is patched to return it. The JAX transformer
runs with attention_mode "xla"; the port on CPU tensors runs the kernels'
plain versions.

Tolerance: fp32 latents (and decoded frames) within ``close``'s defaults
(relative L2 1e-5, each element within 1e-4 of the largest magnitude);
block-cache interval 1 against the exact loop, and the stub's embeddings
against the JAX sampler's, to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, randomize

from latte_tpu.config import Config as JaxConfig
from latte_tpu.core.scheduler import get_scheduler as jax_get_scheduler
from latte_tpu.models.t2v import LatteT2V as JaxLatteT2V
from latte_tpu.sample import sample_t2x as jax_sample_t2x
from latte_tpu.sample.pipeline_t2v import LattePipeline as JaxPipeline
from latte_tpu.utils import create_logger
from latte_tpu.vae.autoencoder_kl import tiny_vae as jax_tiny_vae
from latte_tpu_torch.convert import flax_t2v_to_state_dict, flax_vae_to_state_dict
from latte_tpu_torch.core.scheduler import get_scheduler
from latte_tpu_torch.models.t2v import LatteT2V
from latte_tpu_torch.sample.pipeline_t2v import LattePipeline
from latte_tpu_torch.text import StubTextEncoder
from latte_tpu_torch.vae import tiny_vae

ARCH = dict(num_attention_heads=2, attention_head_dim=8, num_layers=3, patch_size=2,
            sample_size=4, cross_attention_dim=16, caption_channels=64, video_length=4)
SIZE = dict(video_length=4, height=16, width=16)  # vae_spatial_scale 2: 8x8 latents
PROMPT = "a red fox runs"


@pytest.fixture(scope="module")
def models():
    jm = JaxLatteT2V(**ARCH, attention_mode="xla")
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 4, 4, 8, 8)),
                     jnp.zeros((2,)), jnp.zeros((2, 10, 64)), None)
    params = randomize(params["params"], seed=4, std=0.1)
    tm = LatteT2V(**ARCH)
    tm.load_state_dict(flax_t2v_to_state_dict(params), strict=True)
    return jm, {"params": params}, tm.eval()


def pipelines(models, name, vae=False, **kw):
    jm, params, tm = models
    text = StubTextEncoder(64, max_length=10)
    jvae = tvae = vae_params = None
    if vae:
        jvae = jax_tiny_vae()
        vae_params = jvae.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 3, 16, 16)))
        vae_params = {"params": randomize(vae_params["params"], seed=6, std=0.2)}
        tvae = tiny_vae()
        tvae.load_state_dict(flax_vae_to_state_dict(vae_params["params"]), strict=True)
        tvae.eval()
    jp = JaxPipeline(transformer=jm, transformer_params=params, scheduler=jax_get_scheduler(name),
                     text_encoder=text, vae=jvae, vae_params=vae_params, vae_spatial_scale=2, **kw)
    tp = LattePipeline(transformer=tm, scheduler=get_scheduler(name), text_encoder=text,
                       vae=tvae, vae_spatial_scale=2, **kw)
    return jp, tp


def same_z(jp, batch, seed):
    """Hand the port's z (its generator's first draw) to the JAX pipeline."""
    z = torch.randn((batch, 4, 4, 8, 8), generator=torch.Generator().manual_seed(seed)).numpy()

    def prepare_latents(batch, channels, video_length, height, width, rng, num_inference_steps=50):
        return jnp.asarray(z) * jp.scheduler.init_noise_sigma_for(num_inference_steps)

    jp.prepare_latents = prepare_latents


@pytest.mark.parametrize("name, steps, guidance, prompt", [
    ("DDIM", 4, 4.0, PROMPT),
    ("DDIM", 4, 1.0, [PROMPT, "snow on a quiet lake"]),
    ("HeunDiscrete", 3, 4.0, PROMPT),
    ("PNDM", 5, 4.0, PROMPT),
], ids=["ddim_cfg", "ddim_no_cfg_batch2", "heun_cfg", "pndm_cfg"])
def test_latents_match_jax(models, name, steps, guidance, prompt):
    jp, tp = pipelines(models, name)
    batch = 1 if isinstance(prompt, str) else len(prompt)
    same_z(jp, batch, seed=7)
    want = jp(prompt, **SIZE, num_inference_steps=steps, guidance_scale=guidance, seed=7,
              output_type="latents").video
    got = tp.sample_latents(prompt, **SIZE, num_inference_steps=steps, guidance_scale=guidance, seed=7)
    assert got.shape == (batch, 4, 4, 8, 8) and got.dtype == torch.float32
    close(got, want)


def test_block_cache_matches_jax_and_interval_1_is_exact(models):
    """DDIM-6 under CFG with the block cache at interval 2 (the default 2 of
    3 pairs cached) against the JAX pipeline's; interval 1 is the exact
    loop, to the bit."""
    jp, tp = pipelines(models, "DDIM", block_cache_interval=2)
    assert tp.bc_pairs == 2
    same_z(jp, 1, seed=9)
    run = dict(**SIZE, num_inference_steps=6, guidance_scale=4.0, seed=9)
    want = jp(PROMPT, output_type="latents", **run).video
    got = tp.sample_latents(PROMPT, **run)
    close(got, want)
    exact = pipelines(models, "DDIM")[1].sample_latents(PROMPT, **run)
    assert not torch.equal(got, exact)
    one = pipelines(models, "DDIM", block_cache_interval=1)[1].sample_latents(PROMPT, **run)
    assert torch.equal(one, exact)


def test_decoded_video_matches_jax(models):
    """DDIM-3 without CFG through a tiny VAE: the (B, F, H, W, 3) frames in
    [0, 1] against the JAX pipeline's."""
    jp, tp = pipelines(models, "DDIM", vae=True)
    same_z(jp, 1, seed=11)
    run = dict(**SIZE, num_inference_steps=3, guidance_scale=1.0, seed=11)
    want = jp(PROMPT, **run).video
    got = tp(PROMPT, **run).video
    assert got.shape == (1, 4, 16, 16, 3) and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    close(got, want)


def test_stub_embeddings_equal_the_jax_samplers():
    """The port's stub against the one the JAX sampler falls back to (caption
    width 64, 120 tokens), to the bit; the empty negative prompt's mask is all
    zeros."""
    jax_stub = jax_sample_t2x.build_text_encoder(JaxConfig({"caption_channels": 64}), create_logger())
    prompts = ["Yellow and black tropical fish dart through the sea.", "Sunset over the sea."]
    want = jax_stub.encode_with_negative(prompts, "")
    got = StubTextEncoder(64).encode_with_negative(prompts, "")
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w))
    assert got[0].shape == (2, 120, 64) and not got[3].any() and got[1].sum() == 9 + 4


def test_pipeline_refusals(models):
    _, _, tm = models
    sched = get_scheduler("DDIM")
    with pytest.raises(ValueError, match="block_cache_interval does not compose with pp_mesh"):
        LattePipeline(tm, sched, pp_mesh=2, block_cache_interval=2)
    with pytest.raises(ValueError, match="block_cache_pairs"):
        LattePipeline(tm, sched, block_cache_interval=2, block_cache_pairs=3)
    tp = LattePipeline(tm, sched, text_encoder=StubTextEncoder(64, max_length=10), vae_spatial_scale=2)
    with pytest.raises(ValueError, match="enable_temporal_attentions"):
        tp.sample_latents(PROMPT, **SIZE, num_inference_steps=2, enable_temporal_attentions=False)
    with pytest.raises(ValueError, match="without a VAE"):
        tp(PROMPT, **SIZE, num_inference_steps=2)
