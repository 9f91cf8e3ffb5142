"""The port's SVD temporal decoder (latte_tpu_torch/vae/temporal_decoder.py)
against the JAX package's on the CPU: the tiny decoder with non-zero mix
factors, the diffusers state dict through both converters, and
``LattePipeline``'s chunked temporal decode (chunks of 14, each its own
clip) against the JAX pipeline's.

Tolerances: fp32 within 1e-5 relative L2 and 1e-4 of the largest magnitude
elementwise (``close``); bf16 by the VAE's rule (``check_bf16``); the
converted weights equal to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_temporal_decoder as jax_tests
from test_torch_pipeline_t2v import ARCH, PROMPT, SIZE
from torch_port_util import check_bf16, close, randomize

from latte_tpu.sample.pipeline_t2v import LattePipeline as JaxPipeline
from latte_tpu.tools.convert_vae import convert_temporal_decoder_state_dict
from latte_tpu.vae.temporal_decoder import tiny_temporal_decoder as jax_tiny_temporal_decoder
from latte_tpu_torch.convert import flax_temporal_decoder_to_state_dict, load_temporal_decoder_state_dict
from latte_tpu_torch.core.scheduler import get_scheduler
from latte_tpu_torch.models.t2v import LatteT2V
from latte_tpu_torch.sample.pipeline_t2v import LattePipeline
from latte_tpu_torch.text import StubTextEncoder
from latte_tpu_torch.vae import tiny_vae
from latte_tpu_torch.vae.temporal_decoder import TemporalDecoder, tiny_temporal_decoder

REL, ELEM = 1e-5, 1e-4


def _make_sd(seed=0):
    return jax_tests.TestTemporalDecoderConversion()._make_sd(np.random.default_rng(seed))


def _decoders(seed=0, dtype=jnp.float32):
    """The JAX tiny decoder with N(0, 0.2²) params (the mix factors among
    them, so both branches weigh differently in every block; the tree of
    the JAX converter, which spares a Flax init), and the port's with the
    same weights."""
    jdec = jax_tiny_temporal_decoder(dtype=dtype)
    tree = convert_temporal_decoder_state_dict(_make_sd(), n_blocks=2, layers_per_block=1)
    params = randomize(tree, seed=seed)
    dec = tiny_temporal_decoder()
    dec.load_state_dict(flax_temporal_decoder_to_state_dict(params), strict=True)
    return jdec, params, dec.eval()


def _jax_decode(jdec, params, z, num_frames):
    fn = jax.jit(lambda p, zz: jdec.apply({"params": p}, zz, num_frames=num_frames))
    return np.asarray(fn(params, jnp.asarray(z)), np.float32)


def _z(frames, seed=1, h=4):
    return np.random.default_rng(seed).standard_normal((frames, 4, h, h)).astype(np.float32)


@pytest.mark.parametrize("frames, num_frames", [(8, 4), (6, 6), (3, 1)], ids=["2x4", "1x6", "3x1"])
def test_decoder_matches_jax(frames, num_frames):
    jdec, params, dec = _decoders()
    mix = [np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(params) if "mix_factor" in str(k)]
    assert len(mix) == 2 + 2 and all(np.abs(m).min() > 0 for m in mix)  # mid 2 + one a block
    z = _z(frames)
    want = _jax_decode(jdec, params, z, num_frames)
    with torch.no_grad():
        got = dec.decode(torch.from_numpy(z), num_frames=num_frames)
    assert got.shape == (frames, 3, 8, 8)
    close(got, want, REL, ELEM)


def test_bf16_decoder_by_the_vae_rule():
    """bf16 weights with fp32 GroupNorm, mix factors and blend, against the
    JAX decoder computing in bf16 over fp32 params."""
    jdec16, params, dec = _decoders(dtype=jnp.bfloat16)
    jdec32 = jax_tiny_temporal_decoder()
    z = _z(8, seed=2)
    want16 = _jax_decode(jdec16, params, z, 4)
    want32 = _jax_decode(jdec32, params, z, 4)
    dec.to(torch.bfloat16)
    assert dec.mid_block.resnets[0].time_mixer.mix_factor.dtype == torch.float32
    with torch.no_grad():
        got = dec.decode(torch.from_numpy(z), num_frames=4)
    check_bf16(got, want16, want32)


@pytest.mark.parametrize("prefixed", [True, False], ids=["decoder_prefix", "bare"])
def test_diffusers_state_dict_loads_as_the_jax_converter_reads_it(prefixed):
    """tests/test_temporal_decoder.py's diffusers-named state dict, loaded
    strictly by the port, equals the JAX converter's tree carried onto the
    port's names, to the bit; the decoders then agree."""
    sd = _make_sd(5)
    jax_tree = convert_temporal_decoder_state_dict(sd, n_blocks=2, layers_per_block=1)
    if not prefixed:
        sd = {k[len("decoder."):]: v for k, v in sd.items()}
    dec = load_temporal_decoder_state_dict(tiny_temporal_decoder(), {k: torch.from_numpy(v) for k, v in sd.items()})
    want = flax_temporal_decoder_to_state_dict(jax_tree)
    got = dec.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    z = _z(4, seed=6) * 0.1
    out = _jax_decode(jax_tiny_temporal_decoder(), jax_tree, z, 4)
    with torch.no_grad():
        close(dec.decode(torch.from_numpy(z), num_frames=4), out, REL, ELEM)


def test_full_width_decoder_names_and_size():
    """The full decoder (128, 256, 512, 512; 3 resnets a block) has
    diffusers' keys: a mix factor in every spatio-temporal block, the
    upsamplers in blocks 0-2, time_conv_out."""
    with torch.device("meta"):
        sd = TemporalDecoder().state_dict()
    mixes = [k for k in sd if k.endswith("time_mixer.mix_factor")]
    assert len(mixes) == 2 + 4 * 3
    assert {k for k in sd if "upsamplers" in k} == {f"up_blocks.{i}.upsamplers.0.conv.{w}"
                                                     for i in range(3) for w in ("weight", "bias")}
    assert sd["time_conv_out.weight"].shape == (3, 3, 3, 1, 1)
    assert sd["up_blocks.2.resnets.0.spatial_res_block.conv_shortcut.weight"].shape == (256, 512, 1, 1)


@pytest.mark.parametrize("batch", [1, 2])
def test_pipeline_temporal_decode_matches_jax(batch):
    """F = 16 frames of 4x4 latents: chunks 14 + 2 for one video; for two,
    chunks of the flattened B·F frames (14, 14, 4: the second spans both
    videos, as in the JAX pipeline)."""
    jdec, params, dec = _decoders(seed=7)
    jp = JaxPipeline(transformer=None, transformer_params=None, scheduler=None, temporal_decoder=jdec,
                     temporal_decoder_params={"params": params}, vae_spatial_scale=2)
    tp = LattePipeline(transformer=None, scheduler=None, temporal_decoder=dec, vae_spatial_scale=2)
    lat = np.random.default_rng(8).standard_normal((batch, 4, 16, 4, 4)).astype(np.float32) * 0.18215
    want = jp.decode_latents_with_temporal_decoder(jnp.asarray(lat))
    got = tp.decode_latents_with_temporal_decoder(torch.from_numpy(lat))
    assert got.shape == (batch, 16, 8, 8, 3) and got.dtype == np.float32
    close(got, want, REL, ELEM)
    # the chunks are clips of their own: frame 13 is decoded without frame 14
    whole = dec.decode(torch.from_numpy(lat[0].transpose(1, 0, 2, 3) / 0.18215), num_frames=16)
    assert not np.allclose(got[0, 13], (whole[13].permute(1, 2, 0) / 2 + 0.5).clamp(0, 1).detach().numpy())


def test_pipeline_call_decodes_with_the_temporal_decoder():
    """``enable_vae_temporal_decoder`` routes the call's decode through the
    temporal decoder (held to the JAX pipeline's above); without the flag,
    or for a single frame, the SD VAE decodes."""
    torch.manual_seed(0)
    tm = LatteT2V(**ARCH)
    tm.initialize_weights(torch.Generator().manual_seed(1))
    vae = tiny_vae()
    vae.initialize_weights(torch.Generator().manual_seed(2))
    dec = _decoders(seed=9)[2]
    tp = LattePipeline(tm.eval(), get_scheduler("DDIM"), StubTextEncoder(64, max_length=10), vae=vae.eval(),
                       temporal_decoder=dec, vae_spatial_scale=2)
    run = dict(**SIZE, num_inference_steps=2, guidance_scale=4.0, seed=10)
    latents = tp.sample_latents(PROMPT, **run)
    got = tp(PROMPT, enable_vae_temporal_decoder=True, **run).video
    assert got.shape == (1, 4, 16, 16, 3)
    np.testing.assert_array_equal(got, tp.decode_latents_with_temporal_decoder(latents))
    np.testing.assert_array_equal(tp(PROMPT, **run).video, tp.decode_latents(latents))
