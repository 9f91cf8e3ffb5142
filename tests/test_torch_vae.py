"""The port's SD VAE (latte_tpu_torch/vae) against the JAX module
(latte_tpu/vae/autoencoder_kl.py) on the CPU, at tiny widths: the tiny VAE
(8, 16) and a three-block (4, 8, 8) with 2 layers a block, as in
tests/test_vae.py. Inputs come from numpy with a seed; the JAX params (its
init, with biases and GroupNorm parameters perturbed so they carry signal)
go to the port through ``flax_vae_to_state_dict``.

Tolerances. fp32: relative L2 <= 1e-5 and elementwise <= 1e-4 of the largest
magnitude (``torch_port_util.close``); the two sides sum convolutions in
another order, and flax's GroupNorm takes the variance as E[x^2] - E[x]^2
where torch's does not (1e-6-level relative differences). bf16 (the params
rounded to bf16 first, so both sides hold the same values): each side
rounds every conv and projection output to bf16, at slightly different
points (flax adds the bias after rounding the conv, torch inside it; the
fp32 sums run in another order), so the two sides carry independent
rounding noise, measured at up to 2.6e-2 relative L2 of each other through
the three-block coders, each 1e-3 to 2e-2 off the fp32 result. So the port
is held (a) to JAX's bf16 at 5e-2 relative L2 and 5e-2 of the largest
magnitude elementwise, and (b), the sharp check, to JAX's fp32 result on
the same params: its error there at most 1.25x JAX bf16's own + 1e-3, the
rule chip_smoke.py holds bf16 kernels to (it adds no more error than bf16
itself brings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import check_bf16, close, t

from latte_tpu.tools.convert_vae import convert_vae_state_dict
from latte_tpu.vae import autoencoder_kl as jvae
from latte_tpu_torch.convert import flax_vae_to_state_dict, load_vae_state_dict
from latte_tpu_torch.vae import autoencoder_kl as tvae

# (block_out_channels, layers_per_block, groups)
CONFIGS = {"tiny": ((8, 16), 1, 4), "three_blocks": ((4, 8, 8), 2, 4)}


def perturbed_params(module, x, seed=0, bf16=False, init=None):
    """The JAX module's init params on ``x`` (through ``init``, by default
    ``module.init``), with every bias ~ N(0, 0.1²) and every GroupNorm scale
    ~ 1 + N(0, 0.1²) from a numpy seed (the init leaves them 0 and 1);
    rounded to bf16 values when ``bf16``."""
    params = (init or module.init)(jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.default_rng(seed)

    def visit(path, leaf):
        name = path[-1].key
        a = np.asarray(leaf, np.float32)
        if name == "bias":
            a = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        elif name == "scale":
            a = (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if bf16:
            a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        return a

    return jax.tree_util.tree_map_with_path(visit, params)


def nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def nchw(a):
    return np.asarray(jnp.asarray(a, jnp.float32)).transpose(0, 3, 1, 2)


def port(module, params, dtype=torch.float32):
    module.load_state_dict(flax_vae_to_state_dict(params), strict=True)
    return module.to(dtype).eval()


def run(module, x):
    with torch.no_grad():
        return module(t(x)).float()


# (JAX module, port module, input NCHW shape)
def _resnet(c_in, c_out, dtype):
    return jvae.ResnetBlock(c_out, groups=4, dtype=dtype), tvae.ResnetBlock(c_in, c_out, groups=4), (2, c_in, 6, 6)


MODULES = {
    "resnet": lambda dtype: _resnet(8, 8, dtype),
    "resnet_conv_shortcut": lambda dtype: _resnet(8, 16, dtype),
    "attn": lambda dtype: (jvae.AttnBlock(8, groups=4, dtype=dtype), tvae.AttnBlock(8, groups=4), (2, 8, 5, 4)),
    "downsample_even": lambda dtype: (jvae.Downsample(8, dtype=dtype), tvae.Downsample(8), (2, 8, 8, 6)),
    "downsample_odd": lambda dtype: (jvae.Downsample(8, dtype=dtype), tvae.Downsample(8), (2, 8, 7, 5)),
    "upsample_even": lambda dtype: (jvae.Upsample(8, dtype=dtype), tvae.Upsample(8), (2, 8, 4, 6)),
    "upsample_odd": lambda dtype: (jvae.Upsample(8, dtype=dtype), tvae.Upsample(8), (2, 8, 3, 5)),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_block_matches_jax(name):
    jm, tm, shape = MODULES[name](jnp.float32)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    params = perturbed_params(jm, nhwc(x))
    want = nchw(jm.apply({"params": params}, nhwc(x)))
    close(run(port(tm, params), x), want)


def test_nearest_upsampling_picks_the_same_pixels():
    """At exactly 2x, F.interpolate's nearest and jax.image.resize's nearest
    take the same source pixel: equal to the bit, odd sizes too."""
    x = np.random.default_rng(2).standard_normal((2, 3, 5, 7)).astype(np.float32)
    got = torch.nn.functional.interpolate(t(x), scale_factor=2.0, mode="nearest").numpy()
    want = nchw(jax.image.resize(nhwc(x), (2, 10, 14, 3), method="nearest"))
    np.testing.assert_array_equal(got, want)


def _coder(kind, config, dtype):
    ch, layers, groups = CONFIGS[config]
    if kind == "encoder":
        return (jvae.Encoder(ch, layers, groups=groups, dtype=dtype),
                tvae.Encoder(ch, layers, groups=groups), (2, 3, 8, 8))
    return (jvae.Decoder(ch, layers, groups=groups, dtype=dtype),
            tvae.Decoder(ch, layers, groups=groups), (2, 4, 3, 4))


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_coder_matches_jax(kind, config):
    jm, tm, shape = _coder(kind, config, jnp.float32)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    params = perturbed_params(jm, nhwc(x))
    close(run(port(tm, params), x), nchw(jm.apply({"params": params}, nhwc(x))))


def _vaes(config, dtype=jnp.float32, seed=0):
    ch, layers, groups = CONFIGS[config]
    jm = jvae.AutoencoderKL(block_out_channels=ch, layers_per_block=layers, groups=groups, dtype=dtype)
    params = perturbed_params(jm, jnp.zeros((1, 3, 16, 16)), seed, bf16=dtype == jnp.bfloat16)
    tm = tvae.AutoencoderKL(block_out_channels=ch, layers_per_block=layers, groups=groups)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jm, params, port(tm, params, tdtype)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_autoencoder_matches_jax(config):
    """encode (mean; logvar clipped to [-30, 20]), decode, and the full call
    with the posterior's mode."""
    jm, params, tm = _vaes(config)
    x = np.random.default_rng(4).standard_normal((2, 3, 16, 16)).astype(np.float32)
    v = {"params": params}
    post = jm.apply(v, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        tpost = tm.encode(t(x))
        close(tpost.mean, post.mean)
        close(tpost.logvar, post.logvar)
        assert float(tpost.logvar.min()) >= -30 and float(tpost.logvar.max()) <= 20
        z = np.random.default_rng(5).standard_normal(tuple(post.mean.shape)).astype(np.float32)
        close(tm.decode(t(z)), jm.apply(v, jnp.asarray(z), method=jm.decode))
        recon, tpost = tm(t(x))
    jrecon, jpost = jm.apply(v, jnp.asarray(x))
    close(recon, jrecon)
    close(tpost.mode(), jpost.mode())


def test_full_sd_vae_matches_jax():
    """The VAE that ships (128/256/512/512 channels, 2 layers a block, 32
    groups, the ``vae_ckpt: random`` architecture): decode of 4x4 latents
    and encode of the 32x32 frames, at the fp32 limits."""
    jm = jvae.AutoencoderKL()
    params = perturbed_params(jm, jnp.zeros((1, 3, 16, 16)), seed=13, init=jax.jit(jm.init))
    tm = port(tvae.AutoencoderKL(), params)
    v = {"params": params}
    z = np.random.default_rng(14).standard_normal((2, 4, 4, 4)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(z), method=jm.decode)
    post = jm.apply(v, want, method=jm.encode)
    with torch.no_grad():
        close(tm.decode(t(z)), want)
        tpost = tm.encode(t(np.asarray(want)))
    close(tpost.mean, post.mean)
    close(tpost.logvar, post.logvar)


def test_decode_turns_off_only_cudnn_tf32():
    """make_decode_fn runs the VAE with cuDNN's TF32 off and leaves every
    other cuDNN setting as the caller set it, then restores TF32."""
    from latte_tpu_torch.vae import make_decode_fn

    cudnn = torch.backends.cudnn
    seen = []
    tm = tvae.tiny_vae()
    tm.initialize_weights(torch.Generator().manual_seed(16))
    decode_inner = tm.decode
    tm.decode = lambda z: seen.append((cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic)) or decode_inner(z)
    before = (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic)
    try:
        cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = True, True, True
        out = make_decode_fn(tm)(torch.zeros(1, 4, 2, 2))
        after = (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic)
    finally:
        cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = before
    assert seen == [(False, True, True)] and after == (True, True, True)
    assert out.shape == (1, 3, 4, 4)


BF16_CASES = {
    "resnet_conv_shortcut": lambda: MODULES["resnet_conv_shortcut"](jnp.bfloat16),
    "attn": lambda: MODULES["attn"](jnp.bfloat16),
    "encoder": lambda: _coder("encoder", "three_blocks", jnp.bfloat16),
    "decoder": lambda: _coder("decoder", "three_blocks", jnp.bfloat16),
}


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_matches_jax_bf16(name):
    """The modules in bf16 (GroupNorm and softmax in fp32) against the JAX
    modules with dtype bf16 and their fp32 result."""
    jm, tm, shape = BF16_CASES[name]()
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    params = perturbed_params(jm, nhwc(x), bf16=True)
    want = nchw(jm.apply({"params": params}, nhwc(x)))
    want_f32 = nchw(jm.clone(dtype=jnp.float32).apply({"params": params}, nhwc(x)))
    check_bf16(run(port(tm, params, torch.bfloat16), x), want, want_f32)


def test_bf16_vae_matches_jax_bf16():
    """The whole VAE in bf16 (encode, the mode, decode) likewise."""
    jm, params, tm = _vaes("three_blocks", jnp.bfloat16, seed=8)
    x = np.random.default_rng(8).standard_normal((2, 3, 16, 16)).astype(np.float32)
    want, _ = jm.apply({"params": params}, jnp.asarray(x))
    want_f32, _ = jm.clone(dtype=jnp.float32).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, _ = tm(t(x))
    check_bf16(got.float(), np.asarray(want, np.float32), np.asarray(want_f32))


class TestPosterior:
    def test_kl_zero_for_standard_normal(self):
        post = tvae.DiagonalGaussianDistribution(torch.zeros(2, 8, 2, 2), dim=1)
        np.testing.assert_allclose(post.kl().numpy(), 0.0, atol=1e-6)

    def test_kl_mode_and_clip_match_jax(self):
        m = np.random.default_rng(9).standard_normal((2, 8, 3, 3)).astype(np.float32)
        m[:, 4:] *= 20  # logvar beyond [-30, 20] on some elements
        post = tvae.DiagonalGaussianDistribution(t(m), dim=1)
        jpost = jvae.DiagonalGaussianDistribution(jnp.asarray(m), axis=1)
        close(post.kl(), jpost.kl())
        close(post.mode(), jpost.mode())
        close(post.std, jpost.std)
        assert float(post.logvar.max()) == 20.0 and float(post.logvar.min()) == -30.0

    def test_sample_statistics(self):
        moments = torch.cat([torch.full((2000, 1, 1, 1), 3.0), torch.zeros(2000, 1, 1, 1)], dim=1)
        samples = tvae.DiagonalGaussianDistribution(moments, dim=1).sample(torch.Generator().manual_seed(0))
        assert abs(samples.mean().item() - 3.0) < 0.1
        assert abs(samples.std().item() - 1.0) < 0.1


@pytest.mark.parametrize("config", list(CONFIGS))
def test_state_dict_round_trip(config):
    """The port's state dict -> the JAX package's converter ->
    flax_vae_to_state_dict gives the same tensors under the same keys."""
    ch, layers, groups = CONFIGS[config]
    tm = tvae.AutoencoderKL(block_out_channels=ch, layers_per_block=layers, groups=groups)
    gen = torch.Generator().manual_seed(10)
    with torch.no_grad():
        for p in tm.parameters():
            p.normal_(generator=gen)
    sd = tm.state_dict()
    back = flax_vae_to_state_dict(convert_vae_state_dict(sd, n_blocks=len(ch), layers_per_block=layers))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_legacy_attention_keys_give_the_same_output(tmp_path):
    """A state dict with diffusers' legacy query/key/value/proj_attn names
    and 4-D 1x1 attention weights loads to the same module as modern keys."""
    tm = tvae.tiny_vae()
    tm.initialize_weights(torch.Generator().manual_seed(11))
    sd = tm.state_dict()
    legacy = {}
    for k, v in sd.items():
        for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"), ("to_out.0", "proj_attn")):
            if f".attentions.0.{new}." in k:
                k, v = k.replace(f".{new}.", f".{old}."), (v[:, :, None, None] if v.dim() == 2 else v)
        legacy[k] = v
    assert any(".query.weight" in k for k in legacy) and not any(".to_q." in k for k in legacy)
    torch.save({"state_dict": legacy}, tmp_path / "legacy.pt")
    torch.save(sd, tmp_path / "modern.pt")
    x = torch.randn(1, 3, 16, 16, generator=torch.Generator().manual_seed(12))
    outs = []
    for name in ("legacy.pt", "modern.pt"):
        m = tvae.tiny_vae()
        m.load_state_dict(load_vae_state_dict(str(tmp_path / name)), strict=True)
        with torch.no_grad():
            outs.append(m(x)[0])
    assert torch.equal(outs[0], outs[1])


def test_seeded_init_has_the_jax_init_scale():
    """The full SD architecture's seeded init against the JAX init (both at a
    16x16 input): per-tensor std within 5% for tensors of >= 4096 elements,
    zero biases, unit GroupNorm scales and zero GroupNorm biases."""
    jm = jvae.AutoencoderKL()
    jparams = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16))))()["params"]
    want = flax_vae_to_state_dict(jparams)
    tm = tvae.AutoencoderKL()
    tm.initialize_weights(torch.Generator().manual_seed(0))
    got = tm.state_dict()
    assert got.keys() == want.keys()
    checked = 0
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        if k.endswith("bias"):
            assert not v.any() and not want[k].any(), k
        elif "norm" in k:
            assert torch.equal(v, torch.ones_like(v)) and torch.equal(want[k], v), k
        elif v.numel() >= 4096:
            ratio = v.std().item() / want[k].std().item()
            assert abs(ratio - 1) <= 0.05, (k, ratio)
            checked += 1
    assert checked > 50
