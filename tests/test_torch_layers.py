"""Port parity, layer by layer: every ported module of latte_tpu/models
(embeddings.py, layers.py) against its Flax twin on the same random weights,
carried across, and the same numpy inputs. All fp32.

Tolerance: 1e-5 relative, as the L2 norm of the difference over the norm
of the JAX output, and no element off by more than 1e-4 of the output's
largest magnitude. The two sides do the same fp32 arithmetic (matmuls at
full fp32 on both) in another summation order, a few ulp apart; sin/cos of
timestep arguments up to ~1000 rad move single elements by ~3e-5 when the
two libraries' exp() round a frequency one ulp apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, load_block, load_linear, load_qkv, randomize, t

from latte_tpu.models import embeddings as jemb
from latte_tpu.models import layers as jl
from latte_tpu_torch.models import embeddings as temb
from latte_tpu_torch.models import layers as tl

D, HEADS = 64, 4


def _init(module, *args):
    return randomize(module.init(jax.random.PRNGKey(0), *args)["params"])


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_sincos_tables_and_timestep_embedding(rng):
    np.testing.assert_array_equal(
        temb.get_2d_sincos_pos_embed(D, 4), jemb.get_2d_sincos_pos_embed(D, 4)
    )
    np.testing.assert_array_equal(
        temb.get_1d_sincos_pos_embed(D, 16), jemb.get_1d_sincos_pos_embed(D, 16)
    )
    ts = np.array([0, 1, 17, 500, 999], np.int64)
    for dim in (256, 33):
        close(
            temb.timestep_embedding(torch.from_numpy(ts), dim),
            jemb.timestep_embedding(jnp.asarray(ts), dim),
        )


def test_timestep_and_label_embedders(rng):
    ts = np.array([0, 250, 999], np.int32)
    jm = jemb.TimestepEmbedder(hidden_size=D)
    p = _init(jm, jnp.asarray(ts))
    tm = temb.TimestepEmbedder(D)
    load_linear(tm.mlp[0], p["mlp_0"])
    load_linear(tm.mlp[2], p["mlp_2"])
    close(tm(torch.from_numpy(ts)), jm.apply({"params": p}, jnp.asarray(ts)))

    labels = np.array([0, 3, 9], np.int32)
    jl_ = jemb.LabelEmbedder(num_classes=9, hidden_size=D)
    p = _init(jl_, jnp.asarray(labels))
    tl_ = temb.LabelEmbedder(9, D)
    with torch.no_grad():
        tl_.embedding_table.weight.copy_(t(p["embedding_table"]))
    close(tl_(torch.from_numpy(labels).long()), jl_.apply({"params": p}, jnp.asarray(labels)))
    drop = np.array([1, 0, 1])
    close(
        tl_(torch.from_numpy(labels).long(), force_drop_ids=torch.from_numpy(drop)),
        jl_.apply({"params": p}, jnp.asarray(labels), force_drop_ids=jnp.asarray(drop)),
    )


def test_modulate_and_mlp(rng):
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    shift, scale = (rng.standard_normal((2, D)).astype(np.float32) for _ in range(2))
    close(tl.modulate(t(x), t(shift), t(scale)), jl.modulate(x, shift, scale))

    jm = jl.Mlp(hidden_features=4 * D, out_features=D)
    p = _init(jm, jnp.asarray(x))
    tm = tl.Mlp(D, 4 * D, D)
    load_linear(tm.fc1, p["fc1"])
    load_linear(tm.fc2, p["fc2"])
    close(tm(t(x)), jm.apply({"params": p}, jnp.asarray(x)))


@pytest.mark.parametrize("mode", ["flash", "xla"])
@pytest.mark.parametrize("N", [16, 24])
def test_attention(rng, mode, N):
    x = rng.standard_normal((2, N, D)).astype(np.float32)
    jm = jl.Attention(dim=D, num_heads=HEADS, mode=mode)
    p = _init(jm, jnp.asarray(x))
    tm = tl.Attention(D, HEADS)
    load_qkv(tm.qkv, p["qkv"], HEADS)
    load_linear(tm.proj, p["proj"])
    close(tm(t(x)), jm.apply({"params": p}, jnp.asarray(x)))


@pytest.mark.parametrize(
    "jax_kw",
    [dict(attention_mode="flash", fused_adaln=True), dict()],
    ids=["flash-fused", "defaults"],
)
def test_adaln_block(rng, jax_kw):
    x = rng.standard_normal((3, 16, D)).astype(np.float32)
    c = rng.standard_normal((3, D)).astype(np.float32)
    jm = jl.AdaLNBlock(hidden_size=D, num_heads=HEADS, **jax_kw)
    p = _init(jm, jnp.asarray(x), jnp.asarray(c))
    tm = tl.AdaLNBlock(D, HEADS)
    load_block(tm, p, HEADS)
    close(tm(t(x), t(c)), jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(c)))
    # the plain switch computes the same function
    tm.plain = tm.attn.plain = True
    close(tm(t(x), t(c)), jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(c)))


def test_final_layer_patch_embed_unpatchify(rng):
    p_, C = 2, 4
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    c = rng.standard_normal((2, D)).astype(np.float32)
    jm = jl.FinalLayer(hidden_size=D, patch_size=p_, out_channels=2 * C)
    p = _init(jm, jnp.asarray(x), jnp.asarray(c))
    tm = tl.FinalLayer(D, p_, 2 * C)
    load_linear(tm.linear, p["linear"])
    load_linear(tm.adaLN_modulation[1], p["adaLN_modulation"])
    out_j = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(c))
    close(tm(t(x), t(c)), out_j)
    close(tl.unpatchify(t(out_j), p_, 2 * C), jl.unpatchify(out_j, p_, 2 * C))

    img = rng.standard_normal((3, C, 8, 8)).astype(np.float32)
    jm = jl.PatchEmbed(patch_size=p_, hidden_size=D)
    p = _init(jm, jnp.asarray(img))
    tm = tl.PatchEmbed(p_, C, D)
    with torch.no_grad():
        tm.proj.weight.copy_(t(np.asarray(p["proj"]["kernel"]).T.reshape(D, C, p_, p_)))
        tm.proj.bias.copy_(t(p["proj"]["bias"]))
    want = jm.apply({"params": p}, jnp.asarray(img))
    close(tm(t(img)), want)
    # and it is the reference's strided conv
    close(tm.proj(t(img)).flatten(2).transpose(1, 2), want)
