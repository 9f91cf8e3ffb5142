"""The port's LatteT2V (latte_tpu_torch/models/t2v.py) and its weight
carry-over (latte_tpu_torch/convert.py) against the JAX LatteT2V on the
CPU, at the tiny widths of tests/test_t2v.py (2 heads of 16, caption width
64, 16x16 latents of patch 2). The JAX model runs with attention_mode "xla",
as the JAX tests run it on the CPU; the port on CPU tensors runs the
kernels' plain versions. Its params are the JAX init with every leaf
redrawn from a numpy seed (``randomize``), carried over by
``flax_t2v_to_state_dict``.

Tolerances: fp32 ``close``'s defaults (relative L2 1e-5, each element
within 1e-4 of the largest magnitude): the same function summed in another
order. bf16: ``check_bf16`` (within 5e-2 of JAX's bf16, and an error
against JAX's fp32 result at most 1.25x JAX bf16's own + 1e-3). int8:
``close(2e-2, 5e-2)``, the int8 tests' limit (an activation an ulp apart on
the two sides may round to the neighbouring int8 value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import check_bf16, close, randomize

from latte_tpu.models.t2v import LatteT2V as JaxLatteT2V
from latte_tpu.quant import quantize_params as jax_quantize_params
from latte_tpu.tools.convert_t2v import flax_to_reference_t2v_state_dict
from latte_tpu_torch.convert import (
    T2V_BUFFERS,
    flax_t2v_to_state_dict,
    load_t2v_state_dict,
    read_safetensors,
)
from latte_tpu_torch.models.t2v import LatteT2V
from latte_tpu_torch.quant import quantize_params

ARCH = dict(num_attention_heads=2, attention_head_dim=16, num_layers=2, patch_size=2,
            sample_size=8, cross_attention_dim=32, caption_channels=64, video_length=4)
L = 10  # caption tokens


def make(seed=0, std=0.1, frames=4, **kw):
    """The JAX model (xla attention) with randomized params, the port's model
    carrying them, and the params."""
    jm = JaxLatteT2V(**ARCH, attention_mode="xla", **kw)
    x = jnp.zeros((1, 4, frames, 16, 16))
    params = jm.init({"params": jax.random.PRNGKey(0)}, x, jnp.zeros((1,)), jnp.zeros((1, L, 64)), None)
    params = randomize(params["params"], seed=seed, std=std)
    tm = LatteT2V(**ARCH, **kw)
    tm.load_state_dict(flax_t2v_to_state_dict(params), strict=True)
    return jm, params, tm.eval()


def inputs(B=2, frames=4, seed=1, captions=None):
    """x, t, caption states and a mask (row 0 half kept, row 1 all zeros:
    the stub's empty negative prompt), as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 4, frames, 16, 16)).astype(np.float32)
    t = np.array([3.0, 500.5][:B], np.float32)
    shape = (B, L) if captions is None else (B, captions, L)
    ctx = rng.standard_normal(shape + (64,)).astype(np.float32)
    mask = np.zeros(shape, np.int32)
    mask[0, ..., : L // 2] = 1
    return x, t, ctx, mask


def run_both(jm, params, tm, x, t, ctx, mask, **kw):
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                    None if mask is None else jnp.asarray(mask), **kw)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                 None if mask is None else torch.from_numpy(mask), **kw)
    return got, np.asarray(want)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
def test_forward_matches_jax(masked):
    jm, params, tm = make()
    x, t, ctx, mask = inputs()
    got, want = run_both(jm, params, tm, x, t, ctx, mask if masked else None)
    assert got.shape == (2, 8, 4, 16, 16)
    close(got, want)


def test_all_zero_mask_row_is_the_unmasked_row():
    """The additive -10000 bias on every key of a row leaves its softmax as
    it was up to the rounding of logits near -10000 (an fp32 ulp there is
    ~1e-3): a caption with no valid token gives a finite output within 1e-3
    of the unmasked one, where a -inf mask would give NaN. (Against JAX the
    row is held at 1e-5 by test_forward_matches_jax.)"""
    _, _, tm = make()
    x, t, ctx, mask = inputs()
    with torch.no_grad():
        a = tm(*map(torch.from_numpy, (x, t, ctx, mask)))
        b = tm(*map(torch.from_numpy, (x, t, ctx)), None)
    assert torch.isfinite(a).all()
    close(a[1], b[1].numpy(), 1e-3, 1e-3)


def test_t2i_matches_jax():
    """enable_temporal_attentions=False at one frame: no temporal blocks."""
    jm, params, tm = make(frames=1, enable_temporal_attentions=False)
    assert not hasattr(tm, "temporal_transformer_blocks")
    assert "temporal" not in params["blocks"]
    got, want = run_both(jm, params, tm, *inputs(frames=1))
    close(got, want)


def test_geglu_and_chunked_feed_forward_match_jax():
    jm, params, tm = make(activation_fn="geglu", feed_forward_chunk_size=16)
    close(*run_both(jm, params, tm, *inputs()))
    tm.transformer_blocks[0].ff.chunk_size = 7
    with pytest.raises(ValueError, match="chunk"):
        run_both(jm, params, tm, *inputs())


def test_joint_image_captions_match_jax():
    """use_image_num=2 in training form: (B, 1+I, L) captions and masks, 4
    video frames and 2 images, the images skipping the temporal blocks."""
    jm, params, tm = make()
    x, t, ctx, mask = inputs(frames=6, captions=3)
    got, want = run_both(jm, params, tm, x, t, ctx, mask, use_image_num=2, train=True)
    assert got.shape == (2, 8, 6, 16, 16)
    close(got, want)


def test_staging_hooks_split_exactly():
    """return_front=k and then front_state/start_pair=k give the full
    forward to the bit; the front matches the JAX model's."""
    jm, params, tm = make()
    x, t, ctx, mask = inputs()
    tx, tt, tc, tk = map(torch.from_numpy, (x, t, ctx, mask))
    with torch.no_grad():
        full = tm(tx, tt, tc, tk)
        out, front = tm(tx, tt, tc, tk, return_front=1)
        kept = front.clone()
        part = tm(tx, tt, tc, tk, front_state=front, start_pair=1)
    assert torch.equal(out, full) and torch.equal(part, full) and torch.equal(front, kept)
    want_out, want_front = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(ctx), jnp.asarray(mask), return_front=1)
    close(front, want_front)
    close(out, want_out)
    with pytest.raises(ValueError, match="exclusive"):
        tm(tx, tt, tc, tk, return_front=1, front_state=front, start_pair=1)
    with pytest.raises(ValueError, match="together"):
        tm(tx, tt, tc, tk, front_state=front)


def test_bf16_forward_matches_jax_bf16():
    jm, params, tm = make(std=0.05)
    x, t, ctx, mask = inputs()
    tm.to(torch.bfloat16)
    # the adaLN tables stay fp32, as the JAX model's params do
    assert tm.scale_shift_table.dtype == torch.float32
    assert tm.transformer_blocks[0].scale_shift_table.dtype == torch.float32
    assert tm.proj_out.weight.dtype == torch.bfloat16
    want_bf16 = jm.clone(dtype=jnp.bfloat16).apply(
        {"params": params}, *map(jnp.asarray, (x, t, ctx, mask)))
    want_f32 = jm.apply({"params": params}, *map(jnp.asarray, (x, t, ctx, mask)))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (x, t, ctx, mask)))
    assert got.dtype == torch.float32  # the input's type
    check_bf16(got, np.asarray(want_bf16.astype(jnp.float32)), np.asarray(want_f32))


def test_quantized_params_and_forward_match_jax():
    """quantize_params on the port's state dict gives JAX's int8 weights and
    scales bit for bit (the attention projections and the feed-forward, in
    both block kinds), and the int8 forward stays within the int8 limit."""
    jm, params, _ = make()
    got_sd = quantize_params(flax_t2v_to_state_dict(params))
    want_sd = flax_t2v_to_state_dict(jax_quantize_params(params))
    assert set(got_sd) == set(want_sd)
    i8 = [k for k in got_sd if k.endswith("weight_i8")]
    assert len(i8) == 2 * (8 + 2) + 2 * (4 + 2)  # per pair: attn1+attn2+ff, attn1+ff
    assert all(".ff.net.0.proj." in k or ".ff.net.2." in k or ".attn" in k for k in i8)
    for k in got_sd:
        assert got_sd[k].dtype == want_sd[k].dtype, k
        assert torch.equal(got_sd[k], want_sd[k]), k
    tm = LatteT2V(**ARCH, quantized=True)
    tm.load_state_dict(got_sd, strict=True)
    jq = jm.clone(quantized=True)
    x, t, ctx, mask = inputs()
    want = jq.apply({"params": jax_quantize_params(params)}, *map(jnp.asarray, (x, t, ctx, mask)))
    with torch.no_grad():
        got = tm.eval()(*map(torch.from_numpy, (x, t, ctx, mask)))
    close(got, np.asarray(want), 2e-2, 5e-2)


def _reference_sd(params):
    """The JAX exporter's reference state dict, with the conv-shaped patch
    weight (the exporter leaves that reshape to its caller) and the two
    frozen buffers a reference checkpoint carries."""
    sd = flax_to_reference_t2v_state_dict(params, ARCH["num_layers"])
    w = sd["pos_embed.proj.weight"]
    sd["pos_embed.proj.weight"] = w.reshape(w.shape[0], 4, 2, 2)
    sd["temp_pos_embed"] = np.zeros((1, 4, 32), np.float32)
    sd["caption_projection.y_embedding"] = np.zeros((L, 64), np.float32)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("fmt", ["pt", "safetensors"])
def test_reference_checkpoint_loads_as_the_carried_params(tmp_path, fmt):
    """JAX's flax_to_reference_t2v_state_dict, saved as a reference
    checkpoint and read by load_t2v_state_dict, gives the tensors of
    flax_t2v_to_state_dict; it loads strictly. An unknown key raises."""
    _, params, _ = make()
    sd = _reference_sd(params)
    path = str(tmp_path / f"t2v.{fmt}")
    if fmt == "pt":
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    else:
        from safetensors.numpy import save_file

        save_file(sd, path)
    got = load_t2v_state_dict(path, ARCH["num_layers"])
    want = flax_t2v_to_state_dict(params)
    assert set(got) == set(want) and not set(got) & set(T2V_BUFFERS)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    LatteT2V(**ARCH).load_state_dict(got, strict=True)

    torch.save({**{k: torch.from_numpy(v) for k, v in sd.items()}, "extra.weight": torch.zeros(1)},
               str(tmp_path / "extra.pt"))
    with pytest.raises(ValueError, match="extra.weight"):
        load_t2v_state_dict(str(tmp_path / "extra.pt"), ARCH["num_layers"])


def test_safetensors_reader_matches_the_package(tmp_path):
    """read_safetensors against safetensors' own writer: F32 and F16 from
    numpy, BF16 from torch, every value equal; other types raise."""
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float16),
              "c": np.zeros((0, 4), np.float32),
              "d": np.array(2.5, np.float32)}
    save_file(arrays, str(tmp_path / "np.safetensors"), metadata={"format": "np"})
    got = read_safetensors(str(tmp_path / "np.safetensors"))
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == torch.from_numpy(v).dtype and got[k].shape == v.shape
        assert np.array_equal(got[k].numpy(), v)
    bf = torch.randn(4, 6, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    save_torch({"bf": bf}, str(tmp_path / "bf.safetensors"))
    assert torch.equal(read_safetensors(str(tmp_path / "bf.safetensors"))["bf"], bf)
    save_file({"i": np.arange(3, dtype=np.int64)}, str(tmp_path / "i.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        read_safetensors(str(tmp_path / "i.safetensors"))


@pytest.mark.parametrize("kw, exc, match", [
    (dict(moe_experts=2, quantized=True), NotImplementedError, "no int8 expert path"),
    (dict(attention_mode="ring"), ValueError, "requires constructing the model with ring_mesh"),
    (dict(gradient_checkpointing=True, remat_policy="offload"), ValueError, "unknown remat_policy"),
    (dict(attention_mode="pallas"), ValueError, "attention_mode"),
], ids=["moe", "ring", "gradient_checkpointing", "unknown_mode"])
def test_unported_options_raise(kw, exc, match):
    with pytest.raises(exc, match=match):
        LatteT2V(**ARCH, **kw)
