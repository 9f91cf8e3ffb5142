"""W8A8 int8 quantization, port against the JAX package
(``latte_tpu_torch/quant/int8.py`` against ``latte_tpu/quant/int8.py``):
weight quantization and ``quantize_params`` through the weight carry-over,
the int8 products (dynamic, static, and the straight-through product of
quantized training), the fused int8 attention core, the calibration of a
tiny Latte, and the ``QLinear`` modes against ``QDense``. Inputs come from
numpy seeds.

Tolerances: the int8 weights and their scales, the calibrated scales carried
into a quantized state dict, and the int8 products' outputs are held bit for
bit: both sides do the same correctly rounded fp32 operations (one division
per scale, round half to even) and exact int32 sums. The rest:
- calibrated amax of a forward: 1e-5 relative (each is the max of an fp32
  activation that the two sides compute in another summation order, ~1e-6
  apart);
- the straight-through gradients: 1e-5 relative L2 and 1e-4 elementwise
  (fp32 matmuls summed in another order);
- the fused int8 attention core: as in test_torch_int8_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, randomize

from latte_tpu.models import Latte as JaxLatte
from latte_tpu.models.layers import QDense
from latte_tpu.quant import int8 as jq
from latte_tpu_torch.convert import flax_calib_to_amax, flax_to_state_dict
from latte_tpu_torch.models import Latte
from latte_tpu_torch.models.layers import QLinear
from latte_tpu_torch.quant import (
    calibrate_act_amax,
    int8_attention,
    int8_matmul,
    int8_matmul_static,
    int8_matmul_ste,
    merge_amax,
    quantize_params,
    quantize_weight,
)

TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=4, num_heads=4, num_frames=4)
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _weights(seed=0, n_in=64, n_out=48):
    """A JAX (in, out) kernel; its first output channel holds exact ties of
    round(w / scale): its amax is 127/64, so its scale is exactly 1/64 and
    ±0.5/64, 1.5/64, 2.5/64 sit halfway between two int8 values."""
    rng = np.random.default_rng(seed)
    w = (0.1 * rng.standard_normal((n_in, n_out))).astype(np.float32)
    w[:, 0] = 0.0
    w[:8, 0] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32) / 64
    return w


def test_quantize_weight_matches_jax_bit_for_bit():
    w = _weights()
    w_i8, scale = jq.quantize_weight(jnp.asarray(w))
    got_i8, got_scale = quantize_weight(torch.from_numpy(w.T.copy()))  # torch (out, in)
    assert got_i8.dtype == torch.int8 and got_scale.shape == (48, 1) and got_scale.dtype == torch.float32
    np.testing.assert_array_equal(got_i8.numpy(), np.asarray(w_i8).T)
    np.testing.assert_array_equal(got_scale.numpy()[:, 0], np.asarray(scale)[0])
    # round half to even, as jnp.round: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
    assert got_i8[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


@pytest.mark.parametrize("jdtype,tdtype", DTYPES, ids=["fp32", "bf16"])
def test_int8_products_match_jax_bit_for_bit(jdtype, tdtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 17, 64)).astype(np.float32)
    w = _weights()
    w_i8, scale = jq.quantize_weight(jnp.asarray(w))
    t_i8, t_scale = quantize_weight(torch.from_numpy(w.T.copy()))
    jx, tx = jnp.asarray(x, jdtype), torch.from_numpy(x).to(tdtype)

    def same(got, want):
        assert got.dtype == tdtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))

    same(int8_matmul(tx, t_i8, t_scale, tdtype), jq.int8_matmul(jx, w_i8, scale, jdtype))
    amax = np.float32(0.8 * np.abs(x).max())  # a calibrated amax that clips some values
    same(
        int8_matmul_static(tx, t_i8, t_scale, torch.tensor(amax), tdtype),
        jq.int8_matmul_static(jx, w_i8, scale, jnp.asarray(amax), jdtype),
    )


def test_int8_matmul_ste_forward_and_straight_through_gradients():
    """The QAT product: its forward is the serving arithmetic from the fp
    master (bit for bit against JAX), its gradients the fp ones of JAX's
    custom_vjp."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = _weights()
    g = rng.standard_normal((3, 5, 48)).astype(np.float32)
    want = jq.int8_matmul_ste(jnp.asarray(x), jnp.asarray(w), jnp.float32)
    want_dx, want_dw = jax.grad(
        lambda a, b: jnp.sum(jq.int8_matmul_ste(a, b, jnp.float32) * g), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    out = int8_matmul_ste(tx, tw, torch.float32)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    (out * torch.from_numpy(g)).sum().backward()
    close(tx.grad, want_dx, 1e-5, 1e-4)
    close(tw.grad.T, want_dw, 1e-5, 1e-4)


@pytest.mark.parametrize("pv_int8", [True, False], ids=["pv_int8", "qk"])
@pytest.mark.parametrize("jdtype,tdtype", DTYPES, ids=["fp32", "bf16"])
def test_fused_attention_core_matches_jax(jdtype, tdtype, pv_int8):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 64, 3, 32)).astype(np.float32) for _ in range(3))
    jx = [jnp.asarray(a, jdtype) for a in (q, k, v)]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdtype) for a in jx]
    amax = [np.abs(a).max(axis=(0, 1, 3)).astype(np.float32) for a in (q, k, v)]
    want = jq.int8_attention(*jx, *map(jnp.asarray, amax), jdtype, pv_int8=pv_int8)
    got = int8_attention(*tx, *map(torch.from_numpy, amax), tdtype, pv_int8)
    assert got.dtype == tdtype
    tol = (1e-5, 2e-3) if tdtype == torch.float32 else (1e-3, 2.0**-7)
    close(got.float(), np.asarray(want.astype(jnp.float32)), *tol)


def _tiny(attention_mode, int8_attention=True, seed=0):
    """A tiny JAX Latte (fp), its random params, and inputs at two timesteps."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 4, 8, 8)).astype(np.float32)
    t = np.array([999, 17], np.int32)
    jm = JaxLatte(**TINY, attention_mode=attention_mode, int8_attention=int8_attention)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    return jm, randomize(params, seed=seed, std=0.1), x, t


def _jax_calib(jm, params, x, t):
    _, variables = jm.clone(quantized="calib").apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), mutable=["calib"]
    )
    return variables["calib"]


def _sd(tree):
    return flax_to_state_dict(tree, TINY["depth"], TINY["num_heads"], TINY["patch_size"])


@pytest.mark.parametrize("int8_attention", [True, False], ids=["int8_attention", "dense_only"])
def test_quantize_params_matches_jax_through_convert(int8_attention):
    """JAX's quantize_params of Flax params, carried over, equals the port's
    quantize_params of the carried-over fp params, key for key and bit for
    bit: int8 weights (the qkv ones in the reference's [q|k|v] row order),
    per-channel scales, act_scale and the attention's {q,k,v}_scale."""
    jm, params, x, t = _tiny("xla", int8_attention)
    calib = _jax_calib(jm, params, x, t)
    fp_sd = _sd(params)
    for amax, jax_amax in ((flax_calib_to_amax(calib, TINY["depth"]), calib), (None, None)):
        want = _sd(jq.quantize_params(params, act_amax=jax_amax))
        got = quantize_params(fp_sd, act_amax=amax)
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    assert "blocks.0.attn.qkv.weight_i8" in got and "blocks.0.attn.qkv.weight" not in got
    assert "blocks.1.adaLN_modulation.1.weight_i8" in got
    for fp in ("final_layer.linear.weight", "final_layer.adaLN_modulation.1.weight", "x_embedder.proj.weight"):
        assert torch.equal(got[fp], fp_sd[fp])
    static = quantize_params(fp_sd, act_amax=flax_calib_to_amax(calib, TINY["depth"]))
    assert ("blocks.2.attn.q_scale" in static) == int8_attention
    assert static["blocks.2.attn.qkv.act_scale"].shape == ()


@pytest.mark.parametrize("attention_mode", ["xla", "flash"])
def test_calibration_matches_jax_calib_collection(attention_mode):
    """The port's calibration forward records what the JAX "calib"
    collection sows: each target's input amax and each attention's per-head
    q/k/v amax; merged over two calls as the JAX sampler merges timesteps."""
    jm, params, x, t = _tiny(attention_mode)
    want = None
    model = Latte(**TINY, attention_mode=attention_mode, int8_attention=True, quantized="calib")
    model.load_state_dict(_sd(params), strict=True)
    got = None
    for tc in (999, 0):
        tt = np.full((2,), tc, np.int32)
        want = jq.merge_amax(want, _jax_calib(jm, params, x, tt))
        got = merge_amax(got, calibrate_act_amax(model, torch.from_numpy(x), torch.from_numpy(tt)))
    want = flax_calib_to_amax(want, TINY["depth"])
    assert set(got) == set(want) and len(got) == TINY["depth"] * 8  # 5 layers and q, k, v a block
    for key in want:
        assert got[key].shape == want[key].shape, key
        close(got[key], want[key].numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize("mode", [True, "static", "calib", "train"], ids=str)
def test_qlinear_modes_match_qdense(mode):
    """One layer in each mode, with the weights (and the static amax) of the
    JAX QDense: bit for bit in the int8 modes."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    w, b = _weights(), (0.1 * rng.standard_normal(48)).astype(np.float32)
    fp = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
    amax = np.float32(np.abs(x).max())
    if mode in (True, "static"):
        w_i8, scale = jq.quantize_weight(jnp.asarray(w))
        params = {"kernel_i8": w_i8, "kernel_scale": scale, "bias": jnp.asarray(b)}
        if mode == "static":
            params["act_scale"] = jnp.asarray(amax)
    else:
        params = fp
    jl = QDense(features=48, quantized=mode)
    want, calib = jl.apply({"params": params}, jnp.asarray(x), mutable=["calib"])
    layer = QLinear(64, 48, quantized=mode)
    sd = {"bias": torch.from_numpy(b)}
    if mode in (True, "static"):
        sd["weight_i8"] = torch.from_numpy(np.asarray(params["kernel_i8"]).T.copy())
        sd["weight_scale"] = torch.from_numpy(np.array(params["kernel_scale"]).reshape(-1, 1))
        if mode == "static":
            sd["act_scale"] = torch.tensor(amax)
    else:
        sd["weight"] = torch.from_numpy(w.T.copy())
    layer.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    if mode == "calib":  # the fp layer, recording its input's amax
        close(got, want, 1e-5, 1e-5)
        assert float(layer.calib["act_amax"]) == float(calib["calib"]["act_amax"]) == amax
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
