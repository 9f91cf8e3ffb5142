"""The int8 model: a tiny Latte in the W8A8 modes against its JAX twin, with
the JAX package's quantized params (``latte_tpu.quant.quantize_params`` of a
JAX calibration) carried over by ``latte_tpu_torch.convert`` and loaded
strictly; the checks of the registry and of ``Attention`` that keep an int8
flag from serving floating point; and the fp32 scales of a bf16 model.

Tolerance of the forward against JAX: 5e-3 relative L2 and 2e-2 of the
largest magnitude elementwise. Both sides quantize the same weights to the
same int8 values and run exact int32 products, but each activation that a
static or dynamic scale quantizes comes out of fp32 layers that the two
sides sum in another order, an ulp or so apart; where such a value lies
within that of a rounding boundary of round(x / s), it becomes the
neighbouring int8 value on one side. At these tiny widths one such step is
visible: a temporal row has 4 keys, so one step of P moves that row's
attention output by ~1/(127·l), up to ~0.8%, and the blocks after it spread
that. Over 16 seeds of these cases the sound port reads ≤ 3.5e-3 relative
L2 and ≤ 1.03e-2 elementwise (without any such step the two agree to
~1e-6); the JAX int8 model is as sensitive to itself: nudging every weight
by one ulp moves its output by ~0.8%. A port that quantized nothing would
read, against the same JAX int8 output: the fp model 8.6e-3 to 2.4e-2
relative L2 (1.2e-2 to 1.45e-2 at the seed used here), the int8 model with
fp attention in place of the int8 core 6.9e-3 to 1.2e-2 (1.03e-2 to 1.08e-2
here). So the L2 limit sits between, and each case asserts that these twins
fail it. The elementwise cap cannot tell them apart (the twins read from
8.6e-3): it only bounds the worst element. Each int8 piece is held tightly
on its own in test_torch_quant.py and test_torch_int8_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, randomize

from latte_tpu.models import Latte as JaxLatte
from latte_tpu.quant import quantize_params as jax_quantize_params
from latte_tpu_torch.config import Config
from latte_tpu_torch.convert import flax_to_state_dict
from latte_tpu_torch.models import Latte, get_models
from latte_tpu_torch.models.layers import Attention
from latte_tpu_torch.quant import quantize_params

TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=4, num_heads=4, num_frames=4)
REL, ELEM = 5e-3, 2e-2


def _setup(attention_mode, int8_attention, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 4, 8, 8)).astype(np.float32)
    t = np.array([999, 17], np.int32)
    jm = JaxLatte(**TINY, attention_mode=attention_mode, int8_attention=int8_attention)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    return jm, randomize(params, seed=seed, std=0.1), x, t


def _sd(tree):
    return flax_to_state_dict(tree, TINY["depth"], TINY["num_heads"], TINY["patch_size"])


@pytest.mark.parametrize("attention_mode", ["auto", "flash"])
@pytest.mark.parametrize(
    "quantized,int8_attention",
    [(True, False), ("static", False), ("static", True), ("static", "full"), ("static", "qk")],
    ids=["dynamic", "static", "static-int8_attention", "static-full", "static-qk"],
)
def test_int8_forward_matches_jax(quantized, int8_attention, attention_mode):
    jm, params, x, t = _setup(attention_mode, int8_attention)
    amax = None
    if quantized == "static":
        _, variables = jm.clone(quantized="calib").apply(
            {"params": params}, jnp.asarray(x), jnp.asarray(t), mutable=["calib"]
        )
        amax = variables["calib"]
    qparams = jax_quantize_params(params, act_amax=amax)
    want = jm.clone(quantized=quantized).apply({"params": qparams}, jnp.asarray(x), jnp.asarray(t))
    model = Latte(**TINY, attention_mode=attention_mode, int8_attention=int8_attention, quantized=quantized)
    model.load_state_dict(_sd(qparams), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
        plain = Latte(**TINY, attention_mode=attention_mode, int8_attention=int8_attention,
                      quantized=quantized, plain=True)
        plain.load_state_dict(model.state_dict(), strict=True)
        # on CPU tensors the kernels' wrappers are their plain versions
        torch.testing.assert_close(got, plain(torch.from_numpy(x), torch.from_numpy(t)), rtol=0, atol=0)
        # the twins that quantize less: the fp model, and fp attention under an int8 flag
        twins = {"fp": Latte(**TINY, attention_mode=attention_mode)}
        twins["fp"].load_state_dict(_sd(params), strict=True)
        if int8_attention:
            twins["fp attention"] = Latte(**TINY, attention_mode=attention_mode, quantized=quantized)
            twins["fp attention"].load_state_dict(
                {k: v for k, v in _sd(qparams).items() if not k.endswith(("q_scale", "k_scale", "v_scale"))},
                strict=True,
            )
        for name, twin in twins.items():
            with pytest.raises(AssertionError, match="relative L2"):
                close(twin(torch.from_numpy(x), torch.from_numpy(t)), want, REL, ELEM)
    close(got, want, REL, ELEM)


def test_state_dicts_are_strict_between_modes():
    _, params, _, _ = _setup("auto", True)
    fp_sd, q_sd = _sd(params), quantize_params(_sd(params))
    static = Latte(**TINY, quantized="static", int8_attention=True)
    with pytest.raises(RuntimeError):  # no act_scale, no {q,k,v}_scale, fp weights
        static.load_state_dict(q_sd, strict=True)
    with pytest.raises(RuntimeError):
        Latte(**TINY).load_state_dict(q_sd, strict=True)
    Latte(**TINY, quantized=True).load_state_dict(q_sd, strict=True)
    for mode in ("calib", "train"):  # the fp weights, as in JAX
        Latte(**TINY, quantized=mode, int8_attention=mode == "calib").load_state_dict(fp_sd, strict=True)
    with pytest.raises(ValueError, match="int8 model"):
        static.initialize_weights()


def test_bf16_model_keeps_its_scales_fp32():
    """``model.to(torch.bfloat16)`` casts the weights the JAX model computes
    in bf16 (biases, fp layers) and leaves the int8 weights and every scale
    as they were: the JAX model keeps its scale params fp32."""
    jm, params, x, t = _setup("flash", True)
    _, variables = jm.clone(quantized="calib").apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), mutable=["calib"]
    )
    sd = _sd(jax_quantize_params(params, act_amax=variables["calib"]))
    model = Latte(**TINY, quantized="static", int8_attention=True, attention_mode="flash")
    model.load_state_dict(sd, strict=True)
    model.to(torch.bfloat16)
    got = model.state_dict()
    for key, value in sd.items():
        if key.endswith(("_scale", "weight_i8")):
            assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
        else:
            assert got[key].dtype == torch.bfloat16, key
    assert sum(k.endswith("_scale") for k in got) == TINY["depth"] * 13  # 5 layers x 2, q, k, v
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def _args(**kw):
    base = dict(model="Latte-S/2", image_size=64, num_frames=2, extras=1, learn_sigma=True,
                model_overrides={"depth": 2, "hidden_size": 32, "num_heads": 2})
    return Config({**base, **kw})


def test_registry_is_the_int8_attention_choke_point():
    """As ``latte_tpu/models/registry.py:81-99``: the flag must be true,
    "full" or "qk", and it needs quantized: static (or calib)."""
    for quantized in (True, False, None):
        with pytest.raises(ValueError, match="quantized: static"):
            get_models(_args(int8_attention=True, quantized=quantized))
    with pytest.raises(ValueError, match="expected true"):
        get_models(_args(int8_attention="bogus", quantized="static"))
    fp = get_models(_args(int8_attention="qk", quantized="static"))  # the fp model a sampler starts from
    assert not hasattr(fp.blocks[0].attn, "q_scale")
    served = get_models(_args(int8_attention="qk", quantized="static", attention_mode="flash"), quantized="static")
    attn = served.blocks[0].attn
    assert attn.int8 and not attn.pv_int8 and attn.attention_mode == "flash" and attn.q_scale.shape == (2,)
    with pytest.raises(NotImplementedError, match="moe_experts is not supported"):
        get_models(_args(moe_experts=4), quantized="static")


def test_attention_refuses_an_int8_flag_without_calibrated_scales():
    """As the JAX Attention (``layers.py:194-213``): a bad value raises, and so
    does int8_attention with a quantized mode that has no calibrated scales;
    the fp model (quantized=False) is the permitted transient."""
    with pytest.raises(ValueError, match="expected False"):
        Attention(32, 2, int8_attention="bogus")
    for quantized in (True, "train"):
        with pytest.raises(ValueError, match="int8_attention requires"):
            Attention(32, 2, quantized=quantized, int8_attention=True)
    assert not Attention(32, 2, int8_attention=True).int8
    assert Attention(32, 2, quantized="static", int8_attention=True).int8
