"""Port parity for the Mixture-of-Experts feed-forward
(latte_tpu_torch/models/moe.py) and the three model families with it, against
the JAX package on the CPU: ``MoEMlp`` against the JAX ``MoEMlp``, E = 1
against the dense feed-forwards, its gradients against ``jax.grad``, tiny
Latte, LatteIMG and LatteT2V with 4 experts (the JAX models with
``attention_mode="xla"``; the port on CPU tensors runs the kernels' plain
versions), their per-block Switch losses, the weight carry-over and the
refusals.

Inputs and weights come from numpy seeds. Tolerances:
- fp32 outputs: relative L2 1e-5 (``close``'s defaults: each element within
  1e-4 of the largest magnitude), the same arithmetic summed in another
  order; the routing choices equal; the Switch losses within 1e-6;
- bf16: ``check_bf16`` (the VAE's rule: within 5e-2 of JAX's bf16, and an
  error against JAX's fp32 at most 1.25x JAX bf16's own + 1e-3);
- gradients: relative L2 1e-4 (``close(…, 1e-4, 1e-3)``).
Every case prints the smallest top-k margin of its tokens (the gap between
neighbouring probabilities at a choice): a routing flip is only excusable
where that margin is below fp32 rounding, and then it is recorded in
ROADMAP §3, not hidden by another seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import RouterMargins, check_bf16, close, randomize, top_k_margin

from latte_tpu.models import Latte as JaxLatte
from latte_tpu.models import LatteIMG as JaxLatteIMG
from latte_tpu.models.layers import Mlp as JaxMlp
from latte_tpu.models.moe import MoEMlp as JaxMoEMlp
from latte_tpu.models.t2v import LatteT2V as JaxLatteT2V
from latte_tpu.models.t2v import T2VFeedForward as JaxT2VFeedForward
from latte_tpu_torch.config import Config
from latte_tpu_torch.convert import MOE_PARAMS, flax_t2v_to_state_dict, load_flax_params, load_t2v_state_dict
from latte_tpu_torch.models import Latte, LatteIMG, get_models
from latte_tpu_torch.models.layers import Mlp
from latte_tpu_torch.models.moe import MoEMlp, moe_groups
from latte_tpu_torch.models.t2v import LatteT2V, T2VFeedForward

D, H, E = 16, 32, 4
AUX_TOL = 1e-6


def _jax_moe(x, seed=0, std=0.3, hidden=H, **kw):
    """The JAX MoEMlp with weights from a numpy seed, its output, Switch
    loss and params."""
    jm = JaxMoEMlp(hidden_features=hidden, out_features=D, num_experts=kw.pop("num_experts", E), **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = randomize(params, seed=seed, std=std)
    y, var = jm.apply({"params": params}, jnp.asarray(x), mutable=["intermediates"])
    return jm, params, np.asarray(y), float(var["intermediates"]["moe_aux_loss"][0])


def _port_moe(params, hidden=H, **kw):
    tm = MoEMlp(D, hidden, D, kw.pop("num_experts", E), **kw)
    tm.load_state_dict({n: torch.from_numpy(np.array(v)) for n, v in params.items()}, strict=True)
    return tm


def _jax_choices(x, router, k):
    """The JAX layer's routing: fp32 softmax and top-k by iterative masking."""
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32).reshape(-1, router.shape[0]) @ router, axis=-1)
    p, out = probs, []
    for _ in range(k):
        idx = jnp.argmax(p, axis=-1)
        out.append(np.asarray(idx))
        p = p * (1.0 - jax.nn.one_hot(idx, router.shape[1]))
    return out, np.asarray(probs)


def _check_routing(label, tm, x, router, k):
    want, probs = _jax_choices(x, np.asarray(router), k)
    with torch.no_grad():
        _, got, _, _ = tm.route(torch.from_numpy(np.array(x)).reshape(-1, x.shape[-1]))
    margin = top_k_margin(probs, k)
    flips = sum(int((g.numpy() != w).sum()) for g, w in zip(got, want))
    print(f"{label}: smallest top-{k} margin {margin:.3e}, routing choices apart {flips}")
    assert flips == 0


CASES = {
    "gelu-k1": dict(activation_fn="gelu-approximate", top_k=1),
    "gelu-k2": dict(activation_fn="gelu-approximate", top_k=2),
    "geglu-k1": dict(activation_fn="geglu", top_k=1),
    "geglu-k2": dict(activation_fn="geglu", top_k=2),
    # 3 groups of 16 tokens at C = ceil(16·2·0.5/4) = 4: many drops
    "gelu-k2-drops-groups": dict(activation_fn="gelu-approximate", top_k=2, capacity_factor=0.5, group_size=16),
    "geglu-k2-drops-groups": dict(activation_fn="geglu", top_k=2, capacity_factor=0.5, group_size=16),
}


def _x(B=2, N=24, seed=1):
    return np.random.default_rng(seed).standard_normal((B, N, D)).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_mlp_matches_jax(case):
    kw = CASES[case]
    x = _x()
    _, params, want, want_aux = _jax_moe(x, **kw)
    tm = _port_moe(params, **kw)
    _check_routing(case, tm, x, params["router"], kw["top_k"])
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want)
    assert abs(float(aux) - want_aux) <= AUX_TOL
    if "drops" in case:
        g, C = moe_groups(x.shape[0] * x.shape[1], E, 2, 0.5, 16)
        assert (g, C) == (16, 4)


@pytest.mark.parametrize("case", ["gelu-k2", "geglu-k2-drops-groups"])
def test_moe_mlp_bf16_matches_jax(case):
    """The port's bf16 module (router kept fp32 by the cast) against the JAX
    module at ``dtype=bfloat16``, by the VAE's rule."""
    kw = CASES[case]
    x = _x(seed=2)
    jm, params, want32, _ = _jax_moe(x, **kw)
    jb = jm.clone(dtype=jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    want16 = np.asarray(jb.apply({"params": params}, xb).astype(jnp.float32))
    tm = _port_moe(params, **kw).to(torch.bfloat16)
    assert tm.router.dtype == torch.float32 and tm.wi.dtype == torch.bfloat16
    _check_routing(case + " bf16", tm, np.asarray(xb.astype(jnp.float32)), params["router"], kw["top_k"])
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    check_bf16(got, want16, want32)


def test_single_expert_is_the_dense_feed_forward():
    """E = 1: the router's softmax is 1, every token fits, and the layer is
    the JAX dense Mlp (tanh gelu) and T2VFeedForward (geglu) on the same
    weights."""
    x = _x(seed=3)
    for act, hidden in (("gelu-approximate", H), ("geglu", 4 * D)):
        _, params, _, _ = _jax_moe(x, num_experts=1, activation_fn=act, hidden=hidden)
        tm = _port_moe(params, num_experts=1, activation_fn=act, hidden=hidden)
        with torch.no_grad(), RouterMargins(f"E = 1 {act}"):
            got, aux = tm(torch.from_numpy(x))
        assert abs(float(aux) - 1.0) <= AUX_TOL
        if act == "geglu":
            jd = JaxT2VFeedForward(dim=D, activation_fn="geglu")
            dense = {"net_0_proj": {"kernel": params["wi"][0], "bias": params["bi"][0]},
                     "net_2": {"kernel": params["wo"][0], "bias": params["bo"][0]}}
        else:
            jd = JaxMlp(hidden_features=H, out_features=D)
            dense = {"fc1": {"kernel": params["wi"][0], "bias": params["bi"][0]},
                     "fc2": {"kernel": params["wo"][0], "bias": params["bo"][0]}}
        close(got, np.asarray(jd.apply({"params": dense}, jnp.asarray(x))))


def test_single_expert_equals_the_ports_dense_layers():
    """The port's own dense layers on E = 1's weights agree too."""
    x = torch.from_numpy(_x(seed=4))
    for act in ("gelu-approximate", "geglu"):
        moe = MoEMlp(D, 4 * D, D, 1, activation_fn=act)
        with torch.no_grad():
            moe.bi.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
            moe.bo.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
        if act == "geglu":
            dense = T2VFeedForward(D, activation_fn="geglu")
            fc1, fc2 = dense.net[0].proj, dense.net[2]
        else:
            dense = Mlp(D, 4 * D, D)
            fc1, fc2 = dense.fc1, dense.fc2
        with torch.no_grad():
            fc1.weight.copy_(moe.wi[0].T)
            fc1.bias.copy_(moe.bi[0])
            fc2.weight.copy_(moe.wo[0].T)
            fc2.bias.copy_(moe.bo[0])
            close(moe(x)[0], dense(x).numpy())


@pytest.mark.parametrize("case", ["gelu-k2", "geglu-k2-drops-groups"])
def test_moe_mlp_gradients_match_jax(case):
    """d(Σ y·w + 3·aux) with respect to every parameter, router included,
    and the input, against ``jax.grad``."""
    kw = CASES[case]
    x = _x(seed=5)
    jm, params, y, _ = _jax_moe(x, **kw)
    w = np.random.default_rng(6).standard_normal(y.shape).astype(np.float32)

    def loss(p, xx):
        out, var = jm.apply({"params": p}, xx, mutable=["intermediates"])
        return jnp.sum(out * w) + 3.0 * var["intermediates"]["moe_aux_loss"][0]

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tm = _port_moe(params, **kw)
    tx = torch.from_numpy(x).requires_grad_()
    with RouterMargins(f"{case} gradients"):
        out, aux = tm(tx)
    ((out * torch.from_numpy(w)).sum() + 3.0 * aux).backward()
    for name in MOE_PARAMS:
        close(getattr(tm, name).grad, want_p[name], 1e-4, 1e-3)
    close(tx.grad, want_x, 1e-4, 1e-3)


def test_unknown_activation_raises():
    with pytest.raises(NotImplementedError, match="relu"):
        MoEMlp(D, H, D, E, activation_fn="relu")


def test_groups_and_capacity_as_in_jax():
    """The largest divisor of S not above the group size; C = min(g,
    max(1, ceil(g·k·cf / E)))."""
    assert moe_groups(20480, 8, 2, 1.25) == (512, 160)
    assert moe_groups(100, 4, 2, 1.25, group_size=30) == (25, 16)
    assert moe_groups(7, 8, 2, 0.01) == (7, 1)
    assert moe_groups(6, 1, 2, 4.0) == (6, 6)


# ----------------------------------------------------------------- the models

TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=4, num_heads=4, num_frames=4)
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0)


def _jax_columns(var) -> np.ndarray:
    """The sown Switch losses, (columns, n_pairs), spatial first."""
    blocks = var["intermediates"]["blocks"]
    return np.stack([np.asarray(blocks[c]["moe"]["moe_aux_loss"][0]) for c in ("spatial", "temporal")
                     if c in blocks])


def _model_inputs(frames=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, frames, 4, 8, 8)).astype(np.float32), np.array([999, 17], np.int32)


@pytest.mark.parametrize("image_model", [False, True], ids=["Latte", "LatteIMG"])
def test_moe_latte_matches_jax(image_model):
    """A tiny Latte (LatteIMG in its training form, 2 images) with 4
    experts, top-2 at capacity factor 1.0 (tokens drop), against the JAX
    model: output and each block's Switch loss."""
    if image_model:
        jm = JaxLatteIMG(**TINY, use_image_num=2, attention_mode="xla", **MOE)
        tm_cls, kw, frames = LatteIMG, dict(use_image_num=2), 6
    else:
        jm = JaxLatte(**TINY, attention_mode="xla", **MOE)
        tm_cls, kw, frames = Latte, {}, 4
    x, t = _model_inputs(frames)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    params = randomize(params, seed=2, std=0.1)
    train = dict(train=True) if image_model else {}
    want, var = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), mutable=["intermediates"], **train)
    tm = load_flax_params(tm_cls(**TINY, **kw, **MOE), params)
    assert tm.blocks[0].moe.router.shape == (64, 4) and not hasattr(tm.blocks[0], "mlp")
    with torch.no_grad(), RouterMargins(tm_cls.__name__):
        got, aux = tm(torch.from_numpy(x), torch.from_numpy(t).long(), return_aux=True, **train)
    close(got, np.asarray(want))
    want_aux = _jax_columns(var)
    assert aux.shape == want_aux.shape == (2, 2)
    np.testing.assert_allclose(aux.numpy(), want_aux, rtol=0, atol=AUX_TOL)
    with torch.no_grad():  # without return_aux the forward is the plain one
        assert torch.equal(tm(torch.from_numpy(x), torch.from_numpy(t).long(), **train), got)


def test_moe_latte_t2v_matches_jax():
    """A tiny LatteT2V with 4 geglu experts (the block's activation_fn)
    against the JAX model, with its per-block losses; the t2i form has one
    column."""
    arch = dict(num_attention_heads=2, attention_head_dim=16, num_layers=2, patch_size=2, sample_size=8,
                cross_attention_dim=32, caption_channels=64, video_length=4, activation_fn="geglu", **MOE)
    rng = np.random.default_rng(1)
    for frames, temporal in ((4, True), (1, False)):
        jm = JaxLatteT2V(**arch, attention_mode="xla", enable_temporal_attentions=temporal)
        x = rng.standard_normal((2, 4, frames, 16, 16)).astype(np.float32)
        t = np.array([3.0, 500.5], np.float32)
        ctx = rng.standard_normal((2, 10, 64)).astype(np.float32)
        params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), None)
        params = randomize(params["params"], seed=3, std=0.1)
        want, var = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), None,
                             mutable=["intermediates"])
        tm = LatteT2V(**arch, enable_temporal_attentions=temporal)
        tm.load_state_dict(flax_t2v_to_state_dict(params), strict=True)
        assert tm.transformer_blocks[0].moe.wi.shape == (4, 32, 256)
        with torch.no_grad(), RouterMargins(f"LatteT2V frames={frames}"):
            got, aux = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), None, return_aux=True)
        close(got, np.asarray(want))
        want_aux = _jax_columns(var)
        assert aux.shape == want_aux.shape == ((2, 2) if temporal else (1, 2))
        np.testing.assert_allclose(aux.numpy(), want_aux, rtol=0, atol=AUX_TOL)


def test_dense_models_report_no_aux():
    x, t = _model_inputs()
    tm = Latte(**TINY)
    with torch.no_grad():
        out, aux = tm(torch.from_numpy(x), torch.from_numpy(t).long(), return_aux=True)
    assert aux is None and out.shape == (2, 4, 8, 8, 8)
    with pytest.raises(ValueError, match="staging hook"):
        tm(torch.from_numpy(x), torch.from_numpy(t).long(), return_aux=True, return_front=1)


def test_bf16_model_keeps_the_router_fp32():
    """``model.to(bfloat16)``: the experts go bf16, the routers stay fp32
    (a bf16 router would flip routing), in Latte and LatteT2V."""
    tm = Latte(**TINY, **MOE).to(torch.bfloat16)
    t2v = LatteT2V(num_attention_heads=2, attention_head_dim=16, num_layers=1, sample_size=8,
                   caption_channels=64, video_length=4, **MOE).to(torch.bfloat16)
    for model in (tm, t2v):
        routers = [m for m in model.modules() if isinstance(m, MoEMlp)]
        assert routers and all(m.router.dtype == torch.float32 and m.wi.dtype == torch.bfloat16 for m in routers)
    x, t = _model_inputs()
    with torch.no_grad(), RouterMargins("bf16 Latte"):
        out = tm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(t).long())
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_registry_passes_the_moe_keys_and_init_draws_the_experts():
    """As ``latte_tpu/models/registry.py:105-111``; the init is the JAX
    layer's: router N(0, 0.02²), xavier-uniform experts, zero biases."""
    args = Config(dict(model="Latte-S/2", image_size=64, num_frames=2, extras=1, learn_sigma=True,
                       moe_experts=4, moe_top_k=1, moe_capacity_factor=2.0,
                       model_overrides={"depth": 2, "hidden_size": 64, "num_heads": 2}))
    model = get_models(args)
    model.initialize_weights(torch.Generator().manual_seed(0))
    moe = model.blocks[1].moe
    assert (moe.num_experts, moe.top_k, moe.capacity_factor) == (4, 1, 2.0)
    assert abs(float(moe.router.std()) - 0.02) < 0.005
    bound = (6.0 / (64 + 256)) ** 0.5
    assert float(moe.wi.abs().max()) <= bound and float(moe.wi.abs().max()) > 0.9 * bound
    assert not moe.bi.any() and not moe.bo.any()
    assert not get_models(Config(dict(args.to_dict(), moe_experts=0))).blocks[0].is_moe


@pytest.mark.parametrize("quantized", [True, "static", "calib", "train"])
def test_quantized_moe_is_refused(quantized):
    """No int8 expert path, in either package (``layers.py:449-457``,
    ``t2v.py:113-119``)."""
    with pytest.raises(NotImplementedError, match="MoEMlp has no int8 expert path"):
        Latte(**TINY, quantized=quantized, **MOE)
    with pytest.raises(NotImplementedError, match="MoEMlp has no int8 expert path"):
        LatteT2V(num_attention_heads=2, attention_head_dim=16, num_layers=1, sample_size=8,
                 caption_channels=64, quantized=quantized, **MOE)


def test_moe_t2v_checkpoint_names_the_missing_expert_weights(tmp_path):
    """A reference (dense) LatteT2V checkpoint holds no expert weights and no
    converter maps any: loading it for an MoE model fails naming them."""
    arch = dict(num_attention_heads=2, attention_head_dim=16, num_layers=1, sample_size=8, caption_channels=64)
    dense = LatteT2V(**arch)
    torch.save(dense.state_dict(), tmp_path / "t2v.pt")
    with pytest.raises(KeyError, match=r"expert weights.*transformer_blocks\.0\.moe\.(bi|bo|router|wi|wo)"):
        load_t2v_state_dict(str(tmp_path / "t2v.pt"), 1, moe_experts=4)
    sd = load_t2v_state_dict(str(tmp_path / "t2v.pt"), 1)
    assert "transformer_blocks.0.ff.net.2.weight" in sd
