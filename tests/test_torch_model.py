"""Port parity for the whole model: ``latte_tpu_torch`` Latte against the Flax
Latte (with the Pallas kernels in interpret mode, and with the defaults), and
against the reference torch model's own output stored in
``tests/golden/ref_latte_tiny.npz``. Weights cross over through
``latte_tpu_torch.convert`` with a strict load. All fp32.

Tolerance: 1e-4 relative (L2 norm of the difference over the norm of the
other side; no element off by more than 1e-3 of the largest magnitude). A
forward chains ~30 layers whose fp32 results each move by a few ulp with
the summation order, and the random weights (std 0.2) amplify that.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from torch_port_util import close, randomize

from latte_tpu.models import Latte as JaxLatte
from latte_tpu_torch.convert import flax_to_state_dict, load_flax_params
from latte_tpu_torch.models import Latte, LatteIMG, get_model

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "ref_latte_tiny.npz")
GOLDEN_CFG = dict(
    input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=4, num_heads=4,
    num_frames=4, extras=2, num_classes=10,
)
TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=4, num_heads=4, num_frames=4)
REL, ELEM = 1e-4, 1e-3


def _inputs(B=2, F=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F, 4, 8, 8)).astype(np.float32)
    t = np.array([999, 17][:B], np.int32)
    return x, t


def _jax_params(model, x, t, seed=0, **kw):
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), **kw)["params"]
    return randomize(params, seed=seed, std=0.1)


@pytest.mark.parametrize(
    "jax_kw",
    [dict(attention_mode="flash", fused_adaln=True), dict()],
    ids=["flash-fused", "defaults"],
)
def test_forward_matches_flax(jax_kw):
    x, t = _inputs()
    jm = JaxLatte(**TINY, **jax_kw)
    params = _jax_params(jm, x, t)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    tm = load_flax_params(Latte(**TINY), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t))
    close(got, want, REL, ELEM)


def test_class_conditional_and_cfg_match_flax():
    x, t = _inputs()
    y = np.array([3, 10], np.int32)  # 10 is the null class
    cfg = dict(TINY, extras=2, num_classes=10)
    jm = JaxLatte(**cfg)
    params = _jax_params(jm, x, t, y=jnp.asarray(y))
    tm = load_flax_params(Latte(**cfg), params)
    tx, tt, ty = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long()
    with torch.no_grad():
        close(tm(tx, tt, y=ty), jm.apply({"params": params}, *map(jnp.asarray, (x, t)), y=jnp.asarray(y)), REL, ELEM)
        got = tm.forward_with_cfg(tx, tt, y=ty, cfg_scale=4.0)
    want = jm.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), y=jnp.asarray(y),
        cfg_scale=4.0, method=JaxLatte.forward_with_cfg,
    )
    close(got, want, REL, ELEM)
    # guidance touches the first 4 channels only; both halves get it
    assert torch.equal(got[0, :, :4], got[1, :, :4])


def _golden():
    data = np.load(GOLDEN)
    params = unflatten_dict(
        {tuple(k[len("param/"):].split("/")): data[k] for k in data.files if k.startswith("param/")}
    )
    return data, params


def test_forward_matches_reference_golden():
    data, params = _golden()
    tm = load_flax_params(Latte(**GOLDEN_CFG), params)
    with torch.no_grad():
        got = tm(
            torch.from_numpy(data["x"]), torch.from_numpy(data["t"]), y=torch.from_numpy(data["y"])
        )
    close(got, data["fwd"], REL, ELEM)


def test_ddim_matches_reference_golden():
    from latte_tpu_torch.core import create_diffusion, ddim_sample_loop

    data, params = _golden()
    tm = load_flax_params(Latte(**GOLDEN_CFG), params)
    d = create_diffusion("ddim10", diffusion_steps=100)
    got = ddim_sample_loop(
        d, tm, torch.from_numpy(data["xT"]), model_kwargs={"y": torch.from_numpy(data["y"])}
    )
    close(got, data["latents"], REL, ELEM)


def test_convert_is_strict_and_carries_every_weight():
    x, t = _inputs()
    jm = JaxLatte(**TINY)
    params = _jax_params(jm, x, t)
    sd = flax_to_state_dict(params, depth=4, num_heads=4, patch_size=2)
    model = Latte(**TINY)
    assert set(sd) == set(model.state_dict())  # no sincos tables, nothing missing
    assert sd["x_embedder.proj.weight"].shape == (64, 4, 2, 2)
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(v.numel() for v in sd.values())
    del sd["final_layer.linear.bias"]
    with pytest.raises(RuntimeError):
        model.load_state_dict(sd, strict=True)


def test_registry_and_init():
    m = get_model("Latte-S/4", input_size=8, num_frames=2, depth=2)
    assert (m.hidden_size, m.num_heads, m.patch_size) == (384, 6, 4)
    with pytest.raises(ValueError):
        get_model("Latte-XXL/2")
    m = get_model("LatteIMG-S/4", input_size=8, num_frames=2, depth=2, use_image_num=3)
    assert isinstance(m, LatteIMG) and (m.hidden_size, m.patch_size, m.use_image_num) == (384, 4, 3)
    m = Latte(**TINY)
    m.initialize_weights(torch.Generator().manual_seed(0))
    # adaLN-Zero: every block starts as the identity and the output is zero
    x, t = _inputs()
    with torch.no_grad():
        assert torch.count_nonzero(m(torch.from_numpy(x), torch.from_numpy(t))) == 0
