"""Port parity for block-cache sampling (``latte_tpu_torch/core/block_cache.py``,
the staging hooks of ``Latte.forward``, and the sampler entry point's
``block_cache_interval``) against the JAX package, at the sizes of
tests/test_block_cache.py. The JAX weights cross over through
``convert.flax_to_state_dict``; the JAX side runs with attention_mode "xla",
as that file does, and the port on the CPU runs the kernels' plain versions.

Tolerance: ``torch_port_util.close``'s defaults (relative L2 1e-5, each
element within 1e-4 of the largest magnitude): both sides compute the same
fp32 function, summed in another order. The int8 sampler is held to
``close(2e-2, 5e-2)``, the limit of tests/test_torch_sample.py's int8
sampler test, for its reason (int8 rounding steps where the two sides' fp32
activations sit an ulp apart across a rounding boundary).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, randomize

from latte_tpu.config import load_config as jax_load_config
from latte_tpu.core.block_cache import cached_sample_loop as jax_cached_sample_loop
from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.models import Latte as JaxLatte
from latte_tpu.models import get_models as jax_get_models
from latte_tpu.quant import merge_amax, quantize_params
from latte_tpu.sample.sample import build_sample_fn
from latte_tpu_torch.config import load_config
from latte_tpu_torch.convert import flax_to_state_dict, load_flax_params
from latte_tpu_torch.core import create_diffusion, ddim_sample_loop, p_sample_loop
from latte_tpu_torch.core.block_cache import cached_sample_loop
from latte_tpu_torch.models import Latte
from latte_tpu_torch.sample import sample
from test_torch_sample import FFS

K = 2  # cached front pairs (of 4)
ARCH = dict(input_size=8, patch_size=2, hidden_size=32, depth=8, num_heads=2, num_frames=2,
            extras=2, num_classes=10)


@pytest.fixture(scope="module")
def models():
    """The JAX model (attention_mode "xla") with random params, and the port's
    model carrying them."""
    jm = JaxLatte(**ARCH, attention_mode="xla")
    x, t = jnp.zeros((1, 2, 4, 8, 8)), jnp.zeros((1,), jnp.int32)
    rngs = {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)}
    params = randomize(jm.init(rngs, x, t, y=jnp.zeros((1,), jnp.int32))["params"], seed=2, std=0.1)
    tm = load_flax_params(Latte(**ARCH), params).eval()
    return jm, {"params": params}, tm


def _z(batch, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, 2, 4, 8, 8)).astype(np.float32)


def test_staging_split_is_exact_and_matches_the_jax_front(models):
    jm, params, tm = models
    x = _z(2, seed=1)
    t, y = np.array([3, 400]), np.array([1, 7])
    tx, tt, ty = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y)
    with torch.no_grad():
        out_ref = tm(tx, tt, y=ty)
        out_full, front = tm(tx, tt, y=ty, return_front=K)
        kept = front.clone()
        out_partial = tm(tx, tt, y=ty, front_state=front, start_pair=K)
    assert torch.equal(out_full, out_ref)
    assert torch.equal(out_partial, out_full)
    assert torch.equal(front, kept)  # no later block wrote into the front
    assert front.shape == (4, 16, 32)  # (B·F, T, D)

    jx, jt, jy = jnp.asarray(x), jnp.asarray(t, jnp.int32), jnp.asarray(y, jnp.int32)
    want_out, want_front = jm.apply(params, jx, jt, y=jy, return_front=K)
    close(front, want_front)
    close(out_full, want_out)


@pytest.mark.parametrize("cfg", [False, True], ids=["cond", "cfg"])
@pytest.mark.parametrize("interval", [1, 2, 3])
def test_cached_ddim_matches_the_jax_loop(models, interval, cfg):
    """DDIM-6 with the block cache against the JAX cached_sample_loop. Under
    CFG (scale 4) the batch is [cond | uncond] with the null class 10."""
    jm, params, tm = models
    z = _z(2, seed=interval)
    y, scale = (np.array([3, 10]), 4.0) if cfg else (np.array([3, 7]), 1.0)
    want = jax_cached_sample_loop(
        jax_create_diffusion("ddim6"), jm, params, jnp.asarray(z), cache_pairs=K,
        cache_interval=interval, y=jnp.asarray(y, jnp.int32), cfg_scale=scale,
    )
    got = cached_sample_loop(
        create_diffusion("ddim6"), tm, torch.from_numpy(z), cache_pairs=K,
        cache_interval=interval, y=torch.from_numpy(y), cfg_scale=scale,
    )
    close(got, want)


@pytest.mark.parametrize("interval", [1, 2])
def test_cached_ddpm_matches_the_jax_loop(models, interval):
    """DDPM-6 with the block cache: the JAX loop draws each step's noise as
    normal(fold_in(rng, t)); the port gets those numbers as noise_schedule."""
    jm, params, tm = models
    z = _z(1, seed=10 + interval)
    y = np.array([6])
    rng = jax.random.PRNGKey(17)
    steps = 6
    noise = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(rng, t), z.shape, jnp.float32)) for t in range(steps)
    ])
    want = jax_cached_sample_loop(
        jax_create_diffusion(str(steps)), jm, params, jnp.asarray(z), cache_pairs=K,
        cache_interval=interval, y=jnp.asarray(y, jnp.int32), sample_method="ddpm", rng=rng,
    )
    got = cached_sample_loop(
        create_diffusion(str(steps)), tm, torch.from_numpy(z), cache_pairs=K, cache_interval=interval,
        y=torch.from_numpy(y), sample_method="ddpm", noise_schedule=torch.from_numpy(noise),
    )
    close(got, want)


@pytest.mark.parametrize("case", ["ddim", "ddpm", "ddim-cfg"])
def test_interval_one_equals_the_standard_loop_to_the_bit(models, case):
    """Interval 1 is every step full: the port's ddim_sample_loop /
    p_sample_loop (DDPM from a generator of the same seed), and under CFG
    the loop over forward_with_cfg."""
    _, _, tm = models
    z = torch.from_numpy(_z(2, seed=5))
    cfg = case == "ddim-cfg"
    y = torch.tensor([4, 10]) if cfg else torch.tensor([4, 8])
    model_fn = functools.partial(tm.forward_with_cfg, cfg_scale=4.0) if cfg else tm
    diffusion = create_diffusion("5")
    loop = p_sample_loop if case == "ddpm" else ddim_sample_loop
    method = "ddpm" if case == "ddpm" else "ddim"
    want = loop(diffusion, model_fn, z, generator=torch.Generator().manual_seed(3), model_kwargs={"y": y})
    got = cached_sample_loop(
        diffusion, tm, z, cache_pairs=K, cache_interval=1, y=y, cfg_scale=4.0 if cfg else 1.0,
        sample_method=method, generator=torch.Generator().manual_seed(3),
    )
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "bad, match",
    [
        (dict(cache_pairs=0), "cache_pairs"),
        (dict(cache_pairs=4), "cache_pairs"),
        (dict(cache_interval=0), "cache_interval"),
        (dict(return_front=1, front_state=True, start_pair=1), "exclusive"),
        (dict(front_state=True), "set together"),
        (dict(start_pair=1), "set together"),
    ],
    ids=["pairs-0", "pairs-n", "interval-0", "exclusive", "front-alone", "start-alone"],
)
def test_validation_errors_match_jax(models, bad, match):
    """The JAX package's ValueErrors, on both sides."""
    jm, params, tm = models
    z, y = np.zeros((1, 2, 4, 8, 8), np.float32), np.zeros((1,), np.int32)
    if "cache_pairs" in bad or "cache_interval" in bad:
        kw = dict(dict(cache_pairs=1, cache_interval=2), **bad)
        with pytest.raises(ValueError, match=match):
            jax_cached_sample_loop(jax_create_diffusion("ddim2"), jm, params, jnp.asarray(z),
                                   y=jnp.asarray(y), **kw)
        with pytest.raises(ValueError, match=match):
            cached_sample_loop(create_diffusion("ddim2"), tm, torch.from_numpy(z),
                               y=torch.from_numpy(y).long(), **kw)
        return
    front = np.zeros((2, 16, 32), np.float32)
    jkw = {k: (jnp.asarray(front) if k == "front_state" else v) for k, v in bad.items()}
    tkw = {k: (torch.from_numpy(front) if k == "front_state" else v) for k, v in bad.items()}
    with pytest.raises(ValueError, match=match):
        jm.apply(params, jnp.asarray(z), jnp.zeros((1,), jnp.int32), y=jnp.asarray(y), **jkw)
    with torch.no_grad(), pytest.raises(ValueError, match=match):
        tm(torch.from_numpy(z), torch.zeros((1,), dtype=torch.long), y=torch.from_numpy(y).long(), **tkw)


# the entry point on a tiny ffs config: 3 pairs, so the default k is (3·2)//3 = 2
TINY6 = [
    "model_overrides={depth: 6, hidden_size: 32, num_heads: 2}",
    "image_size=32", "num_frames=2", "use_fp16=false",
    "sample_method=ddim", "num_sampling_steps=6", "block_cache_interval=2",
]
ENTRY_CASES = {
    "default-k": [],
    "k1": ["block_cache_pairs=1"],
    "cfg": ["extras=2", "num_classes=10", "cfg_scale=4.0", "sample_class=3"],
    "int8-flash-full": ["quantized=static", "attention_mode=flash", "int8_attention=true"],
    "int8-auto-qk": ["quantized=static", "attention_mode=auto", "int8_attention=qk"],
}


def _jax_params(jm, extras):
    x0, t0 = jnp.zeros((1, 2, 4, 4, 4)), jnp.zeros((1,), jnp.int32)
    if extras == 2:
        rngs = {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)}
        params = jm.init(rngs, x0, t0, y=jnp.zeros((1,), jnp.int32))["params"]
    else:
        params = jm.init(jax.random.PRNGKey(0), x0, t0)["params"]
    return randomize(params, seed=3, std=0.1)


@pytest.mark.parametrize("case", list(ENTRY_CASES))
def test_block_cache_sampler_matches_the_jax_sampler(tmp_path, case):
    """``sample.main`` with ``block_cache_interval: 2`` on the CPU, from a
    checkpoint, against the JAX build_sample_fn's block-cache branch on the
    same config, weights and z (the int8 cases after the JAX sampler's
    calibration recipe, as in tests/test_torch_sample.py)."""
    over = TINY6 + ENTRY_CASES[case] + [f"save_video_path={tmp_path}/v.mp4"]
    cfg, jcfg = load_config(FFS, over), jax_load_config(FFS, over)
    extras = int(getattr(cfg, "extras", 1))
    jm = jax_get_models(jcfg)
    params = _jax_params(jm, extras)
    torch.save({"ema": flax_to_state_dict(params, 6, 2, 2)}, tmp_path / "c.pt")
    cfg.ckpt = str(tmp_path / "c.pt")
    got = np.load(sample.main(cfg, device="cpu"))["latents"]

    if case.startswith("int8"):
        zc = jnp.asarray(sample.calibration_latents(cfg, torch.device("cpu")).numpy())
        calib = jm.clone(quantized="calib")
        amax = None
        for tc in sample.CALIBRATION_TIMESTEPS:
            _, var = calib.apply({"params": params}, zc, jnp.full((1,), tc, jnp.int32), mutable=["calib"])
            amax = merge_amax(amax, var["calib"])
        jm, params = jm.clone(quantized="static"), quantize_params(params, act_amax=amax)
    fn, use_cfg = build_sample_fn(jm, {"params": params}, jcfg, jax_create_diffusion("6"))
    z = jnp.asarray(torch.randn((1, 2, 4, 4, 4), generator=torch.Generator().manual_seed(0)).numpy())
    y = None
    if extras == 2:
        y = jnp.array([3], jnp.int32)
        if use_cfg:
            z, y = jnp.concatenate([z, z]), jnp.array([3, 10], jnp.int32)
    want = np.asarray(fn(z, y, jax.random.PRNGKey(1)))[:1]
    assert got.shape == (1, 2, 4, 4, 4) and np.isfinite(got).all()
    if case.startswith("int8"):
        close(got, want, 2e-2, 5e-2)
    else:
        close(got, want)


def test_host_loop_mode_with_a_block_cache_raises(tmp_path):
    """As the JAX sampler: the block cache needs loop_mode: scan. The entry
    point refuses before it builds anything."""
    cfg = load_config(FFS, TINY6 + ["loop_mode=host", f"save_video_path={tmp_path}/v.mp4"])
    with pytest.raises(ValueError, match="loop_mode=scan"):
        sample.main(cfg, device="cpu")
    assert not any(tmp_path.iterdir())
