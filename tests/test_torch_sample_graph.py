"""The sampler as one program (``loop_mode``): the port's
``sample.build_sample_fn`` / ``build_sample_impl`` and the static-buffer
runner of ``core/step_graph.py``, which on the CPU calls the step it would
replay as a CUDA graph on the card, on a tiny Latte (depth 4, hidden 32, 2
heads, 2 frames of 4x4 latents, 6 steps).

- Against the JAX package's ``build_sample_fn`` under ``loop_mode`` scan and
  host, on the same weights (carried over by ``convert.flax_to_state_dict``)
  and the same z: DDIM, DDPM with JAX's per-step noise ``normal(fold_in(rng,
  t))`` injected as ``noise_schedule``, CFG, the block cache at intervals 2
  and 3 (which both packages refuse under host), and static W8A8 with int8
  attention after each package's own calibration. Tolerance: that of
  tests/test_torch_sample.py, ``close``'s defaults (relative L2 1e-5, each
  element within 1e-4 of the largest magnitude) for one fp32 function
  summed in another order, and ``close(2e-2, 5e-2)`` for int8 (rounding
  steps where the two sides' fp32 activations sit an ulp apart across a
  rounding boundary).
- Inside the port, scan against the eager loop to the bit in each case; one
  sampler called with two z (no stale static buffer); a new batch shape
  capturing again; DDPM from a generator against ``run_steps``; a serving
  artifact through the runner against the live sampler; the error that
  names an op a capture cannot take.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, one_cpu_thread, randomize

from latte_tpu.config import load_config as jax_load_config
from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.models import get_models as jax_get_models
from latte_tpu.quant import merge_amax, quantize_params
from latte_tpu.sample.sample import build_sample_fn as jax_build_sample_fn
from latte_tpu_torch.config import load_config
from latte_tpu_torch.convert import flax_to_state_dict
from latte_tpu_torch.core import create_diffusion
from latte_tpu_torch.core.samplers import denoise_step, run_steps
from latte_tpu_torch.core.step_graph import CaptureError, GraphedStep, _NameTheOp
from latte_tpu_torch.sample import sample
from latte_tpu_torch.serve import aot, export_aot
from test_torch_sample import FFS

STEPS = 6
TINY = [
    "model_overrides={depth: 4, hidden_size: 32, num_heads: 2}",
    "image_size=32", "num_frames=2", "use_fp16=false", "sample_method=ddim", f"num_sampling_steps={STEPS}",
    "ckpt=null",
]
CASES = {
    "ddim": [],
    "ddpm": ["sample_method=ddpm"],
    "cfg": ["extras=2", "num_classes=10", "cfg_scale=4.0"],
    "block_cache_2": ["block_cache_interval=2"],
    "block_cache_3": ["block_cache_interval=3"],
    "int8_static": ["quantized=static", "int8_attention=true"],
}
SHAPE = (1, 2, 4, 4, 4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_cpu_thread():
        yield


@functools.cache
def _jax_params(class_conditional: bool):
    jm = jax_get_models(jax_load_config(FFS, TINY + (CASES["cfg"] if class_conditional else [])))
    rngs, kw = {"params": jax.random.PRNGKey(0)}, {}
    if class_conditional:
        rngs["label_dropout"], kw["y"] = jax.random.PRNGKey(1), jnp.zeros((1,), jnp.int32)
    init = jax.jit(lambda: jm.init(rngs, jnp.zeros(SHAPE), jnp.zeros((1,), jnp.int32), **kw))
    return randomize(init()["params"], seed=3, std=0.1)


def _setup(case, tmp_path):
    """Both configs, the JAX model and params, and the port's model built by
    the sampler from a checkpoint of those params."""
    over = TINY + CASES[case]
    cfg, jcfg = load_config(FFS, over), jax_load_config(FFS, over)
    jm, params = jax_get_models(jcfg), _jax_params(case == "cfg")
    torch.save({"ema": flax_to_state_dict(params, 4, 2, 2)}, tmp_path / "c.pt")
    cfg.ckpt = str(tmp_path / "c.pt")
    return cfg, jcfg, jm, params, sample.build_model(cfg, CPU)


def _jax_int8(jm, params, cfg):
    """The JAX sampler's static int8 recipe: amax over the calibration
    forwards on the port's calibration z, then quantize_params."""
    zc = jnp.asarray(sample.calibration_latents(cfg, CPU).numpy())
    calib, amax = jm.clone(quantized="calib"), None
    forward = jax.jit(lambda t: calib.apply({"params": params}, zc, t, mutable=["calib"])[1]["calib"])
    for tc in sample.CALIBRATION_TIMESTEPS:
        amax = merge_amax(amax, forward(jnp.full((1,), tc, jnp.int32)))
    return jm.clone(quantized="static"), quantize_params(params, act_amax=amax)


def _z(batch=1, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((batch,) + SHAPE[1:]).astype(np.float32))


def _eager(model, cfg, z, y=None, **kw):
    """The eager loop over the same construction (``build_sample_impl`` with
    loop "host"), CFG-doubled as ``build_sample_fn`` doubles."""
    impl, use_cfg = sample.build_sample_impl(model, cfg, create_diffusion(str(STEPS)), loop="host")
    x, yy = sample.cfg_batch(use_cfg, model.num_classes, z, y)
    return impl(x, yy, **kw)[: z.shape[0]]


@pytest.mark.parametrize("case", list(CASES))
def test_scan_and_host_against_the_jax_sampler(case, tmp_path):
    cfg, jcfg, jm, params, model = _setup(case, tmp_path)
    if case == "int8_static":
        jm, params = _jax_int8(jm, params, cfg)
    z = _z()
    y = torch.tensor([3]) if case == "cfg" else None
    rng = jax.random.PRNGKey(7)
    noise = None
    if case == "ddpm":  # JAX's per-step noise, injected into the port's loop
        noise = torch.from_numpy(np.stack([
            np.asarray(jax.random.normal(jax.random.fold_in(rng, t), SHAPE, jnp.float32)) for t in range(STEPS)]))
    jz, jy = jnp.asarray(z.numpy()), None
    if y is not None:
        jz, jy = jnp.concatenate([jz, jz]), jnp.array([3, 10], jnp.int32)
    tol = (2e-2, 5e-2) if case == "int8_static" else ()
    got = {}
    for mode in ("scan", "host"):
        cfg.loop_mode = jcfg.loop_mode = mode
        if case.startswith("block_cache") and mode == "host":  # both packages refuse it
            with pytest.raises(ValueError, match="loop_mode=scan"):
                sample.build_sample_fn(model, cfg, create_diffusion(str(STEPS)))
            with pytest.raises(ValueError, match="loop_mode=scan"):
                jax_build_sample_fn(jm, {"params": params}, jcfg, jax_create_diffusion(str(STEPS)))
            continue
        fn = sample.build_sample_fn(model, cfg, create_diffusion(str(STEPS)))
        assert (fn.graphed is not None) == (mode == "scan")
        got[mode] = fn(z, y, noise_schedule=noise)
        jfn, use_cfg = jax_build_sample_fn(jm, {"params": params}, jcfg, jax_create_diffusion(str(STEPS)))
        assert use_cfg == fn.use_cfg == (case == "cfg")
        assert got[mode].shape == SHAPE and torch.isfinite(got[mode]).all()
        close(got[mode], np.asarray(jfn(jz, jy, rng))[:1], *tol)
    cfg.loop_mode = "scan"
    eager = _eager(model, cfg, z, y, noise_schedule=noise)
    for mode, lat in got.items():
        assert torch.equal(lat, eager), (mode, (lat - eager).abs().max())


@pytest.mark.parametrize("case", ["cfg", "block_cache_2"])
def test_one_sampler_for_many_calls(case, tmp_path):
    """One ``build_sample_fn`` called with two z: each equals the eager loop
    on its own z (nothing stale in the static buffers) and the second
    records nothing new; a batch of 2 records the programs again."""
    cfg, _, _, _, model = _setup(case, tmp_path)
    fn = sample.build_sample_fn(model, cfg, create_diffusion(str(STEPS)))
    y = torch.tensor([3]) if case == "cfg" else None
    programs = 2 if case.startswith("block_cache") else 1
    for seed in (0, 1):
        z = _z(seed=seed)
        assert torch.equal(fn(z, y), _eager(model, cfg, z, y))
        assert fn.graphed.captures == programs
    replays = sum(g.replays for g in fn.graphed.graphs.values())
    assert replays == 2 * STEPS - programs
    z2 = _z(batch=2, seed=2)
    y2 = None if y is None else torch.tensor([3, 5])
    assert torch.equal(fn(z2, y2), _eager(model, cfg, z2, y2))
    assert fn.graphed.captures == 2 * programs and fn.graphed.x.shape[0] == (4 if case == "cfg" else 2)


def test_ddpm_from_a_generator_equals_run_steps(tmp_path):
    """The runner copies the loops' own per-step draws: the same generator
    seed gives ``run_steps``' latents to the bit."""
    cfg, _, _, _, model = _setup("ddpm", tmp_path)
    fn = sample.build_sample_fn(model, cfg, create_diffusion(str(STEPS)))
    z = _z()
    got = fn(z, generator=torch.Generator().manual_seed(5))
    diffusion = create_diffusion(str(STEPS))
    with torch.inference_mode():
        want = run_steps(lambda x, t, noise: denoise_step(diffusion, model, "ddpm", x, t, noise), diffusion, z,
                         generator=torch.Generator().manual_seed(5))
    assert torch.equal(got, want)
    assert not torch.equal(got, fn(z, generator=torch.Generator().manual_seed(6)))


def test_artifact_through_the_runner_equals_the_live_sampler(tmp_path):
    """``serve.aot.load_sampler`` replays the exported programs (here the
    block cache's full and partial steps) through the runner: two calls with
    the same placed weights record the programs once, and each equals the
    live graphed sampler to the bit."""
    cfg = load_config(FFS, TINY + CASES["block_cache_2"] + [
        "model_overrides={depth: 4, hidden_size: 32, num_heads: 2, patch_size: 1}", "image_size=16"])
    model = sample.build_model(cfg, CPU)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.copy_(torch.from_numpy(np.random.default_rng(i).standard_normal(p.shape).astype(np.float32) * 0.1))
    call = aot.load_sampler(export_aot.main(cfg, str(tmp_path / "a"), batch=1, device="cpu"))
    assert isinstance(call.graphed, GraphedStep) and call.graphed.cached
    placed = call.place(model.state_dict())
    live = sample.build_sample_fn(model, cfg, create_diffusion(str(STEPS)))
    shape = (1, 2, 4, 2, 2)
    for seed in (0, 1):
        z = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
        assert torch.equal(call(placed, z), live(z))
    assert call.graphed.captures == 2 and sorted(call.graphed.graphs) == ["full", "partial"]


def test_an_op_that_cannot_be_captured_is_named():
    """A capture runs under ``_NameTheOp``: an op's failure comes back as
    ``CaptureError`` naming the op (here a shape error of aten.mm)."""
    with pytest.raises(CaptureError, match="aten.mm"), _NameTheOp():
        torch.ones(2, 3) @ torch.ones(2, 3)
