"""Port parity for the diffusion engine and the sampling loops:
``latte_tpu_torch.core`` against ``latte_tpu.core`` on the same schedules,
model weights (carried across), starting noise and per-step noise, all fp32.

Tolerances: schedule tables are the same fp64 numpy code (exact); single
engine steps 1e-5 relative (L2, fp32 elementwise math); the loops over the
tiny model 1e-4 relative (L2; no element off by more than 1e-3 of the
largest magnitude), since each step feeds a forward's few-ulp differences
into the next.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, randomize

from latte_tpu.core import diffusion as jdiff
from latte_tpu.core import diffusion_utils as jdu
from latte_tpu.core import samplers as jsamp
from latte_tpu.core import schedules as jsched
from latte_tpu.models import Latte as JaxLatte
from latte_tpu_torch.convert import load_flax_params
from latte_tpu_torch.core import cfg_model_fn, create_diffusion, ddim_sample_loop, p_sample_loop
from latte_tpu_torch.core import diffusion_utils as tdu
from latte_tpu_torch.core import schedules as tsched
from latte_tpu_torch.models import Latte

TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=4, num_heads=4, num_frames=4)
SHAPE = (1, 4, 4, 8, 8)


@pytest.mark.parametrize("name", ["linear", "squaredcos_cap_v2", "quad", "const"])
def test_schedules_are_the_reference_tables(name):
    np.testing.assert_array_equal(
        tsched.get_named_beta_schedule(name, 100), jsched.get_named_beta_schedule(name, 100)
    )
    for spec in ("ddim10", "25", "10,5"):
        assert tsched.space_timesteps(100, spec) == jsched.space_timesteps(100, spec)


@pytest.mark.parametrize("respacing", ["50", "ddim50", "250"])
def test_respaced_engine_tables(respacing):
    jd, td = jdiff.create_diffusion(respacing), create_diffusion(respacing)
    for name in (
        "betas", "alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
        "posterior_mean_coef1", "posterior_mean_coef2", "timestep_map",
    ):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))


def test_engine_steps_and_probability_helpers():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    out = rng.standard_normal((1, 4, 8, 8, 8)).astype(np.float32)
    jd, td = jdiff.create_diffusion("50"), create_diffusion("50")
    fn_j, fn_t = (lambda x, t, **kw: jnp.asarray(out)), (lambda x, t, **kw: torch.from_numpy(out))
    for step in (49, 7, 0):
        tj, tt = jnp.full((1,), step, jnp.int32), torch.full((1,), step)
        close(td.q_sample(torch.from_numpy(x), tt, torch.from_numpy(noise)),
              jd.q_sample(jnp.asarray(x), tj, jnp.asarray(noise)))
        pm_t = td.p_mean_variance(fn_t, torch.from_numpy(x), tt)
        pm_j = jd.p_mean_variance(fn_j, jnp.asarray(x), tj)
        for key in ("mean", "log_variance", "pred_xstart"):
            close(pm_t[key], pm_j[key])
        for kind in ("p_sample", "ddim_sample"):
            close(
                getattr(td, kind)(fn_t, torch.from_numpy(x), tt, torch.from_numpy(noise))["sample"],
                getattr(jd, kind)(fn_j, jnp.asarray(x), tj, jnp.asarray(noise))["sample"],
            )
        assert td.map_t(tt).item() == int(jd.map_t(tj)[0])
    a, b = x * 0.5, out[:, :, :4] * 0.5
    close(tdu.normal_kl(*map(torch.from_numpy, (a, b, b, a))), jdu.normal_kl(a, b, b, a))
    close(
        tdu.discretized_gaussian_log_likelihood(
            torch.from_numpy(np.tanh(x)), means=torch.from_numpy(a), log_scales=torch.from_numpy(b)
        ),
        jdu.discretized_gaussian_log_likelihood(np.tanh(x), means=a, log_scales=b),
    )


@pytest.fixture(scope="module")
def tiny_models():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    jm = JaxLatte(**TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((1,), jnp.int32))["params"]
    params = randomize(params, seed=2, std=0.1)
    tm = load_flax_params(Latte(**TINY), params)
    jfn = lambda x, t, **kw: jm.apply({"params": params}, x, t, **kw)  # noqa: E731
    return jfn, tm, x


def test_ddim10_matches_jax(tiny_models):
    jfn, tm, x_T = tiny_models
    jd, td = jdiff.create_diffusion("ddim10"), create_diffusion("ddim10")
    want = jsamp.ddim_sample_loop(jd, jfn, jnp.asarray(x_T))
    got = ddim_sample_loop(td, tm, torch.from_numpy(x_T))
    close(got, want, 1e-4, 1e-3)


@pytest.mark.parametrize("loop", ["ddpm", "ddim-eta"])
def test_stochastic_loops_match_jax_with_injected_noise(tiny_models, loop):
    jfn, tm, x_T = tiny_models
    jd, td = jdiff.create_diffusion("6"), create_diffusion("6")
    sched = np.random.default_rng(3).standard_normal((6,) + SHAPE).astype(np.float32)
    if loop == "ddpm":
        want = jsamp.p_sample_loop(jd, jfn, jnp.asarray(x_T), noise_schedule=jnp.asarray(sched))
        got = p_sample_loop(td, tm, torch.from_numpy(x_T), noise_schedule=torch.from_numpy(sched))
    else:
        want = jsamp.ddim_sample_loop(
            jd, jfn, jnp.asarray(x_T), eta=0.5, noise_schedule=jnp.asarray(sched)
        )
        got = ddim_sample_loop(
            td, tm, torch.from_numpy(x_T), eta=0.5, noise_schedule=torch.from_numpy(sched)
        )
    close(got, want, 1e-4, 1e-3)


def test_cfg_model_fn_matches_jax():
    rng = np.random.default_rng(4)
    out = rng.standard_normal((2, 3, 8, 4, 4)).astype(np.float32)
    x = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    # a model whose output depends on its input, so the halving shows
    fj = lambda x, t: jnp.asarray(out) * jnp.concatenate([x, x], axis=2)  # noqa: E731
    ft = lambda x, t: torch.from_numpy(out) * torch.cat([x, x], dim=2)  # noqa: E731
    got = cfg_model_fn(ft, 3.0)(torch.from_numpy(x), None)
    want = jsamp.cfg_model_fn(fj, 3.0)(jnp.asarray(x), None)
    close(got, want)
