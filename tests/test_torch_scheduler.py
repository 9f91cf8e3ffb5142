"""The port's ten inference schedulers (latte_tpu_torch/core/scheduler.py)
against the JAX schedulers (latte_tpu/core/scheduler.py) on the CPU.

Each runs a few steps of the pipeline's loop (``scale_model_input``,
``model_timestep``, ``step``, the interleaved correctors repeating the
index) on one analytic eps function of the model input and the (possibly
fractional) timestep, from the same x_T; the stochastic steps get the JAX
run's draws (``normal(fold_in(rng, call))``) as their ``noise``. Everything
is fp32 on both sides, with the scalar coefficients in fp32: the final
latents within relative L2 1e-5 (``close``), the conditioning timesteps
equal within 1e-4 of a step (the correctors' fractional ones go through
fp32 exp and log).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close

from latte_tpu.core.scheduler import get_scheduler as jax_get_scheduler
from latte_tpu_torch.core.scheduler import SCHEDULERS, get_scheduler

SHAPE = (1, 4, 2, 4, 4)
CASES = [(name, {}) for name in SCHEDULERS] + [
    ("DDIM", dict(eta=0.5)),
    ("DDPM", dict(variance_type="fixed_large", clip_sample=False)),
    ("PNDM", dict(skip_prk_steps=True)),
    ("DPMSolverMultistep", dict(prediction_type="v_prediction")),
    ("EulerDiscrete", dict(beta_schedule="scaled_linear", beta_end=0.012, beta_start=0.00085)),
]


def eps_jax(x, t):
    return 0.6 * x + 0.2 * jnp.sin(jnp.asarray(t, jnp.float32) / 250.0)


def eps_torch(x, t):
    return 0.6 * x + 0.2 * torch.sin(torch.tensor(t, dtype=torch.float32) / 250.0)


def run_jax(name, kw, steps, x0, seed=0):
    s = jax_get_scheduler(name, **kw)
    ts = jnp.asarray(s.timesteps(steps), jnp.int32)
    n = int(ts.shape[0])
    state = s.init_state(steps, x0.shape)
    rng = jax.random.PRNGKey(seed)
    x = jnp.asarray(x0) * s.init_noise_sigma_for(steps)
    noises, times = [], []
    i = calls = 0
    while i < n and calls < 3 * n:
        idx = jnp.int32(i)
        t = s.model_timestep(idx, ts, state)
        times.append(float(t))
        key = jax.random.fold_in(rng, calls)
        noises.append(np.array(jax.random.normal(key, x.shape, x.dtype)))
        x, state = s.step(eps_jax(s.scale_model_input(x, idx, state), t), idx, ts, x, state, rng=key)
        calls += 1
        if s.interleaved and bool(state["in_correction"]):
            continue
        i += 1
    return np.asarray(x), noises, times


def run_torch(name, kw, steps, x0, noises):
    s = get_scheduler(name, **kw)
    ts = s.timesteps(steps)
    n = len(ts)
    state = s.init_state(steps)
    x = torch.from_numpy(x0) * s.init_noise_sigma_for(steps)
    times = []
    i = calls = 0
    while i < n and calls < 3 * n:
        t = s.model_timestep(i, ts, state)
        times.append(t)
        noise = torch.from_numpy(noises[calls]) if s.needs_noise else None
        x, state = s.step(eps_torch(s.scale_model_input(x, i, state), t), i, ts, x, state, noise=noise)
        calls += 1
        if s.interleaved and state["in_correction"]:
            continue
        i += 1
    return x, times


@pytest.mark.parametrize("name, kw", CASES, ids=[n + "".join(f"-{k}" for k in kw) for n, kw in CASES])
@pytest.mark.parametrize("steps", [6])
def test_scheduler_matches_jax(name, kw, steps):
    x0 = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    want, noises, want_t = run_jax(name, kw, steps, x0)
    got, got_t = run_torch(name, kw, steps, x0, noises)
    assert len(got_t) == len(want_t)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-4)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    close(got, want)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_tables_match_jax(name):
    """timesteps, init_noise_sigma and the stochastic flag per scheduler."""
    s, j = get_scheduler(name), jax_get_scheduler(name)
    for n in (4, 10, 50):
        assert np.array_equal(s.timesteps(n), np.asarray(j.timesteps(n)))
        assert s.init_noise_sigma_for(n) == j.init_noise_sigma_for(n)
    stochastic = {"DDPM", "EulerAncestralDiscrete", "KDPM2AncestralDiscrete"}
    assert s.needs_noise == (name in stochastic)


def test_get_scheduler_refusals():
    assert isinstance(get_scheduler("DDIMScheduler"), SCHEDULERS["DDIM"])
    assert get_scheduler("DDIM", eta=0.5).needs_noise
    with pytest.raises(ValueError, match="unknown scheduler"):
        get_scheduler("LMSDiscrete")
    with pytest.raises(ValueError, match="does not accept"):
        get_scheduler("DDIM", solver_order=2)
    with pytest.raises(ValueError, match=">= 4"):
        get_scheduler("PNDM").timesteps(3)
