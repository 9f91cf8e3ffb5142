"""Port parity for the second half of the diffusion engine: the loss types,
the forward process's moments, the bits-per-dim loop, classifier guidance,
DDIM inversion and the loops' trajectories (``latte_tpu_torch.core``
against ``latte_tpu.core``), all fp32 on the CPU.

The model is tests/test_torch_diffusion.py's tiny Latte (params from a
numpy seed, carried across), or where a step's arithmetic alone is held a
fixed model output. Per-step noise is JAX's (``fold_in(rng, t)`` draws for
the bits-per-dim loop), injected into the port. The classifier gradient
``cond_fn`` is analytic, -s·(x - target), scaled by the model timestep it
is given so that the remap shows.

Tolerances: 1e-5 relative L2 with no element off by more than 1e-4 of the
largest magnitude (``close``'s defaults: the same fp32 arithmetic summed in
another order), for every step, loop and loss, and for the KL branch's
gradient in the model's output at t > 0. At t = 0 that gradient is the
decoder NLL's, log(cdf(x + 1/255) - cdf(x - 1/255)) of two tanh
approximations a bin apart: their difference cancels most of fp32's digits
(torch's and XLA's tanh differ by an ulp), so that row is held within 1e-3
(it lands ~1.1e-4 apart, where the KL rows land ~1e-7 apart; the hybrid
loss's gradient test, tests/test_torch_train.py, leaves the row out).
torch and BLAS run on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, one_cpu_thread, randomize

from latte_tpu.core import diffusion as jdiff
from latte_tpu.core import samplers as jsamp
from latte_tpu.models import Latte as JaxLatte
from latte_tpu_torch.convert import load_flax_params
from latte_tpu_torch.core import (
    GaussianDiffusion,
    LossType,
    create_diffusion,
    ddim_reverse_loop,
    ddim_sample_loop,
    p_sample_loop,
)
from latte_tpu_torch.models import Latte

TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=4, num_heads=4, num_frames=4)
SHAPE = (1, 4, 4, 8, 8)
BATCH_T = (0, 7, 49)  # the decoder NLL's step, an early and the last step of a 50-step engine


@pytest.fixture(autouse=True)
def _one_thread():
    with one_cpu_thread():
        yield


@pytest.fixture(scope="module")
def tiny_models():
    """The JAX tiny Latte's apply, the port's model carrying its params, and
    an x of SHAPE."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    jm = JaxLatte(**TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((1,), jnp.int32))
    params = randomize(shapes["params"], seed=2, std=0.1)
    tm = load_flax_params(Latte(**TINY), params)
    jfn = jax.jit(lambda x, t: jm.apply({"params": params}, x, t))
    return (lambda x, t, **kw: jfn(x, t)), tm, x


def _target(shape, seed=11):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cond_fns(target, scale=0.3):
    """The analytic classifier gradient in JAX and in torch: -s·(x - target),
    times the model timestep / 1000."""

    def jfn(x, t):
        return -scale * (x - target) * (t.astype(jnp.float32) / 1000.0).reshape(-1, 1, 1, 1, 1)

    def tfn(x, t):
        return -scale * (x - torch.from_numpy(target)) * (t.float() / 1000.0).reshape(-1, 1, 1, 1, 1)

    return jfn, tfn


def _fixed_output(shape, seed=4):
    out = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return out, (lambda x, t, **kw: jnp.asarray(out)), (lambda x, t, **kw: torch.from_numpy(out))


@pytest.mark.parametrize("use_kl, rescale", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["mse", "kl", "rescaled_mse", "kl_over_rescale"])
def test_create_diffusion_loss_type(use_kl, rescale):
    got = create_diffusion("", use_kl=use_kl, rescale_learned_sigmas=rescale).loss_type
    want = jdiff.create_diffusion("", use_kl=use_kl, rescale_learned_sigmas=rescale).loss_type
    assert got.name == want.name
    assert got.is_vb() == want.is_vb()


def test_new_tables_and_q_mean_variance():
    """alphas_cumprod_next and log_one_minus_alphas_cumprod are the JAX
    engine's fp64 tables, and tables() carries them; q_mean_variance and
    _prior_bpd agree."""
    jd, td = jdiff.create_diffusion("50"), create_diffusion("50")
    for name in ("alphas_cumprod_next", "log_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
        assert torch.equal(td.tables()[name], torch.as_tensor(getattr(jd, name), dtype=torch.float32))
    x = _target((3,) + SHAPE[1:], seed=5)
    t = np.array(BATCH_T)
    got = td.q_mean_variance(torch.from_numpy(x), torch.from_numpy(t))
    want = jd.q_mean_variance(jnp.asarray(x), jnp.asarray(t, jnp.int32))
    for g, w in zip(got, want):
        close(g, np.broadcast_to(np.asarray(w), g.shape))
    close(td._prior_bpd(torch.from_numpy(x)), jd._prior_bpd(jnp.asarray(x)))


@pytest.mark.parametrize("loss_type", list(LossType), ids=lambda lt: lt.name)
def test_training_losses_of_every_loss_type(loss_type):
    """Every term of training_losses on the same noise; the KL types'
    gradient in the model's output (its mean half too: not detached there)
    against jax.grad."""
    x0, noise = _target((3,) + SHAPE[1:], seed=5), _target((3,) + SHAPE[1:], seed=6)
    t = np.array(BATCH_T)
    out, _, _ = _fixed_output((3, 4, 8, 8, 8))
    jd = jdiff.create_diffusion("50")
    jd.loss_type = jdiff.LossType[loss_type.name]
    td = create_diffusion("50")
    td.loss_type = loss_type

    def jax_terms(o):
        return jd.training_losses(lambda x, tt: o, jnp.asarray(x0), jnp.asarray(t, jnp.int32),
                                  noise=jnp.asarray(noise))

    want = jax_terms(jnp.asarray(out))
    t_out = torch.from_numpy(out).requires_grad_()
    got = td.training_losses(lambda x, tt: t_out * 1.0, torch.from_numpy(x0), torch.from_numpy(t),
                             noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    if loss_type.is_vb():
        (g,) = torch.autograd.grad(got["loss"].sum(), t_out)
        want_g = np.asarray(jax.grad(lambda o: jnp.sum(jax_terms(o)["loss"]))(jnp.asarray(out)))
        assert np.abs(want_g[:, :, :4]).max() > 0  # the mean half learns from the KL
        close(g[1:], want_g[1:])
        close(g[:1], want_g[:1], 1e-3, 1e-3)


def test_training_losses_by_position_in_jax_order():
    """Both engines called by position, ``(model_fn, x_start, t,
    model_kwargs, noise)``: the labels reach a class-conditional model_fn
    and the noise is the one given, in both."""
    x0, noise = _target((3,) + SHAPE[1:], seed=5), _target((3,) + SHAPE[1:], seed=6)
    t, y = np.array(BATCH_T), np.array([1, 4, 9])
    out = _fixed_output((3, 4, 8, 8, 8))[0]

    def jfn(x, tt, y):
        return jnp.asarray(out) * (1.0 + y.astype(jnp.float32) / 10.0).reshape(-1, 1, 1, 1, 1)

    def tfn(x, tt, y):
        return torch.from_numpy(out) * (1.0 + y.float() / 10.0).reshape(-1, 1, 1, 1, 1)

    want = jdiff.create_diffusion("50").training_losses(
        jfn, jnp.asarray(x0), jnp.asarray(t, jnp.int32), {"y": jnp.asarray(y, jnp.int32)}, jnp.asarray(noise))
    got = create_diffusion("50").training_losses(
        tfn, torch.from_numpy(x0), torch.from_numpy(t), {"y": torch.from_numpy(y)}, torch.from_numpy(noise))
    assert set(got) == set(want) == {"mse", "vb", "loss"}
    for k in want:
        close(got[k], want[k])


def test_training_losses_draw_noise_from_the_generator():
    td = create_diffusion("50")
    x0 = torch.from_numpy(_target((2,) + SHAPE[1:]))
    t = torch.tensor([3, 40])
    _, _, fn = _fixed_output((2, 4, 8, 8, 8))
    got = td.training_losses(fn, x0, t, generator=torch.Generator().manual_seed(9))
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(9))
    want = td.training_losses(fn, x0, t, noise=noise)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="noise"):
        td.training_losses(fn, x0, t)


def test_calc_bpd_loop_matches_jax(tiny_models):
    """Every output of the bits-per-dim loop on a 5-step engine, JAX's
    per-step noise injected; the columns in JAX's scan order (t = T-1 first)."""
    jfn, tm, x = tiny_models
    jd, td = jdiff.create_diffusion("5"), create_diffusion("5")
    rng = jax.random.PRNGKey(3)
    want = jd.calc_bpd_loop(jfn, jnp.asarray(x), rng)
    sched = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, t), SHAPE)) for t in range(5)])
    with torch.no_grad():
        got = td.calc_bpd_loop(tm, torch.from_numpy(x), noise_schedule=torch.from_numpy(sched))
    assert set(got) == set(want)
    assert got["vb"].shape == got["mse"].shape == got["xstart_mse"].shape == (1, 5)
    for k in want:
        close(got[k], want[k])
    with pytest.raises(ValueError, match="noise_schedule"):
        td.calc_bpd_loop(tm, torch.from_numpy(x))


@pytest.mark.parametrize("kind", ["p_sample", "ddim_sample"])
def test_guided_step_matches_jax(kind):
    """One guided step at three timesteps of a respaced engine: DDPM shifts
    the mean, DDIM conditions the score."""
    x, noise = _target((3,) + SHAPE[1:], seed=5), _target((3,) + SHAPE[1:], seed=6)
    t = np.array(BATCH_T)
    _, fj, ft = _fixed_output((3, 4, 8, 8, 8))
    cj, ct = _cond_fns(_target((3,) + SHAPE[1:], seed=8))
    jd, td = jdiff.create_diffusion("50"), create_diffusion("50")
    want = getattr(jd, kind)(fj, jnp.asarray(x), jnp.asarray(t, jnp.int32), jnp.asarray(noise), cond_fn=cj)
    got = getattr(td, kind)(ft, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise), cond_fn=ct)
    unguided = getattr(td, kind)(ft, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise))
    assert not torch.equal(got["sample"], unguided["sample"])
    for k in ("sample", "pred_xstart"):
        close(got[k], want[k])


@pytest.mark.parametrize("loop", ["ddpm", "ddim"])
def test_guided_loops_with_trajectory_match_jax(tiny_models, loop):
    """Both loops on the tiny model with a cond_fn, JAX's per-step noise
    injected, collect_trajectory: the final x and every step's, (T, ...)."""
    jfn, tm, x_T = tiny_models
    jd, td = jdiff.create_diffusion("6"), create_diffusion("6")
    sched = np.random.default_rng(3).standard_normal((6,) + SHAPE).astype(np.float32)
    cj, ct = _cond_fns(_target(SHAPE, seed=8))
    jloop, tloop = (jsamp.p_sample_loop, p_sample_loop) if loop == "ddpm" else (
        jsamp.ddim_sample_loop, ddim_sample_loop)
    want, want_traj = jloop(jd, jfn, jnp.asarray(x_T), cond_fn=cj, noise_schedule=jnp.asarray(sched),
                            collect_trajectory=True)
    got, traj = tloop(td, tm, torch.from_numpy(x_T), cond_fn=ct, noise_schedule=torch.from_numpy(sched),
                      collect_trajectory=True)
    assert traj.shape == (6,) + SHAPE
    assert torch.equal(traj[-1], got)
    close(got, want)
    close(traj, want_traj)


def test_ddim_reverse_step_and_loop_match_jax(tiny_models):
    """The reverse ODE's step at three timesteps (fixed model output) and
    the whole encoding loop x_0 -> x_T on the tiny model."""
    jfn, tm, x0 = tiny_models
    jd, td = jdiff.create_diffusion("50"), create_diffusion("50")
    x = _target((3,) + SHAPE[1:], seed=5)
    t = np.array(BATCH_T)
    _, fj, ft = _fixed_output((3, 4, 8, 8, 8))
    want = jd.ddim_reverse_sample(fj, jnp.asarray(x), jnp.asarray(t, jnp.int32))
    got = td.ddim_reverse_sample(ft, torch.from_numpy(x), torch.from_numpy(t))
    for k in ("sample", "pred_xstart"):
        close(got[k], want[k])
    with pytest.raises(AssertionError):
        td.ddim_reverse_sample(ft, torch.from_numpy(x), torch.from_numpy(t), eta=0.5)
    jd, td = jdiff.create_diffusion("ddim6"), create_diffusion("ddim6")
    want = jsamp.ddim_reverse_loop(jd, jfn, jnp.asarray(x0))
    got = ddim_reverse_loop(td, tm, torch.from_numpy(x0))
    close(got, want)


def test_engine_keeps_the_loss_type():
    betas = create_diffusion("").betas
    assert GaussianDiffusion(betas=betas).loss_type == LossType.MSE
    assert GaussianDiffusion(betas=betas, loss_type=LossType.KL).loss_type.is_vb()
