"""Port parity for the training path: ``training_losses``, the gradients of a
tiny Latte, the learning-rate schedules and the loss-aware timestep sampler,
each against the JAX package on the same inputs (the train step itself is in
test_torch_train_step.py).

The tiny model is depth 4, hidden 144, 2 heads (head_dim 72, as at full
width), 4 frames of 8x8 latents; the JAX side is ``Latte(attention_mode=
"flash", fused_adaln=True)``, whose Pallas kernels and flash backward run in
interpret mode on the CPU. Weights, inputs, t and noise come from numpy
seeds (the noise of the JAX train step from its own rng splits) and cross
over through ``latte_tpu_torch.convert``; gradient trees and train states
map by the same linear map. All fp32.

Tolerances (relative L2 of the difference over the JAX side's norm, and an
elementwise cap relative to the JAX side's largest magnitude):
- losses: 1e-5 (the same fp32 arithmetic, summed in another order);
- model gradients: 1e-4 and 1e-3, as for the
  model's forward in test_torch_model.py: a backward chains ~60 layers whose
  fp32 results each move by a few ulp with the summation order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, randomize

from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.core.timestep_samplers import LossSecondMomentResampler as JaxResampler
from latte_tpu.models import Latte as JaxLatte
from latte_tpu.train.state import make_lr_schedule as jax_make_lr_schedule
from latte_tpu_torch.convert import flax_to_state_dict, load_flax_params
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.core.timestep_samplers import LossSecondMomentResampler
from latte_tpu_torch.models import Latte
from latte_tpu_torch.train.state import make_lr_schedule

TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=144, depth=4, num_heads=2, num_frames=4)
LOSS_REL = 1e-5
REL, ELEM = 1e-4, 1e-3


def _batch(B=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 4, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    return x, noise


def _jax_model_and_params(seed=0):
    jm = JaxLatte(**TINY, attention_mode="flash", fused_adaln=True)
    x, _ = _batch()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((2,), jnp.int32))["params"]
    return jm, randomize(params, seed=seed, std=0.1)


def _port_model(params, **kw):
    return load_flax_params(Latte(**TINY, **kw), params)


def _state_dict(tree):
    return flax_to_state_dict(tree, TINY["depth"], TINY["num_heads"], TINY["patch_size"])


def test_training_losses_match_jax():
    """mse, vb and the hybrid loss for a fixed model output, t = 0 (the
    decoder NLL) included, and the loss's gradient with respect to that
    output (the VB term sees a detached mean) at t > 0. At t = 0 the
    gradient of the decoder NLL divides by differences of two saturated
    tanh-based CDFs (bins of 1/255 against a std of 0.01), which fp32
    resolves to a few percent on either side, so only its value is held."""
    rng = np.random.default_rng(5)
    x0 = np.clip(rng.standard_normal((4, 3, 4, 6, 6)), -1, 1).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    out = rng.standard_normal((4, 3, 8, 6, 6)).astype(np.float32)
    t = np.array([0, 1, 500, 999])
    jd, td = jax_create_diffusion(""), create_diffusion("")

    def jax_terms(o):
        return jd.training_losses(lambda x, tt: o, jnp.asarray(x0), jnp.asarray(t, jnp.int32),
                                  noise=jnp.asarray(noise))

    want = jax_terms(jnp.asarray(out))
    t_out = torch.from_numpy(out).requires_grad_()
    got = td.training_losses(lambda x, tt: t_out, torch.from_numpy(x0), torch.from_numpy(t),
                             noise=torch.from_numpy(noise))
    assert set(got) == set(want) == {"mse", "vb", "loss"}
    for k in want:
        close(got[k], want[k], LOSS_REL, LOSS_REL)
    (g,) = torch.autograd.grad(got["loss"].sum(), t_out)
    want_g = np.asarray(jax.grad(lambda o: jnp.sum(jax_terms(o)["loss"]))(jnp.asarray(out)))
    close(g[1:], want_g[1:], LOSS_REL, LOSS_REL)
    close(g[0, :, :4], want_g[0, :, :4], LOSS_REL, LOSS_REL)  # the mse part at t = 0


GRAD_T = np.array([1, 500])


@functools.cache
def _jax_loss_and_grads():
    """The JAX model's loss and gradient tree, computed once for both cases."""
    jm, params = _jax_model_and_params()
    x0, noise = _batch()
    jd = jax_create_diffusion("")

    def loss_fn(p):
        model_fn = lambda x, tt: jm.apply({"params": p}, x, tt)  # noqa: E731
        terms = jd.training_losses(model_fn, jnp.asarray(x0), jnp.asarray(GRAD_T, jnp.int32),
                                   noise=jnp.asarray(noise))
        return jnp.mean(terms["loss"])

    return params, *jax.value_and_grad(loss_fn)(params)


@pytest.mark.parametrize("checkpointing", [False, True], ids=["plain", "gradient_checkpointing"])
def test_tiny_latte_gradients_match_jax(checkpointing):
    """Loss and every gradient leaf of the hybrid loss through the model:
    the forward kernels, the adaLN backward and the flash backward. (t > 0:
    see test_training_losses_match_jax for the decoder NLL's gradient.)"""
    params, want_loss, want_grads = _jax_loss_and_grads()
    x0, noise = _batch()
    t = GRAD_T
    model = _port_model(params, gradient_checkpointing=checkpointing)
    terms = create_diffusion("").training_losses(
        model, torch.from_numpy(x0), torch.from_numpy(t), noise=torch.from_numpy(noise)
    )
    loss = terms["loss"].mean()
    loss.backward()
    close(loss, want_loss, LOSS_REL, LOSS_REL)
    want = _state_dict(want_grads)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        close(got[name], want[name].numpy(), REL, ELEM)


@pytest.mark.parametrize(
    "kw",
    [
        dict(lr=1e-4),
        dict(lr=1e-4, warmup_steps=10),
        dict(lr=3e-4, schedule="cosine", decay_steps=100, lr_min=1e-5),
        dict(lr=3e-4, warmup_steps=10, schedule="cosine", decay_steps=100),
    ],
    ids=["constant", "warmup", "cosine", "warmup-cosine"],
)
def test_lr_schedules_match_optax(kw):
    """optax evaluates its schedules in fp32: agreement to 1e-6 of lr."""
    want, got = jax_make_lr_schedule(**kw), make_lr_schedule(**kw)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 110, 150):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=0, atol=1e-6 * kw["lr"])
    assert got(0) == 0.0 if kw.get("warmup_steps") else got(0) == kw["lr"]


def test_loss_second_moment_resampler_matches_jax():
    """The importance weights after the same (t, loss) history."""
    d = create_diffusion("", diffusion_steps=20)
    jax_s, port_s = JaxResampler(jax_create_diffusion("", diffusion_steps=20)), LossSecondMomentResampler(d)
    rng = np.random.default_rng(0)
    for _ in range(30):
        ts, losses = rng.integers(0, 20, 16), rng.random(16)
        jax_s.update_with_all_losses(ts, losses)
        port_s.update_with_local_losses(torch.from_numpy(ts), torch.from_numpy(losses))
    np.testing.assert_allclose(port_s.weights(), jax_s.weights(), rtol=1e-12)
    assert port_s._warmed_up() and not np.allclose(port_s.weights(), port_s.weights().mean())
    t, w = port_s.sample(torch.Generator().manual_seed(0), 64)
    p = port_s.weights() / port_s.weights().sum()
    np.testing.assert_allclose(w.numpy(), 1.0 / (p[t.numpy()] * 20), rtol=1e-6)
