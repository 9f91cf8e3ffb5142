"""LatteT2V's gradients in the port (latte_tpu_torch/models/t2v.py), plain
and under gradient checkpointing ("full" and "dots", latte_tpu_torch/models/
remat.py), against the JAX LatteT2V's ``jax.value_and_grad`` on the CPU, at
the tiny widths of tests/test_torch_t2v.py. The loss is the diffusion
engine's hybrid training loss (learned sigma: mse + vb) on the same x_0, t
and noise, the model called on (B, C, F, H, W) as the T2V models take it.

Tolerances: the loss within 1e-5 relative; each gradient within
``rtol=1e-4, atol=1e-5`` of JAX's, JAX's own bound for its remat gradient
against its plain one (tests/test_t2v.py); the port's remat gradients
against its plain gradients to the bit (the same functions recomputed,
the same gradient sums), the virtual pipeline's within ``rtol=1e-5,
atol=1e-9`` (its microbatches sum the batch's gradients in another order;
a parameter whose gradient is zero in exact arithmetic, such as the key
bias, comes out at ~1e-11 on both sides). torch and BLAS run on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_t2v import ARCH, L, inputs
from torch_port_util import one_cpu_thread, randomize

from latte_tpu.core import diffusion as jdiff
from latte_tpu.models.t2v import LatteT2V as JaxLatteT2V
from latte_tpu_torch.convert import flax_t2v_to_state_dict
from latte_tpu_torch.core import create_diffusion
from latte_tpu_torch.dist.pipeline import pipelined_t2v_forward
from latte_tpu_torch.models import remat
from latte_tpu_torch.models.t2v import LatteT2V

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
T = np.array([0, 731])  # the decoder NLL's step and a KL step of the VB term


def _to_video(x):
    """(B, F, C, H, W) as the engine holds latents <-> (B, C, F, H, W)."""
    return x.transpose(1, 2) if isinstance(x, torch.Tensor) else jnp.transpose(x, (0, 2, 1, 3, 4))


def _batch():
    x, _, ctx, mask = inputs()
    rng = np.random.default_rng(7)
    x0 = np.transpose(x, (0, 2, 1, 3, 4)).copy()  # (B, F, C, H, W)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    return x0, noise, ctx, mask


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX model's params (tests/test_torch_t2v.py's ``make``: every leaf
    drawn from a numpy seed, here over the init's shapes alone) and its loss
    and gradient (as the port's state dict) on the batch."""
    jm = JaxLatteT2V(**ARCH, attention_mode="xla")
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, 4, 16, 16)),
                            jnp.zeros((1,)), jnp.zeros((1, L, 64)), None)
    params = randomize(shapes["params"], seed=0, std=0.1)
    x0, noise, ctx, mask = _batch()
    jd = jdiff.create_diffusion("")

    def loss_fn(p):
        def fn(x, t):
            out = jm.apply({"params": p}, _to_video(x), t.astype(jnp.float32), jnp.asarray(ctx), jnp.asarray(mask))
            return _to_video(out)

        return jd.training_losses(fn, jnp.asarray(x0), jnp.asarray(T, jnp.int32), noise=jnp.asarray(noise))[
            "loss"].mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = {k: v.numpy() for k, v in flax_t2v_to_state_dict(grads).items()}
    return params, float(loss), want


def _port_loss(model, forward=None):
    x0, noise, ctx, mask = map(torch.from_numpy, _batch())
    forward = forward or model

    def fn(x, t):
        return _to_video(forward(_to_video(x), t.float(), ctx, mask))

    return create_diffusion("").training_losses(fn, x0, torch.from_numpy(T), noise=noise)["loss"].mean()


def _grads(model, params, forward=None):
    model.load_state_dict(flax_t2v_to_state_dict(params), strict=True)
    with one_cpu_thread():
        loss = _port_loss(model, forward)
        loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}


def _check_against_jax(loss, grads, jax_reference):
    _, want_loss, want = jax_reference
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.fixture(scope="module")
def plain_grads(jax_reference):
    return _grads(LatteT2V(**ARCH), jax_reference[0])


@pytest.mark.parametrize("policy", [None, "full", "dots"], ids=["plain", "full", "dots"])
def test_gradients_match_jax(jax_reference, plain_grads, policy):
    """The hybrid loss's gradient of every parameter against JAX's; under a
    remat policy also against the port's plain gradient."""
    if policy is None:
        loss, grads = plain_grads
    else:
        model = LatteT2V(**ARCH, gradient_checkpointing=True, remat_policy=policy)
        loss, grads = _grads(model, jax_reference[0])
        assert loss == plain_grads[0]
        for k, g in grads.items():
            assert torch.equal(g, plain_grads[1][k]), k
    _check_against_jax(loss, grads, jax_reference)


def test_virtual_pipeline_of_the_remat_model(jax_reference, plain_grads):
    """pipelined_t2v_forward over 2 stages in one process (LocalHop), each
    pair under "full" remat, 2 microbatches: the gradients of the
    one-process forward, and JAX's."""
    model = LatteT2V(**ARCH, gradient_checkpointing=True)

    def forward(*args):
        return pipelined_t2v_forward(model, *args, mesh=2, microbatches=2)

    loss, grads = _grads(model, jax_reference[0], forward)
    np.testing.assert_allclose(loss, plain_grads[0], rtol=1e-6)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), plain_grads[1][k].numpy(), rtol=1e-5, atol=1e-9, err_msg=k)
    _check_against_jax(loss, grads, jax_reference)


def test_remat_acts_only_with_grad(monkeypatch):
    """Serving a checkpointed model runs each pair once: no checkpoint
    without grad; with grad, one a pair."""
    calls = []

    def counting(fn, *args, **kwargs):
        calls.append(fn)
        return fn(*args)

    monkeypatch.setattr(remat, "checkpoint", counting)
    model = LatteT2V(**ARCH, gradient_checkpointing=True, remat_policy="dots")
    x, t, ctx, mask = map(torch.from_numpy, inputs())
    with torch.no_grad():
        model(x, t, ctx, mask)
    assert calls == []
    model(x, t, ctx, mask)
    assert len(calls) == ARCH["num_layers"]


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat_policy 'offload'"):
        LatteT2V(**ARCH, gradient_checkpointing=True, remat_policy="offload")
