"""Port parity for the train step: two full steps of the port's
``make_train_step`` (hybrid loss, backward through the kernels' plain
versions, global grad norm, clipping, AdamW, EMA) against the JAX
``make_train_step`` fed the same t and the same noise, and the
mixed-precision step.

The tiny model and the weight carry-over are those of test_torch_train.py.
Tolerances: loss, grad norm and every parameter and EMA leaf within 1e-4
relative L2 (as for the model's gradients there); elementwise, see the note
in the test on AdamW.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import ELEM, REL, TINY, _batch, _jax_model_and_params, _port_model, _state_dict
from torch_port_util import close

from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.train.state import create_train_state as jax_create_train_state
from latte_tpu.train.state import make_optimizer as jax_make_optimizer
from latte_tpu.train.step import make_train_step as jax_make_train_step
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
from latte_tpu_torch.train.step import make_train_step


def _jax_noise(rng, step, shape):
    """The noise the JAX train step draws at ``step`` (its fold_in and split)."""
    r = jax.random.fold_in(rng, step)
    _, rng_noise, _, _ = jax.random.split(r, 4)
    return np.asarray(jax.random.normal(rng_noise, shape, dtype=jnp.float32))


@pytest.mark.parametrize("start_clip_iter", [0, 5], ids=["clipped", "unclipped"])
def test_two_train_steps_match_jax(start_clip_iter):
    """Params, EMA, loss and grad norm after two steps of AdamW (lr 1e-3,
    weight decay 0.01), clipping at norm 0.1 from ``start_clip_iter`` and
    EMA 0.9, with the same t and noise on both sides."""
    jm, params = _jax_model_and_params(seed=1)
    x0, _ = _batch(seed=2)
    ts = [np.array([3, 700]), np.array([1, 250])]
    hp = dict(ema_decay=0.9, clip_max_norm=0.1, start_clip_iter=start_clip_iter)
    jopt = jax_make_optimizer(lr=1e-3, weight_decay=0.01)
    jstate = jax_create_train_state(params, jopt)
    jstep = jax.jit(jax_make_train_step(jm, jax_create_diffusion(""), jopt, **hp))
    rng = jax.random.PRNGKey(7)

    model = _port_model(params)
    state = create_train_state(model, make_optimizer(model, 0.01), make_lr_schedule(1e-3))
    step = make_train_step(create_diffusion(""), **hp)
    for s, t in enumerate(ts):
        jstate, jm_metrics = jstep(jstate, {"latents": jnp.asarray(x0), "t": jnp.asarray(t, jnp.int32)}, rng)
        noise = _jax_noise(rng, s, x0.shape)
        metrics = step(state, {"latents": torch.from_numpy(x0), "t": torch.from_numpy(t),
                               "noise": torch.from_numpy(noise.copy())}, torch.Generator())
        for k in ("loss", "mse", "vb", "grad_norm", "t_mean"):
            close(metrics[k], jm_metrics[k], REL, ELEM)
    assert state.step == int(jstate.step) == 2
    # the clip really bit in one case and not in the other
    assert float(metrics["grad_norm"]) > 0.1
    # AdamW moves an element by ~lr whatever its gradient's size, so an
    # element whose gradient is rounding noise moves by the sign of that
    # noise: the k part of each qkv bias (softmax ignores a shift shared by
    # all keys, so its gradient is 0 in exact arithmetic) is left out, and
    # no other element may be off by more than the 2·lr two steps can move it
    D = TINY["hidden_size"]
    for got, want in ((model, jstate.params), (state.ema, jstate.ema_params)):
        want = _state_dict(want)
        for name, p in got.named_parameters():
            g, w = p.detach().numpy(), want[name].numpy()
            if name.endswith("attn.qkv.bias"):
                g, w = np.delete(g, np.s_[D:2 * D]), np.delete(w, np.s_[D:2 * D])
            close(g, w, REL, 2e-3 / np.abs(w).max())


def test_mixed_precision_step_keeps_fp32_masters():
    """``compute_dtype=bf16`` over fp32 parameters: the forward runs in bf16,
    the gradients, AdamW moments and EMA stay fp32."""
    _, params = _jax_model_and_params()
    model = _port_model(params, compute_dtype=torch.bfloat16)
    state = create_train_state(model, make_optimizer(model), make_lr_schedule(1e-3))
    x0, noise = _batch()
    out = model(torch.from_numpy(x0), torch.tensor([10, 20]))
    assert out.dtype == torch.float32  # back in the input's type
    m = make_train_step(create_diffusion(""))(
        state, {"latents": torch.from_numpy(x0), "noise": torch.from_numpy(noise)},
        torch.Generator().manual_seed(0),
    )
    assert torch.isfinite(m["loss"]) and m["loss"].dtype == torch.float32
    for p, e in zip(model.parameters(), state.ema.parameters()):
        assert p.dtype == e.dtype == p.grad.dtype == torch.float32
    assert all(v.dtype == torch.float32 for s in state.optimizer.state.values() for k, v in s.items()
               if k != "step")
    # it changed the weights, and differs from the fp32 forward by bf16's rounding only
    with torch.no_grad():
        f32 = _port_model(params)(torch.from_numpy(x0), torch.tensor([10, 20]))
        rel = ((out - f32).norm() / f32.norm()).item()
    assert 0 < rel < 0.05
