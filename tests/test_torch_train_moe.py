"""Port parity for Mixture-of-Experts training against the JAX package on
the CPU: two steps of the port's ``make_train_step`` with the Switch loss
(``moe_aux_weight=0.01``) against the JAX ``make_train_step`` on the same
weights, t and noise, plain, with ``gradient_accumulation_steps: 2`` and
with ``remat_policy: dots``; the trainer's Switch-loss weight; and
``train.main`` on ``configs/ffs/ffs_train_moe.yaml`` at a tiny size with
``expert_parallel=1``, and what it refuses.

The tiny model: depth 4, hidden 64, 2 heads, 4 frames of 8x8 latents, 4
experts top-2 at capacity factor 1.0 (tokens drop); the JAX side with
``attention_mode="xla"``. Tolerances, as for the dense steps
(test_torch_train_step.py): loss, mse, vb, grad norm, ``moe_aux``, every
parameter and EMA leaf within 1e-4 relative L2, elementwise within the 2·lr
two AdamW steps can move an element, the k part of each qkv bias left out.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_options import _accum_noise
from test_torch_train_step import _jax_noise
from torch_port_util import RouterMargins, close, randomize

from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.models import Latte as JaxLatte
from latte_tpu.train.state import create_train_state as jax_create_train_state
from latte_tpu.train.state import make_optimizer as jax_make_optimizer
from latte_tpu.train.step import make_train_step as jax_make_train_step
from latte_tpu_torch.config import Config, load_config
from latte_tpu_torch.convert import flax_to_state_dict, load_flax_params
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.models import Latte
from latte_tpu_torch.train import train
from latte_tpu_torch.train.callbacks import Callback
from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
from latte_tpu_torch.train.step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFS_MOE = os.path.join(REPO, "configs", "ffs", "ffs_train_moe.yaml")
TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=4, num_heads=2, num_frames=4,
            moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
REL, ELEM = 1e-4, 1e-3
HP = dict(ema_decay=0.9, clip_max_norm=0.1, start_clip_iter=0, moe_aux_weight=0.01)
TS = [np.array([3, 700]), np.array([1, 250])]


def _state_dict(tree):
    return flax_to_state_dict(tree, TINY["depth"], TINY["num_heads"], TINY["patch_size"])


@pytest.mark.parametrize("grad_accum, remat", [(1, None), (2, None), (1, "dots")],
                         ids=["plain", "accum2", "dots"])
def test_two_moe_steps_match_jax(grad_accum, remat):
    """Two AdamW (lr 1e-3, weight decay 0.01) / clip / EMA steps with the
    Switch loss at 0.01: the metrics, ``moe_aux`` among them, the parameters
    (routers and experts included) and the EMA."""
    remat_kw = dict(gradient_checkpointing=True, remat_policy=remat) if remat else {}
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal((2, 4, 4, 8, 8)).astype(np.float32)
    jm = JaxLatte(**TINY, attention_mode="xla", **remat_kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x0), jnp.zeros((2,), jnp.int32))["params"]
    params = randomize(params, seed=1, std=0.1)
    jopt = jax_make_optimizer(lr=1e-3, weight_decay=0.01)
    jstate = jax_create_train_state(params, jopt)
    jstep = jax.jit(jax_make_train_step(jm, jax_create_diffusion(""), jopt, grad_accum=grad_accum, **HP))
    model = load_flax_params(Latte(**TINY, **remat_kw), params)
    state = create_train_state(model, make_optimizer(model, 0.01), make_lr_schedule(1e-3))
    step = make_train_step(create_diffusion(""), grad_accum=grad_accum, **HP)
    key = jax.random.PRNGKey(7)
    noise_fn = _accum_noise if grad_accum == 2 else _jax_noise
    for s, t in enumerate(TS):
        jstate, want = jstep(jstate, {"latents": jnp.asarray(x0), "t": jnp.asarray(t, jnp.int32)}, key)
        noise = noise_fn(key, s, x0.shape)
        with RouterMargins(f"step {s + 1}, grad_accum {grad_accum}, remat {remat}"):
            got = step(state, {"latents": torch.from_numpy(x0), "t": torch.from_numpy(t),
                               "noise": torch.from_numpy(np.array(noise))}, torch.Generator())
        for k in ("loss", "mse", "vb", "grad_norm", "moe_aux"):
            close(got[k], want[k], REL, ELEM)
        assert float(got["moe_aux"]) >= 1.0 - 1e-3  # E·Σ f·P is 1 at a uniform split, more otherwise
    D = TINY["hidden_size"]
    for ours, theirs in ((model, jstate.params), (state.ema, jstate.ema_params)):
        theirs = _state_dict(theirs)
        for name, p in ours.named_parameters():
            g, w = p.detach().numpy(), theirs[name].numpy()
            if name.endswith("attn.qkv.bias"):
                g, w = np.delete(g, np.s_[D:2 * D]), np.delete(w, np.s_[D:2 * D])
            close(g, w, REL, 2e-3 / np.abs(w).max())


def test_aux_weight_zero_collects_nothing():
    """At ``moe_aux_weight`` 0 the step asks the model for no losses and
    reports none, and the loss is the diffusion loss alone."""
    model = Latte(**TINY)
    model.initialize_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    batch = {"latents": torch.from_numpy(rng.standard_normal((2, 4, 4, 8, 8)).astype(np.float32)),
             "t": torch.tensor([5, 600])}
    out = []
    for weight in (0.0, 0.01):
        state = create_train_state(model, make_optimizer(model), make_lr_schedule(0.0))
        with RouterMargins(f"weight {weight}"):
            out.append(make_train_step(create_diffusion(""), moe_aux_weight=weight)(
                state, batch, torch.Generator().manual_seed(1)))
    assert "moe_aux" not in out[0] and "moe_aux" in out[1]
    close(out[1]["loss"], float(out[0]["loss"]) + 0.01 * float(out[1]["moe_aux"]), 1e-6, 1e-6)


def test_trainer_sets_the_aux_weight_as_jax_does():
    """0.01 when unset, the config's value when set, 0 for a null or a dense
    model (``latte_tpu/train/train.py:573-577``)."""
    assert train.moe_aux_weight(Config(dict(moe_experts=8))) == 0.01
    assert train.moe_aux_weight(Config(dict(moe_experts=8, moe_aux_weight=0.05))) == 0.05
    assert train.moe_aux_weight(Config(dict(moe_experts=8, moe_aux_weight=None))) == 0.0
    assert train.moe_aux_weight(Config(dict(moe_experts=1, moe_aux_weight=0.05))) == 0.0
    assert train.moe_aux_weight(Config(dict())) == 0.0


class _Log(Callback):
    def __init__(self):
        self.metrics, self.state, self.first = [], None, None

    def on_train_start(self, config, state, experiment_dir):
        self.state = state
        self.first = {n: p.detach().clone() for n, p in state.model.named_parameters()}

    def on_log(self, step, metrics):
        self.metrics.append(dict(metrics))


TINY_CLI = ["image_size=64", "num_frames=4", "local_batch_size=2", "log_every=1", "expert_parallel=1",
            "model_overrides={depth: 4, hidden_size: 64, num_heads: 2}"]


def test_ffs_train_moe_through_the_cli(tmp_path):
    """ffs_train_moe.yaml (8 experts, top-2, capacity 1.25, Switch weight
    0.01, gradient checkpointing) at a tiny width with expert_parallel=1: 3
    steps from synthetic latents, finite losses, ``moe_aux`` ≥ 1 reported at
    every log, and the routers and experts trained."""
    log = _Log()
    with RouterMargins("ffs_train_moe.yaml, 3 steps"):
        out = train.main(load_config(FFS_MOE, TINY_CLI + ["max_train_steps=3", f"results_dir={tmp_path}/r"]),
                         callbacks=[log], device="cpu")
    assert out["final_step"] == 3 and np.isfinite(out["loss"])
    assert len(log.metrics) == 3 and all(m["moe_aux"] >= 1.0 - 1e-3 for m in log.metrics)
    model = log.state.model
    assert model.gradient_checkpointing and model.blocks[0].moe.num_experts == 8
    for name in ("blocks.0.moe.router", "blocks.3.moe.wi", "blocks.3.moe.bo"):
        assert not torch.equal(model.get_parameter(name).detach(), log.first[name]), name
    ckpts = os.listdir(os.path.join(out["experiment_dir"], "checkpoints"))
    assert ckpts == ["0000003.pt"]


@pytest.mark.parametrize("override, exc, match", [
    ("expert_parallel=2", AssertionError, "expert_parallel=2 must divide 1 devices"),
    ("quant_train=true", NotImplementedError, "MoEMlp has no int8 expert path"),
], ids=["expert_parallel", "quant_train"])
def test_trainer_refusals(tmp_path, override, exc, match):
    """What stays refused with MoE: its experts split over more GPUs than the
    run has (the shipped config's ``expert_parallel: 4`` in one process: the
    JAX trainer's error; over 4 processes it trains, tests/test_torch_dist_train.py),
    and int8 training."""
    with pytest.raises(exc, match=match):
        train.main(load_config(FFS_MOE, TINY_CLI + ["max_train_steps=1", override, f"results_dir={tmp_path}/r"]),
                   device="cpu")
