"""The train step as one program (``train.step.GraphedTrainStep``, the port's
counterpart of ``jax.jit(train_step, donate_argnums=(0,))``), on the CPU.

On the CPU the graph's runner calls the step's body on its static buffers
(the first call's batch and draws, into which every later call copies its
own), so it is the graph's plain version: it must give the eager step's
numbers to the bit. Each case runs three steps from the same weights and
batches both ways and holds the parameters, the EMA, both AdamW moments,
their step counters and every metric equal (``torch.equal``). The learning
rate warms up (0, then half, then all of it) and the clip and the EMA
switch on and off between steps, so a value baked into the first call's
buffers would show.

The runner is also held against the JAX package's jitted step over three
steps with the clip from step 2 and the EMA every 2 steps (the tolerances
of test_torch_train_step.py), checkpoints round-trip between the graphed
and the eager trainer (``train.main``), and the step's body draws no random
number, so the remat policies' checkpoints stash no RNG state: the body
leaves the generators as the prologue left them, and "full" and "dots"
give the step without remat to the bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import REL, TINY, _batch, _jax_model_and_params, _port_model, _state_dict
from test_torch_train_step import _jax_noise
from torch_port_util import close

from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.train.state import create_train_state as jax_create_train_state
from latte_tpu.train.state import make_optimizer as jax_make_optimizer
from latte_tpu.train.step import make_train_step as jax_make_train_step
from latte_tpu_torch.config import load_config
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.core.timestep_samplers import LossSecondMomentResampler
from latte_tpu_torch.models import Latte
from latte_tpu_torch.train import train
from latte_tpu_torch.train.checkpoint import load_checkpoint
from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
from latte_tpu_torch.train.step import GraphedTrainStep, make_train_step

SMALL = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2, num_heads=2, num_frames=2)
B, STEPS, LR, WARMUP = 2, 3, 1e-3, 2
# each case: the model's and the step's options
CASES = {
    "fp32": {},
    "mixed_precision_bf16_mu": dict(compute_dtype=torch.bfloat16, mu_dtype=torch.bfloat16),
    "grad_accum_2": dict(grad_accum=2),
    "clip_from_step_2": dict(start_clip_iter=2),
    "ema_every_2": dict(ema_every=2),
    "loss_aware_sampler": dict(loss_aware=True),
    "class_label_dropout": dict(extras=2),
    "latent_cache_moments": dict(cache=True),
    "remat_full": dict(remat="full"),
    "remat_dots": dict(remat="dots"),
}


def _model(extras: int = 1, remat=None, compute_dtype=None) -> Latte:
    cond = dict(extras=2, num_classes=3, class_dropout_prob=0.5) if extras == 2 else {}
    model = Latte(**SMALL, **cond, gradient_checkpointing=remat is not None, remat_policy=remat or "full")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # no zero-initialised layer: every weight gets a gradient
        for p in model.parameters():
            p.normal_(0, 0.05, generator=gen)
    model.compute_dtype = compute_dtype
    return model


def _step_batch(s: int, extras: int = 1, cache: bool = False) -> dict:
    """Step ``s``'s batch, new tensors from a numpy seed."""
    rng = np.random.default_rng(10 + s)
    shape = (B, SMALL["num_frames"], 4, 8, 8)
    if cache:
        batch = {"latent_mean": rng.standard_normal(shape), "latent_std": rng.uniform(0.1, 1.0, shape)}
    else:
        batch = {"latents": rng.standard_normal(shape)}
    batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in batch.items()}
    if extras == 2:
        batch["y"] = torch.from_numpy(rng.integers(0, 3, (B,)))
    return batch


def _train(case: dict, graphed: bool, steps: int = STEPS):
    """``steps`` steps of ``case`` through the eager step or the graph's
    runner: the state, each step's metrics (cloned) and the runner."""
    extras = case.get("extras", 1)
    model = _model(extras, case.get("remat"), case.get("compute_dtype"))
    state = create_train_state(model, make_optimizer(model, 0.01, mu_dtype=case.get("mu_dtype")),
                               make_lr_schedule(LR, warmup_steps=WARMUP))
    diffusion = create_diffusion("")
    step = make_train_step(diffusion, ema_decay=0.9, clip_max_norm=0.1,
                           start_clip_iter=case.get("start_clip_iter", 0), ema_every=case.get("ema_every", 1),
                           grad_accum=case.get("grad_accum", 1))
    run = GraphedTrainStep(step) if graphed else step
    sampler = LossSecondMomentResampler(diffusion) if case.get("loss_aware") else None
    history = []
    for s in range(steps):
        gen = torch.Generator().manual_seed(100 + s)
        batch = _step_batch(s, extras, case.get("cache", False))
        if sampler is not None:
            batch["t"], batch["t_weights"] = sampler.sample(gen, B)
        metrics = run(state, batch, gen)
        history.append({k: v.clone() for k, v in metrics.items()})
        if sampler is not None:
            sampler.update_with_local_losses(metrics["t_sampled"], metrics["per_sample_loss"])
    return state, history, run


def _leaves(state) -> dict:
    out = {f"model.{n}": p for n, p in state.model.named_parameters()}
    out.update({f"ema.{n}": p for n, p in state.ema.named_parameters()})
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_graph_runner_equals_eager_step(name):
    """Three steps through the graph's runner equal three eager steps to
    the bit: parameters, EMA, both moments (in their stored types), the
    step counters and every metric."""
    case = CASES[name]
    eager, want_hist, _ = _train(case, graphed=False)
    graphed, got_hist, runner = _train(case, graphed=True)
    graph = runner.graphs["step"]
    assert (graph.captures, graph.replays, graphed.step) == (1, STEPS - 1, STEPS)
    for got, want in zip(got_hist, want_hist):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    want = _leaves(eager)
    got = _leaves(graphed)
    assert got.keys() == want.keys() and any(k.endswith("exp_avg_sq") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (name, k)
    mu = {v.dtype for k, v in got.items() if k.endswith(".exp_avg")}
    assert mu == {case.get("mu_dtype", torch.float32)}
    if name == "clip_from_step_2":  # the clip bites once it is on
        assert float(got_hist[2]["grad_norm"]) > 0.1
    if name == "ema_every_2":  # the EMA moved at step 2 alone, by its own program
        ema = runner.graphs["ema"]
        assert (ema.captures, ema.replays) == (1, 0)


def test_graph_runner_matches_jax_over_three_steps():
    """Three steps of the graph's runner against the JAX jitted step with
    warmup (lr 0, then 5e-4, then 1e-3), the clip from step 2 and the EMA
    every 2 steps, fed the same t and noise: losses and grad norms within
    test_torch_train_step.py's tolerances, every parameter and EMA leaf
    within 1e-4 relative L2 and twice the learning rate the steps sum to
    elementwise (its note on AdamW: the k part of each qkv bias left out)."""
    jm, params = _jax_model_and_params(seed=1)
    x0, _ = _batch(seed=2)
    ts = [np.array([3, 700]), np.array([1, 250]), np.array([999, 42])]
    hp = dict(ema_decay=0.9, clip_max_norm=0.1, start_clip_iter=2, ema_every=2)
    jopt = jax_make_optimizer(lr=LR, weight_decay=0.01, warmup_steps=WARMUP)
    jstate = jax_create_train_state(params, jopt)
    jstep = jax.jit(jax_make_train_step(jm, jax_create_diffusion(""), jopt, **hp))
    rng = jax.random.PRNGKey(7)

    model = _port_model(params)
    state = create_train_state(model, make_optimizer(model, 0.01), make_lr_schedule(LR, warmup_steps=WARMUP))
    runner = GraphedTrainStep(make_train_step(create_diffusion(""), **hp))
    norms = []
    for s, t in enumerate(ts):
        jstate, want = jstep(jstate, {"latents": jnp.asarray(x0), "t": jnp.asarray(t, jnp.int32)}, rng)
        noise = _jax_noise(rng, s, x0.shape)
        got = runner(state, {"latents": torch.from_numpy(x0), "t": torch.from_numpy(t),
                             "noise": torch.from_numpy(noise.copy())}, torch.Generator())
        for k in ("loss", "mse", "vb", "grad_norm", "t_mean"):
            close(got[k], want[k], REL, 1e-3)
        norms.append(float(got["grad_norm"]))
    assert state.step == int(jstate.step) == 3 and runner.graphs["step"].replays == 2
    assert norms[2] > 0.1  # the clip bit at step 2
    D = TINY["hidden_size"]
    moved = 2 * LR * sum(min(s, WARMUP) / WARMUP for s in range(len(ts)))
    for got, want in ((model, jstate.params), (state.ema, jstate.ema_params)):
        want = _state_dict(want)
        for name, p in got.named_parameters():
            g, w = p.detach().numpy(), want[name].numpy()
            if name.endswith("attn.qkv.bias"):
                g, w = np.delete(g, np.s_[D:2 * D]), np.delete(w, np.s_[D:2 * D])
            close(g, w, REL, moved / np.abs(w).max())


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_step_body_draws_nothing_and_remat_equals_no_remat(remat):
    """With label dropout, the body after the prologue leaves the step's
    generator and the default generator as they were (the model draws
    nothing, inside a checkpoint or out), and two steps under the remat
    policy equal two steps without remat to the bit."""
    step = make_train_step(create_diffusion(""), ema_decay=0.9)
    states = {}
    for key, policy in (("remat", remat), ("none", None)):
        model = _model(extras=2, remat=policy)
        states[key] = create_train_state(model, make_optimizer(model, 0.01), make_lr_schedule(LR))
    for s in range(2):
        batch = _step_batch(s, extras=2)
        gen = torch.Generator().manual_seed(5 + s)
        inputs = step.prologue(states["remat"], batch, gen)
        assert set(inputs.draws[0]) == {"t", "noise", "force_drop_ids"}
        before, default = gen.get_state(), torch.random.get_rng_state()
        step.body(states["remat"], inputs)
        assert torch.equal(gen.get_state(), before) and torch.equal(torch.random.get_rng_state(), default)
        step(states["none"], batch, torch.Generator().manual_seed(5 + s))
    got, want = _leaves(states["remat"]), _leaves(states["none"])
    for k in want:
        assert torch.equal(got[k], want[k]), k


FFS_TRAIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "ffs",
                         "ffs_train.yaml")
TINY_TRAIN = ["image_size=32", "num_frames=2", "model_overrides={depth: 2, hidden_size: 32, num_heads: 2}",
              "local_batch_size=2", "log_every=1", "learning_rate=1e-3", "lr_warmup_steps=2",
              "start_clip_iter=1", "ckpt_every=2"]


def _main(tmp_path, name: str, graph_step: bool, steps: int, resume=None) -> str:
    over = [*TINY_TRAIN, f"results_dir={tmp_path}/{name}", f"max_train_steps={steps}"]
    if resume:
        over.append(f"resume_from_checkpoint={resume}")
    out = train.main(load_config(FFS_TRAIN, over), device="cpu", graph_step=graph_step)
    return os.path.join(out["experiment_dir"], "checkpoints", f"{steps:07d}.pt")


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("first_graphed", [True, False], ids=["graphed_then_eager", "eager_then_graphed"])
def test_checkpoints_round_trip_between_graphed_and_eager(tmp_path, monkeypatch, first_graphed):
    """``train.main`` on the CPU: two steps one way, saved, then resumed the
    other way for two more, equal to four uninterrupted steps of the other
    way (model, EMA, the optimizer's state dict and the step) to the bit;
    the graphed runs go through ``GraphedTrainStep``."""
    built = []

    class Spy(GraphedTrainStep):
        def __init__(self, step):
            super().__init__(step)
            built.append(self)
            self.seen = {}

        def release(self):  # the run's end releases its graphs: count them first
            self.seen.update({name: (g.captures, g.replays) for name, g in self.graphs.items()})
            super().release()

    monkeypatch.setattr(train, "GraphedTrainStep", Spy)
    half = _main(tmp_path, "half", first_graphed, 2)
    resumed = _main(tmp_path, "resumed", not first_graphed, 4, resume=half)
    whole = _main(tmp_path, "whole", not first_graphed, 4)
    assert len(built) == (1 if first_graphed else 2)
    assert all(r.seen["step"][0] == 1 and r.seen["step"][1] >= 1 and not r.graphs for r in built)
    got, want = load_checkpoint(resumed), load_checkpoint(whole)
    assert got["step"] == want["step"] == 4
    for part in ("model", "ema", "opt"):
        assert _equal(got[part], want[part]), part
