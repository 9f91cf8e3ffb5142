"""Port parity for the trainer's options against the JAX package: gradient
accumulation, ``fixed_spatial`` (its mask, its steps and frozen
parameters), bf16 Adam first moments (two steps against optax, and their
round trip through a checkpoint), the "dots" remat policy, and the partial
``pretrained`` load.

The tiny model, its weights and the JAX step's t and noise are those of
test_torch_train_step.py. Tolerances: losses, grad norms, parameters and EMA
within 1e-4 relative L2 (elementwise 2·lr, the k part of each qkv bias left
out, as there); bf16 first moments within one bf16 step (2^-7 of their
size) of optax's, since the fp32 moment they are rounded from differs by the
gradients' ~1e-6 (see the test); "dots" gradients equal to "full" gradients to the bit on
the CPU (the "full" gradients are held to the JAX model's in
test_torch_train.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import ELEM, LOSS_REL, REL, TINY, _batch, _jax_model_and_params, _port_model, _state_dict
from test_torch_train_cond import _state_matches
from test_torch_train_step import _jax_noise
from torch.utils._python_dispatch import TorchDispatchMode
from torch_port_util import close

from latte_tpu.config import load_config as jax_load_config
from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.models import Latte as JaxLatte
from latte_tpu.train.callbacks import Callback as JaxCallback
from latte_tpu.train.state import create_train_state as jax_create_train_state
from latte_tpu.train.state import make_optimizer as jax_make_optimizer
from latte_tpu.train.state import trainable_temporal_attn_mask as jax_trainable_mask
from latte_tpu.train.step import make_train_step as jax_make_train_step
from latte_tpu.train.train import main as jax_main
from latte_tpu_torch.config import load_config
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.models import Latte, LatteIMG
from latte_tpu_torch.train import train
from latte_tpu_torch.train.callbacks import Callback
from latte_tpu_torch.train.checkpoint import load_checkpoint, load_pretrained, restore_train_state, save_checkpoint
from latte_tpu_torch.train.state import (
    create_train_state,
    make_lr_schedule,
    make_optimizer,
    trainable_temporal_attn_mask,
)
from latte_tpu_torch.train.step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UCF_TRAIN = os.path.join(REPO, "configs", "ucf101", "ucf101_train.yaml")
HP = dict(ema_decay=0.9, clip_max_norm=0.1, start_clip_iter=0)
TS = [np.array([3, 700]), np.array([1, 250])]
D = TINY["hidden_size"]


def _run_two_steps(jopt, jkw, port_opt, model, params, noise_fn=None, grad_accum=1, freeze=None):
    """Two steps of the JAX step and of the port's on the same weights and
    t, with the JAX step's noise; returns the JAX state and each step's
    metrics on both sides."""
    jm = JaxLatte(**TINY, attention_mode="flash", fused_adaln=True)
    x0, _ = _batch(seed=2)
    jstate = jax_create_train_state(params, jopt)
    jstep = jax.jit(jax_make_train_step(jm, jax_create_diffusion(""), jopt, grad_accum=grad_accum, **jkw, **HP))
    if freeze is not None:
        for name, trainable in freeze.items():
            model.get_parameter(name).requires_grad_(trainable)
    state = create_train_state(model, port_opt(model), make_lr_schedule(1e-3))
    step = make_train_step(create_diffusion(""), grad_accum=grad_accum, **HP)
    rng = jax.random.PRNGKey(7)
    out = []
    for s, t in enumerate(TS):
        jstate, want = jstep(jstate, {"latents": jnp.asarray(x0), "t": jnp.asarray(t, jnp.int32)}, rng)
        noise = (noise_fn or _jax_noise)(rng, s, x0.shape)
        got = step(state, {"latents": torch.from_numpy(x0), "t": torch.from_numpy(t),
                           "noise": torch.from_numpy(np.array(noise))}, torch.Generator())
        for k in ("loss", "mse", "vb", "grad_norm"):
            close(got[k], want[k], REL, ELEM)
        out.append((got, want))
    return state, jstate, out


def _accum_noise(rng, step, shape, K=2):
    """The noise of the JAX step's K chunks (chunk k draws from
    fold_in(rng, k), k = 1..K), each chunk's rows put back at rows k - 1,
    k - 1 + K, ... of the batch."""
    r = jax.random.fold_in(rng, step)
    noise = np.empty(shape, np.float32)
    for k in range(1, K + 1):
        _, rng_noise, _, _ = jax.random.split(jax.random.fold_in(r, k), 4)
        noise[k - 1::K] = np.asarray(jax.random.normal(rng_noise, (shape[0] // K, *shape[1:])))
    return noise


def test_gradient_accumulation_steps_match_jax():
    """K = 2 interleaved chunks of one row each, two steps: the loss is the
    mean of the chunks', the gradients their mean, applied once."""
    _, params = _jax_model_and_params(seed=1)
    model = _port_model(params)
    state, jstate, _ = _run_two_steps(
        jax_make_optimizer(lr=1e-3, weight_decay=0.01), {}, lambda m: make_optimizer(m, 0.01),
        model, params, noise_fn=_accum_noise, grad_accum=2,
    )
    _state_matches(model, state.ema, jstate, D)


def test_gradient_accumulation_equals_one_chunk():
    """The same rows, t and noise in K = 2 chunks and in one: the clipped
    gradients within 1e-5 relative L2 (fp32 sums over other batch sizes),
    the loss the mean of the chunk losses."""
    _, params = _jax_model_and_params(seed=1)
    x0, noise = _batch(B=4, seed=2)
    batch = {"latents": torch.from_numpy(x0), "t": torch.tensor([3, 700, 1, 250]), "noise": torch.from_numpy(noise)}
    grads, losses = [], []
    for K in (1, 2):
        model = _port_model(params)
        state = create_train_state(model, make_optimizer(model), make_lr_schedule(1e-3))
        losses.append(make_train_step(create_diffusion(""), grad_accum=K)(state, batch, torch.Generator())["loss"])
        grads.append(torch.cat([p.grad.flatten() for p in model.parameters()]))
    close(grads[1], grads[0].numpy(), 1e-5, 1e-4)
    close(losses[1], losses[0].numpy(), LOSS_REL, LOSS_REL)


def test_fixed_spatial_mask_matches_jax():
    """The port's mask is the JAX mask carried through flax_to_state_dict (a
    bool tree as 0/1 survives its linear map): the odd blocks' attention."""
    _, params = _jax_model_and_params()
    # one bool a leaf: as 0/1 arrays of the leaf's shape
    mask = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m, np.float32), jax_trainable_mask(params), params)
    want = _state_dict(mask)
    got = trainable_temporal_attn_mask(_port_model(params))
    assert set(got) == set(want)
    for name, trainable in got.items():
        assert np.all(want[name].numpy() == float(trainable)), name
    assert sorted(n for n, v in got.items() if v) == sorted(
        f"blocks.{i}.attn.{layer}.{kind}" for i in (1, 3) for layer in ("qkv", "proj") for kind in ("weight", "bias"))


def test_fixed_spatial_steps_match_jax():
    """Two steps training the temporal attention alone (weight decay 0.01
    on the trainable parameters only): against the JAX step's zeroed
    gradients and decay mask, and every frozen parameter and its EMA equal
    to their initial value to the bit."""
    _, params = _jax_model_and_params(seed=1)
    model = _port_model(params)
    mask = trainable_temporal_attn_mask(model)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, jstate, _ = _run_two_steps(
        jax_make_optimizer(lr=1e-3, weight_decay=0.01, decay_mask=jax_trainable_mask),
        dict(fixed_spatial=True), lambda m: make_optimizer(m, 0.01), model, params, freeze=mask,
    )
    _state_matches(model, state.ema, jstate, D)
    ema = dict(state.ema.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, init[name]) != mask[name], name
        if not mask[name]:
            assert torch.equal(ema[name], init[name]), name
    assert len(state.optimizer.state) == sum(mask.values())


def test_bf16_first_moment_steps_match_optax():
    """``adam_mu_dtype: bfloat16``: two steps against optax.adamw with
    ``mu_dtype=bfloat16``; every first moment bf16, within 2^-8 relative
    L2 of optax's and one bf16 step of the tensor's largest magnitude
    (2^-7); the second moments fp32. The gradients the moments come from
    differ between the two sides as the model's do (1e-4), so about a
    quarter of the elements (25.5% at this seed) round to a neighbouring
    bf16 value: the arithmetic itself is held to the bit in the next test."""
    _, params = _jax_model_and_params(seed=1)
    model = _port_model(params)
    state, jstate, _ = _run_two_steps(
        jax_make_optimizer(lr=1e-3, weight_decay=0.01, mu_dtype=jnp.bfloat16), {},
        lambda m: make_optimizer(m, 0.01, mu_dtype=torch.bfloat16), model, params,
    )
    _state_matches(model, state.ema, jstate, D)
    adam = jstate.opt_state[0]
    mu = _state_dict(jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), adam.mu))
    for name, p in model.named_parameters():
        st = state.optimizer.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
        got, want = st["exp_avg"].float().numpy(), mu[name].numpy()
        if name.endswith("attn.qkv.bias"):
            got, want = np.delete(got, np.s_[D:2 * D]), np.delete(want, np.s_[D:2 * D])
        close(got, want, 2.0**-8, 2.0**-7)
    assert int(adam.count) == int(next(iter(state.optimizer.state.values()))["step"]) == 2


def test_bf16_first_moment_arithmetic_equals_optax():
    """On the same gradients, three steps of the port's AdamW with bf16
    first moments (weight decay 0.01) give optax.adamw's moments and
    parameters to the bit: the bf16 product b1·mu, the fp32 update from the
    fp32 moment, the bias corrections in fp32, the rounding at the end."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 250)).astype(np.float32)
    opt = optax.adamw(1e-3, weight_decay=0.01, mu_dtype=jnp.bfloat16)
    params = {"w": jnp.asarray(p0)}
    opt_state = opt.init(params)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    port = make_optimizer(torch.nn.ParameterList([w]), 0.01, mu_dtype=torch.bfloat16)
    for _ in range(3):
        g = (rng.standard_normal(p0.shape) * 1e-3).astype(np.float32)
        updates, opt_state = opt.update({"w": jnp.asarray(g)}, opt_state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g)
        port.param_groups[0]["lr"] = 1e-3
        port.step()
        st = port.state[w]
        assert st["exp_avg"].dtype == torch.bfloat16
        np.testing.assert_array_equal(st["exp_avg"].float().numpy(), np.asarray(opt_state[0].mu["w"].astype(jnp.float32)))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), np.asarray(opt_state[0].nu["w"]))
        np.testing.assert_array_equal(w.detach().numpy(), np.asarray(params["w"]))


def test_bf16_first_moment_survives_a_checkpoint(tmp_path):
    """The bf16 moments come back bf16 and equal to the bit through
    save_checkpoint / restore_train_state, and the next step is the same."""
    _, params = _jax_model_and_params(seed=1)
    x0, noise = _batch(seed=2)
    batch = {"latents": torch.from_numpy(x0), "t": torch.tensor([3, 700]), "noise": torch.from_numpy(noise)}
    step = make_train_step(create_diffusion(""))

    def fresh():
        m = _port_model(params)
        return create_train_state(m, make_optimizer(m, 0.01, mu_dtype=torch.bfloat16), make_lr_schedule(1e-3))

    a = fresh()
    step(a, batch, torch.Generator())
    path = save_checkpoint(str(tmp_path / "0000001.pt"), a)
    b = restore_train_state(fresh(), load_checkpoint(path))
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert sb["exp_avg"].dtype == torch.bfloat16 and torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    step(a, batch, torch.Generator())
    step(b, batch, torch.Generator())
    assert all(torch.equal(pa, pb) for pa, pb in zip(a.model.parameters(), b.model.parameters()))


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.addmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.addmm += func is torch.ops.aten.addmm.default
        return func(*args, **(kwargs or {}))


def _remat_grads(cls, policy, **kw):
    """Gradients of the hybrid loss under gradient checkpointing, and the
    Linear products (aten.addmm) the backward ran."""
    model = cls(**TINY, gradient_checkpointing=True, remat_policy=policy, **kw)
    model.initialize_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.1, generator=torch.Generator().manual_seed(p.numel()))
    frames = TINY["num_frames"] + kw.get("use_image_num", 0)
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.standard_normal((2, frames, 4, 8, 8)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal(x0.shape).astype(np.float32))
    fn = lambda x, t: model(x, t, train=True)  # noqa: E731
    loss = create_diffusion("").training_losses(fn, x0, torch.tensor([1, 500]), noise=noise)["loss"].mean()
    with _CountMatmuls() as count:
        loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}, count.addmm


@pytest.mark.parametrize("cls, kw", [(Latte, {}), (LatteIMG, dict(use_image_num=2))], ids=["Latte", "LatteIMG"])
def test_dots_gradients_equal_full(cls, kw):
    """"dots" saves the Linear outputs of each pair (5 a block) and replays
    the rest: its gradients equal "full"'s to the bit, and its backward runs
    5 · depth fewer Linear products."""
    loss_f, full, n_full = _remat_grads(cls, "full", **kw)
    loss_d, dots, n_dots = _remat_grads(cls, "dots", **kw)
    assert torch.equal(loss_f, loss_d)
    assert all(torch.equal(full[n], dots[n]) for n in full)
    assert n_full - n_dots == 5 * TINY["depth"], (n_full, n_dots)


TINY_UCF = ["image_size=64", "num_frames=4", "num_classes=5", "local_batch_size=2", "log_every=1",
            "model_overrides={depth: 4, hidden_size: 144, num_heads: 2}"]


class _Start:
    def on_train_start(self, config, state, experiment_dir):
        self.state = state


class _JaxStart(_Start, JaxCallback):
    pass


class _PortStart(_Start, Callback):
    pass


def test_partial_pretrained_load_matches_jax(tmp_path):
    """``pretrained``: a .pt written here from seeded weights of a model with
    7 classes, loaded into a 5-class config by both trainers (0 steps): the
    same parameters take the file's (EMA) values, and the label table alone
    keeps its initial value (its shape differs), on both sides; the EMA
    starts equal to the loaded parameters."""
    src = Latte(**dict(TINY, extras=2, num_classes=7))
    src.initialize_weights(torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in src.parameters():
            p.normal_(0, 0.1, generator=torch.Generator().manual_seed(p.numel() + 1))
    ema = {k: v + 1.0 for k, v in src.state_dict().items()}
    path = str(tmp_path / "pretrained.pt")
    torch.save({"model": src.state_dict(), "ema": ema}, path)
    over = TINY_UCF + ["max_train_steps=0", f"pretrained={path}", "attention_mode=xla"]
    jcb, pcb = _JaxStart(), _PortStart()
    jax_main(jax_load_config(UCF_TRAIN, over + [f"results_dir={tmp_path}/jax"]), callbacks=[jcb])
    train.main(load_config(UCF_TRAIN, over + [f"results_dir={tmp_path}/port"]), callbacks=[pcb], device="cpu")
    jparams = _state_dict(jax.device_get(jcb.state.params))
    loaded = {n: torch.equal(p.detach(), ema[n]) for n, p in pcb.state.model.named_parameters()}
    jloaded = {n: torch.equal(jparams[n], ema[n]) if jparams[n].shape == ema[n].shape else False for n in jparams}
    assert loaded == jloaded
    assert [n for n, v in loaded.items() if not v] == ["y_embedder.embedding_table.weight"]
    assert all(torch.equal(a, b) for a, b in zip(pcb.state.model.parameters(), pcb.state.ema.parameters()))
    # the count the trainer logs
    model = Latte(**dict(TINY, extras=2, num_classes=5))
    assert load_pretrained(model, path) == 1


@pytest.mark.parametrize("where", ["missing", "directory"])
def test_pretrained_path_refusals(tmp_path, where):
    """A ``pretrained`` path that does not exist raises FileNotFoundError
    (the JAX trainer would ignore it), a directory (orbax) NotImplementedError."""
    path = tmp_path / "ckpt"
    if where == "directory":
        path.mkdir()
    error = FileNotFoundError if where == "missing" else NotImplementedError
    with pytest.raises(error, match="pretrained"):
        train.main(load_config(UCF_TRAIN, TINY_UCF + ["max_train_steps=1", f"pretrained={path}",
                                                      f"results_dir={tmp_path}/r"]), device="cpu")


def test_gradient_accumulation_must_divide_the_batch(tmp_path):
    with pytest.raises(ValueError, match="must divide local_batch_size"):
        train.main(load_config(UCF_TRAIN, TINY_UCF + ["gradient_accumulation_steps=3",
                                                      f"results_dir={tmp_path}/r"]), device="cpu")
    assert not os.path.exists(tmp_path / "r")


def test_options_through_the_cli(tmp_path):
    """ucf101_train.yaml at a tiny size with every option of this slice at
    once: from a pretrained file, temporal attention alone, 2 chunks, bf16
    first moments, "dots": after 2 steps only the odd blocks' attention
    changed, and every first moment is bf16."""
    src = Latte(**dict(TINY, extras=2, num_classes=5))
    src.initialize_weights(torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in src.parameters():
            p.normal_(0, 0.1, generator=torch.Generator().manual_seed(p.numel() + 2))
    path = str(tmp_path / "pretrained.pt")
    torch.save({"ema": src.state_dict()}, path)
    cb = _PortStart()
    out = train.main(load_config(UCF_TRAIN, TINY_UCF + [
        "max_train_steps=2", f"pretrained={path}", "fixed_spatial=true", "gradient_accumulation_steps=2",
        "adam_mu_dtype=bfloat16", "remat_policy=dots", f"results_dir={tmp_path}/r",
    ]), callbacks=[cb], device="cpu")
    assert out["final_step"] == 2 and np.isfinite(out["loss"])
    model = cb.state.model
    assert model.remat_policy == "dots" and model.gradient_checkpointing
    mask = trainable_temporal_attn_mask(model)
    want = src.state_dict()
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), want[name]) != mask[name], name
    assert {v["exp_avg"].dtype for v in cb.state.optimizer.state.values()} == {torch.bfloat16}
