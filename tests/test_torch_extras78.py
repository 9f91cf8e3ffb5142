"""``extras: 78``, Latte conditioned on CLIP text features, in the port
against the JAX package on the CPU: the tiny Latte (depth 4, hidden 144)
and LatteIMG forward, CFG forward and gradients, two train steps against
the JAX step, the trainer's synthetic batches against the JAX trainer's,
``train.main`` on them, and what the port refuses where the JAX package
has no path (its gaps, recorded in ROADMAP §3).

Latte projects the flattened (B, 77·768) features, SiLU first, in the
compute type; LatteIMG a (768,) row per frame kind, (B, 1 + I, 768). The
JAX models are initialised with an explicit ``text_embedding`` (the JAX
trainer passes none, its first gap).

Tolerances: forwards within 1e-5 relative L2 and 1e-4 of the largest
magnitude elementwise; gradients and two steps within 1e-4 relative L2
(test_torch_train.py's); batches equal to the bit.
"""

import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import ELEM, LOSS_REL, TINY
from test_torch_train_step import _jax_noise
from torch_port_util import close, randomize

from latte_tpu.config import load_config as jax_load_config
from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.models import Latte as JaxLatte
from latte_tpu.models.dit_img import LatteIMG as JaxLatteIMG
from latte_tpu.train.state import create_train_state as jax_create_train_state
from latte_tpu.train.state import make_optimizer as jax_make_optimizer
from latte_tpu.train.step import make_train_step as jax_make_train_step
from latte_tpu.train.train import make_batch_iterator as jax_make_batch_iterator
from latte_tpu_torch.config import load_config
from latte_tpu_torch.convert import flax_to_state_dict, load_flax_params
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.models import Latte, LatteIMG, get_models
from latte_tpu_torch.sample import sample
from latte_tpu_torch.train import train
from latte_tpu_torch.train.callbacks import Callback
from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
from latte_tpu_torch.train.step import global_norm, make_train_step

REL = 1e-5
GRAD_REL = 1e-4
TEXT = dict(TINY, extras=78)
IMAGES = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFS_TRAIN = os.path.join(REPO, "configs", "ffs", "ffs_train.yaml")
PROJ = "text_embedding_projection.weight"


def _inputs(B=2, frames=4, text_rows=None, seed=0):
    """x, noise and text features: (B, 77, 768), or (B, rows, 768) for
    LatteIMG."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, frames, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    text = rng.standard_normal((B, text_rows or 77, 768)).astype(np.float32)
    return x, noise, text


def _randomized(params, seed):
    """N(0, 0.1²) leaves, as the other tiny-model tests draw them, but the
    projection's kernel at its xavier init: at 0.1 over 59136 inputs the
    conditioning would be ~14 where the model's init gives ~1."""
    kernel = params["text_embedding_projection"]["kernel"]
    params = randomize(params, seed=seed, std=0.1)
    params["text_embedding_projection"]["kernel"] = np.asarray(kernel)
    return params


def _latte(seed=1, **kw):
    jm = JaxLatte(**TEXT, attention_mode="flash", fused_adaln=True, **kw)
    x, _, text = _inputs()
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.zeros((2,), jnp.int32),
                                     text_embedding=jnp.asarray(text)))()["params"]
    params = _randomized(params, seed)
    return jm, params, load_flax_params(Latte(**TEXT, **kw), params)


def _latte_img(seed=2, **kw):
    jm = JaxLatteIMG(**TEXT, attention_mode="flash", use_image_num=IMAGES, **kw)
    x, _, text = _inputs(frames=4 + IMAGES, text_rows=1 + IMAGES)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.zeros((2,), jnp.int32),
                                     text_embedding=jnp.asarray(text), train=True))()["params"]
    params = _randomized(params, seed)
    return jm, params, load_flax_params(LatteIMG(**TEXT, use_image_num=IMAGES, **kw), params)


@pytest.fixture(scope="module")
def latte():
    return _latte()


def test_forward_matches_flax(latte):
    jm, params, model = latte
    x, _, text = _inputs(seed=3)
    t = np.array([999, 17], np.int32)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), text_embedding=jnp.asarray(text))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t), text_embedding=torch.from_numpy(text))
    close(got, want, REL, ELEM)
    # the text reaches the output
    with torch.no_grad():
        other = model(torch.from_numpy(x), torch.from_numpy(t), text_embedding=torch.from_numpy(text[::-1].copy()))
    assert not torch.allclose(other[0], got[0])


def test_cfg_forward_matches_flax(latte):
    jm, params, model = latte
    x, _, text = _inputs(seed=4)
    t = np.array([500, 500], np.int32)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), cfg_scale=4.0,
                    text_embedding=jnp.asarray(text), method=JaxLatte.forward_with_cfg)
    with torch.no_grad():
        got = model.forward_with_cfg(torch.from_numpy(x), torch.from_numpy(t), cfg_scale=4.0,
                                     text_embedding=torch.from_numpy(text))
    close(got, want, REL, ELEM)


def _grads_match(jm, params, model, x, t, noise, text, **apply_kw):
    jd = jax_create_diffusion("")

    def loss_fn(p):
        fn = functools.partial(jm.apply, {"params": p}, **apply_kw)
        terms = jd.training_losses(fn, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                                   model_kwargs={"text_embedding": jnp.asarray(text)}, noise=jnp.asarray(noise))
        return jnp.mean(terms["loss"])

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    fn = functools.partial(model, **apply_kw)
    terms = create_diffusion("").training_losses(fn, torch.from_numpy(x), torch.from_numpy(t),
                                                 noise=torch.from_numpy(noise),
                                                 model_kwargs={"text_embedding": torch.from_numpy(text)})
    loss = terms["loss"].mean()
    loss.backward()
    close(loss, want_loss, LOSS_REL, LOSS_REL)
    want = flax_to_state_dict(want_grads, TINY["depth"], TINY["num_heads"], TINY["patch_size"])
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want) and PROJ in got
    for name in want:
        close(got[name], want[name].numpy(), GRAD_REL, ELEM)


def test_gradients_match_flax():
    """Loss and every gradient of the hybrid loss under full remat, the
    projection's among them."""
    jm, params, model = _latte(seed=5, gradient_checkpointing=True)
    x, noise, text = _inputs(seed=6)
    _grads_match(jm, params, model, x, np.array([1, 500]), noise, text, train=True)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_latte_img_forward_matches_flax(train):
    """Under ``train`` row 0 of the text conditions the 4 video frames and
    the temporal blocks, rows 1-2 the 2 images; otherwise all 6 frames are
    video frames under one row."""
    jm, params, model = _latte_img()
    x, _, text = _inputs(frames=4 + IMAGES, text_rows=1 + IMAGES if train else 1, seed=7)
    t = np.array([999, 17], np.int32)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), text_embedding=jnp.asarray(text),
                    train=train)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t), train=train, text_embedding=torch.from_numpy(text))
    close(got, want, REL, ELEM)


def test_latte_img_gradients_match_flax():
    jm, params, model = _latte_img(seed=8, gradient_checkpointing=True)
    x, noise, text = _inputs(frames=4 + IMAGES, text_rows=1 + IMAGES, seed=9)
    _grads_match(jm, params, model, x, np.array([3, 700]), noise, text, train=True)


def test_two_train_steps_match_jax():
    """Two AdamW/clip/EMA steps against the JAX ``make_train_step`` with
    ``extras=78`` (the batch's ``text_embedding`` into the model), the same
    t and noise on both sides, at ffs_train.yaml's learning rate, 1e-4. (At
    the other step tests' 1e-3 the first AdamW step moves each of the
    projection's 8.5 M weights by ±lr in a pattern that follows the
    features' signs, which raises the conditioning ~25x: there the port at
    the JAX step's own step-1 parameters is 3e-3 from its gradient, fp32
    chaos rather than a difference of the two steps.)"""
    lr = 1e-4
    jm, params, model = _latte(seed=10)
    x0, _, text = _inputs(seed=11)
    hp = dict(ema_decay=0.9, clip_max_norm=0.1, start_clip_iter=0)
    jopt = jax_make_optimizer(lr=lr, weight_decay=0.01)
    jstate = jax_create_train_state(params, jopt)
    jstep = jax.jit(jax_make_train_step(jm, jax_create_diffusion(""), jopt, extras=78, **hp))
    state = create_train_state(model, make_optimizer(model, 0.01), make_lr_schedule(lr))
    step = make_train_step(create_diffusion(""), **hp)
    rng = jax.random.PRNGKey(7)
    start = model.get_parameter(PROJ).detach().clone()
    for s, t in enumerate([np.array([3, 700]), np.array([1, 250])]):
        jbatch = {"latents": jnp.asarray(x0), "t": jnp.asarray(t, jnp.int32), "text_embedding": jnp.asarray(text)}
        jstate, want = jstep(jstate, jbatch, rng)
        batch = {"latents": torch.from_numpy(x0), "t": torch.from_numpy(t),
                 "noise": torch.from_numpy(_jax_noise(rng, s, x0.shape)), "text_embedding": torch.from_numpy(text)}
        got = step(state, batch, torch.Generator())
        for k in ("loss", "mse", "vb", "grad_norm"):
            close(got[k], want[k], GRAD_REL, ELEM)
    D = TINY["hidden_size"]
    for got, want in ((model, jstate.params), (state.ema, jstate.ema_params)):
        want = flax_to_state_dict(want, TINY["depth"], TINY["num_heads"], TINY["patch_size"])
        for name, p in got.named_parameters():
            g, w = p.detach().numpy(), want[name].numpy()
            if name.endswith("attn.qkv.bias"):  # see test_torch_train_step.py's note on AdamW
                g, w = np.delete(g, np.s_[D:2 * D]), np.delete(w, np.s_[D:2 * D])
            close(g, w, GRAD_REL, 2 * lr / np.abs(w).max())
    assert not torch.equal(model.get_parameter(PROJ).detach(), start)


# ---- the entry points --------------------------------------------------------

TRAIN_TINY = ["image_size=32", "num_frames=2", "local_batch_size=2", "log_every=1", "extras=78",
              "model_overrides={depth: 2, hidden_size: 32, num_heads: 2}"]


def test_synthetic_batches_match_jax():
    """Synthetic latents, then (B, 77, 768) standard-normal text features,
    from ``global_seed``, equal to the JAX trainer's draws."""
    over = TRAIN_TINY + ["data_path=/nonexistent", "global_seed=3"]
    log = logging.getLogger("test")
    it, kind = train.make_batch_iterator(load_config(FFS_TRAIN, over), log, 2)
    jit, jkind = jax_make_batch_iterator(jax_load_config(FFS_TRAIN, over), log, 2)
    assert kind == jkind == "synthetic_latents"
    for _ in range(2):
        got, want = next(it), next(jit)
        assert set(got) == set(want) == {"latents", "text_embedding"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert got["text_embedding"].shape == (2, 77, 768)


class Snapshot(Callback):
    def on_train_start(self, config, state, experiment_dir):
        self.state, self.start = state, state.model.get_parameter(PROJ).detach().clone()


def test_train_main_trains_the_projection(tmp_path):
    """``train.main`` on ffs_train.yaml with ``extras=78`` (synthetic
    latents and text) for 3 steps: finite, and the projection moved (in
    step 3: adaLN-Zero gives its gradient 0 until the modulations moved)."""
    cb = Snapshot()
    out = train.main(load_config(FFS_TRAIN, TRAIN_TINY + [f"results_dir={tmp_path}", "max_train_steps=3",
                                                          "data_path=/nonexistent"]),
                     callbacks=[cb], device="cpu")
    assert out["final_step"] == 3 and np.isfinite(out["loss"])
    proj = cb.state.model.text_embedding_projection
    assert proj.in_features == 77 * 768
    assert not torch.equal(proj.weight.detach(), cb.start)


def test_latte_img_synthetic_text_rows(tmp_path):
    """LatteIMG's synthetic text has a row per frame kind, (B, 1 + I, 768),
    the shape its model takes, and ``train.main`` runs on it."""
    over = TRAIN_TINY + [f"results_dir={tmp_path}", "data_path=/nonexistent", "use_image_num=2",
                         "max_train_steps=1"]
    cfg = load_config(os.path.join(REPO, "configs", "ffs", "ffs_img_train.yaml"), over)
    it, _ = train.make_batch_iterator(cfg, logging.getLogger("test"), 2)
    assert next(it)["text_embedding"].shape == (2, 3, 768)
    out = train.main(cfg, device="cpu")
    assert out["final_step"] == 1 and np.isfinite(out["loss"])


@pytest.mark.parametrize("case", ["dataset", "pixels", "sampler", "width"])
def test_refusals(case, tmp_path):
    """No dataset provides text embeddings (nor do synthetic pixels, as in
    JAX): ValueError. The sampler refuses extras: 78, whose JAX counterpart
    passes no text to its loop (NotImplementedError naming it). A JAX tree
    whose projection is not the model's width: ValueError naming it."""
    if case in ("dataset", "pixels"):
        data = [f"data_path={tmp_path}"] if case == "dataset" else ["synthetic_kind=pixels", "vae_ckpt=random"]
        cfg = load_config(FFS_TRAIN, TRAIN_TINY + [f"results_dir={tmp_path}/r", "max_train_steps=1", *data])
        with pytest.raises(ValueError, match="no dataset provides them"):
            train.main(cfg, device="cpu")
    elif case == "sampler":
        with pytest.raises(NotImplementedError, match="sample.py:341-349"):
            sample.check_config(load_config(os.path.join(REPO, "configs", "ffs", "ffs_sample.yaml"),
                                            ["extras=78"]))
    else:
        jm, params, _ = _latte()
        cfg = load_config(FFS_TRAIN, TRAIN_TINY)
        model = get_models(cfg)
        with pytest.raises(ValueError, match="77, 768"):
            load_flax_params(model, params)


def test_global_norm_of_a_wide_gradient():
    """The step's grad norm over the projection's 144 x 59136 gradient
    within 1e-6 of the fp64 norm (the CPU's fp32 norm is 3e-4 off there,
    which put the grad norm of the two steps above 6e-4 from the JAX
    step's)."""
    g = torch.randn((144, 77 * 768), generator=torch.Generator().manual_seed(0)) * 0.05
    small = torch.randn(100, generator=torch.Generator().manual_seed(1))
    want = torch.sqrt(g.double().square().sum() + small.double().square().sum()).item()
    assert abs(global_norm([g, small]).item() - want) <= 1e-6 * want
