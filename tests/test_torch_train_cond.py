"""Port parity for class-conditional training and LatteIMG: the label
dropout, the class-conditional train step against the JAX step, and the
joint video-image model (``LatteIMG``) against the Flax one, forward,
gradients under full remat, CFG and a class-conditional step with per-image
labels.

The JAX step draws its label dropout from its own rng. The tests take that
decision from the JAX model itself: it is applied with the step's dropout
rng and ``capture_intermediates`` on ``y_embedder``, and each output row
that equals the table's null row is a drop. The port gets the same decision
as ``force_drop_ids`` (and ``force_drop_ids_image``), as it gets the JAX
step's t and noise. The tiny models are those of test_torch_train.py
(depth 4, hidden 144, 2 heads, 4 video frames of 8x8 latents), with 2
still images for LatteIMG and a dropout rate of 0.5, so that both drops
and kept labels occur. All fp32.

Tolerances: forwards 1e-4 relative L2 and 1e-3 elementwise (as in
test_torch_model.py), gradients and two steps 1e-4 relative L2 (as in
test_torch_train.py and test_torch_train_step.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import ELEM, LOSS_REL, REL, TINY
from test_torch_train_step import _jax_noise
from torch_port_util import close, randomize

from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.models import Latte as JaxLatte
from latte_tpu.models.dit_img import LatteIMG as JaxLatteIMG
from latte_tpu.train.state import create_train_state as jax_create_train_state
from latte_tpu.train.state import make_optimizer as jax_make_optimizer
from latte_tpu.train.step import make_train_step as jax_make_train_step
from latte_tpu_torch.config import Config
from latte_tpu_torch.convert import flax_to_state_dict, load_flax_params
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.models import Latte, LatteIMG
from latte_tpu_torch.models.embeddings import LabelEmbedder
from latte_tpu_torch.sample.sample import sample_loop
from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
from latte_tpu_torch.train.step import make_train_step

NUM_CLASSES, IMAGES = 5, 2
COND = dict(TINY, extras=2, num_classes=NUM_CLASSES, class_dropout_prob=0.5)


def _inputs(B=2, frames=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, frames, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, B).astype(np.int32)
    y_image = rng.integers(0, NUM_CLASSES, (B, IMAGES)).astype(np.int32)
    return x, noise, y, y_image


def _init(jm, x, seed=1, **kw):
    rngs = {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)}
    params = jm.init(rngs, jnp.asarray(x), jnp.zeros((x.shape[0],), jnp.int32), **kw)["params"]
    return randomize(params, seed=seed, std=0.1)


def _is_y_embedder(module, method_name):
    return module.name == "y_embedder"


def _jax_apply(jm, params, x, t, drop_rng, **kw):
    """The JAX model's output under ``train=True`` with ``drop_rng`` as its
    label-dropout rng, and its drop decisions: one (B,) array for ``y`` and,
    with still images, one (B, I) array for ``y_image`` (1 = dropped)."""
    out, state = jm.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), train=True,
        rngs={"label_dropout": drop_rng}, capture_intermediates=_is_y_embedder,
        mutable=["intermediates"], **kw,
    )
    calls = state.get("intermediates", {}).get("y_embedder", {}).get("__call__", ())
    null = params["y_embedder"]["embedding_table"][NUM_CLASSES] if calls else None
    return out, [jnp.all(e == null, axis=-1) for e in calls]


def _jax_drops(jm, params, x, t, drop_rng, **kw):
    """The drop decisions of ``_jax_apply`` alone, from the same model with
    XLA attention, jitted: the label-dropout rng of ``y_embedder`` depends
    on the module tree and the rng, not on how the blocks attend."""
    fn = jax.jit(lambda p, xx, tt, r, labels: _jax_apply(jm.clone(attention_mode="xla"), p, xx, tt, r, **labels)[1])
    return [np.asarray(d) for d in fn(params, jnp.asarray(x), jnp.asarray(t), drop_rng, kw)]


def _drop_kwargs(drops):
    names = ("force_drop_ids", "force_drop_ids_image")
    return {name: torch.from_numpy(np.asarray(d, np.int64)) for name, d in zip(names, drops)}


# ---- the label dropout ------------------------------------------------------


def test_label_dropout_rate_is_dropout_prob():
    """Under ``train`` each label drops with probability ``dropout_prob``:
    the share of 20000 draws within 5 binomial standard deviations."""
    emb = LabelEmbedder(NUM_CLASSES, 8, dropout_prob=0.1)
    labels = torch.randint(0, NUM_CLASSES, (20000,), generator=torch.Generator().manual_seed(0))
    out = emb(labels, train=True, generator=torch.Generator().manual_seed(1))
    dropped = (out == emb.embedding_table.weight[NUM_CLASSES]).all(dim=-1).double().mean().item()
    assert abs(dropped - 0.1) <= 5 * (0.1 * 0.9 / 20000) ** 0.5, dropped
    # the same generator seed draws the same decision
    again = emb(labels, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(out, again)


def test_label_dropout_only_under_train():
    """``train=False`` never drops, whatever ``nn.Module.training`` says and
    with or without a generator; ``force_drop_ids`` decides alone."""
    emb = LabelEmbedder(NUM_CLASSES, 8, dropout_prob=0.9).train()
    labels = torch.arange(NUM_CLASSES).repeat(20)
    want = emb.embedding_table(labels)
    assert torch.equal(emb(labels), want)
    assert torch.equal(emb(labels, generator=torch.Generator().manual_seed(0)), want)
    force = (labels % 2).long()
    got = emb(labels, train=True, force_drop_ids=force, generator=torch.Generator().manual_seed(0))
    assert torch.equal(got, emb.embedding_table(torch.where(force == 1, NUM_CLASSES, labels)))


@pytest.mark.parametrize("method", ["ddpm", "ddim"])
def test_train_mode_model_samples_as_in_eval_mode(method):
    """A class-conditional model left in ``.train()`` mode (as the trainer's
    EMA copy is) samples exactly the latents of the same model in
    ``.eval()`` mode, with CFG and with DDPM's noise from a generator."""
    model = Latte(**dict(COND, class_dropout_prob=0.1))
    model.initialize_weights(torch.Generator().manual_seed(0))
    cfg = Config(num_sampling_steps=3, sample_method=method, cfg_scale=4.0, extras=2)
    z = torch.randn((2, 4, 4, 8, 8), generator=torch.Generator().manual_seed(1))
    y = torch.tensor([1, 3])

    def run(m):
        return sample_loop(m, cfg, z, y, torch.Generator().manual_seed(2))

    assert torch.equal(run(model.train()), run(model.eval()))


# ---- the class-conditional step --------------------------------------------


def _state_matches(model, ema, jstate, D):
    """Every parameter and EMA leaf within 1e-4 relative L2 and 2·lr
    elementwise, the k part of each qkv bias left out (see
    test_torch_train_step.py's note on AdamW)."""
    for got, want in ((model, jstate.params), (ema, jstate.ema_params)):
        want = flax_to_state_dict(want, TINY["depth"], TINY["num_heads"], TINY["patch_size"])
        for name, p in got.named_parameters():
            g, w = p.detach().numpy(), want[name].numpy()
            if name.endswith("attn.qkv.bias"):
                g, w = np.delete(g, np.s_[D:2 * D]), np.delete(w, np.s_[D:2 * D])
            close(g, w, REL, 2e-3 / np.abs(w).max())


@pytest.mark.parametrize("image_model", [False, True], ids=["Latte", "LatteIMG"])
def test_class_conditional_steps_match_jax(image_model):
    """Two AdamW/clip/EMA steps of a class-conditional model (LatteIMG with
    per-image labels ``y_image``) against the JAX step, with the JAX step's
    t, noise and label-dropout decisions handed to the port."""
    frames = TINY["num_frames"] + (IMAGES if image_model else 0)
    x0, _, y, y_image = _inputs(frames=frames, seed=2)
    if image_model:
        jm = JaxLatteIMG(**COND, attention_mode="flash", use_image_num=IMAGES)
        params = _init(jm, x0, y=jnp.asarray(y), y_image=jnp.asarray(y_image), train=True)
        model = load_flax_params(LatteIMG(**COND, use_image_num=IMAGES), params)
        labels = dict(y=y, y_image=y_image)
    else:
        jm = JaxLatte(**COND, attention_mode="flash", fused_adaln=True)
        params = _init(jm, x0, y=jnp.asarray(y))
        model = load_flax_params(Latte(**COND), params)
        labels = dict(y=y)
    hp = dict(ema_decay=0.9, clip_max_norm=0.1, start_clip_iter=0)
    jopt = jax_make_optimizer(lr=1e-3, weight_decay=0.01)
    jstate = jax_create_train_state(params, jopt)
    jstep = jax.jit(jax_make_train_step(jm, jax_create_diffusion(""), jopt, extras=2, **hp))
    state = create_train_state(model, make_optimizer(model, 0.01), make_lr_schedule(1e-3))
    step = make_train_step(create_diffusion(""), **hp)
    rng = jax.random.PRNGKey(7)
    jd, seen = jax_create_diffusion(""), []
    for s, t in enumerate([np.array([3, 700]), np.array([1, 250])]):
        jbatch = {"latents": jnp.asarray(x0), "t": jnp.asarray(t, jnp.int32),
                  **{k: jnp.asarray(v) for k, v in labels.items()}}
        noise = _jax_noise(rng, s, x0.shape)
        # the drop decisions of this step: its dropout rng, the model at its
        # current parameters (the decision does not depend on them)
        _, _, drop_rng, _ = jax.random.split(jax.random.fold_in(rng, s), 4)
        x_t = jd.q_sample(jnp.asarray(x0), jnp.asarray(t, jnp.int32), noise=jnp.asarray(noise))
        drops = _jax_drops(jm, jstate.params, x_t, t, drop_rng, **{k: jnp.asarray(v) for k, v in labels.items()})
        seen.extend(np.concatenate([np.asarray(d).reshape(-1) for d in drops]))
        jstate, want = jstep(jstate, jbatch, rng)
        batch = {"latents": torch.from_numpy(x0), "t": torch.from_numpy(t), "noise": torch.from_numpy(noise),
                 **{k: torch.from_numpy(v) for k, v in labels.items()}, **_drop_kwargs(drops)}
        got = step(state, batch, torch.Generator())
        for k in ("loss", "mse", "vb", "grad_norm"):
            close(got[k], want[k], REL, ELEM)
    assert 0 < np.mean(seen) < 1, seen  # labels both dropped and kept
    _state_matches(model, state.ema, jstate, TINY["hidden_size"])


# ---- LatteIMG ---------------------------------------------------------------


def _img_models(extras, **kw):
    cfg = dict(TINY, use_image_num=IMAGES, **(COND if extras == 2 else {}), **kw)
    jm = JaxLatteIMG(**cfg, attention_mode="flash")
    x0, _, y, y_image = _inputs(frames=TINY["num_frames"] + IMAGES, seed=3)
    kw = dict(y=jnp.asarray(y), y_image=jnp.asarray(y_image)) if extras == 2 else {}
    params = _init(jm, x0, **kw, train=True)
    return jm, params, load_flax_params(LatteIMG(**cfg), params), x0, y, y_image


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("extras", [1, 2], ids=["uncond", "class"])
def test_latte_img_forward_matches_flax(extras, train):
    """Under ``train`` the temporal blocks see the 4 video frames and the 2
    images pass them by (with their own labels when class-conditional);
    otherwise all 6 frames are video frames."""
    jm, params, model, x0, y, y_image = _img_models(extras)
    t = np.array([999, 17], np.int32)
    kw, tkw = {}, {}
    if extras == 2:
        kw = dict(y=jnp.asarray(y), y_image=jnp.asarray(y_image))
        tkw = dict(y=torch.from_numpy(y), y_image=torch.from_numpy(y_image))
    if train:
        want, drops = _jax_apply(jm, params, x0, t, jax.random.PRNGKey(5), **kw)
        tkw.update(_drop_kwargs(drops))
    else:
        want = jm.apply({"params": params}, jnp.asarray(x0), jnp.asarray(t), **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(x0), torch.from_numpy(t), train=train, **tkw)
    close(got, want, REL, ELEM)
    if train:  # the images' outputs differ from an all-video forward's
        with torch.no_grad():
            video = model(torch.from_numpy(x0), torch.from_numpy(t), **{k: v for k, v in tkw.items()
                                                                       if k in ("y", "y_image")})
        assert not torch.allclose(got[:, TINY["num_frames"]:], video[:, TINY["num_frames"]:])


@pytest.mark.parametrize("extras", [1, 2], ids=["uncond", "class"])
def test_latte_img_gradients_match_flax(extras):
    """Loss and every gradient of the hybrid loss through LatteIMG under
    full remat (``gradient_checkpointing``), train mode."""
    jm, params, model, x0, y, y_image = _img_models(extras, gradient_checkpointing=True)
    _, noise, _, _ = _inputs(frames=x0.shape[1], seed=4)
    t = np.array([1, 500])
    kw = dict(y=jnp.asarray(y), y_image=jnp.asarray(y_image)) if extras == 2 else {}
    drop_rng = jax.random.PRNGKey(9)
    drops = _jax_drops(jm, params, x0, t, drop_rng, **kw)
    jd = jax_create_diffusion("")

    def loss_fn(p):
        fn = functools.partial(jm.apply, {"params": p}, train=True, rngs={"label_dropout": drop_rng})
        terms = jd.training_losses(fn, jnp.asarray(x0), jnp.asarray(t, jnp.int32),
                                   model_kwargs=kw, noise=jnp.asarray(noise))
        return jnp.mean(terms["loss"])

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    tkw = {}
    if extras == 2:
        tkw = dict(y=torch.from_numpy(y), y_image=torch.from_numpy(y_image), **_drop_kwargs(drops))
    fn = functools.partial(model, train=True)
    terms = create_diffusion("").training_losses(fn, torch.from_numpy(x0), torch.from_numpy(t),
                                                 noise=torch.from_numpy(noise), model_kwargs=tkw)
    loss = terms["loss"].mean()
    loss.backward()
    close(loss, want_loss, LOSS_REL, LOSS_REL)
    want = flax_to_state_dict(want_grads, TINY["depth"], TINY["num_heads"], TINY["patch_size"])
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        close(got[name], want[name].numpy(), REL, ELEM)


def test_latte_img_cfg_and_conversion_match_flax():
    """``forward_with_cfg`` (sampling: every frame a video frame), and the
    conversion: LatteIMG's Flax tree maps onto the port's parameters as
    Latte's does, every weight carried, the load strict."""
    jm, params, model, x0, y, _ = _img_models(2)
    t = np.array([500, 500], np.int32)
    yy = np.array([y[0], NUM_CLASSES], np.int32)
    want = jm.apply({"params": params}, jnp.asarray(x0), jnp.asarray(t), y=jnp.asarray(yy),
                    cfg_scale=4.0, method=JaxLatteIMG.forward_with_cfg)
    with torch.no_grad():
        got = model.forward_with_cfg(torch.from_numpy(x0), torch.from_numpy(t), y=torch.from_numpy(yy),
                                     cfg_scale=4.0)
    close(got, want, REL, ELEM)
    sd = flax_to_state_dict(params, TINY["depth"], TINY["num_heads"], TINY["patch_size"])
    assert set(sd) == set(Latte(**COND).state_dict()) == set(model.state_dict())
    assert sum(np.size(a) for a in jax.tree_util.tree_leaves(params)) == sum(v.numel() for v in sd.values())
