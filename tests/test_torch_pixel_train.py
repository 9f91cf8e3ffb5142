"""Pixel training in the port against the JAX package, on the CPU at a tiny
size: Latte-S/2 at hidden 32 and depth 2, the JAX tests' tiny VAE (f2,
channels 8/16) carried over with ``flax_vae_to_state_dict``, 32² frames, 4
frames a clip. The uint8 dequantize and the encode's moments against JAX's,
the fused-encode step against the latent-cache step, the latent-cache
writer against JAX's (each side reads the other's cache), the trainer from
a folder of mp4s, from the cache and from synthetic pixels, and what it
refuses. Everything written goes to tmp_path.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vae import perturbed_params
from torch_port_util import close

import latte_tpu.tools.cache_latents as jax_cache_mod
import latte_tpu.train.train as jax_train_mod
from latte_tpu.config import Config as JaxConfig
from latte_tpu.data.latents import LatentCacheDataset as JaxLatentCacheDataset
from latte_tpu.utils import save_video
from latte_tpu.vae import autoencoder_kl as jvae
from latte_tpu_torch.config import load_config
from latte_tpu_torch.convert import flax_vae_to_state_dict
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.data import LatentCacheDataset
from latte_tpu_torch.models import get_model
from latte_tpu_torch.tools import cache_latents
from latte_tpu_torch.train import train
from latte_tpu_torch.train.callbacks import Callback
from latte_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
from latte_tpu_torch.train.step import dequantize_video, make_train_step
from latte_tpu_torch.vae import autoencoder_kl as tvae

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFS_TRAIN = os.path.join(REPO, "configs", "ffs", "ffs_train.yaml")
SIZE, FRAMES, LATENT = 32, 4, 16  # the tiny VAE is f2
TINY = [
    "model=Latte-S/2", "model_overrides={depth: 2, hidden_size: 32, num_heads: 2}",
    f"image_size={SIZE}", f"latent_size={LATENT}", f"num_frames={FRAMES}", "frame_interval=1",
    "local_batch_size=2", "log_every=1", "ckpt_every=100", "num_workers=1", "global_seed=0",
    "cache_batch_size=3",
]
MOMENT_REL = 1e-5


@pytest.fixture(scope="module")
def vae_params():
    """The JAX tiny VAE's init with every bias and GroupNorm scale perturbed
    (numpy seed 0), so each carries signal."""
    return perturbed_params(jvae.tiny_vae(), jnp.zeros((1, 3, SIZE, SIZE)))


@pytest.fixture
def tiny_vae(vae_params, monkeypatch):
    """The trainer's VAE swapped for the tiny one on the port's side; the
    rest of ``build_encode_fn`` (the encode, its posterior sample) runs."""

    def build_vae(vae_ckpt, device, tiny=False):
        vae = tvae.tiny_vae()
        vae.load_state_dict(flax_vae_to_state_dict(vae_params), strict=True)
        return vae.to(device).eval()

    monkeypatch.setattr(train, "build_vae", build_vae)


def _jax_build_encode_fn(vae_params):
    """``build_encode_fn`` of the JAX trainer over the tiny VAE (as
    ``tests/test_latent_cache.py`` builds it, without the orbax file)."""
    vae = jvae.tiny_vae()

    def build(config):
        scale = float(getattr(config, "vae_scale", 0.18215))

        def encode(video, rng, params):
            B, F = video.shape[:2]
            post = vae.apply(params, video.reshape(B * F, *video.shape[2:]), method=vae.encode)
            z = post.sample(rng) * scale
            return z.reshape(B, F, *z.shape[1:])

        encode.raw = lambda flat, params: vae.apply(params, flat, method=vae.encode)
        return encode, {"params": vae_params}

    return build


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(3)
    for i in range(4):
        save_video(str(d / f"{i:03d}.mp4"), (rng.random((10, SIZE, SIZE, 3)) * 255).astype(np.uint8))
    return str(d)


def _cfg(tmp_path, *extra):
    return load_config(FFS_TRAIN, TINY + [f"results_dir={tmp_path}/results", *extra])


def test_uint8_dequantize_matches_jax_to_the_bit():
    x = np.concatenate([
        np.arange(256, dtype=np.uint8),
        np.random.default_rng(0).integers(0, 256, 4096, dtype=np.uint8),
    ]).reshape(2, 4, 2, 272)
    got = dequantize_video(torch.from_numpy(x))
    want = np.asarray(jnp.asarray(x).astype(jnp.float32) / 127.5 - 1.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    f = torch.rand(3, 4)
    assert dequantize_video(f) is f  # fp32 pixels pass through


def test_encode_moments_match_jax(tiny_vae, vae_params):
    """The trainer's encode on (B, F, 3, H, W) frames: the posterior's mean
    and std within 1e-5 relative L2 of the JAX encode; the sample it returns
    is (mean + std · eps) · vae_scale with eps from the generator, drawn on
    the frame-flattened layout."""
    encode = train.build_encode_fn(_cfg("/unused", "vae_ckpt=random"), torch.device("cpu"))
    video = np.random.default_rng(9).uniform(-1, 1, (2, FRAMES, 3, SIZE, SIZE)).astype(np.float32)
    flat = video.reshape(2 * FRAMES, 3, SIZE, SIZE)
    jvae_ = jvae.tiny_vae()
    jpost = jvae_.apply({"params": vae_params}, jnp.asarray(flat), method=jvae_.encode)
    post = encode.raw(torch.from_numpy(flat))
    close(post.mean, jpost.mean, MOMENT_REL)
    close(post.std, jpost.std, MOMENT_REL)
    assert not post.mean.requires_grad and not any(p.requires_grad for p in encode.vae.parameters())
    z = encode(torch.from_numpy(video), torch.Generator().manual_seed(4))
    eps = torch.randn(post.mean.shape, generator=torch.Generator().manual_seed(4))
    want = ((post.mean + post.std * eps) * 0.18215).reshape(2, FRAMES, 4, LATENT, LATENT)
    torch.testing.assert_close(z, want, rtol=0, atol=0)


def test_fused_encode_step_loss_equals_cached_moments_loss(tiny_vae):
    """The port's mirror of ``tests/test_latent_cache.py``: the same pixels
    and generator seed give the same loss through the fused encode as
    through their cached moments (the posterior sample is drawn first, on
    the same layout), to the bit; and a uint8 batch the loss of its
    dequantized fp32 pixels."""
    cfg = _cfg("/unused", "vae_ckpt=random")
    encode = train.build_encode_fn(cfg, torch.device("cpu"))
    model = get_model("Latte-S/2", input_size=LATENT, num_frames=FRAMES, hidden_size=32, depth=2, num_heads=2)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # no zero-initialised layer: the output depends on the latents
        for p in model.parameters():
            p.normal_(0, 0.05, generator=gen)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    video_u8 = torch.from_numpy(
        np.random.default_rng(9).integers(0, 256, (2, FRAMES, 3, SIZE, SIZE), dtype=np.uint8))
    video = dequantize_video(video_u8)
    post = encode.raw(video.reshape(2 * FRAMES, 3, SIZE, SIZE))
    cached = {
        "latent_mean": post.mean.reshape(2, FRAMES, 4, LATENT, LATENT).contiguous(),
        "latent_std": post.std.reshape(2, FRAMES, 4, LATENT, LATENT).contiguous(),
    }
    losses = {}
    for name, batch, encode_fn in (("fused", {"video": video}, encode), ("uint8", {"video": video_u8}, encode),
                                   ("cached", cached, None)):
        model.load_state_dict(weights)
        state = create_train_state(model, make_optimizer(model), make_lr_schedule(1e-3))
        step = make_train_step(create_diffusion(""), vae_scale=0.18215, encode_fn=encode_fn)
        losses[name] = step(state, batch, torch.Generator().manual_seed(7))["loss"]
    assert torch.isfinite(losses["cached"])
    assert losses["fused"].item() == losses["cached"].item() == losses["uint8"].item()
    with pytest.raises(ValueError, match="no encode_fn"):
        make_train_step(create_diffusion(""))(state, {"video": video}, torch.Generator())


def test_cache_latents_matches_jax_and_each_side_reads_the_other(tiny_vae, vae_params, video_dir,
                                                                  tmp_path, monkeypatch):
    """Both writers over the same mp4 folder and config: the same items
    (the datasets draw the same clips), the same metadata, the moments
    within 1e-5 relative L2; the port's and JAX's LatentCacheDataset read
    the port's cache alike."""
    monkeypatch.setattr(jax_train_mod, "build_encode_fn", _jax_build_encode_fn(vae_params))
    over = TINY + [f"data_path={video_dir}", "vae_ckpt=random"]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cache_latents.main(load_config(FFS_TRAIN, over), port_dir, device="cpu") == port_dir
    jax_cache_mod.main(JaxConfig(load_config(FFS_TRAIN, over).to_dict()), jax_dir)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == \
        [f"{i:06d}.npz" for i in range(4)] + ["latent_cache.json"]
    meta = json.load(open(os.path.join(port_dir, "latent_cache.json")))
    assert meta == json.load(open(os.path.join(jax_dir, "latent_cache.json")))
    assert meta["num_items"] == 4 and meta["frames"] == FRAMES and meta["latent_shape"] == [4, LATENT, LATENT]
    ours, theirs, jax_reads = LatentCacheDataset(port_dir), JaxLatentCacheDataset(jax_dir), \
        JaxLatentCacheDataset(port_dir)
    for i in range(4):
        got, want, read = ours[i], theirs[i], jax_reads[i]
        assert set(got) == set(want) == set(read) == {"latent_mean", "latent_std"}
        for k in want:
            assert got[k].shape == (FRAMES, 4, LATENT, LATENT) and got[k].dtype == np.float32
            close(got[k], want[k], MOMENT_REL)
            np.testing.assert_array_equal(read[k], got[k])
    assert LatentCacheDataset(jax_dir).meta == meta


def test_cache_latents_cli_and_its_refusals(tiny_vae, video_dir, tmp_path):
    """``--out`` defaults to ``<data_path>_latents``; an empty folder and a
    config without a VAE are refused."""
    data = tmp_path / "clips"
    data.mkdir()
    for f in sorted(os.listdir(video_dir))[:2]:
        os.symlink(os.path.join(video_dir, f), data / f)
    out = cache_latents.cli(["--config", FFS_TRAIN, "--device", "cpu", *TINY, f"data_path={data}/",
                             "vae_ckpt=random"])
    assert out == f"{data}_latents" and len(LatentCacheDataset(out)) == 2
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no videos under"):
        cache_latents.main(load_config(FFS_TRAIN, TINY + [f"data_path={tmp_path}/empty", "vae_ckpt=random"]),
                           str(tmp_path / "c1"), device="cpu")
    with pytest.raises(ValueError, match="needs vae_ckpt"):
        cache_latents.main(load_config(FFS_TRAIN, TINY + [f"data_path={data}"]), str(tmp_path / "c2"),
                           device="cpu")


@pytest.mark.parametrize("source", ["videos", "cache", "synthetic_pixels"])
def test_cli_trains_from_pixels_and_from_the_cache(tiny_vae, video_dir, tmp_path, monkeypatch, source):
    """``train.main`` two steps from a folder of mp4s (uint8 transport, the
    fused encode), from the port's latent cache of it, and from synthetic
    uint8 pixels; the frozen VAE is in neither the optimizer, the EMA nor
    the checkpoint."""
    if source == "cache":
        data_path = cache_latents.main(load_config(FFS_TRAIN, TINY + [f"data_path={video_dir}", "vae_ckpt=random"]),
                                       str(tmp_path / "cache"), device="cpu")
        extra = [f"data_path={data_path}"]
    elif source == "videos":
        extra = [f"data_path={video_dir}", "vae_ckpt=random"]
    else:
        extra = [f"data_path={tmp_path}/missing", "synthetic_kind=pixels", "vae_ckpt=random"]
    kinds, built = [], []
    real_iterator, real_build = train.make_batch_iterator, train.build_encode_fn

    def spy_iterator(*a):
        batches, kind = real_iterator(*a)
        kinds.append(kind)
        return batches, kind

    def spy_build(*a):
        built.append(real_build(*a))
        return built[-1]

    class KeepState(Callback):
        def on_train_start(self, config, state, experiment_dir):
            self.state = state

    monkeypatch.setattr(train, "make_batch_iterator", spy_iterator)
    monkeypatch.setattr(train, "build_encode_fn", spy_build)
    keep = KeepState()
    out = train.main(_cfg(tmp_path, "max_train_steps=2", *extra), callbacks=[keep], device="cpu")
    assert out["final_step"] == 2 and np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])
    assert kinds == [{"videos": "real", "cache": "latents_cached", "synthetic_pixels": "synthetic_pixels"}[source]]
    assert len(built) == (source != "cache")
    state = keep.state
    optimized = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert optimized == {id(p) for p in state.model.parameters()}
    if built:
        assert not optimized & {id(p) for p in built[0].vae.parameters()}
    payload = load_checkpoint(latest_checkpoint(os.path.join(out["experiment_dir"], "checkpoints")))
    assert set(payload["model"]) == set(payload["ema"]) == set(state.model.state_dict())
    assert not any(n.startswith(("encoder.", "decoder.", "quant_conv")) for n in payload["model"])


@pytest.mark.parametrize("case", ["pixels_without_vae", "missing_vae_ckpt", "vae_ckpt_directory"])
def test_pixel_data_refusals(tmp_path, case):
    """Pixels with no VAE raise ``ValueError``; a ``vae_ckpt`` that does not
    exist ``FileNotFoundError``, as in the JAX trainer; a directory
    ``NotImplementedError`` naming the conversion."""
    extra = [f"data_path={tmp_path}/missing", "synthetic_kind=pixels", "max_train_steps=1"]
    error, match = {
        "pixels_without_vae": (ValueError, "no VAE is configured"),
        "missing_vae_ckpt": (FileNotFoundError, "does not exist"),
        "vae_ckpt_directory": (NotImplementedError, "flax_vae_to_state_dict"),
    }[case]
    if case == "missing_vae_ckpt":
        extra.append(f"vae_ckpt={tmp_path}/vae.bin")
    elif case == "vae_ckpt_directory":
        extra.append(f"vae_ckpt={tmp_path}")
    with pytest.raises(error, match=match):
        train.main(_cfg(tmp_path, *extra), device="cpu")
