"""The port's training entry point and its data: the latent-cache iterator
against the JAX package's on a cache in its layout, the CLI on the CPU at a
tiny size (checkpoint, resume, the sampler loading the trained EMA), its
refusal to run on a missing GPU, and the options the port does not carry
yet.
Everything written goes to tmp_path.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from latte_tpu.config import load_config as jax_load_config
from latte_tpu.train.train import make_batch_iterator as jax_make_batch_iterator
from latte_tpu_torch.config import load_config
from latte_tpu_torch.sample import sample
from latte_tpu_torch.train import train
from latte_tpu_torch.train.callbacks import CallbackList, EarlyStopOnNaN
from latte_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
from latte_tpu_torch.train.step import _latents

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFS_TRAIN = os.path.join(REPO, "configs", "ffs", "ffs_train.yaml")
FFS_SAMPLE = os.path.join(REPO, "configs", "ffs", "ffs_sample.yaml")
ARCH = ["image_size=32", "num_frames=2", "model_overrides={depth: 2, hidden_size: 32, num_heads: 2}"]
TINY = ARCH + ["local_batch_size=2", "log_every=1", "learning_rate=1e-3"]


def _cfg(tmp_path, *extra):
    return load_config(FFS_TRAIN, TINY + [f"results_dir={tmp_path}/results", *extra])


def _write_cache(path, n=5, frames=2, shape=(4, 4, 4), scale=0.25, seed=0):
    """A latent cache in latte_tpu/data/latents.py's layout."""
    rng = np.random.default_rng(seed)
    os.makedirs(path)
    meta = dict(num_items=n, frames=frames, latent_shape=list(shape), vae_scale=scale, source="test")
    with open(os.path.join(path, "latent_cache.json"), "w") as f:
        json.dump(meta, f)
    for i in range(n):
        np.savez(
            os.path.join(path, f"{i:06d}.npz"),
            latent_mean=rng.standard_normal((frames, *shape)).astype(np.float32),
            latent_std=rng.random((frames, *shape)).astype(np.float32),
        )


def test_latent_cache_iterator_matches_jax(tmp_path):
    """Same cache, seed and one worker: the port's iterator yields the JAX
    iterator's batches, and both take the cache's vae_scale."""
    cache = str(tmp_path / "cache")
    _write_cache(cache)
    over = [f"data_path={cache}", "num_workers=1", "global_seed=3", "vae_scale=0.18215"]
    cfg, jcfg = load_config(FFS_TRAIN, over), jax_load_config(FFS_TRAIN, over)
    log = logging.getLogger("test")
    it, kind = train.make_batch_iterator(cfg, log, 2)
    jit, jkind = jax_make_batch_iterator(jcfg, log, 2)
    assert kind == jkind == "latents_cached"
    assert cfg.vae_scale == jcfg.vae_scale == 0.25
    for _ in range(3):  # crosses an epoch boundary (5 items, batches of 2)
        got, want = next(it), next(jit)
        assert set(got) == set(want) == {"latent_mean", "latent_std"}
        for k in want:
            assert got[k].shape == (2, 2, 4, 4, 4)
            np.testing.assert_array_equal(got[k], want[k])
    # the step's posterior sample from the cached moments
    batch = {k: torch.from_numpy(v) for k, v in got.items()}
    lat = _latents(batch, torch.Generator().manual_seed(1), 0.25)
    eps = torch.randn((4, 4, 4, 4), generator=torch.Generator().manual_seed(1))
    want = (batch["latent_mean"].reshape(4, 4, 4, 4) + batch["latent_std"].reshape(4, 4, 4, 4) * eps) * 0.25
    torch.testing.assert_close(lat, want.reshape(2, 2, 4, 4, 4), rtol=0, atol=0)


def test_cli_trains_checkpoints_resumes_and_feeds_the_sampler(tmp_path):
    out = train.cli(["--config", FFS_TRAIN, "--device", "cpu", *TINY,
                     f"results_dir={tmp_path}/results", "max_train_steps=3", "ckpt_every=2"])
    assert out["final_step"] == 3 and np.isfinite(out["loss"]) and out["steps_per_sec"] > 0
    assert set(out) == {"experiment_dir", "final_step", "loss", "grad_norm", "steps_per_sec"}
    ckpt_dir = os.path.join(out["experiment_dir"], "checkpoints")
    assert sorted(os.listdir(ckpt_dir)) == ["0000002.pt", "0000003.pt"]
    assert os.path.exists(os.path.join(out["experiment_dir"], "config.yaml"))
    payload = load_checkpoint(latest_checkpoint(ckpt_dir))
    assert set(payload) == {"model", "ema", "opt", "step", "args"} and payload["step"] == 3
    assert payload["args"]["model"] == "Latte-XL/2"

    # resume from step 2: the run starts from that state exactly (model, EMA,
    # AdamW moments, step) and carries on to step 3
    at_two = load_checkpoint(os.path.join(ckpt_dir, "0000002.pt"))

    class CheckStart(EarlyStopOnNaN):
        def on_train_start(self, config, state, experiment_dir):
            assert state.step == 2
            for name, v in state.model.state_dict().items():
                assert torch.equal(v, at_two["model"][name]), name
            for name, v in state.ema.state_dict().items():
                assert torch.equal(v, at_two["ema"][name]), name
            for s, want in zip(state.optimizer.state.values(), at_two["opt"]["state"].values()):
                assert torch.equal(s["exp_avg_sq"], want["exp_avg_sq"])

    cfg = _cfg(tmp_path, "max_train_steps=3", f"resume_from_checkpoint={ckpt_dir}/0000002.pt")
    resumed = train.main(cfg, callbacks=[CheckStart()], device="cpu")
    assert resumed["final_step"] == 3 and np.isfinite(resumed["loss"])
    again = load_checkpoint(latest_checkpoint(os.path.join(resumed["experiment_dir"], "checkpoints")))
    assert again["step"] == 3

    # the port's sampler loads the trained EMA (find_model prefers it)
    scfg = load_config(FFS_SAMPLE, ARCH + [
        "use_fp16=false", "sample_method=ddim", "num_sampling_steps=3",
        f"ckpt={ckpt_dir}/0000003.pt", f"save_video_path={tmp_path}/v.mp4",
    ])
    model = sample.build_model(scfg, torch.device("cpu"))
    for name, v in model.state_dict().items():
        assert torch.equal(v, payload["ema"][name]), name
    assert any(not torch.equal(payload["ema"][k], payload["model"][k]) for k in payload["ema"])
    lat = np.load(sample.main(scfg, device="cpu"))["latents"]
    assert lat.shape == (1, 2, 4, 4, 4) and np.isfinite(lat).all()


def test_cli_with_loss_aware_sampler_and_early_stop(tmp_path):
    cfg = _cfg(tmp_path, "max_train_steps=4", "ckpt_every=100", "schedule_sampler=loss-second-moment",
               "lr_schedule=cosine", "lr_warmup_steps=1", "mixed_precision=true", "ema_every=2")

    class StopAfterTwo(EarlyStopOnNaN):
        def should_stop(self, step, metrics):
            return super().should_stop(step, metrics) or step == 2

    out = train.main(cfg, callbacks=[StopAfterTwo()], device="cpu")
    assert out["final_step"] == 2 and np.isfinite(out["loss"])
    assert "amp" in os.path.basename(out["experiment_dir"])
    assert os.listdir(os.path.join(out["experiment_dir"], "checkpoints")) == ["0000002.pt"]
    nan_stop = EarlyStopOnNaN()
    assert CallbackList([nan_stop]).should_stop(5, {"loss": float("nan")}) and nan_stop.tripped


def test_entry_point_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(_cfg(tmp_path, "max_train_steps=1"))
    assert not os.path.exists(tmp_path / "results")


@pytest.mark.parametrize(
    "override",
    [
        "expert_parallel=2",
        "tensor_parallel=2",
        "sequence_parallel=2",
        "pipeline_parallel=2",
        "fsdp=true",
        "zero1=true",
        "coordinator_address=localhost:1234",
        "num_processes=2",
        "process_id=1",
    ],
)
def test_unported_options_raise(tmp_path, override):
    """The multi-GPU keys in one process: a ``tensor_parallel``,
    ``sequence_parallel``, ``pipeline_parallel`` or ``expert_parallel`` the
    world size does not divide, and ``num_processes`` without a coordinator,
    raise as the JAX trainer does; ``fsdp``, ``zero1`` and a lone ``coordinator_address`` or
    ``process_id`` train on one device, as the JAX trainer's one-device
    mesh does (their multi-process runs: tests/test_torch_dist_train.py,
    tests/test_torch_dist_tp.py)."""
    cfg = _cfg(tmp_path, "max_train_steps=1", override)
    key = override.split("=")[0]
    if key in ("tensor_parallel", "sequence_parallel", "pipeline_parallel", "expert_parallel"):
        with pytest.raises(AssertionError, match=f"{key}=2 x .*must divide 1 devices|{key}=2 must divide 1 devices"):
            train.main(cfg, device="cpu")
    elif key == "num_processes":
        with pytest.raises(ValueError, match="needs coordinator_address"):
            train.main(cfg, device="cpu")
    else:
        assert train.main(cfg, device="cpu")["final_step"] == 1


@pytest.mark.parametrize("override", ["synthetic_kind=pixels", "data_path=<videos>"])
def test_pixel_data_without_what_it_needs_raises(tmp_path, override):
    """Pixel data trains now (tests/test_torch_pixel_train.py): synthetic
    pixels without a VAE raise ``ValueError``, an empty video folder
    ``FileNotFoundError``."""
    error, match = ValueError, "no VAE is configured"
    if override == "data_path=<videos>":
        (tmp_path / "videos").mkdir()
        override = f"data_path={tmp_path}/videos"
        error, match = FileNotFoundError, "no videos under"
    with pytest.raises(error, match=match):
        train.main(_cfg(tmp_path, "max_train_steps=1", override), device="cpu")


def test_quant_train_step_matches_jax_and_the_cli_trains(tmp_path):
    """``quant_train: true``: the blocks' qkv, proj, fc1 and fc2 run the W8A8
    forward from fp32 masters with a straight-through backward, the adaLN
    modulation stays fp (JAX ``quantized="train"``). One AdamW step against
    the JAX step on the same weights, t and noise: the loss within 1e-3 and
    the grad norm within 1e-3 relative (measured 8.8e-5 and 1.5e-4 here,
    ≤ 7.9e-4 and ≤ 2.4e-4 over seeds 1-8). Each int8 product is held bit
    for bit in test_torch_quant.py; here the fp32 activations it quantizes
    come out of layers the two sides sum in another order, and a value an
    ulp from a rounding boundary of round(x / s) becomes the neighbouring
    int8 value on one side: nudging every weight of the JAX int8 model by
    one ulp moves its own output by 0.8% (its fp model's by 1e-6). The loss
    cannot tell a step that quantized nothing from a sound one at this
    width: the fp model's step reads 1.4e-4 here (1.4e-4 to 3.9e-3 over
    seeds 1-8). Its grad norm reads 1.5e-3 here (≥ 5.1e-4 over seeds 1-8),
    so the test asserts that the fp twin fails the grad-norm limit. Then the
    CLI trains a step."""
    import jax
    import jax.numpy as jnp
    from test_torch_train import _batch, _jax_model_and_params, _port_model
    from test_torch_train_step import _jax_noise

    from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
    from latte_tpu.train.state import create_train_state as jax_create_train_state
    from latte_tpu.train.state import make_optimizer as jax_make_optimizer
    from latte_tpu.train.step import make_train_step as jax_make_train_step
    from latte_tpu_torch.core.diffusion import create_diffusion
    from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
    from latte_tpu_torch.train.step import make_train_step

    jm, params = _jax_model_and_params(seed=1)
    jm = jm.clone(quantized="train")
    x0, _ = _batch(seed=2)
    t = np.array([3, 700])
    jopt = jax_make_optimizer(lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jm, jax_create_diffusion(""), jopt))
    rng = jax.random.PRNGKey(7)
    _, want = jstep(jax_create_train_state(params, jopt), {"latents": jnp.asarray(x0), "t": jnp.asarray(t)}, rng)
    noise = torch.from_numpy(_jax_noise(rng, 0, x0.shape).copy())

    def step(**quantized):
        model = _port_model(params, **quantized)
        state = create_train_state(model, make_optimizer(model), make_lr_schedule(1e-3))
        batch = {"latents": torch.from_numpy(x0), "t": torch.from_numpy(t), "noise": noise}
        out = make_train_step(create_diffusion(""))(state, batch, torch.Generator())
        return abs(float(out["loss"]) / float(want["loss"]) - 1), abs(float(out["grad_norm"]) / float(want["grad_norm"]) - 1)

    loss_err, norm_err = step(quantized="train")
    assert loss_err <= 1e-3 and norm_err <= 1e-3
    assert step()[1] > 1e-3  # the fp twin

    class Modes(EarlyStopOnNaN):
        def on_train_start(self, config, state, experiment_dir):
            blk = state.model.blocks[0]
            self.modes = (blk.attn.qkv.quantized, blk.mlp.fc2.quantized, blk.adaLN_modulation[1].quantized)

    cb = Modes()
    out = train.main(_cfg(tmp_path, "max_train_steps=1", "quant_train=true"), callbacks=[cb], device="cpu")
    assert out["final_step"] == 1 and np.isfinite(out["loss"])
    assert cb.modes == ("train", "train", False)
