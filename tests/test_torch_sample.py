"""The port's entry point and package boundary: the config loader on the
shipped ffs config, the sampler CLI on the CPU (only when asked for it), the
reference checkpoint path, the VAE decode to an mp4, and that neither the
package nor chip_smoke.py imports JAX or anything of latte_tpu. Everything
written goes to tmp_path.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from latte_tpu.config import load_config as jax_load_config
from latte_tpu.utils import read_video
from latte_tpu_torch.config import load_config
from latte_tpu_torch.sample import sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFS = os.path.join(REPO, "configs", "ffs", "ffs_sample.yaml")
TINY = [
    "model_overrides={depth: 2, hidden_size: 32, num_heads: 2}",
    "image_size=32", "num_frames=2", "use_fp16=false",
    "sample_method=ddim", "num_sampling_steps=3",
]


def test_loader_reads_the_ffs_config():
    cfg = load_config(FFS, ["sample_method=ddim", "num_sampling_steps=50"])
    assert cfg.to_dict() == jax_load_config(FFS, ["sample_method=ddim", "num_sampling_steps=50"]).to_dict()
    assert (cfg.model, cfg.num_frames, cfg.image_size, cfg.vae_ckpt) == ("Latte-XL/2", 16, 256, None)
    assert cfg.use_fp16 is True and cfg.num_sampling_steps == 50


def test_port_imports_no_jax_and_nothing_of_latte_tpu():
    code = (
        "import sys, pkgutil, importlib, latte_tpu_torch\n"
        "for m in pkgutil.walk_packages(latte_tpu_torch.__path__, 'latte_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('vae.autoencoder_kl', 'data.datasets', 'data.video_transforms', 'tools.cache_latents',\n"
        "          'core.block_cache', 'sample.sample_many', 'models.dit_img', 'train.trainer',\n"
        "          'serve.aot', 'serve.export_aot', 'kernels.ops', 'stats', 'diagnostics', 'profiling',\n"
        "          'persistence'):\n"
        "    assert 'latte_tpu_torch.' + m in sys.modules, m\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'latte_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith('latte_tpu_torch')]), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    n_port, bad = out.stdout.strip().split(" ", 1)
    assert int(n_port) > 10 and bad == "[]", out.stdout


def test_entry_point_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only refusal")
    cfg = load_config(FFS, TINY + [f"save_video_path={tmp_path}/v.mp4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.main(cfg)
    assert not any(tmp_path.iterdir())


def test_cli_runs_on_cpu_when_asked(tmp_path):
    path = sample.cli(
        ["--config", FFS, "--device", "cpu", "--save_video_path", str(tmp_path / "v.mp4"), *TINY]
    )
    assert path == str(tmp_path / "v_latents.npz")
    lat = np.load(path)["latents"]
    assert lat.shape == (1, 2, 4, 4, 4) and np.isfinite(lat).all()


def test_reference_checkpoint_and_vae_guard(tmp_path):
    cfg = load_config(FFS, TINY + [f"save_video_path={tmp_path}/v.mp4"])
    model = sample.build_model(cfg, torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.05, generator=gen)
    # the reference's format: {"model", "ema"} state dicts with the sincos tables
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["pos_embed"], sd["temp_embed"] = model.pos_embed.clone(), model.temp_embed.clone()
    torch.save({"ema": sd, "model": {k: torch.zeros_like(v) for k, v in sd.items()}}, tmp_path / "c.pt")
    cfg.ckpt = str(tmp_path / "c.pt")
    loaded = sample.build_model(cfg, torch.device("cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    lat = np.load(sample.main(cfg, device="cpu"))["latents"]
    want = sample.sample_latents(model, cfg, torch.device("cpu"))
    np.testing.assert_array_equal(lat, want.numpy())

    cfg.ckpt = str(tmp_path / "missing.pt")
    with pytest.raises(FileNotFoundError):
        sample.main(cfg, device="cpu")
    # the full SD VAE from a seed decodes the 4x4 latents to 32x32 frames
    cfg.ckpt, cfg.vae_ckpt = None, "random"
    path = sample.main(cfg, device="cpu")
    assert path == str(tmp_path / "v.mp4")
    assert read_video(path).shape == (2, 32, 32, 3)


def test_checkpoint_directory_names_the_conversion(tmp_path):
    """The JAX trainer writes orbax checkpoint directories, which the JAX
    sampler loads; the port reads a reference-format .pt and says how to
    convert, rather than failing inside torch.load."""
    ckpt = tmp_path / "0000006"
    (ckpt / "params").mkdir(parents=True)
    cfg = load_config(FFS, TINY + [f"save_video_path={tmp_path}/v.mp4", f"ckpt={ckpt}"])
    with pytest.raises(NotImplementedError, match="flax_to_state_dict"):
        sample.build_model(cfg, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="orbax"):
        sample.main(cfg, device="cpu")
    assert not (tmp_path / "v_latents.npz").exists()


@pytest.mark.parametrize("override", ["tensor_parallel=2"], ids=["tensor_parallel"])
def test_unported_sampler_options_raise(tmp_path, override):
    """Tensor-parallel serving runs one process a GPU (its runs:
    tests/test_torch_dist_train.py, tests/test_torch_dist_tp.py): in one
    process the entry point refuses it, as the JAX sampler refuses a tp
    larger than its devices, rather than sampling the plain way."""
    cfg = load_config(FFS, TINY + [f"save_video_path={tmp_path}/v.mp4", override])
    with pytest.raises(ValueError, match="tensor_parallel=2 needs 2 processes"):
        sample.main(cfg, device="cpu")
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize(
    "int8_overrides",
    [["attention_mode=flash", "int8_attention=true"], ["attention_mode=auto", "int8_attention=qk"]],
    ids=["flash-full", "auto-qk"],
)
def test_static_int8_sampler_matches_the_jax_sampler(tmp_path, int8_overrides):
    """``quantized: static`` with the int8 attention core through the entry
    point, DDIM-3 from a checkpoint, against the JAX sampler's own recipe
    (calibration at t = 999, 500, 0 on one z, quantize_params, the static
    model, build_sample_fn) on the same weights, calibration z and starting
    z. Tolerance: that of test_torch_int8_model.py, whose reasons hold for
    each of the three forwards (int8 rounding steps where the two sides'
    fp32 activations sit an ulp apart across a rounding boundary)."""
    import jax
    import jax.numpy as jnp
    from torch_port_util import close, randomize

    from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
    from latte_tpu.models import get_models as jax_get_models
    from latte_tpu.quant import merge_amax, quantize_params
    from latte_tpu.sample.sample import build_sample_fn
    from latte_tpu_torch.convert import flax_to_state_dict

    over = TINY + ["quantized=static", *int8_overrides, f"save_video_path={tmp_path}/v.mp4"]
    cfg, jcfg = load_config(FFS, over), jax_load_config(FFS, over)
    jm = jax_get_models(jcfg)
    x0, t0 = jnp.zeros((1, 2, 4, 4, 4)), jnp.zeros((1,), jnp.int32)
    params = randomize(jm.init(jax.random.PRNGKey(0), x0, t0)["params"], seed=3, std=0.1)
    torch.save({"ema": flax_to_state_dict(params, 2, 2, 2)}, tmp_path / "c.pt")
    cfg.ckpt = str(tmp_path / "c.pt")
    got = np.load(sample.main(cfg, device="cpu"))["latents"]

    zc = jnp.asarray(sample.calibration_latents(cfg, torch.device("cpu")).numpy())
    calib = jm.clone(quantized="calib")
    amax = None
    for tc in sample.CALIBRATION_TIMESTEPS:
        _, var = calib.apply({"params": params}, zc, jnp.full((1,), tc, jnp.int32), mutable=["calib"])
        amax = merge_amax(amax, var["calib"])
    qparams = {"params": quantize_params(params, act_amax=amax)}
    fn, _ = build_sample_fn(jm.clone(quantized="static"), qparams, jcfg, jax_create_diffusion("3"))
    z = torch.randn((1, 2, 4, 4, 4), generator=torch.Generator().manual_seed(0))
    want = fn(jnp.asarray(z.numpy()), None, jax.random.PRNGKey(1))
    assert got.shape == (1, 2, 4, 4, 4) and np.isfinite(got).all()
    close(got, want, 2e-2, 5e-2)


def test_tiny_vae_decode_matches_the_jax_decode(tmp_path):
    """``vae: tiny``: the port's decode (make_decode_fn, then decode_video's
    uint8 frames) against the JAX sampler's (make_decode_fn(tiny_vae(),
    params), then to_uint8) on the same latents, the JAX params carried
    across; then the entry point writes the mp4. Float frames within
    test_torch_vae.py's fp32 limits; uint8 frames equal on >= 99.9% of
    values (a float a few ulp from a multiple of 1/255 may truncate to the
    neighbouring integer)."""
    import jax.numpy as jnp
    from test_torch_vae import perturbed_params
    from torch_port_util import close

    from latte_tpu.utils import to_uint8 as jax_to_uint8
    from latte_tpu.vae import make_decode_fn as jax_make_decode_fn
    from latte_tpu.vae.autoencoder_kl import tiny_vae as jax_tiny_vae
    from latte_tpu_torch.convert import flax_vae_to_state_dict
    from latte_tpu_torch.vae import make_decode_fn

    cfg = load_config(FFS, TINY + ["vae=tiny", f"save_video_path={tmp_path}/v.mp4"])
    vae = sample.load_vae(cfg, torch.device("cpu"))
    jm = jax_tiny_vae()
    params = perturbed_params(jm, jnp.zeros((1, 3, 16, 16)), seed=13)
    vae.load_state_dict(flax_vae_to_state_dict(params), strict=True)
    latents = torch.from_numpy(np.random.default_rng(13).standard_normal((1, 2, 4, 4, 4)).astype(np.float32))

    flat = latents.reshape(2, 4, 4, 4) / 0.18215
    want = np.asarray(jax_make_decode_fn(jm, {"params": params})(jnp.asarray(flat.numpy())))
    close(make_decode_fn(vae)(flat), want)
    frames = sample.decode_video(vae, latents)
    want_u8 = jax_to_uint8(want.transpose(0, 2, 3, 1))
    assert frames.dtype == np.uint8 and frames.shape == want_u8.shape == (2, 8, 8, 3)
    assert (frames == want_u8).mean() >= 0.999

    path = sample.main(cfg, device="cpu")
    assert path == str(tmp_path / "v.mp4") and read_video(path).shape == (2, 8, 8, 3)


def test_missing_vae_checkpoint_saves_latents_with_a_warning(tmp_path, capsys):
    """As the JAX sampler does: a vae_ckpt that names no file gives latents."""
    missing = tmp_path / "no_vae.bin"
    cfg = load_config(FFS, TINY + [f"vae_ckpt={missing}", f"save_video_path={tmp_path}/v.mp4"])
    path = sample.main(cfg, device="cpu")
    assert path == str(tmp_path / "v_latents.npz") and np.load(path)["latents"].shape == (1, 2, 4, 4, 4)
    err = capsys.readouterr().err
    assert "WARNING" in err and str(missing) in err


def test_vae_checkpoint_directory_names_the_conversion(tmp_path):
    """A vae_ckpt directory (the JAX package's orbax VAE, or a diffusers
    folder) is refused before sampling, naming both ways to a state dict."""
    (tmp_path / "vae").mkdir()
    cfg = load_config(FFS, TINY + [f"vae_ckpt={tmp_path / 'vae'}", f"save_video_path={tmp_path}/v.mp4"])
    with pytest.raises(NotImplementedError, match="flax_vae_to_state_dict.*diffusion_pytorch_model.bin"):
        sample.main(cfg, device="cpu")
    assert not (tmp_path / "v.mp4").exists() and not (tmp_path / "v_latents.npz").exists()


def test_vae_checkpoint_file_in_diffusers_keys_loads_strictly(tmp_path):
    """A .pt state dict in diffusers' AutoencoderKL keys (the full SD
    architecture, stored in fp16 as released VAEs often are) loads with
    strict=True and decodes; the loaded weights are the saved ones."""
    from latte_tpu_torch.vae import AutoencoderKL

    ref = AutoencoderKL()
    ref.initialize_weights(torch.Generator().manual_seed(14))
    sd = {k: v.half() for k, v in ref.state_dict().items()}
    assert "decoder.up_blocks.0.upsamplers.0.conv.weight" in sd
    assert "encoder.mid_block.attentions.0.to_out.0.weight" in sd
    torch.save(sd, tmp_path / "diffusion_pytorch_model.bin")
    cfg = load_config(FFS, TINY + [f"vae_ckpt={tmp_path / 'diffusion_pytorch_model.bin'}",
                                   f"save_video_path={tmp_path}/v.mp4"])
    vae = sample.load_vae(cfg, torch.device("cpu"))
    for k, v in vae.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, sd[k].float()), k
    path = sample.main(cfg, device="cpu")
    assert read_video(path).shape == (2, 32, 32, 3)
