"""The port's entry point and package boundary: the config loader on the
shipped ffs config, the sampler CLI on the CPU (only when asked for it), the
reference checkpoint path, and that neither the package nor chip_smoke.py
imports JAX or anything of latte_tpu. Everything written goes to tmp_path.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from latte_tpu.config import load_config as jax_load_config
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
    cfg.ckpt, cfg.vae_ckpt = None, "random"
    with pytest.raises(NotImplementedError, match="VAE decode"):
        sample.main(cfg, device="cpu")
