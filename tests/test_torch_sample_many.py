"""The port's ``sample_many`` (one process, one device) against the JAX
package's sampler: batch-2 latents from the generator's own z against the
JAX ``build_sample_fn`` on the same z (plain, block cache, CFG), the files
and their index interleave, ``create_npz_from_sample_folder``, the labels
under ``extras: 2``, the refusal under ``WORLD_SIZE > 1`` and the CLI on
the CPU. Tolerance: ``torch_port_util.close``'s defaults, as in
tests/test_torch_block_cache.py. Everything written goes to tmp_path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close

from latte_tpu.config import load_config as jax_load_config
from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.models import get_models as jax_get_models
from latte_tpu.sample.sample import build_sample_fn
from latte_tpu.utils import read_video
from latte_tpu_torch.config import load_config
from latte_tpu_torch.convert import flax_to_state_dict
from latte_tpu_torch.sample import sample, sample_many
from test_torch_block_cache import TINY6, _jax_params
from test_torch_sample import FFS

TINY4 = [
    "model_overrides={depth: 4, hidden_size: 32, num_heads: 2}",
    "image_size=32", "num_frames=2", "use_fp16=false",
    "sample_method=ddim", "num_sampling_steps=3", "per_proc_batch_size=2", "num_fvd_samples=3",
]
CASES = {
    "ddim": [],
    "block-cache": ["block_cache_interval=2"],
    "cfg": ["extras=2", "num_classes=10", "cfg_scale=4.0"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_latents_match_the_jax_sampler(tmp_path, case):
    """One batch of 2 from BatchGenerator (DDIM-6) against the JAX
    build_sample_fn at batch 2 on the generator's own z and labels (under
    CFG doubled with the null class, as the JAX BatchGenerator does)."""
    over = TINY6[:-1] + ["per_proc_batch_size=2", f"save_video_path={tmp_path}/out"] + CASES[case]
    cfg, jcfg = load_config(FFS, over), jax_load_config(FFS, over)
    jm = jax_get_models(jcfg)
    params = _jax_params(jm, int(getattr(cfg, "extras", 1)))
    torch.save({"ema": flax_to_state_dict(params, 6, 2, 2)}, tmp_path / "c.pt")
    cfg.ckpt = str(tmp_path / "c.pt")
    gen = sample_many.BatchGenerator(cfg, device="cpu")
    z, y = gen.draw(0)
    got = gen.sample_latents()
    assert gen.it == 1 and got.shape == (2, 2, 4, 4, 4)
    # the generator is sample_loop on its own draws
    assert torch.equal(sample.sample_loop(gen.model, cfg, z, y), got)

    fn, use_cfg = build_sample_fn(jm, {"params": params}, jcfg, jax_create_diffusion("6"))
    jz = jnp.asarray(z.numpy())
    jy = None if y is None else jnp.asarray(y.numpy(), jnp.int32)
    if use_cfg:
        jz, jy = jnp.concatenate([jz, jz]), jnp.concatenate([jy, jnp.full((2,), 10, jnp.int32)])
    want = np.asarray(fn(jz, jy, jax.random.PRNGKey(1)))[:2]
    close(got, want)


def test_latent_files_interleave_and_npz(tmp_path):
    """No VAE: num_fvd_samples 3 rounds up to two batches of 2, written as
    0000-0003.npz, each the latents of its place in its batch; the folder
    bundles to (4, F, 4, L, L)."""
    cfg = load_config(FFS, TINY4 + [f"save_video_path={tmp_path}/out"])
    out = sample_many.main(cfg, device="cpu")
    files = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert out == str(tmp_path / "out") and files == [f"{i:04d}.npz" for i in range(4)]
    gen = sample_many.BatchGenerator(cfg, device="cpu")
    batches = [gen.sample_latents(), gen.sample_latents()]
    for idx in range(4):
        lat = np.load(tmp_path / "out" / f"{idx:04d}.npz")["latents"]
        np.testing.assert_array_equal(lat, batches[idx // 2][idx % 2].numpy())
    assert not np.array_equal(batches[0].numpy(), batches[1].numpy())
    bundle = np.load(sample_many.create_npz_from_sample_folder(out))["arr_0"]
    assert bundle.shape == (4, 2, 4, 4, 4)


def test_mp4_files_and_npz_with_a_vae(tmp_path):
    """``vae: tiny``: four mp4s of 2 frames at 8x8, each one video decoded by
    decode_to_uint8, bundled to uint8 (4, 2, 8, 8, 3)."""
    cfg = load_config(FFS, TINY4 + ["vae=tiny", f"save_video_path={tmp_path}/out"])
    out = sample_many.main(cfg, device="cpu")
    files = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert files == [f"{i:04d}.mp4" for i in range(4)]
    for name in files:
        assert read_video(str(tmp_path / "out" / name)).shape == (2, 8, 8, 3)
    clips = sample_many.BatchGenerator(cfg, device="cpu")()  # the gen_fn protocol
    assert clips.dtype == np.uint8 and clips.shape == (2, 2, 8, 8, 3)
    bundle = np.load(sample_many.create_npz_from_sample_folder(out))["arr_0"]
    assert bundle.dtype == np.uint8 and bundle.shape == (4, 2, 8, 8, 3)


def test_class_labels_lie_in_range_and_follow_the_seed(tmp_path):
    cfg = load_config(FFS, TINY4 + ["extras=2", "num_classes=10", f"save_video_path={tmp_path}/o"])
    gen, again = sample_many.BatchGenerator(cfg, device="cpu"), sample_many.BatchGenerator(cfg, device="cpu")
    labels = []
    for it in range(8):
        z, y = gen.draw(it)
        z2, y2 = again.draw(it)
        assert torch.equal(z, z2) and torch.equal(y, y2)
        assert y.shape == (2,) and y.dtype == torch.int64 and 0 <= y.min() and y.max() < 10
        labels += y.tolist()
    assert len(set(labels)) > 3
    assert not torch.equal(gen.draw(0)[0], gen.draw(1)[0])
    cfg.seed = 1
    assert not torch.equal(sample_many.BatchGenerator(cfg, device="cpu").draw(0)[0], gen.draw(0)[0])


def test_more_than_one_process_raises(tmp_path, monkeypatch):
    """A launcher's WORLD_SIZE without the rank to join it raises: no quiet
    sampling on one card of many (the multi-process form itself:
    tests/test_torch_dist_sample.py)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    cfg = load_config(FFS, TINY4 + [f"save_video_path={tmp_path}/out"])
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2 but no RANK"):
        sample_many.main(cfg, device="cpu")
    assert not any(tmp_path.iterdir())


def test_cli_runs_on_cpu_when_asked_and_refuses_cuda_without_a_gpu(tmp_path):
    out = sample_many.cli(["--config", FFS, "--device", "cpu", "--save_video_path", str(tmp_path / "o"), *TINY4])
    assert sorted(p.name for p in (tmp_path / "o").iterdir()) == [f"{i:04d}.npz" for i in range(4)]
    assert out == str(tmp_path / "o")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sample_many.cli(["--config", FFS, "--save_video_path", str(tmp_path / "g"), *TINY4])
        assert not (tmp_path / "g").exists()
