"""The port's T2X entry point (latte_tpu_torch/sample/sample_t2x.py) on the
CPU at a tiny size, on the shipped configs/t2x configs with overrides: an
mp4 per prompt through a tiny VAE, a png for the t2i config, ``.npz``
latents without a VAE, a reference checkpoint in ``.safetensors``, the
int8 path, and each refusal. (The pipeline's numbers against the JAX
pipeline are tests/test_torch_pipeline_t2v.py's.)
"""

import os

import cv2
import numpy as np
import pytest
import torch

from latte_tpu_torch.config import load_config
from latte_tpu_torch.core.scheduler import get_scheduler
from latte_tpu_torch.models.t2v import LatteT2V
from latte_tpu_torch.sample import sample_t2x
from latte_tpu_torch.sample.pipeline_t2v import LattePipeline
from latte_tpu_torch.text import StubTextEncoder
from latte_tpu_torch.utils import read_video

T2V = "configs/t2x/t2v_sample.yaml"
T2I = "configs/t2x/t2i_sample.yaml"
TINY = ["num_attention_heads=2", "attention_head_dim=8", "num_layers=2", "caption_channels=32",
        "cross_attention_dim=16", "image_size=[32,32]", "num_sampling_steps=2", "use_fp16=false"]


def tiny(path, tmp_path, *more):
    return load_config(path, TINY + [f"save_video_path={tmp_path}", *more])


def test_t2v_writes_one_mp4_per_prompt(tmp_path):
    cfg = tiny(T2V, tmp_path, "video_length=4", "vae=tiny", "text_prompt=[a cat, a dog]")
    records = sample_t2x.main(cfg, device="cpu")
    assert [os.path.basename(r["path"]) for r in records] == ["00_a_cat.mp4", "01_a_dog.mp4"]
    for r in records:
        frames = read_video(r["path"])
        assert frames.shape == (4, 8, 8, 3)  # 4x4 latents, the tiny VAE's 2x
        assert r["latents"].shape == (1, 4, 4, 4, 4) and r["decode_s"] is not None
    # seed + i: the prompts' latents differ
    assert not torch.equal(records[0]["latents"], records[1]["latents"])


def test_t2i_writes_a_png(tmp_path):
    cfg = tiny(T2I, tmp_path, "vae=tiny")
    (record,) = sample_t2x.main(cfg, device="cpu")
    assert record["path"].endswith(".png")
    assert cv2.imread(record["path"]).shape == (8, 8, 3)
    assert record["latents"].shape == (1, 4, 1, 4, 4)


def test_latents_from_a_safetensors_checkpoint(tmp_path):
    """No VAE: one .npz per prompt, equal to the pipeline's latents from the
    checkpoint's weights (seed + i)."""
    from safetensors.torch import save_file

    cfg = tiny(T2V, tmp_path / "out", "video_length=4", "text_prompt=[a cat, a dog]", "seed=3")
    model = LatteT2V(**sample_t2x.transformer_kwargs(cfg))
    model.initialize_weights(torch.Generator().manual_seed(5))
    save_file(model.state_dict(), str(tmp_path / "t2v.safetensors"))
    cfg.ckpt = str(tmp_path / "t2v.safetensors")
    records = sample_t2x.main(cfg, device="cpu")
    pipe = LattePipeline(model.eval(), get_scheduler("DDIM"), StubTextEncoder(32))
    for i, r in enumerate(records):
        assert r["path"].endswith(".npz") and r["decode_s"] is None
        saved = np.load(r["path"])["latents"]
        want = pipe.sample_latents(r["prompt"], video_length=4, height=32, width=32,
                                   num_inference_steps=2, seed=3 + i)
        assert np.array_equal(saved, want.numpy())


def test_cli_quantized_and_block_cache(tmp_path):
    """quantized: true serves the int8 model; the block cache runs through
    the config's keys."""
    records = sample_t2x.cli([
        "--config", T2V, "--device", "cpu", *TINY, f"save_video_path={tmp_path}", "video_length=4",
        "quantized=true", "num_layers=3", "block_cache_interval=2", "text_prompt=[a cat]",
    ])
    assert torch.isfinite(records[0]["latents"]).all()


@pytest.mark.parametrize("override, exc, match", [
    ("pipeline_parallel=2", NotImplementedError, "M6"),
    ("moe_experts=2 quantized=true", NotImplementedError, "no int8 expert path"),
    ("ckpt=/nonexistent/t2v.safetensors", FileNotFoundError, "does not exist"),
    ("quantized=static", ValueError, "quantized"),
    ("sample_method=LMSDiscrete", ValueError, "unknown scheduler"),
], ids=["pipeline_parallel", "moe", "missing_ckpt", "static_int8", "scheduler"])
def test_refusals(tmp_path, override, exc, match):
    with pytest.raises(exc, match=match):
        sample_t2x.main(tiny(T2V, tmp_path, "video_length=4", *override.split()), device="cpu")


def test_t5_directory_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="M5.2"):
        sample_t2x.main(tiny(T2V, tmp_path, f"t5_ckpt={tmp_path}"), device="cpu")


def test_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        sample_t2x.cli(["--config", T2V, *TINY, f"save_video_path={tmp_path}"])
