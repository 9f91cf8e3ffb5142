"""The port's T2X entry point (latte_tpu_torch/sample/sample_t2x.py) on the
CPU at a tiny size, on the shipped configs/t2x configs with overrides: an
mp4 per prompt through a tiny VAE, a png for the t2i config, ``.npz``
latents without a VAE, a reference checkpoint in ``.safetensors``, the
int8 path, each refusal, and a ``t5_ckpt`` directory against the JAX
pipeline with the JAX T5 encoder. (The pipeline's other numbers against
the JAX pipeline are tests/test_torch_pipeline_t2v.py's.)
"""

import json
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
    ("pipeline_parallel=2", AssertionError, "pipeline_parallel=2 needs 2 devices, have 1"),
    ("pipeline_parallel=2 block_cache_interval=2", ValueError, "block_cache_interval does not compose with pp_mesh"),
    ("moe_experts=2 quantized=true", NotImplementedError, "no int8 expert path"),
    ("ckpt=/nonexistent/t2v.safetensors", FileNotFoundError, "does not exist"),
    ("quantized=static", ValueError, "quantized"),
    ("sample_method=LMSDiscrete", ValueError, "unknown scheduler"),
], ids=["pipeline_parallel", "pp_block_cache", "moe", "missing_ckpt", "static_int8", "scheduler"])
def test_refusals(tmp_path, override, exc, match):
    with pytest.raises(exc, match=match):
        sample_t2x.main(tiny(T2V, tmp_path, "video_length=4", *override.split()), device="cpu")


def test_t5_directory_refused(tmp_path):
    """A ``t5_ckpt`` directory now loads the port's T5; one without its
    files is refused, naming what it lacks (no silent fall-back to the
    stub)."""
    (tmp_path / "t5").mkdir()
    with pytest.raises(FileNotFoundError, match="config.json"):
        sample_t2x.main(tiny(T2V, tmp_path, f"t5_ckpt={tmp_path}/t5"), device="cpu")
    (tmp_path / "t5" / "config.json").write_text(json.dumps(dict(T5_TINY)))
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        sample_t2x.main(tiny(T2V, tmp_path, f"t5_ckpt={tmp_path}/t5"), device="cpu")


T5_TINY = dict(vocab_size=128, d_model=32, d_kv=4, d_ff=32, num_layers=2, num_heads=2,
               feed_forward_proj="gated-gelu")


def test_t5_checkpoint_matches_the_jax_pipeline(tmp_path):
    """``sample_t2x`` with a tiny ``t5_ckpt`` directory (config.json,
    model.safetensors, a synthetic spiece.model) and a LatteT2V checkpoint,
    in fp32, against the JAX ``LattePipeline`` with the JAX
    ``T5TextEncoder`` (FlaxT5EncoderModel and ``tokenizers``' Unigram on
    the same weights and vocabulary), z handed across: the latents of both
    prompts within 1e-5 relative L2 (``close``)."""
    import jax
    import jax.numpy as jnp
    from safetensors.torch import save_file
    from torch_port_util import close, hf_unigram_tokenizer, randomize, spiece_model_bytes, spiece_pieces
    from transformers import FlaxT5EncoderModel
    from transformers import T5Config as HFT5Config

    from latte_tpu.core.scheduler import get_scheduler as jax_get_scheduler
    from latte_tpu.models.t2v import LatteT2V as JaxLatteT2V
    from latte_tpu.sample.pipeline_t2v import LattePipeline as JaxPipeline
    from latte_tpu.text import T5TextEncoder as JaxT5TextEncoder
    from latte_tpu_torch.convert import flax_t2v_to_state_dict, flax_t5_to_state_dict

    pieces = spiece_pieces()
    t5 = FlaxT5EncoderModel(HFT5Config(**T5_TINY), seed=0)
    t5_params = randomize(t5.params, seed=1)
    t5_dir = tmp_path / "t5"
    t5_dir.mkdir()
    (t5_dir / "config.json").write_text(json.dumps(T5_TINY))
    (t5_dir / "spiece.model").write_bytes(spiece_model_bytes(pieces))
    save_file(flax_t5_to_state_dict(t5_params), str(t5_dir / "model.safetensors"))

    prompts = ["A cat walking on the beach", "the red car in the city at night"]
    cfg = tiny(T2V, tmp_path / "out", "video_length=4", f"t5_ckpt={t5_dir}", f"ckpt={tmp_path}/t2v.safetensors",
               "seed=3", "guidance_scale=4.0", f"text_prompt=[{', '.join(prompts)}]")
    arch = sample_t2x.transformer_kwargs(cfg)
    jm = JaxLatteT2V(**{k: v for k, v in arch.items() if not k.startswith("moe") and k != "attention_mode"},
                     attention_mode="xla")
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 4, 4, 4, 4)),
                                     jnp.zeros((2,)), jnp.zeros((2, 120, 32)), None))()
    params = randomize(params["params"], seed=2, std=0.1)
    save_file(flax_t2v_to_state_dict(params), str(tmp_path / "t2v.safetensors"))

    records = sample_t2x.main(cfg, device="cpu")
    jtext = JaxT5TextEncoder(t5, t5_params, hf_unigram_tokenizer(pieces), max_length=120)
    jp = JaxPipeline(transformer=jm, transformer_params={"params": params}, scheduler=jax_get_scheduler("DDIM"),
                     text_encoder=jtext)
    for i, (prompt, r) in enumerate(zip(prompts, records)):
        z = torch.randn((1, 4, 4, 4, 4), generator=torch.Generator().manual_seed(3 + i)).numpy()
        jp.prepare_latents = lambda *a, num_inference_steps=50, z=z: (
            jnp.asarray(z) * jp.scheduler.init_noise_sigma_for(num_inference_steps))
        want = jp(prompt, video_length=4, height=32, width=32, num_inference_steps=2, guidance_scale=4.0,
                  output_type="latents").video
        close(r["latents"], want)


def test_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        sample_t2x.cli(["--config", T2V, *TINY, f"save_video_path={tmp_path}"])
