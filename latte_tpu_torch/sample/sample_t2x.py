"""Text-to-video / text-to-image sampling entry point (port of
``latte_tpu/sample/sample_t2x.py``).

Builds LatteT2V (the published Latte-1 architecture unless the config says
otherwise), the caption encoder and the VAE, picks one of the ten
schedulers (``sample_method``), drives
:class:`latte_tpu_torch.sample.pipeline_t2v.LattePipeline` once per prompt
with seed ``seed + i``, and writes a png (``video_length: 1``) or an mp4 at
8 fps per prompt under ``save_video_path``; without a VAE the latents as
``.npz``.

- ``ckpt``: LatteT2V weights in the reference's diffusers naming (``.pt``,
  ``.bin`` or ``.safetensors``, read by ``convert.load_t2v_state_dict``);
  null initialises the model from ``torch.Generator`` seed 0; a path that
  does not exist raises ``FileNotFoundError`` (the JAX sampler would sample
  from random init instead).
- ``vae_ckpt``: as in ``sample.load_vae`` (``random``: the SD VAE from a
  seed; null: save latents).
- ``t5_ckpt``: a Hugging Face T5 directory (``config.json``, the weights,
  ``spiece.model``): :meth:`latte_tpu_torch.text.T5TextEncoder.from_pretrained`
  on the device in the config's type; otherwise the hash-embedding stub
  (:class:`latte_tpu_torch.text.StubTextEncoder`), as the JAX sampler falls
  back to it. No temporal decoder is built, as in the JAX sampler.
- ``use_fp16: true`` serves in bf16; ``quantized: true`` in W8A8 int8
  (dynamic activation scales) for the attention projections and the
  feed-forward, quantized from the fp32 weights.
- ``block_cache_interval`` / ``block_cache_pairs``: the pipeline's block cache.
- ``moe_experts > 1`` (with ``moe_top_k``, ``moe_capacity_factor``): the
  Mixture-of-Experts feed-forward in every block; with ``quantized: true``
  it raises ``NotImplementedError`` (no int8 expert path, as in JAX), and a
  ``ckpt`` raises ``KeyError`` naming the expert weights it lacks.
- ``pipeline_parallel`` S > 1 (with ``pp_microbatches``, default 2):
  exactly S processes, one a GPU (``torchrun``; dp 1, as the JAX sampler's
  ``pp`` devices), each building and holding its stage's pairs of the
  transformer alone (``dist/pipeline.py``). Every rank encodes the prompts
  itself (the same text encoder on the same ids gives the same features),
  runs the scheduler loop on the same latents (the pipelined forward's
  output is replicated), and rank 0 alone decodes and writes the outputs.
  Another process count raises the JAX sampler's ``AssertionError``; the
  block cache with it, the JAX pipeline's ``ValueError``.

Runs on ``cuda`` unless asked for the CPU::

    python -m latte_tpu_torch.sample.sample_t2x --config configs/t2x/t2v_sample.yaml \
        [--device cpu] [key=value ...]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from latte_tpu_torch.config import Config, load_config
from latte_tpu_torch.convert import load_t2v_state_dict
from latte_tpu_torch.core.scheduler import get_scheduler
from latte_tpu_torch.dist.mesh import MeshConfig, barrier, setup
from latte_tpu_torch.dist.pipeline import stage_state_dict
from latte_tpu_torch.models.layers import MOE_INT8_REFUSAL
from latte_tpu_torch.models.t2v import LatteT2V
from latte_tpu_torch.quant import quantize_params
from latte_tpu_torch.sample.pipeline_t2v import PP_BLOCK_CACHE_ERROR, LattePipeline
from latte_tpu_torch.sample.sample import load_vae
from latte_tpu_torch.text import StubTextEncoder, T5TextEncoder
from latte_tpu_torch.utils import create_logger, resolve_device, save_image, save_video


def image_hw(config: Config) -> tuple:
    size = config.image_size
    if isinstance(size, (list, tuple)):
        return int(size[0]), int(size[1])
    return int(size), int(size)


def transformer_kwargs(config: Config) -> dict:
    """LatteT2V's architecture from the config; the defaults are Latte-1's."""
    def get(key, default):
        value = getattr(config, key, None)
        return default if value is None else value

    return dict(
        num_attention_heads=int(get("num_attention_heads", 16)),
        attention_head_dim=int(get("attention_head_dim", 72)),
        num_layers=int(get("num_layers", 28)),
        caption_channels=int(get("caption_channels", 4096)),
        cross_attention_dim=int(get("cross_attention_dim", 1152)),
        video_length=int(get("video_length", 16)),
        sample_size=image_hw(config)[0] // 8,
        enable_temporal_attentions=bool(get("enable_temporal_attentions", True)),
        attention_mode=str(get("attention_mode", "auto")),
        moe_experts=int(getattr(config, "moe_experts", 0) or 0),
        moe_top_k=int(getattr(config, "moe_top_k", 2) or 2),
        moe_capacity_factor=float(getattr(config, "moe_capacity_factor", 1.25) or 1.25),
    )


def build_transformer(config: Config, device: torch.device, ctx=None) -> LatteT2V:
    """LatteT2V on ``device`` in the config's type, from ``ckpt`` or, when
    it is null, the JAX modules' init drawn from ``torch.Generator`` seed 0
    on the device. A t2i model (``enable_temporal_attentions: false``) has
    no temporal blocks and leaves a checkpoint's out. With ``quantized:
    true`` the int8 model, quantized from the fp32 weights. ``ctx`` with a
    pp axis: the stage's pairs alone, with the one-process weights."""
    kwargs = transformer_kwargs(config)
    if ctx is not None and ctx.pp > 1:
        kwargs.update(pp=ctx.pp, pp_rank=ctx.pp_rank)
    with torch.device(device):
        model = LatteT2V(**kwargs)
    ckpt = getattr(config, "ckpt", None)
    if ckpt:
        if not os.path.exists(str(ckpt)):
            raise FileNotFoundError(f"ckpt {ckpt!r} does not exist")
        sd = load_t2v_state_dict(str(ckpt), model.num_layers, model.moe_experts)
        if not model.enable_temporal_attentions:
            sd = {k: v for k, v in sd.items() if not k.startswith("temporal_transformer_blocks.")}
        if model.pp > 1:
            sd = stage_state_dict(sd, model)
        model.load_state_dict(sd, strict=True)
    else:
        model.initialize_weights(torch.Generator(device=device).manual_seed(0))
    # the reference's use_fp16 switch maps to bf16, as in the JAX sampler
    dtype = torch.bfloat16 if getattr(config, "use_fp16", False) else torch.float32
    if getattr(config, "quantized", False) not in (False, None):
        if config.quantized is not True:
            raise ValueError(f"quantized: {config.quantized!r}; the T2X sampler serves true or false")
        masters = model.state_dict()
        del model
        with torch.device(device):
            model = LatteT2V(**kwargs, quantized=True)
        model.load_state_dict(quantize_params(masters), strict=True)
    return model.to(dtype=dtype).eval()


def build_text_encoder(config: Config, device: torch.device = None):
    """The T5 encoder of a ``t5_ckpt`` directory on ``device``, in the
    config's type (bf16 under ``use_fp16``; the JAX sampler computes T5 in
    bf16 whatever the config), else the hash-embedding stub, as in JAX."""
    logger = create_logger()
    t5_ckpt = getattr(config, "t5_ckpt", None)
    if t5_ckpt and os.path.isdir(str(t5_ckpt)):
        dtype = torch.bfloat16 if getattr(config, "use_fp16", False) else torch.float32
        logger.info(f"loading T5 from {t5_ckpt} ({dtype}, {device})")
        return T5TextEncoder.from_pretrained(str(t5_ckpt), dtype=dtype, device=device or "cuda")
    logger.info("WARNING: no T5 checkpoint — using the hash-embedding stub")
    return StubTextEncoder(dim=int(getattr(config, "caption_channels", None) or 4096))


def check_config(config: Config, world: int = None) -> None:
    """Raise before anything is built: for int8 serving of an MoE model,
    which neither package carries; for ``pipeline_parallel`` S on another
    number of processes than S (``world``, once known; the JAX sampler's
    ``AssertionError``), and with the block cache (the JAX pipeline's
    ``ValueError``)."""
    pp = int(getattr(config, "pipeline_parallel", 1) or 1)
    if pp > 1:
        if int(getattr(config, "block_cache_interval", 0) or 0) > 1:
            raise ValueError(PP_BLOCK_CACHE_ERROR)
        if world is not None and world != pp:
            raise AssertionError(
                f"pipeline_parallel={pp} needs {pp} devices, have {world} (one process a GPU, dp 1)"
            )
    if getattr(config, "quantized", False) and int(getattr(config, "moe_experts", 0) or 0) > 1:
        raise NotImplementedError(MOE_INT8_REFUSAL)


def main(config: Config, device: Optional[str] = None) -> List[dict]:
    """One output per prompt. Returns a record per prompt: ``prompt``,
    ``path``, ``latents`` (fp32, on the host), ``latents_s`` (host seconds
    to the latents, ending in a synchronize) and ``decode_s`` (the decode
    to host frames; None without a VAE). Under ``pipeline_parallel`` every
    rank returns its records, ``path`` None but on rank 0."""
    check_config(config)
    pp = int(getattr(config, "pipeline_parallel", 1) or 1)
    if pp > 1:
        dev, ctx = setup(config, device, check=lambda world: check_config(config, world),
                         mesh=MeshConfig(dp=1, pp=pp))
    else:
        dev, ctx = resolve_device(device), None
    main_rank = ctx is None or ctx.rank == 0
    text_encoder = build_text_encoder(config, dev)
    vae = load_vae(config, dev) if main_rank else None
    model = build_transformer(config, dev, ctx)
    logger = create_logger(enabled=main_rank)  # after the loaders above, which reset the logger
    if ctx is not None:
        logger.info(f"pipeline-parallel serving: pp={pp}, stage {ctx.pp_rank} holds pairs "
                    f"{model.num_layers // pp * ctx.pp_rank}..{model.num_layers // pp * (ctx.pp_rank + 1) - 1}")
    if not getattr(config, "ckpt", None):
        logger.info("WARNING: no T2V checkpoint — sampling from random init")
    scheduler = get_scheduler(
        str(getattr(config, "sample_method", None) or "DDIM"),
        beta_start=float(getattr(config, "beta_start", 0.0001)),
        beta_end=float(getattr(config, "beta_end", 0.02)),
        beta_schedule=str(getattr(config, "beta_schedule", "linear")),
    )
    pipeline = LattePipeline(
        transformer=model, scheduler=scheduler, text_encoder=text_encoder, vae=vae,
        block_cache_interval=int(getattr(config, "block_cache_interval", 0) or 0),
        block_cache_pairs=getattr(config, "block_cache_pairs", None),
        pp_mesh=ctx, pp_microbatches=int(getattr(config, "pp_microbatches", 2) or 2),
    )
    h, w = image_hw(config)
    video_length = int(getattr(config, "video_length", 16))
    prompts = getattr(config, "text_prompt", None) or ["a beautiful sunset"]
    if isinstance(prompts, str):
        prompts = [prompts]  # a scalar string would explode into characters
    out_dir = str(getattr(config, "save_video_path", None) or "./sample_videos/t2v")
    if main_rank:
        os.makedirs(out_dir, exist_ok=True)
    records = []
    for i, prompt in enumerate(prompts):
        t0 = time.perf_counter()
        latents = pipeline.sample_latents(
            prompt, video_length=video_length, height=h, width=w,
            num_inference_steps=int(getattr(config, "num_sampling_steps", 50)),
            guidance_scale=float(getattr(config, "guidance_scale", 7.5)),
            seed=int(getattr(config, "seed", 0) or 0) + i,
            enable_temporal_attentions=bool(getattr(config, "enable_temporal_attentions", True)),
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        latents_s = time.perf_counter() - t0
        tag = prompt.replace(" ", "_")[:40]
        decode_s = path = None
        if main_rank and vae is None:  # rank 0 writes
            path = os.path.join(out_dir, f"{i:02d}_{tag}.npz")
            np.savez(path, latents=latents.cpu().numpy())
        elif main_rank:
            t0 = time.perf_counter()
            video = pipeline.decode_latents(latents)  # ends in a copy to the host
            decode_s = time.perf_counter() - t0
            frames = (video[0] * 255).astype(np.uint8)
            if video_length == 1:
                path = os.path.join(out_dir, f"{i:02d}_{tag}.png")
                save_image(path, frames[0])
            else:
                path = os.path.join(out_dir, f"{i:02d}_{tag}.mp4")
                save_video(path, frames, fps=8)
        logger.info(f"[{i + 1}/{len(prompts)}] {prompt!r}: latents in {latents_s:.2f} s"
                    + ("" if decode_s is None else f", decoded in {decode_s:.2f} s") + f" on {dev} -> {path}")
        records.append(dict(prompt=prompt, path=path, latents=latents.float().cpu(),
                            latents_s=latents_s, decode_s=decode_s))
    if ctx is not None:
        barrier()
    return records


def cli(argv=None) -> List[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    return main(load_config(a.config, a.overrides), device=a.device)


if __name__ == "__main__":
    cli()
