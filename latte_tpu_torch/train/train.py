"""Training entry point (port of ``latte_tpu/train/train.py``), on one GPU
or one process per GPU.

Builds the model, AdamW, the EMA and the diffusion from a config, feeds a
latent cache, a dataset of videos or frames (``data/datasets.py``), or,
when ``data_path`` does not exist, synthetic latents or pixels
(``synthetic_kind``), and runs the training step (``train/step.py``).
Pixel batches travel as uint8 and are VAE-encoded inside the step by the
frozen VAE of ``vae_ckpt`` (``random``: the full SD VAE from a seed; else a
diffusers state dict file), which is in neither the optimizer, the EMA nor
the checkpoint. The kernels of
``latte_tpu_torch/kernels`` carry every attention and adaLN forward, and
the flash-attention backward. It syncs with the host once per
``log_every`` steps, writes a checkpoint every ``ckpt_every`` steps and at
the end, and resumes from ``resume_from_checkpoint``. The step loop's
checkpoints are written in a background thread after a copy to the host
(``async_checkpoint``, default true as in the JAX trainer); the final one
blocks, and every exit path waits for the write in flight.

It trains the video model (``Latte-*``) and the joint video-image model
(``LatteIMG-*`` with ``use_image_num`` still images behind the video frames),
unconditional, class-conditional (``extras: 2``; the batches carry ``y``,
and ``y_image`` for the images) or text-conditioned (``extras: 78``; on
synthetic latents alone, which carry ``text_embedding``: no dataset provides
text embeddings, in either package). ``pretrained`` partially loads a checkpoint
before training, ``fixed_spatial`` trains the temporal attention alone,
``gradient_accumulation_steps`` splits each batch into chunks,
``adam_mu_dtype: bfloat16`` stores AdamW's first moment in bf16 and
``remat_policy: dots`` keeps the matmul outputs under gradient checkpointing.
``moe_experts > 1`` trains the Mixture-of-Experts model (``moe_top_k``,
``moe_capacity_factor``) with the Switch loss at ``moe_aux_weight``
(default 0.01, as in the JAX trainer; 0 for a dense model); ``quant_train``
with MoE raises (no int8 expert path, as in JAX).

Several GPUs, one process each (``torchrun``, or the JAX trainer's
``coordinator_address``/``num_processes``/``process_id``): the mesh is dp ×
``expert_parallel`` × ``sequence_parallel`` × ``tensor_parallel`` ×
``pipeline_parallel`` (``dist/mesh.py``), the global batch
``local_batch_size·dp`` (each rank its dp index's rows; the members of an
ep, sp, tp or pp group share them), the
experts split over ep, the blocks' heads and MLP columns over tp (Megatron,
``dist/tp.py``; the model is initialised whole and each rank keeps its
part), the model's fused batch·token rows over sp (``models/dit.py``,
``dist/seq.py``), ``fsdp`` splits the block weights, their EMA and their
moments over dp and ``zero1`` the moments (``dist/sharding.py``); tp
composes with each of dp, ep, fsdp and zero1, as the JAX rules compose.
``pipeline_parallel`` S splits the block pairs by depth (each rank builds
and holds its stage's pairs alone, ``dist/pipeline.py``) and streams
``pp_microbatches`` (default ``max(2, 2·S)``) of each forward's rows
through the stages; it composes with dp and ``zero1`` only (the JAX
trainer's errors otherwise), and turns the MoE Switch loss off with the JAX
trainer's warning. Every stage of a dp row reads the same rows: each takes
the loss on the replicated output, so each needs the latents and targets.
Rank 0 makes the experiment directory, logs and writes the full checkpoints
(the one-process format, gathered over dp, ep, tp and pp); the logged
metrics are the global batch's. Unlike the JAX trainer, the
port keeps its fused adaLN kernels on any mesh: each rank runs them on its
own rows (the JAX trainer drops ``fused_adaln`` there because a
``pallas_call`` is opaque to GSPMD's partitioner).

On one process the step runs as CUDA graphs (``train.step.
GraphedTrainStep``, the JAX trainer's ``jax.jit(train_step,
donate_argnums=(0,))``): the first step eagerly, as the warm-up, then the
step is captured, and every later step copies its batch and its draws into
the static buffers and replays it; the state (parameters, gradients, AdamW
moments, EMA) is updated in place. The frozen VAE's encode of a pixel batch
is inside the graph, as the JAX ``encode_fn`` is inside its jit. On the CPU,
which only tests ask for, the same runner calls the step's body. What
stays eager, and why, is logged once at the start:

- any run over several processes (dp, ``zero1``, ``fsdp``, ep, tp, sp, pp:
  a ``ShardedParams`` step): its collectives run over NCCL, which this port
  does not capture in a graph;
- pipeline parallelism (``apply_fn``), which is one of those runs.

``main(..., graph_step=False)`` runs the same step eagerly on one process
(the tests and the smoke script hold the graph against it).

Runs on ``cuda`` unless asked for the CPU::

    python -m latte_tpu_torch.train.train --config configs/ffs/ffs_train.yaml \\
        [--device cpu] [key=value ...]
    torchrun --nproc_per_node=4 -m latte_tpu_torch.train.train \\
        --config configs/ffs/ffs_train_moe.yaml
"""

from __future__ import annotations

import argparse
import copy
import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from latte_tpu_torch.config import Config, load_config
from latte_tpu_torch.config.loader import save_config
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.core.timestep_samplers import LossAwareSampler, create_named_schedule_sampler
from latte_tpu_torch.dist.mesh import barrier, batch_rows, setup, shard_batch
from latte_tpu_torch.dist.sharding import ZERO1_EP_ERROR, ShardedParams, apply_fsdp, tp_shard_state_dict
from latte_tpu_torch.models import get_models
from latte_tpu_torch.models.registry import LatteIMG_models
from latte_tpu_torch.train.callbacks import CallbackList
from latte_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    latest_checkpoint_under,
    load_checkpoint,
    load_pretrained,
    restore_train_state,
    save_checkpoint,
    wait_for_saves,
)
from latte_tpu_torch.train.state import (
    create_train_state,
    make_lr_schedule,
    make_optimizer,
    trainable_temporal_attn_mask,
)
from latte_tpu_torch.train.step import GraphedTrainStep, make_train_step
from latte_tpu_torch.utils import create_experiment_dir, create_logger
from latte_tpu_torch.vae import build_vae, make_encode_fn

__all__ = [
    "build_encode_fn", "build_encode_fn_raw", "check_config", "make_batch_iterator", "moe_aux_weight",
    "pp_microbatches", "main", "cli",
]

# the JAX trainer's warning for MoE under pipeline parallelism
PP_MOE_AUX_WARNING = (
    "pipeline_parallel > 1 discards moe_aux_weight={}: the MoE load-balancing loss is not collectable "
    "through the pipelined forward; routing balance is unregularized on this run"
)

def check_config(config: Config, world: int = 1) -> None:
    """Raise for what the trainer refuses before anything is built: the JAX
    trainer's mesh errors (``pipeline_parallel`` with tensor or sequence
    parallelism, with ``fsdp`` or with ``expert_parallel``, ``ValueError``; a
    mesh that does not divide the ``world`` size, ``AssertionError``; a
    per-forward batch that ``pp_microbatches`` does not divide,
    ``AssertionError``; ``moe_experts`` that ``expert_parallel`` does not
    divide and ``zero1`` with ``expert_parallel``, ``ValueError``), and the
    port's own ``AssertionError`` when a rank's share of a forward's rows is
    not a multiple of ``pp_microbatches`` (each rank streams its own rows),
    ``ValueError`` for a LatteIMG
    model with ``sequence_parallel`` (which the JAX LatteIMG cannot take),
    and ``ValueError`` for gradient accumulation that does not divide the
    batch and for ``extras: 78`` on batches that carry no text (a dataset, a
    latent cache, synthetic pixels)."""
    tp, sp, pp, ep = (int(getattr(config, k, 1) or 1) for k in
                      ("tensor_parallel", "sequence_parallel", "pipeline_parallel", "expert_parallel"))
    if pp > 1:
        if tp > 1 or sp > 1:
            raise ValueError(
                "pipeline_parallel composes with data parallelism only "
                f"(got tensor_parallel={tp}, sequence_parallel={sp})"
            )
        if getattr(config, "fsdp", False):
            raise ValueError("pipeline_parallel already shards the block stack; disable fsdp (zero1 moment "
                             "sharding is compatible)")
        if ep > 1:
            raise ValueError("expert_parallel does not compose with pipeline_parallel (the pipelined stage "
                             "shards the pair stack wholesale)")
    if world % (tp * sp * pp * ep):
        raise AssertionError(
            f"tensor_parallel={tp} x sequence_parallel={sp} x pipeline_parallel={pp} x "
            f"expert_parallel={ep} must divide {world} devices"
        )
    if pp > 1:
        accum = int(getattr(config, "gradient_accumulation_steps", 1) or 1)
        local = int(getattr(config, "local_batch_size", 5))
        dp = world // (tp * sp * pp * ep)
        global_batch, m = local * dp, pp_microbatches(config)
        fwd_batch = global_batch // accum
        if fwd_batch % m:
            raise AssertionError(
                f"per-forward batch {fwd_batch} (global {global_batch} / grad_accum {accum}) not divisible by "
                f"pp_microbatches={m}"
            )
        if (local // accum) % m:
            raise AssertionError(
                f"a rank's per-forward rows {local // accum} (local_batch_size {local} / grad_accum {accum}) "
                f"not divisible by pp_microbatches={m}: each rank streams its own rows through the stages"
            )
    moe_experts = int(getattr(config, "moe_experts", 0) or 0)
    if ep > 1 and (moe_experts % ep != 0 or moe_experts < ep):
        raise ValueError(f"expert_parallel={ep} needs moe_experts (got {moe_experts}) divisible by it")
    if ep > 1 and getattr(config, "zero1", False) and not getattr(config, "fsdp", False):
        raise ValueError(ZERO1_EP_ERROR)
    if sp > 1 and config.model in LatteIMG_models:
        raise ValueError(
            f"{config.model} with sequence_parallel={sp}: the JAX LatteIMG has no activation_sharding "
            "(latte_tpu/models/dit_img.py), so neither package splits its rows over sp"
        )
    extras = int(getattr(config, "extras", 1))
    if extras not in (1, 2, 78):
        raise ValueError(f"extras={extras}: expected 1 (unconditional), 2 (class) or 78 (text)")
    data_path = str(getattr(config, "data_path", "") or "")
    if extras == 78 and (os.path.isdir(data_path) or str(getattr(config, "synthetic_kind", "latents")) == "pixels"):
        raise ValueError(
            "extras: 78 trains on text embeddings, and no dataset provides them (a data_path folder, a "
            "latent cache and synthetic pixels carry none, as in the JAX trainer); leave data_path unset "
            "for synthetic latents"
        )
    accum = int(getattr(config, "gradient_accumulation_steps", 1) or 1)
    batch = int(getattr(config, "local_batch_size", 5))
    if accum < 1 or batch % accum:
        raise ValueError(f"gradient_accumulation_steps={accum} must divide local_batch_size={batch}")


def pp_microbatches(config: Config) -> int:
    """The microbatches a pipelined forward streams: ``pp_microbatches``,
    by default ``max(2, 2·pipeline_parallel)``, as in the JAX trainer."""
    pp = int(getattr(config, "pipeline_parallel", 1) or 1)
    return int(getattr(config, "pp_microbatches", 0) or 0) or max(2, 2 * pp)


def moe_aux_weight(config: Config) -> float:
    """The Switch loss's weight: ``moe_aux_weight`` (0.01 when unset; a
    null turns it off) for an MoE model, 0 for a dense one, as the JAX
    trainer sets it."""
    if int(getattr(config, "moe_experts", 0) or 0) <= 1:
        return 0.0
    return float(getattr(config, "moe_aux_weight", 0.01) or 0.0)


def build_encode_fn(config: Config, device) -> Optional[Callable]:
    """The fused VAE encode, or ``None`` when ``vae_ckpt`` is not set:
    ``encode(video, generator, noise=None) -> latents``, (B, F, 3, H, W)
    fp32 pixels in [-1, 1] to a posterior sample (B, F, 4, H/8, W/8) times
    ``vae_scale``, the frames encoded in one (B·F, 3, H, W) batch; the
    sample's noise is ``noise`` when given (the train step draws it before
    the step's arithmetic), else drawn from ``generator``.
    ``encode.posterior_spec(video_shape)`` is that noise's (shape, dtype),
    ``encode.raw`` the posterior encoder on flat frames
    (``vae.make_encode_fn``), ``encode.vae`` the frozen VAE.

    ``vae_ckpt: random`` is the full SD VAE with seeded random weights; a
    file is a diffusers state dict (``vae.build_vae``). A path that does not
    exist raises ``FileNotFoundError``, as the JAX trainer does (the sampler
    falls back to latents instead)."""
    vae_ckpt = str(getattr(config, "vae_ckpt", None) or "")
    if not vae_ckpt:
        return None
    if vae_ckpt != "random" and not os.path.exists(vae_ckpt):
        raise FileNotFoundError(
            f"vae_ckpt {vae_ckpt!r} does not exist: give a diffusers AutoencoderKL state dict "
            "file, or vae_ckpt: random for a smoke run"
        )
    vae = build_vae(vae_ckpt, device).requires_grad_(False)
    raw = make_encode_fn(vae)
    scale = float(getattr(config, "vae_scale", 0.18215))

    def encode(video: torch.Tensor, generator: Optional[torch.Generator], draws=None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.profiler.record_function("vae_encode"):
            B, F = video.shape[:2]
            post = raw(video.reshape(B * F, *video.shape[2:]))
            if noise is None and draws is not None:
                # draws (train.step.Draws): the posterior noise of the global batch, cut to these rows
                noise = draws.randn(post.mean.shape, generator, video.device, post.mean.dtype)
            z = post.sample(generator, noise) * scale
            return z.reshape(B, F, *z.shape[1:])

    def posterior_spec(video_shape) -> Tuple[tuple, torch.dtype]:
        """The posterior's (B·F, C, h, w) and type for a (B, F, 3, H, W) video:
        each of the encoder's downsamplers halves h and w, rounding down."""
        B, F, _, h, w = video_shape
        for _ in range(len(vae.encoder.down_blocks) - 1):
            h, w = h // 2, w // 2
        return (B * F, vae.quant_conv.out_channels // 2, h, w), vae.quant_conv.weight.dtype

    encode.raw, encode.vae, encode.posterior_spec = raw, vae, posterior_spec
    return encode


def build_encode_fn_raw(config: Config, device) -> Callable:
    """The frozen VAE of :func:`build_encode_fn` as a posterior encoder,
    ``(N, 3, H, W) -> DiagonalGaussianDistribution``, for
    ``tools/cache_latents.py``."""
    encode = build_encode_fn(config, device)
    if encode is None:
        raise ValueError("latent caching needs vae_ckpt set in the config")
    return encode.raw


def make_batch_iterator(
    config: Config, logger, batch_size: int, ctx=None
) -> Tuple[Iterator[Dict[str, np.ndarray]], str]:
    """The batches and their kind, by what ``data_path`` holds: a latent
    cache ("latents_cached"; a cache is a directory too, so it is tested
    first), a dataset of videos or frames ("real", ``get_dataset``; uint8
    pixels unless ``pixel_transport`` is not "uint8"), or nothing: synthetic
    uint8 pixels (B, F, 3, S, S) with ``synthetic_kind: pixels``
    ("synthetic_pixels"), else synthetic latents ("synthetic_latents"),
    both from ``global_seed``. F counts the ``use_image_num`` still images
    too; a class-conditional config's synthetic batches draw ``y`` (B,) in
    [0, ``num_classes``) after the data, and ``y_image`` (B, I) after it
    under ``use_image_num``; a text-conditioned one (``extras: 78``)
    standard-normal ``text_embedding`` (B, 77, 768) after the data, as the
    JAX trainer's latent batches do ((B, 1 + I, 768) for LatteIMG, the shape
    its model takes).

    Over several GPUs (``ctx``) ``batch_size`` is a rank's: a dataset's
    loader reads the dp index's shard of every epoch (``shard_id``/
    ``num_shards`` = dp index/dp; the ranks of an ep group read the same
    rows), and synthetic batches are drawn for the global batch and cut to
    the dp index's rows, so any world size draws the one-process batches."""
    from latte_tpu_torch.data import DataLoader, LatentCacheDataset, get_dataset, is_latent_cache

    dp, dp_rank = (ctx.dp, ctx.dp_rank) if ctx is not None else (1, 0)

    data_path = str(getattr(config, "data_path", "") or "")
    latent = int(getattr(config, "latent_size", 0) or int(config.image_size) // 8)
    frames = int(getattr(config, "num_frames", 16)) + int(getattr(config, "use_image_num", 0) or 0)
    seed = int(getattr(config, "global_seed", 0))
    num_workers = int(getattr(config, "num_workers", 4) or 4)
    if is_latent_cache(data_path):
        dataset = LatentCacheDataset(data_path)
        logger.info(
            f"latent cache {data_path}: {len(dataset)} items "
            f"({dataset.meta['frames']}f, latent {dataset.meta['latent_shape']})"
        )
        cache_scale = float(dataset.meta.get("vae_scale", 0.18215))
        if abs(cache_scale - float(getattr(config, "vae_scale", cache_scale))) > 1e-9:
            logger.warning(
                f"latent cache was encoded with vae_scale={cache_scale} but the config says "
                f"{config.vae_scale}; using the cache's scale"
            )
        config.vae_scale = cache_scale
        loader = DataLoader(dataset, batch_size=batch_size, num_workers=num_workers, seed=seed,
                            shard_id=dp_rank, num_shards=dp)
        return iter(loader), "latents_cached"
    if os.path.isdir(data_path):
        dataset = get_dataset(config)
        logger.info(f"dataset {config.dataset}: {len(dataset)} videos")
        loader = DataLoader(
            dataset, batch_size=batch_size, num_workers=num_workers, seed=seed,
            pixel_uint8=str(getattr(config, "pixel_transport", "uint8")) == "uint8",
            shard_id=dp_rank, num_shards=dp,
        )
        return iter(loader), "real"
    rng = np.random.default_rng(seed)
    batch_size *= dp  # the global batch; shard_batch cuts this rank's rows
    # the CLIP features of a text-conditioned model: Latte's flattened (77, 768),
    # LatteIMG's a row per frame kind (1 + I, 768)
    text_shape = (batch_size, 77, 768)
    if config.model in LatteIMG_models:
        text_shape = (batch_size, 1 + int(getattr(config, "use_image_num", 0) or 0), 768)

    def with_conditioning(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        extras = int(getattr(config, "extras", 1))
        if extras == 2:
            nc = int(getattr(config, "num_classes", 1) or 1)
            batch["y"] = rng.integers(0, nc, size=(batch_size,), dtype=np.int32)
            if getattr(config, "use_image_num", 0):
                batch["y_image"] = rng.integers(0, nc, size=(batch_size, int(config.use_image_num)), dtype=np.int32)
        elif extras == 78:
            batch["text_embedding"] = rng.standard_normal(text_shape, dtype=np.float32)
        return batch

    if str(getattr(config, "synthetic_kind", "latents")) == "pixels":
        # the compute and transfer of the real-data path (uint8 video through
        # the fused encode) without the host's decode and transforms
        logger.info("data_path missing — using synthetic uint8 pixel batches")
        size = int(config.image_size)

        def synthetic_pixels():
            while True:
                yield shard_batch(with_conditioning(
                    {"video": rng.integers(0, 256, size=(batch_size, frames, 3, size, size), dtype=np.uint8)}
                ), ctx)

        return synthetic_pixels(), "synthetic_pixels"
    logger.info("data_path missing — using synthetic latent batches")

    def synthetic():
        while True:
            yield shard_batch(with_conditioning({
                "latents": rng.standard_normal(
                    (batch_size, frames, 4, latent, latent), dtype=np.float32
                )
            }), ctx)

    return synthetic(), "synthetic_latents"


def _step_seed(seed: int, step: int) -> int:
    """A generator seed per (run seed, step): a resumed run draws what an
    uninterrupted one would (the JAX step's ``fold_in(rng, step)``)."""
    return (seed * 1_000_003 + step) % (2**63)


def main(config: Config, callbacks=None, device: Optional[str] = None, *, graph_step: bool = True) -> dict:
    """Train; returns ``{"experiment_dir", "final_step", "loss", "grad_norm",
    "steps_per_sec"}`` (the last three from the last log interval; an MoE
    model's ``moe_aux`` too). Over several GPUs every rank returns the same
    metrics, and the experiment directory rank 0 made. On one process the
    step is graphed (see the module docstring) unless ``graph_step`` is
    False."""
    # the rendezvous before anything else, as the JAX trainer's
    dev, ctx = setup(config, device, check=lambda world: check_config(config, world))
    main_rank = ctx is None or ctx.rank == 0
    cbs = CallbackList(callbacks)
    results_dir = str(getattr(config, "results_dir", "./results"))
    if main_rank:
        experiment_dir = create_experiment_dir(results_dir, config)
        save_config(config, os.path.join(experiment_dir, "config.yaml"))
        os.makedirs(os.path.join(experiment_dir, "checkpoints"), exist_ok=True)
    barrier()
    if not main_rank:
        # join the directory rank 0 just made: the highest NNN-<name> index
        exps = [d for d in os.listdir(results_dir) if "-" in d and d.split("-")[0].isdigit()]
        experiment_dir = os.path.join(results_dir, max(exps, key=lambda d: int(d.split("-")[0])))
    logger = create_logger(experiment_dir if main_rank else None, enabled=main_rank)
    ckpt_dir = os.path.join(experiment_dir, "checkpoints")
    seed = int(getattr(config, "global_seed", 0))

    quantized = "train" if getattr(config, "quant_train", False) else False
    with torch.device(dev):
        # quant_train: W8A8 forward of the block matmuls from fp32 masters,
        # straight-through backward (the JAX trainer's quantized="train")
        model = get_models(config, quantized=quantized, moe_mesh=ctx, mesh=ctx)
        # under tp the model is drawn whole, as in one process, and each rank keeps its part
        whole = get_models(config, quantized=quantized, moe_mesh=ctx) if model.tp > 1 else model
    whole.initialize_weights(torch.Generator(device=dev).manual_seed(seed))
    pretrained = getattr(config, "pretrained", None)
    if pretrained:
        kept = load_pretrained(whole, str(pretrained), ctx)
        logger.info(f"partial-loaded pretrained {pretrained} ({kept} keys kept at init)")
    if whole is not model:
        model.load_state_dict(tp_shard_state_dict(whole.state_dict(), ctx.tp, ctx.tp_rank))
        del whole
    if getattr(config, "mixed_precision", False):
        # bf16 compute over fp32 master parameters (model.clone(dtype=bfloat16))
        model.compute_dtype = torch.bfloat16
    if getattr(config, "fixed_spatial", False):
        # fine-tune the temporal attention alone; the rest is frozen
        for name, trainable in trainable_temporal_attn_mask(model).items():
            model.get_parameter(name).requires_grad_(trainable)
    model.train()
    max_steps = int(getattr(config, "max_train_steps", 1000))
    schedule = make_lr_schedule(
        float(getattr(config, "learning_rate", 1e-4)),
        int(getattr(config, "lr_warmup_steps", 0) or 0),
        schedule=str(getattr(config, "lr_schedule", "warmup") or "warmup"),
        decay_steps=int(getattr(config, "lr_decay_steps", 0) or max_steps or 0),
        lr_min=float(getattr(config, "lr_min", 0.0) or 0.0),
    )
    # bf16 first-moment storage; nu and the EMA stay fp32
    mu_dtype = torch.bfloat16 if str(getattr(config, "adam_mu_dtype", "") or "") == "bfloat16" else None
    ema = copy.deepcopy(model).requires_grad_(False)
    shards = None
    if ctx is not None:
        fsdp = bool(getattr(config, "fsdp", False))
        if fsdp:
            apply_fsdp(model, ctx)
            apply_fsdp(ema, ctx)
        shards = ShardedParams(model, ctx, zero1=bool(getattr(config, "zero1", False)) and not fsdp)
        logger.info(
            f"{ctx.world} processes ({torch.distributed.get_backend()}): dp {ctx.dp} x ep {ctx.ep}, global batch "
            f"{int(getattr(config, 'local_batch_size', 5)) * ctx.dp}, fsdp {fsdp}, "
            f"zero1 {bool(getattr(config, 'zero1', False)) and not fsdp}, sequence_parallel {ctx.sp}, "
            f"tensor_parallel {ctx.tp}, pipeline_parallel {ctx.pp}"
        )
    optimizer = make_optimizer(model, float(getattr(config, "weight_decay", 0.0)), mu_dtype=mu_dtype,
                               params=shards.leaves if shards is not None else None)
    state = create_train_state(model, optimizer, schedule, ema)
    logger.info(
        f"{config.model} on {dev}: {sum(p.numel() for p in model.parameters()):,} parameters "
        f"({sum(p.numel() for p in model.parameters() if p.requires_grad):,} trainable), "
        f"compute {model.compute_dtype or torch.float32}, "
        f"gradient checkpointing {model.gradient_checkpointing} ({model.remat_policy}), "
        f"int8 training {model.quantized == 'train'}, Adam mu {mu_dtype or torch.float32}, "
        f"experts {model.moe_experts or 1} (Switch loss weight {moe_aux_weight(config)})"
    )

    resume = getattr(config, "resume_from_checkpoint", None)
    start_step = 0
    if resume:
        if os.path.isfile(str(resume)):
            path = str(resume)
        elif os.path.isdir(str(resume)):
            path = latest_checkpoint(str(resume))
        else:  # `true`: the newest checkpoint of this model under results_dir
            path = latest_checkpoint_under(
                str(getattr(config, "results_dir", "./results")), model=str(config.model)
            )
        if path is None:
            logger.warning(f"resume_from_checkpoint={resume!r}: no checkpoint found; starting from scratch")
        else:
            restore_train_state(state, load_checkpoint(path), shards)
            start_step = state.step
            logger.info(f"resumed from {path} @ step {start_step}")

    local_batch = int(getattr(config, "local_batch_size", 5))
    grad_accum = int(getattr(config, "gradient_accumulation_steps", 1) or 1)
    if grad_accum > 1:
        logger.info(f"gradient accumulation: {grad_accum} chunks/step")
    batches, data_kind = make_batch_iterator(config, logger, local_batch, ctx)
    if start_step and data_kind.startswith("synthetic"):
        # a resumed run takes the batches an unbroken one would
        for _ in range(start_step):
            next(batches)
    needs_encode = data_kind in ("real", "synthetic_pixels")
    encode_fn = build_encode_fn(config, dev) if needs_encode else None
    if needs_encode and encode_fn is None:
        raise ValueError(
            "the batches are raw pixels but no VAE is configured: set vae_ckpt to a diffusers "
            "AutoencoderKL state dict file, or vae_ckpt: random for a smoke run"
        )
    if not needs_encode and getattr(config, "vae_ckpt", None):
        logger.info(f"{data_kind} batches: VAE encode skipped (latents direct)")
    diffusion = create_diffusion("", diffusion_steps=1000)
    aux_weight, apply_fn = moe_aux_weight(config), None
    if ctx is not None and ctx.pp > 1:
        from latte_tpu_torch.dist.pipeline import make_pipelined_apply

        # each rank's forward rows stream through the stages in M microbatches
        apply_fn = make_pipelined_apply(model, ctx, pp_microbatches(config))
        logger.info(f"pipeline parallelism: pp={ctx.pp} stages x {pp_microbatches(config)} microbatches "
                    f"(this stage: pairs {model.pp_rank * (model.depth // 2 // ctx.pp)}.."
                    f"{(model.pp_rank + 1) * (model.depth // 2 // ctx.pp) - 1})")
        if aux_weight > 0.0:
            logger.warning(PP_MOE_AUX_WARNING.format(aux_weight))
            aux_weight = 0.0
    train_step = make_train_step(
        diffusion,
        ema_decay=float(getattr(config, "ema_decay", 0.9999)),
        ema_every=int(getattr(config, "ema_every", 1) or 1),
        clip_max_norm=float(getattr(config, "clip_max_norm", 0.1)),
        start_clip_iter=int(getattr(config, "start_clip_iter", 0) or 0),
        vae_scale=float(getattr(config, "vae_scale", 0.18215)),
        encode_fn=encode_fn,
        grad_accum=grad_accum,
        moe_aux_weight=aux_weight,
        shards=shards,
        apply_fn=apply_fn,
    )
    if ctx is None and graph_step:
        train_step = GraphedTrainStep(train_step)
        logger.info("train step: one program, a CUDA graph of forward, backward, clip, AdamW and EMA, "
                    "captured after the first (eager) step and replayed every step"
                    + ("" if dev.type == "cuda" else f" (on {dev}: the body is called instead)"))
    elif ctx is None:
        logger.info("train step: eager (graph_step=False)")
    else:
        logger.info(f"train step: eager over {ctx.world} processes: its collectives run over NCCL, which is "
                    "not captured in a graph (dp, zero1, fsdp, ep, tp, sp and pp stay eager)")
    schedule_sampler = create_named_schedule_sampler(
        str(getattr(config, "schedule_sampler", "uniform") or "uniform"), diffusion
    )

    log_every = int(getattr(config, "log_every", 100))
    ckpt_every = int(getattr(config, "ckpt_every", 10000))
    # the step loop's saves write in the background (JAX's default)
    async_ckpt = bool(getattr(config, "async_checkpoint", True))
    args = config.to_dict() if isinstance(config, Config) else dict(config)
    generator = torch.Generator(device=dev)
    cbs.on_train_start(config, state, experiment_dir)
    try:
        result = _train_loop(
            config, state, cbs, batches, train_step, schedule_sampler, generator, logger, dev, ctx, shards, args,
            ckpt_dir=ckpt_dir, seed=seed, start_step=start_step, max_steps=max_steps, local_batch=local_batch,
            grad_accum=grad_accum, log_every=log_every, ckpt_every=ckpt_every, async_ckpt=async_ckpt,
        )
    finally:
        # on every exit path the write in flight reaches the disk, and no
        # writer thread outlives the run (a failed write raises here)
        wait_for_saves()
        if isinstance(train_step, GraphedTrainStep):
            train_step.release()  # the graphs' memory, before the caller's next run
    barrier()
    result = {"experiment_dir": experiment_dir, **result}
    cbs.on_train_end(result)
    return result


def _train_loop(config, state, cbs, batches, train_step, schedule_sampler, generator, logger, dev, ctx, shards, args,
                *, ckpt_dir, seed, start_step, max_steps, local_batch, grad_accum, log_every, ckpt_every,
                async_ckpt) -> dict:
    """The step loop and its checkpoints; the final checkpoint blocking."""
    loss_aware = isinstance(schedule_sampler, LossAwareSampler)
    running, t_start = 0, time.perf_counter()
    last_metrics: dict = {}
    stop_step, last_ckpt_step = max_steps, None
    for step_idx in range(start_step, max_steps):
        generator.manual_seed(_step_seed(seed, step_idx))
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in next(batches).items()}
        if loss_aware:
            # drawn for the global batch; this rank's rows
            t, w = schedule_sampler.sample(generator, local_batch * (ctx.dp if ctx else 1))
            rows = batch_rows(local_batch, ctx)
            batch["t"], batch["t_weights"] = t[rows], w[rows]
        metrics = train_step(state, batch, generator)
        if loss_aware:
            schedule_sampler.update_with_local_losses(
                *(gather_rows(metrics[k], ctx, grad_accum) for k in ("t_sampled", "per_sample_loss"))
            )
        running += 1
        if (step_idx + 1) % log_every == 0:
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])  # the host sync
            steps_per_sec = running / (time.perf_counter() - t_start)
            last_metrics = {"loss": loss, "grad_norm": gnorm, "steps_per_sec": steps_per_sec}
            if "moe_aux" in metrics:
                last_metrics["moe_aux"] = float(metrics["moe_aux"])
            logger.info(
                f"step {step_idx + 1}: loss={loss:.4f} grad_norm={gnorm:.3f} steps/s={steps_per_sec:.3f}"
                + (f" moe_aux={last_metrics['moe_aux']:.4f}" if "moe_aux" in last_metrics else "")
            )
            cbs.on_log(step_idx + 1, last_metrics)
            if cbs.should_stop(step_idx + 1, last_metrics):
                logger.info(f"early stop requested at step {step_idx + 1}")
                stop_step = step_idx + 1
                break
            running, t_start = 0, time.perf_counter()
        if (step_idx + 1) % ckpt_every == 0:
            path = save_checkpoint(os.path.join(ckpt_dir, f"{step_idx + 1:07d}.pt"), state, args, shards,
                                   block=not async_ckpt)
            last_ckpt_step = step_idx + 1
            logger.info(f"saved checkpoint {path}" + (" (writing in the background)" if async_ckpt else ""))
            cbs.on_checkpoint(step_idx + 1, path)

    # a final checkpoint unless that step was just saved or nothing trained;
    # the write in flight lands first, as in JAX
    wait_for_saves()
    if last_ckpt_step != stop_step and stop_step > start_step:
        path = save_checkpoint(os.path.join(ckpt_dir, f"{stop_step:07d}.pt"), state, args, shards)
        logger.info(f"saved checkpoint {path}")
        cbs.on_checkpoint(stop_step, path)
    return {"final_step": stop_step, **last_metrics}


def gather_rows(x: torch.Tensor, ctx, chunks: int = 1) -> torch.Tensor:
    """A step's per-row values (this rank's rows, chunk by chunk) for the
    global batch, in the order one process lists them: chunk-major, then
    the dp indices' rows (all-gathered over dp; the ep replicas are
    equal)."""
    if ctx is None or ctx.dp == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(ctx.dp)]
    torch.distributed.all_gather(parts, x.contiguous(), group=ctx.dp_group)
    return torch.stack(parts).view(ctx.dp, chunks, -1).transpose(0, 1).reshape(-1)


def cli(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    return main(load_config(a.config, a.overrides), device=a.device)


if __name__ == "__main__":
    cli()
