"""Single-device sampling entry point (port of ``latte_tpu/sample/sample.py``).

Builds the model from a config, loads a reference-format checkpoint (or
initialises it from a seed when ``ckpt`` is null), runs the respaced DDPM or
DDIM loop, decodes the latents with the SD VAE and writes the frames to
``save_video_path`` as an mp4 at 8 fps (OpenCV). The VAE comes from ``vae:
tiny`` or ``vae_ckpt: random`` (seeded random weights: a tiny VAE or the full
SD architecture) or from ``vae_ckpt``, a diffusers ``AutoencoderKL`` state
dict (``diffusion_pytorch_model.bin``). ``moe_experts`` serves the
Mixture-of-Experts model (exactly or with the block cache; not in int8,
which raises before anything is built). With no VAE configured, or a
``vae_ckpt`` that does not exist, it saves the latents as ``<save_video_path
stem>_latents.npz`` instead, as the JAX sampler does.

Tensor-parallel serving (``tensor_parallel: N``, the JAX sampler's
Megatron split, ``latte_tpu/sample/sample.py:117-185``): N processes, one a
GPU (``torchrun --nproc_per_node=N``, or ``coordinator_address``/
``num_processes``/``process_id``), each holding its heads and MLP columns of
the model (``dist/tp.py``). Every rank builds the whole model (and, in int8,
calibrates and quantizes it) as one process does, keeps its part, and draws
the same z, labels and noise; each step's forward is one all-reduce after
each attention and each MLP. Rank 0 decodes and writes the video. It
composes with CFG, the block cache and the int8 modes; as in JAX it needs
``loop_mode: scan`` (``ValueError``), and N processes.

``loop_mode`` is JAX's: ``scan`` (the default) runs the trajectory as one
program, a CUDA graph of the sampler's step captured once on static buffers
and replayed once a timestep (:mod:`latte_tpu_torch.core.step_graph`; on
the CPU the same static-buffer runner calls the step), ``host`` the eager
Python loop over the step. :func:`build_sample_fn` builds the sampler once
for many calls, as JAX's does. A step that holds a collective (tensor
parallelism's all-reduces, an MoE model's dispatch over a mesh) runs the
eager loop under ``scan``: no collective is captured in a graph.

``block_cache_interval: N`` (> 1) samples with the block cache
(:mod:`latte_tpu_torch.core.block_cache`): the first ``block_cache_pairs``
pairs (default 2/3 of them, rounded down) are recomputed only every Nth
step. It composes with CFG and with the int8 modes below (the partial
forward uses the full model's static scales), and, as in the JAX sampler,
needs ``loop_mode: scan``. :func:`sample_loop` is the one construction of
the sampler, which this entry point and ``sample_many`` share.

W8A8 int8 serving, as in the JAX sampler: ``quantized: true`` quantizes the
fp32 weights once (dynamic per-token activation scales); ``quantized:
static`` first calibrates the activation amax over three forwards (t = 999,
500, 0) on one seeded z, then serves with static scales, and with
``int8_attention`` (true/"full" or "qk") runs the attention core in int8 too.

Runs on ``cuda`` unless asked for the CPU::

    python -m latte_tpu_torch.sample.sample --config configs/ffs/ffs_sample.yaml \
        [--device cpu] [key=value ...]
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from typing import Optional

import numpy as np
import torch

from latte_tpu_torch.config import Config, load_config
from latte_tpu_torch.convert import load_reference_checkpoint
from latte_tpu_torch.core.block_cache import cached_step, run_cached_steps
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.core.samplers import cfg_model_fn, denoise_step, run_steps
from latte_tpu_torch.core.step_graph import GraphedStep
from latte_tpu_torch.dist.mesh import MeshConfig, barrier, setup
from latte_tpu_torch.dist.sharding import tp_shard_state_dict
from latte_tpu_torch.models import Latte, get_models
from latte_tpu_torch.models.layers import MOE_INT8_REFUSAL
from latte_tpu_torch.models.moe import MoEMlp
from latte_tpu_torch.quant import calibrate_act_amax, merge_amax, quantize_params
from latte_tpu_torch.utils import create_logger, resolve_device, save_video, to_uint8
from latte_tpu_torch.vae import AutoencoderKL, build_vae, make_decode_fn

CALIBRATION_TIMESTEPS = (999, 500, 0)


def check_config(config: Config, world: Optional[int] = None) -> None:
    """Raise for a sampler option this port does not carry
    (``NotImplementedError``), a block cache or tensor parallelism without
    ``loop_mode: scan`` (``ValueError``, as in JAX) or, given the ``world``
    size, ``tensor_parallel`` on another number of processes
    (``ValueError``), before anything is built. (``block_cache_pairs`` does nothing without the interval. A
    ``vae_ckpt`` directory is refused by :func:`load_vae`.) ``quantized``
    with ``moe_experts`` raises ``NotImplementedError``: MoE has no int8
    expert path, in either package; so does ``extras: 78``, which the JAX
    sampler passes no text to."""
    block_cache_interval(config)
    tp = tensor_parallel(config)
    if tp > 1 and loop_mode(config) != "scan":
        raise ValueError("tensor_parallel serving requires loop_mode=scan")
    if tp > 1 and world is not None and world != tp:
        raise ValueError(f"tensor_parallel={tp} needs {tp} processes (one a GPU), have {world}")
    if int(getattr(config, "extras", 1)) == 78:
        raise NotImplementedError(
            "extras: 78: the JAX sampler builds a text embedding for its int8 calibration "
            "(latte_tpu/sample/sample.py:315-316) but passes none to the sample loop (sample.py:341-349), "
            "so it does not sample a text-conditioned Latte, and neither does the port; "
            "the model itself takes text_embedding (Latte.forward, forward_with_cfg)"
        )
    if quantized_mode(config) and int(getattr(config, "moe_experts", 0) or 0) > 1:
        raise NotImplementedError(MOE_INT8_REFUSAL)


def loop_mode(config: Config) -> str:
    """``loop_mode``, "scan" by default: "host" runs the eager loop, any
    other value the graphed one (the JAX loops' test)."""
    return str(getattr(config, "loop_mode", "scan") or "scan")


def block_cache_interval(config: Config) -> int:
    """``block_cache_interval`` when it turns the block cache on (> 1), else
    0. As in the JAX sampler it needs ``loop_mode: scan``."""
    interval = int(getattr(config, "block_cache_interval", 0) or 0)
    if interval <= 1:
        return 0
    if loop_mode(config) != "scan":
        raise ValueError("block_cache_interval requires loop_mode=scan")
    return interval


def tensor_parallel(config: Config) -> int:
    return int(getattr(config, "tensor_parallel", 1) or 1)


def quantized_mode(config: Config):
    """The serving mode of ``quantized``: False, True (dynamic) or "static"."""
    q = getattr(config, "quantized", False) or False
    if q not in (False, True, "static"):
        raise ValueError(f"quantized: {q!r}; expected false, true or static")
    return q


def latent_shape(config: Config, n: int) -> tuple:
    """(n, F, C, L, L): n videos' latents for ``config``."""
    latent = int(getattr(config, "latent_size", 0) or int(config.image_size) // 8)
    return (n, int(getattr(config, "num_frames", 16)), int(getattr(config, "in_channels", 4)), latent, latent)


def calibration_latents(config: Config, device: torch.device) -> torch.Tensor:
    """The one z the calibration forwards run on: (1, F, C, L, L) from
    ``torch.Generator`` seed 0 (the JAX sampler draws it from PRNGKey(0))."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(latent_shape(config, 1), generator=gen, device=device)


def calibrate(config: Config, masters: dict, dtype: torch.dtype, device: torch.device) -> dict:
    """Activation amax of the configured model in its serving type over the
    forwards at ``CALIBRATION_TIMESTEPS`` (the per-head q/k/v amax too when
    ``int8_attention`` is set)."""
    with torch.device(device):
        model = get_models(config, quantized="calib")
    model.load_state_dict(masters, strict=True)
    model.to(device=device, dtype=dtype).eval()
    z = calibration_latents(config, device)
    kwargs = {}
    if int(getattr(config, "extras", 1)) == 2:
        kwargs["y"] = torch.full((1,), int(getattr(config, "sample_class", 0)), device=device)
    amax = None
    for tc in CALIBRATION_TIMESTEPS:
        t = torch.full((1,), tc, device=device)
        amax = merge_amax(amax, calibrate_act_amax(model, z, t, **kwargs))
    return amax


def build_model(config: Config, device: torch.device, ctx=None, moe_mesh=None) -> Latte:
    """The configured model on ``device`` in the config's dtype, from ``ckpt``
    (a reference ``.pt``) or, when ``ckpt`` is null, the reference init drawn
    from ``torch.Generator`` seed 0. With ``quantized`` the int8 model,
    quantized from the fp32 weights (not from a bf16 cast of them). A
    ``ckpt`` directory (the JAX trainer's orbax checkpoint) raises
    ``NotImplementedError``: the port reads no orbax format. With ``ctx``
    (a ``DistContext`` with tp > 1) this rank's tp part of that model;
    ``moe_mesh`` the ``DistContext`` of an MoE model's dispatch groups."""
    with torch.device(device):
        model = get_models(config, moe_mesh=moe_mesh)
    ckpt = getattr(config, "ckpt", None)
    if ckpt:
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"ckpt {ckpt!r} does not exist")
        if os.path.isdir(ckpt):
            raise NotImplementedError(
                f"ckpt {ckpt!r} is a directory, as the JAX trainer's orbax checkpoints are; "
                "the port reads a reference-format .pt. Convert the checkpoint's params in a "
                "process that has JAX with latte_tpu_torch.convert.flax_to_state_dict and "
                "torch.save the state dict it returns"
            )
        sd = load_reference_checkpoint(ckpt, prefer_ema=bool(getattr(config, "prefer_ema", True)))
        model.load_state_dict(sd, strict=True)
    else:
        model.initialize_weights(torch.Generator(device=device).manual_seed(0))
    # the reference's use_fp16 switch maps to bf16, as in the JAX sampler
    dtype = torch.bfloat16 if getattr(config, "use_fp16", False) else torch.float32
    qmode = quantized_mode(config)
    if qmode:
        masters = model.state_dict()
        amax = calibrate(config, masters, dtype, device) if qmode == "static" else None
        with torch.device(device):
            model = get_models(config, quantized=qmode)
        model.load_state_dict(quantize_params(masters, act_amax=amax), strict=True)
    if ctx is not None and ctx.tp > 1:
        whole = model.state_dict()
        with torch.device(device):
            model = get_models(config, quantized=qmode, moe_mesh=moe_mesh, mesh=ctx)
        model.load_state_dict(tp_shard_state_dict(whole, ctx.tp, ctx.tp_rank), strict=True)
    return model.to(device=device, dtype=dtype).eval()


def cfg_of(config: Config) -> tuple:
    """``(use_cfg, cfg_scale)``: classifier-free guidance is on for a
    class-conditional model (``extras: 2``) at ``cfg_scale`` > 1."""
    cfg_scale = float(getattr(config, "cfg_scale", 1.0))
    return int(getattr(config, "extras", 1)) == 2 and cfg_scale > 1.0, cfg_scale


def cache_pairs(config: Config, depth: int) -> int:
    """The block cache's pair k: ``block_cache_pairs``, by default 2/3 of
    the model's pairs (rounded down); raises outside [1, pairs)."""
    n_pairs = depth // 2
    k = int(getattr(config, "block_cache_pairs", 0) or (n_pairs * 2) // 3)
    if not 1 <= k < n_pairs:
        raise ValueError(f"cache_pairs must be in [1, {n_pairs}), got {k}")
    return k


def sampler_step(model, config: Config, diffusion, depth: int):
    """The configured sampler's step over ``model`` (the module, or any
    callable taking its arguments): ``step(x, t, noise, y)`` -> next x, or
    with the block cache ``step(x, t, noise, y, front)`` -> ``(next x,
    front)`` (``front`` None: a full forward). x carries the CFG batch's
    [cond | uncond] halves. The live loop (:func:`sample_loop`) and the
    exported artifact (``serve.aot``) run this one construction."""
    method = str(getattr(config, "sample_method", "ddpm")).lower()
    use_cfg, cfg_scale = cfg_of(config)
    if block_cache_interval(config):
        k = cache_pairs(config, depth)

        def cached(x, t, noise, y, front):
            return cached_step(diffusion, model, x, t, noise, front, cache_pairs=k, y=y,
                               cfg_scale=cfg_scale, ddim=method == "ddim")

        return cached

    model_fn = cfg_model_fn(model, cfg_scale) if use_cfg else model

    def step(x, t, noise, y):
        return denoise_step(diffusion, model_fn, method, x, t, noise, None if y is None else {"y": y})

    return step


def run_sampler(step, diffusion, x: torch.Tensor, y: Optional[torch.Tensor], *, interval: int, ddim: bool,
                generator: Optional[torch.Generator] = None, noise_schedule=None) -> torch.Tensor:
    """The timestep loop over a :func:`sampler_step` (or an exported one):
    the standard loop, or with ``interval`` the block cache's schedule; each
    step's noise by the loops' rule (``noise_schedule[t]``, else
    ``generator``; the cached DDIM takes zeros)."""
    if interval:
        return run_cached_steps(lambda x, t, noise, front: step(x, t, noise, y, front), diffusion, x,
                                interval, ddim, generator, noise_schedule)
    return run_steps(lambda x, t, noise: step(x, t, noise, y), diffusion, x, generator, noise_schedule)


def cfg_batch(use_cfg: bool, num_classes: int, z: torch.Tensor, y: Optional[torch.Tensor]):
    """z and y as the sampler carries them: under CFG the [cond | uncond]
    halves, the second half's labels the null class."""
    if use_cfg:
        z = torch.cat([z, z], dim=0)
        y = torch.cat([y, torch.full_like(y, num_classes)], dim=0)
    return z, y


def holds_collectives(model) -> bool:
    """Whether ``model``'s forward runs a collective: tensor parallelism's
    all-reduces, or an MoE layer's dispatch over a mesh."""
    return int(getattr(model, "tp", 1) or 1) > 1 or any(
        m.mesh is not None for m in model.modules() if isinstance(m, MoEMlp))


def build_sample_impl(model, config: Config, diffusion, loop: str = "scan"):
    """``(sample_impl, use_cfg)``: ``sample_impl(x, y, generator=None,
    noise_schedule=None)`` the final latents of the sampler's batch x (under
    CFG the [cond | uncond] halves of :func:`cfg_batch`), fp32, a new tensor;
    the counterpart of the JAX package's ``build_sample_impl``, the one
    construction of the sampler (the CFG combine, DDPM or DDIM, the
    standard or the block-cache loop). ``loop`` "scan" replays the step as
    a CUDA graph (:class:`~latte_tpu_torch.core.step_graph.GraphedStep`,
    ``sample_impl.graphed``), built at the first call and kept for the next
    ones, unless the step holds a collective (:func:`holds_collectives`),
    which runs the eager loop as "host" does. ``generator`` draws DDPM's
    per-step noise, unless ``noise_schedule[t]`` gives it (the loops' rule)."""
    use_cfg = cfg_of(config)[0]
    interval = block_cache_interval(config)
    if loop == "host" and int(getattr(model, "tp", 1) or 1) > 1:
        raise ValueError("tensor_parallel serving requires loop_mode=scan")
    ddim = str(getattr(config, "sample_method", "ddpm")).lower() == "ddim"
    step = sampler_step(model, config, diffusion, model.depth)
    graphed = None
    if loop != "host" and not holds_collectives(model):
        # the graphs read the model's tensors by address: a moved tensor captures again
        graphed = step = GraphedStep(step, cached=bool(interval),
                                     weights=lambda: itertools.chain(model.parameters(), model.buffers()))

    def sample_impl(x, y=None, generator=None, noise_schedule=None) -> torch.Tensor:
        with torch.inference_mode():
            latents = run_sampler(step, diffusion, x, y, interval=interval, ddim=ddim, generator=generator,
                                  noise_schedule=noise_schedule)
            return latents.clone() if graphed is not None else latents

    sample_impl.graphed = graphed
    return sample_impl, use_cfg


def build_sample_fn(model, config: Config, diffusion):
    """The configured sampler over ``model``: ``fn(z, y=None, generator=None,
    noise_schedule=None)`` -> the final latents (B, F, 4, L, L), fp32, from
    noise z (B, F, 4, L, L) and, for a class-conditional model, labels y
    (B,) (the CFG doubling inside). Built once for many calls, as the JAX
    package's ``build_sample_fn``: under ``loop_mode: scan`` its graphs
    (``fn.graphed``) are captured at the first call and captured again only
    when the batch shape, the dtype, the device or the model's tensors
    change; ``fn.release()`` frees them. ``fn.use_cfg`` is the CFG flag."""
    impl, use_cfg = build_sample_impl(model, config, diffusion, loop=loop_mode(config))

    def sample_fn(z, y=None, generator=None, noise_schedule=None) -> torch.Tensor:
        n = z.shape[0]
        x, y = cfg_batch(use_cfg, model.num_classes, z, y)
        return impl(x, y, generator, noise_schedule)[:n]

    sample_fn.use_cfg, sample_fn.graphed = use_cfg, impl.graphed
    sample_fn.release = impl.graphed.release if impl.graphed is not None else lambda: None
    return sample_fn


def sample_loop(
    model: Latte,
    config: Config,
    z: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    noise_schedule=None,
) -> torch.Tensor:
    """Final latents (B, F, 4, L, L), fp32, from noise ``z`` (B, F, 4, L, L)
    and, for a class-conditional model, labels ``y`` (B,): one call of a
    :func:`build_sample_fn` built for it, whose graphs it frees."""
    sample_fn = build_sample_fn(model, config, create_diffusion(str(config.num_sampling_steps)))
    try:
        return sample_fn(z, y, generator, noise_schedule)
    finally:
        sample_fn.release()


def sample_latents(model: Latte, config: Config, device: torch.device, sample_fn=None) -> torch.Tensor:
    """One video's final latents (1, F, 4, L, L), fp32, from ``config.seed``:
    z, then DDPM's noise, from one ``torch.Generator``; through
    ``sample_fn`` (a :func:`build_sample_fn`) when given, else one built
    for the call."""
    generator = torch.Generator(device=device).manual_seed(int(getattr(config, "seed", 0) or 0))
    z = torch.randn(latent_shape(config, 1), generator=generator, device=device)
    y = None
    if int(getattr(config, "extras", 1)) == 2:
        y = torch.full((1,), int(getattr(config, "sample_class", 0)), device=device)
    if sample_fn is None:
        return sample_loop(model, config, z, y, generator)
    return sample_fn(z, y, generator)


def load_vae(config: Config, device: torch.device) -> Optional[AutoencoderKL]:
    """The configured VAE, fp32, on ``device``, or ``None`` when there is none.

    ``vae: tiny`` and ``vae_ckpt: random`` give seeded random weights (a tiny
    VAE, or the full SD architecture) from ``torch.Generator`` seed 0; a
    ``vae_ckpt`` file is a diffusers ``AutoencoderKL`` state dict, loaded with
    ``strict=True``. A ``vae_ckpt`` that does not exist gives ``None`` with a
    warning, as in the JAX sampler; a directory (the JAX package's orbax
    VAE, or a diffusers model folder) raises ``NotImplementedError``."""
    vae_ckpt = str(getattr(config, "vae_ckpt", None) or "")
    tiny = str(getattr(config, "vae", "") or "") == "tiny"
    if not tiny:
        if not vae_ckpt:
            return None
        if vae_ckpt != "random" and not os.path.exists(vae_ckpt):
            create_logger().info(f"WARNING: vae_ckpt {vae_ckpt!r} does not exist — saving latents")
            return None
    return build_vae(vae_ckpt, device, tiny=tiny)


def decode_video(vae: AutoencoderKL, latents: torch.Tensor) -> np.ndarray:
    """The first video of ``latents`` (B, F, 4, h, w) as uint8 frames
    (F, H, W, 3): all B·F frames decoded in one batch at fp32 (the JAX
    sampler's decode), after dividing by the VAE's scaling factor."""
    b, f = latents.shape[:2]
    flat = latents.reshape(b * f, *latents.shape[2:]).float() / vae.scaling_factor
    video = make_decode_fn(vae)(flat)  # (b·f, 3, H, W)
    video = video.reshape(b, f, *video.shape[1:]).permute(0, 1, 3, 4, 2)
    return to_uint8(video[0].float().cpu().numpy())


def main(config: Config, device: Optional[str] = None) -> str:
    """Sample one video; return the path of the written mp4, or of the saved
    ``_latents.npz`` when no VAE is configured (under tensor parallelism
    rank 0 writes it; every rank returns the path)."""
    check_config(config)
    tp = tensor_parallel(config)
    if tp > 1:
        dev, ctx = setup(config, device, check=lambda world: check_config(config, world),
                         mesh=MeshConfig(dp=1, tp=tp))
    else:
        dev, ctx = resolve_device(device), None
    main_rank = ctx is None or ctx.rank == 0
    logger = create_logger(enabled=main_rank)
    vae = load_vae(config, dev)
    model = build_model(config, dev, ctx)
    if not getattr(config, "ckpt", None):
        logger.info("WARNING: no checkpoint given — sampling from random init")
    logger.info(
        f"serving with quantized={quantized_mode(config)}, int8_attention="
        f"{getattr(config, 'int8_attention', False)}, attention_mode={getattr(config, 'attention_mode', 'auto')}, "
        f"tensor_parallel={tp}"
    )

    t0 = time.perf_counter()
    sample_fn = build_sample_fn(model, config, create_diffusion(str(config.num_sampling_steps)))
    latents = sample_latents(model, config, dev, sample_fn)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    logger.info(f"sampled in {time.perf_counter() - t0:.2f}s on {dev} (loop_mode={loop_mode(config)}, "
                f"graphed={sample_fn.graphed is not None})")
    sample_fn.release()  # the graphs' memory, before the decode

    out_path = getattr(config, "save_video_path", None) or "./sample_videos/sample.mp4"
    if vae is None:
        out_path = os.path.splitext(out_path)[0] + "_latents.npz"
    if not main_rank:
        barrier()
        return out_path
    if vae is not None:
        t0 = time.perf_counter()
        frames = decode_video(vae, latents)  # ends in a copy to the host
        logger.info(f"decoded {len(frames)} frames in {time.perf_counter() - t0:.2f}s on {dev}")
        save_video(out_path, frames, fps=8)
        logger.info(f"saved video to {out_path}")
    else:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.savez(out_path, latents=latents.float().cpu().numpy())
        logger.info(f"no VAE configured — saved latents to {out_path}")
    if ctx is not None:
        barrier()
    return out_path


def cli(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--save_video_path", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    cfg = load_config(a.config, a.overrides)
    if a.ckpt:
        cfg.ckpt = a.ckpt
    if a.save_video_path:
        cfg.save_video_path = a.save_video_path
    return main(cfg, device=a.device)


if __name__ == "__main__":
    cli()
