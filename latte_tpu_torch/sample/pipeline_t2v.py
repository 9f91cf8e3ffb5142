"""LattePipeline: text-to-video generation (port of
``latte_tpu/sample/pipeline_t2v.py``).

Prompt encoding with a negative prompt in the [uncond ‖ cond] order, z drawn
from a ``torch.Generator`` seeded by ``seed`` and scaled by the scheduler's
``init_noise_sigma``, the denoising loop over one of the ten schedulers of
:mod:`latte_tpu_torch.core.scheduler`, and the decode of every frame with
the SD VAE (one batch of B·F frames; a video of one frame is an image).

One step: the latents doubled under CFG, scaled by ``scale_model_input``,
the model at the scheduler's ``model_timestep`` (fp32, fractional for the
interleaved correctors), then CFG over all output channels,
``uncond + g·(text − uncond)``, and the learned-sigma half dropped before
``scheduler.step``. This is not the Latte sampler's 4-channel CFG rule
(``core.samplers.cfg_combine``). The loop runs ``while i < n_indices and
calls < 3·n_indices``; an interleaved scheduler repeats the index while its
corrector is due, and PNDM's call sequence is longer than the step count.

Block cache (``block_cache_interval`` > 1): every ``interval``-th model
call is a full forward that also returns the activation after the first
``block_cache_pairs`` pairs (default 2/3 of them); the calls between resume
the transformer's block list at that pair from it. Interval 0 or 1 is the
exact loop.

Stochastic schedulers draw each step's noise from the same generator as z,
after it.

Pipeline-parallel serving (``pp_mesh``, a ``DistContext`` with a pp axis, or
a stage count for the one-process virtual pipeline): the transformer is a
stage's (its pairs alone, built with ``pp``/``pp_rank``) and each step runs
``dist.pipeline.pipelined_t2v_forward`` with the largest microbatch count
not above ``pp_microbatches`` that divides the step's batch, as the JAX
pipeline does; the output is replicated, so every stage runs the scheduler
loop on the same latents. The block cache does not compose with it (the
JAX pipeline's ``ValueError``).

The text encoder's features may be tensors on the device (the port's T5)
or numpy arrays (the caption stub); they reach the transformer as fp32 on
its device without a trip through the host.

Decoding: a video of one frame is an image; with ``temporal_decoder`` (the
port's SVD :class:`~latte_tpu_torch.vae.temporal_decoder.TemporalDecoder`)
and ``enable_vae_temporal_decoder`` the frames go through it in chunks of
14 (the reference's chunk), each chunk decoded as one clip of its own
length, the F % 14 remainder last; otherwise every frame through the SD VAE.
``sample_t2x`` builds no temporal decoder, as in the JAX sampler.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from latte_tpu_torch.vae import cudnn_tf32, make_decode_fn


# the JAX pipeline's refusal of the block cache under pp_mesh
PP_BLOCK_CACHE_ERROR = (
    "block_cache_interval does not compose with pp_mesh (the pipelined forward has no staging hooks)"
)


@dataclasses.dataclass
class VideoPipelineOutput:
    video: np.ndarray  # (B, F, H, W, 3) float in [0, 1], or the latents (B, C, F, h, w)


class LattePipeline:
    """T2V pipeline over (transformer, scheduler, text encoder, VAE). The
    transformer is a :class:`latte_tpu_torch.models.t2v.LatteT2V` (its
    parameters fix the device and compute type), the text encoder has
    ``encode_with_negative`` (features and masks, tensors or numpy), the
    VAE is the port's :class:`~latte_tpu_torch.vae.AutoencoderKL` (fp32),
    the temporal decoder a ``TemporalDecoder`` (its parameters' type)."""

    def __init__(
        self,
        transformer,
        scheduler,
        text_encoder=None,
        vae=None,
        temporal_decoder=None,
        vae_scale: float = 0.18215,
        vae_spatial_scale: int = 8,
        pp_mesh=None,
        pp_microbatches: int = 2,
        block_cache_interval: int = 0,
        block_cache_pairs: Optional[int] = None,
    ):
        self.transformer = transformer
        self.scheduler = scheduler
        self.text_encoder = text_encoder
        self.vae = vae
        self.temporal_decoder = temporal_decoder
        self.vae_scale = vae_scale
        self.vae_spatial_scale = vae_spatial_scale
        self.bc_interval = int(block_cache_interval or 0)
        if self.bc_interval > 1:
            if pp_mesh is not None:
                raise ValueError(PP_BLOCK_CACHE_ERROR)
            n_pairs = transformer.num_layers
            self.bc_pairs = int(block_cache_pairs or (n_pairs * 2) // 3)
            if not 1 <= self.bc_pairs < n_pairs:
                raise ValueError(f"block_cache_pairs must be in [1, {n_pairs}), got {self.bc_pairs}")
        self._decode = None if vae is None else make_decode_fn(vae)
        self.pp_microbatches = int(pp_microbatches)
        self.pp_hop = None
        if pp_mesh is not None:
            from latte_tpu_torch.dist.pipeline import make_hop

            self.pp_hop = make_hop(pp_mesh)

    @property
    def device(self) -> torch.device:
        return self.transformer.proj_out.weight.device

    def encode_prompt(self, prompt: Sequence[str], negative_prompt: str = "", do_cfg: bool = True,
                      clean_caption: bool = True):
        """(features, mask) on the device, fp32 and int32: [uncond ‖ cond]
        under CFG."""
        if self.text_encoder is None:
            raise ValueError("the pipeline was built without a text encoder")
        cond, cond_mask, uncond, uncond_mask = self.text_encoder.encode_with_negative(
            list(prompt), negative_prompt, clean=clean_caption
        )
        cond, cond_mask, uncond, uncond_mask = (
            torch.as_tensor(a, device=self.device) for a in (cond, cond_mask, uncond, uncond_mask))
        if do_cfg:
            cond, cond_mask = torch.cat([uncond, cond]), torch.cat([uncond_mask, cond_mask])
        return cond.float(), cond_mask

    def prepare_latents(self, batch: int, channels: int, video_length: int, height: int, width: int,
                        generator: torch.Generator, num_inference_steps: int = 50) -> torch.Tensor:
        f = self.vae_spatial_scale
        shape = (batch, channels, video_length, height // f, width // f)
        z = torch.randn(shape, generator=generator, device=self.device)
        return z * self.scheduler.init_noise_sigma_for(num_inference_steps)

    def _forward(self, latent_in, t, ctx, mask, cache: Optional[str], front):
        """The transformer: the exact forward, or the cache's full forward
        (returning the front too) or partial forward (from the front); under
        ``pp_mesh`` the pipelined forward."""
        if self.pp_hop is not None:
            from latte_tpu_torch.dist.pipeline import pipelined_t2v_forward

            # the largest feasible microbatch count not above the requested one
            mb = min(self.pp_microbatches, latent_in.shape[0])
            while latent_in.shape[0] % mb:
                mb -= 1
            return pipelined_t2v_forward(self.transformer, latent_in, t, ctx, mask, mesh=self.pp_hop,
                                         microbatches=mb), front
        if cache == "full":
            return self.transformer(latent_in, t, ctx, mask, return_front=self.bc_pairs)
        if cache == "partial":
            return self.transformer(latent_in, t, ctx, mask, front_state=front,
                                    start_pair=self.bc_pairs), front
        return self.transformer(latent_in, t, ctx, mask), front

    def _step(self, latents, state, ctx, mask, i, ts, guidance_scale, do_cfg, noise,
              cache=None, front=None):
        sched = self.scheduler
        latent_in = torch.cat([latents, latents]) if do_cfg else latents
        latent_in = sched.scale_model_input(latent_in, i, state)
        t = torch.full((latent_in.shape[0],), sched.model_timestep(i, ts, state),
                       dtype=torch.float32, device=latents.device)
        noise_pred, front = self._forward(latent_in, t, ctx, mask, cache, front)
        if do_cfg:
            uncond, text = noise_pred.chunk(2)
            noise_pred = uncond + guidance_scale * (text - uncond)
        c = latents.shape[1]
        if noise_pred.shape[1] == 2 * c:  # learned sigma: keep the eps half
            noise_pred = noise_pred[:, :c]
        latents, state = sched.step(noise_pred, i, ts, latents, state, noise=noise)
        return latents, state, front

    @torch.inference_mode()
    def sample_latents(
        self,
        prompt: Union[str, Sequence[str]],
        video_length: int = 16,
        height: int = 512,
        width: int = 512,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: str = "",
        seed: int = 0,
        enable_temporal_attentions: bool = True,
        clean_caption: bool = True,
    ) -> torch.Tensor:
        """The final latents (B, C, F, h, w), fp32, on the device."""
        if isinstance(prompt, str):
            prompt = [prompt]
        do_cfg = guidance_scale > 1.0
        built = bool(getattr(self.transformer, "enable_temporal_attentions", True))
        if bool(enable_temporal_attentions) != built:
            raise ValueError(
                f"enable_temporal_attentions={enable_temporal_attentions} but the transformer was "
                f"built with {built}; rebuild the transformer (sample_t2x config "
                "enable_temporal_attentions) to change it"
            )
        ctx, ctx_mask = self.encode_prompt(prompt, negative_prompt, do_cfg, clean_caption)
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        latents = self.prepare_latents(len(prompt), self.transformer.in_channels, video_length,
                                       height, width, generator, num_inference_steps)
        sched = self.scheduler
        ts = sched.timesteps(num_inference_steps)
        n_indices = len(ts)  # PNDM's prologue makes it longer than the step count
        state = sched.init_state(num_inference_steps)
        interleaved = bool(getattr(sched, "interleaved", False))
        front = None
        i = calls = 0
        while i < n_indices and calls < 3 * n_indices:
            cache = None
            if self.bc_interval > 1:
                cache = "full" if calls % self.bc_interval == 0 else "partial"
            noise = None
            if sched.needs_noise:
                noise = torch.randn(latents.shape, generator=generator, device=latents.device)
            latents, state, front = self._step(latents, state, ctx, ctx_mask, i, ts, guidance_scale,
                                               do_cfg, noise, cache, front)
            calls += 1
            if interleaved and state["in_correction"]:
                continue  # the corrector call repeats the index
            i += 1
        return latents

    def __call__(self, prompt, video_length: int = 16, height: int = 512, width: int = 512,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 negative_prompt: str = "", seed: int = 0, enable_temporal_attentions: bool = True,
                 enable_vae_temporal_decoder: bool = False, output_type: str = "video",
                 clean_caption: bool = True) -> VideoPipelineOutput:
        """The JAX pipeline's call: the decoded video, or with ``output_type
        "latents"`` the latents, as numpy."""
        latents = self.sample_latents(
            prompt, video_length, height, width, num_inference_steps, guidance_scale,
            negative_prompt, seed, enable_temporal_attentions, clean_caption,
        )
        if output_type == "latents":
            return VideoPipelineOutput(video=latents.cpu().numpy())
        if latents.shape[2] > 1 and enable_vae_temporal_decoder and self.temporal_decoder is not None:
            return VideoPipelineOutput(video=self.decode_latents_with_temporal_decoder(latents))
        return VideoPipelineOutput(video=self.decode_latents(latents))

    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """(B, C, F, h, w) -> (B, F, H, W, 3) in [0, 1], fp32 numpy: all B·F
        frames through the VAE in one batch, in fp32 with TF32 off."""
        if self._decode is None:
            raise ValueError("the pipeline was built without a VAE")
        B, C, F, h, w = latents.shape
        z = latents.transpose(1, 2).reshape(B * F, C, h, w).float() / self.vae_scale
        video = self._decode(z)  # (B·F, 3, H, W)
        video = video.view(B, F, *video.shape[1:]).permute(0, 1, 3, 4, 2)
        return (video / 2 + 0.5).clamp(0, 1).float().cpu().numpy()

    # the JAX pipeline's chunk (latte_tpu/sample/pipeline_t2v.py:319-337)
    TEMPORAL_CHUNK = 14

    def decode_latents_with_temporal_decoder(self, latents: torch.Tensor) -> np.ndarray:
        """(B, C, F, h, w) -> (B, F, H, W, 3) in [0, 1], fp32 numpy: the B·F
        frames through the temporal decoder in chunks of 14, each decoded as
        one clip (``num_frames`` = its length), in the decoder's type with
        cuDNN's TF32 off; each chunk's frames go to the host before the
        next, so one chunk's activations are alive at a time."""
        if self.temporal_decoder is None:
            raise ValueError("the pipeline was built without a temporal decoder")
        B, C, F, h, w = latents.shape
        z = latents.transpose(1, 2).reshape(B * F, C, h, w).float() / self.vae_scale
        out = []
        with torch.inference_mode(), cudnn_tf32(False):
            for s in range(0, z.shape[0], self.TEMPORAL_CHUNK):
                chunk = z[s : s + self.TEMPORAL_CHUNK]
                frames = self.temporal_decoder.decode(chunk, num_frames=chunk.shape[0])
                out.append((frames.float() / 2 + 0.5).clamp(0, 1).cpu())
        video = torch.cat(out).view(B, F, *out[0].shape[1:]).permute(0, 1, 3, 4, 2)
        return video.numpy()
