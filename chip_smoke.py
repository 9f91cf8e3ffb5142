#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (latte_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure ends the script with a
non-zero exit and a traceback:

1. device: the card's name and power limit (nvidia-smi);
2. build: the kernel library, one nvcc process per latte_tpu_torch/csrc/*.cu
   source, all at once, then one link; ptxas's registers, shared memory and
   spills of the tensor-core attention kernels (bf16 forward and backward,
   int8 in both P.V modes), of the register-tiled fp32 forward and backward
   and of the adaLN kernels (csrc/adaln.cu), and the count
   of HMMA (bf16) and IMMA (int8) tensor-core instructions in the
   tensor-core kernels' SASS where cuobjdump exists (none may spill, each
   tensor-core kernel must have its instructions: the int8 "qk" kernels
   IMMA and, in bf16 alone, HMMA);
3. kernels: each forward CUDA kernel against its plain PyTorch version in
   bf16 at the sampler's spatial and temporal shapes, with its time, the
   plain version's, the bound from its bytes and operations and, for
   attention, the time of torch's scaled_dot_product_attention as a
   yardstick; then the attention's logsumexp output, and each kernel in fp32
   at the spatial shape. The adaLN kernels must take their vector route
   (csrc/adaln.cu's *_vec_kernel), equal in bf16 to the plain version to the
   bit (y, and out on all but 1% of its elements), each timed beside the
   generic kernels (the first versions) forced, with F.layer_norm as
   ln_modulate's yardstick; also at ADALN_SHAPES: the trainers' batch 5 in
   bf16 and fp32, the registry's other widths in both dtypes, and D = 1000
   and a misaligned view, which must take the generic kernels. The bf16
   attention forward must take the
   tensor-core kernel, where it is also held against the plain mirror of
   its tile schedule (equal to the bit on all but 1% of elements), and the
   fp32 one the register-tiled fp32 kernel; the bf16 one is also held and
   timed at FLASH_SHAPES (T2V 512^2, a ragged N, the mixed-precision
   trainer's batch 5, and a misaligned layout that the bf16 CUDA-core
   kernel takes), the fp32 one at FLASH_FP32_SHAPES (batch 1 and the
   training config's batch 5, spatial and temporal, at batch 5 with SDPA's
   fp32 forward and the CUDA-core kernel forced beside it; ragged N = 200
   and 40; a misaligned layout that the CUDA-core kernel takes). Then the two
   flash-attention backward kernels (dQ, dK/dV) the same way at BWD_SHAPES:
   in bf16 at both shapes, at the mixed-precision trainer's batch 5, at a
   ragged N and at a misaligned layout, in fp32 at the spatial shape, at
   the training config's batch 5 (spatial and temporal), at a ragged N, at
   a temporal N = 40 and at a misaligned layout, with the backward of
   scaled_dot_product_attention as the yardstick. Each takes the route it
   names: bf16 the tensor-core kernels, also held to the bit against the
   plain versions (all but 1% of the outputs), fp32 the register-tiled fp32
   kernels (within FP32_TOL), the misaligned cases the CUDA-core ones;
4. forward: full-width Latte-XL/2 (16 x 256^2, bf16, random weights from a
   seed), kernel path against the plain path and an fp32 plain path, the
   launch counts of one forward (every attention call on the tensor-core
   route), its device time by kind and the device's idle share, and the
   same profile with the generic adaLN kernels forced. In this and every
   later phase each adaLN launch takes the vector route;
5. sampler: the entry point ``latte_tpu_torch.sample.sample.main`` on
   configs/ffs/ffs_sample.yaml with DDIM-50 at batch 1 from a random
   checkpoint, then DDPM for a few steps; finite latents, launch counts,
   videos/min (median of ROUTE_PAIRS DDIM-50 runs, each paired with a run
   that forces the CUDA-core attention forward), the device's idle share in a
   profiled DDIM-50 run, and the
   DDIM latents against the plain path's; every bf16 attention call of
   both runs goes through the tensor-core kernel, and none of a forced run;
5b. vae: ``sample.main`` with DDIM-50 and ``vae_ckpt: random`` (the full SD
   VAE from a seed) from the same checkpoint: the mp4 read back through cv2
   as 16 frames of 256x256x3, the DiT's launches alone (the
   VAE launches no hand-written kernel); two DDIM latent frames decoded in
   fp32 with TF32 off against the same VAE in fp64 (relative L2 <= 1e-4,
   uint8 frames equal on >= 99.9%), and those frames encoded likewise; a
   16-frame decode's seconds (median of 5), error against fp64 and peak
   memory in fp32 with TF32 off (the sampler's), fp32 with cuDNN's TF32
   (PyTorch's default) and bf16 with fp32 GroupNorm and softmax; the fp32
   and bf16 decodes' device time by kind and idle share; videos/min with
   decode;
5c. block cache: ``sample.main`` with DDIM-50, ``block_cache_pairs: 9`` and
   ``block_cache_interval: 2`` from the same checkpoint: 950 launches of
   each per-block kernel (0.679 of the exact run's 1400; 25 full forwards
   and 25 of the back 5 pairs), all on the tensor-core and vector routes;
   finite latents with their cosine (> 0.9, tests/test_block_cache.py's
   bound) and relative L2 against phase 5's exact latents; at full width
   ``return_front``'s forward equal to the plain forward and the partial
   forward from its front equal to the full one, to the bit, and the cached
   loop at interval 1 equal to phase 5's DDIM-50 latents to the bit;
   videos/min in alternating pairs against the exact DDIM-50 and the device
   idle share of one profiled run; then in static W8A8 with int8 attention
   (flash, and "qk" under "auto"): 950 tensor-core int8 attention launches
   after 3 bf16 calibration forwards, the latents against the exact int8
   and bf16 ones, and pairs against the exact int8 DDIM-50;
5d. sample many: ``sample_many.main`` with DDIM-50 at batch 2,
   ``num_fvd_samples: 3`` (rounded up to 4) and ``vae_ckpt: random``: mp4s
   0000-0003 read back as 16x256x256x3, ``create_npz_from_sample_folder``'s
   (4, 16, 256, 256, 3), every launch on the tensor-core and vector routes,
   s a video at batch 2 (the generator's runs, to latents) beside phase 5's
   batch 1;
5e. t2v: ``sample_t2x.main`` on configs/t2x/t2v_sample.yaml as shipped
   (LatteT2V, 28 pairs, three prompts, 16 frames at 512^2, DDIM-50, CFG
   7.5, bf16, the hash-embedding caption stub) with ``vae_ckpt: random``:
   three mp4s read back as 16x512x512x3; 2800 B1 launches a video (all on
   the tensor cores), 2850 B2 and 2800 B3 (all on the vector route), none
   of another kernel; s a video to latents and with decode (median of
   prompts 2-3), peak memory. On the same seeded weights: one CFG forward
   against the plain bf16 and fp32 paths (cosine >= 0.999, error <= 1.25x
   the plain bf16 path's + 1e-3) and the DDIM-50 latents of prompt 1
   against the plain path's (cosine >= 0.99); one profiled DDIM step by
   kind (the cross-attention, plain torch as in JAX, a kind of its own) and
   its idle share; t2i_sample.yaml as shipped (a 512^2 png, B1 1400, B2
   1450, B3 1400); the block cache at interval 2 (18 of 28 pairs: B1 and
   B3 1900, B2 1950; its latent cosine against the exact run) and at
   interval 1 equal to the exact loop to the bit; ``quantized: true`` (one
   CFG forward against the bf16 one, cosine >= 0.99; DDIM-10 seconds beside
   bf16's; one int8 DDIM step profiled by kind); B2 and B3 on the operands
   one CFG forward hands them (pair 0's spatial and temporal norms, the
   spatial norm3's unit gate, norm_out) on the vector route against their
   plain versions to the bit; B1 at the CFG shapes (32 x 1024 and 2048 x 16) against the
   plain version, with its bound and SDPA. Prints a ``t2v: {...}`` line.
   To run it alone: ``import chip_smoke as c; c.build.build();
   c.build.load_library(); c.t2v_phase(tmp, smi, torch.device("cuda", 0),
   c.Timer(torch.device("cuda", 0)))``;
5f. eval (right after 5d, on its mp4s): the port's metric stack
   (``latte_tpu_torch.eval``) with I3D, Inception and C3D on the card from
   seeded random weights (``eval_phase``): each detector against the same
   module on the CPU in fp32 on the sampler's 256^2 frames (relative L2 <=
   EVAL_REL), a 16-clip (Inception: 64-frame) call timed host to host with
   its device time, idle share and FLOP bound; 8 real clips written as
   frame folders and 5d's mp4s converted by
   ``tools.convert_videos_to_frames``; fvd2048_16f, kid50k_full, is50k and
   isv2048_ucf through ``calc_metric``, fid50k_full through the
   ``calc_metrics`` CLI in a process of its own (Inception loaded from a
   torchscript file), all finite; the FVD again from ``cache_dir`` to the
   bit, the cached real stats against a fresh run's, the FVD with I3D
   loaded from a torchscript file;
   fvd2048_16f from ``sample_many.BatchGenerator`` at DDIM-50 (1400
   launches of B1, B2, B3 on the tensor-core and vector routes); the host's
   decode time a clip against the detector's, and the 2 x 2048-clip FVD
   projected from them. Prints an ``eval: {...}`` line;
6. train: (a) one full-width train step (fp32, batch 1, gradient
   checkpointing) on the kernel path against the plain path from the same
   weights, t and noise, and the same in mixed precision; (b) the entry
   point ``latte_tpu_torch.train.train.main`` on configs/ffs/ffs_train.yaml
   as shipped (fp32, batch 5, synthetic latents) for a few steps, with its
   launch counts (every attention launch, forward and backward, on the
   fp32 route), seconds per step, peak memory and a profile of the last
   step, then a resume from its checkpoint that runs alternating pairs of
   steps against the CUDA-core backward forced (``backward_route`` patched
   for the step), then pairs against the CUDA-core forward forced
   (``forward_route`` patched), and a short DDIM run of the port's sampler
   on the trained EMA, none of it on the tensor-core kernels;
   (c) ``train.main`` with mixed_precision: true at batch 5: six steps on
   the tensor-core backward (the median of steps 3-5, a profile of step
   6), then alternating pairs of steps against the CUDA-core backward
   forced (``backward_route`` patched for the step);
   (d) two steps with quant_train: true (int8 training) at batch 1;
   (e) pixel train: ``train.main`` on ffs_train.yaml (fp32, batch 5) from a
   folder of 6 mp4s of 64 frames at 320x288 written from a numpy seed,
   with ``vae_ckpt: random``: the uint8 clips VAE-encoded inside every step.
   Six steps: finite losses and grad norms, 6 x STEP_LAUNCHES launches on
   the fp32 routes (the encode adds none), s/step (median of steps 3-5),
   the encode's share of the profiled step 6's device time (the kernels
   under the trainer's ``vae_encode`` range), peak memory and the host time
   the loop waited on the loader; then ``tools.cache_latents`` writes the
   folder's latent cache, one step from five clips through the fused encode
   is held against one from their cached moments (same weights and
   generator seed; losses within 1e-5 relative), and two steps each run
   from the cache and from ``synthetic_kind: pixels``. Prints a
   ``pixel_train: {...}`` line;
   (f) train more: ``train.main`` on configs/ucf101/ucf101_train.yaml as
   shipped (Latte-XL/2 over 101 classes, fp32, batch 5, synthetic latents
   and labels) for six steps (the median of steps 3-5, peak memory, every
   launch on the fp32 and vector routes, 6 x STEP_LAUNCHES), one step's
   gradients against the plain path with the same labels and drop ids
   (cosine >= 0.999, relative L2 <= 1e-3), two steps with
   mixed_precision: true on the tensor-core routes; the same for
   configs/ffs/ffs_img_train.yaml (LatteIMG-XL/2, 16 frames and 8 images,
   batch 4; its last step profiled), then two steps of
   configs/ucf101/ucf101_img_train.yaml (``y_image``); the options on the
   ucf101 model at full width: gradient_accumulation_steps 5 (gradients
   within 1e-5 of one chunk's on the same rows and draws, the memory of
   its forwards and backwards below one chunk's), remat_policy dots (gradients within 1e-6 of
   full remat's, and whether equal to the bit; s/step and working memory
   beside it), bf16
   first moments (every exp_avg bf16; the state's bytes beside fp32's),
   and ``pretrained`` from the six-step run's checkpoint with
   ``fixed_spatial`` through ``train.main`` (only the temporal attention
   changed, every other parameter equal to the loaded one to the bit).
   Prints a ``train_more: {...}`` line;
7. int8: (a) the int8 flash-attention kernel against its plain version
   in bf16 at the spatial, temporal and T2V 512^2 (N = 1024) shapes and at
   N = 2048 (two scale blocks), in both P.V modes, every case on the
   tensor-core kernel (csrc/flash_attention_int8_tc.cu), timed beside the
   dp4a kernel forced (held to the same limit), with the time of bf16 SDPA
   at the same shape as context (it is no int8 yardstick: no PyTorch call
   computes int8 attention); the "qk" mode also equal to the plain version
   to the bit on all but 1% of the outputs, where the same kernel taking p
   against each 32-key K tile's maximum must not be; then at the same
   shapes in fp32, held tightly (the "qk" mode within 1e-6 of the largest
   magnitude, and timed beside the dp4a kernel), where three deliberately
   wrong kernels (a P scale per K tile or per row, no quantize of q/k/v)
   must fail the same check, the two kernels held to each other, and, on
   inputs where l has at most two terms, to each other and to the plain
   version to the bit; (b) the full-width forward calibrated at
   three timesteps and served in static W8A8 with int8 attention, kernel
   path against the plain int8 path and the fp32 plain path, launch counts
   and a profile in which the int8 products and the quantize passes are
   kinds of their own; (c) ``sample.main`` with quantized: static,
   int8_attention: true, attention_mode: flash at DDIM-50 from the same
   checkpoint as phase 5: launch counts (every int8 attention on the
   tensor cores), the int8 quality guard against the bf16 latents of phase
   5, the plain int8 path, int8 videos/min, alternating pairs against the
   dp4a kernel forced (``int8_route`` patched for the run); the same
   DDIM-50 with int8_attention: qk under attention_mode: auto (the fused
   rule, P.V in bf16): launches (every int8 attention on the tensor cores),
   the quality guard and pairs against the dp4a kernel forced; then a few
   DDIM steps with quantized: true;
8. moe: the Mixture-of-Experts feed-forward (``models/moe.py``, 8 experts,
   top-2) at full width. (a) One train step of Latte-XL/2 with MoE (fp32,
   batch 1, gradient checkpointing, the Switch loss at 0.01), kernel path
   against plain path on the same weights (``set_plain``): every gradient
   and the routers' (cosine >= 0.999, relative L2 <= 1e-3), and how many
   routing choices differ. (b) ``train.main`` on
   configs/ffs/ffs_train_moe.yaml with ``expert_parallel=1`` its one
   override (2.76 B parameters, fp32, batch 5, full remat) for six steps:
   finite losses, ``moe_aux`` >= 1 - 1e-3 every step, block 0's router
   moved by step 1 and its ``wi`` not before step 2 (adaLN-Zero), 6 x
   STEP_LAUNCHES on the fp32 and vector routes, s/step (median of steps
   3-5), peak memory, step 6 profiled by kind and the disk's free space
   (no checkpoint written: ``NoCheckpoints``); one more step with the MoE
   parts (router, dispatch, expert products, combine; forward, recompute
   and backward) timed by CUDA events. (c) ``sample.main`` on
   ffs_sample.yaml with ``moe_experts: 8``, DDIM-50, batch 1, bf16, from a
   checkpoint of seeded random weights: 1400 launches of B1, B2, B3 on the
   tensor-core and vector routes, finite latents, s a video (median of 3),
   the idle share of a profiled DDIM-10, each MoE part timed alone at the
   spatial and temporal shapes, the latents against the plain path's
   (cosine >= 0.99), ``quantized: static`` refused. (d)
   ``sample_t2x.main`` on configs/t2x/t2v_sample.yaml as shipped with
   ``moe_experts=8`` at DDIM-10 (three prompts, CFG): launches
   (``t2v_launches(28, 30)``), finite latents, s a step, peak memory with
   and after the fp32 build; one CFG forward against the plain path
   (cosine >= 0.999) with the routing choices of both, one DDIM step
   profiled by kind and its MoE parts by CUDA events, ``quantized: true``
   refused. Prints a ``moe: {...}`` line;
9. text: the text encoders, ``extras: 78`` and the SVD temporal decoder at
   full width on seeded random weights. (a) A T5 v1.1-XXL ``t5_ckpt``
   directory (d_model 4096, 64 heads of 64, d_ff 10240, 24 layers,
   gated-gelu; 4.76 B parameters made on the card in bf16, written as two
   safetensors shards with their index, config.json and a synthetic
   spiece.model), then ``sample_t2x.cli`` on configs/t2x/t2v_sample.yaml
   with it, ``num_sampling_steps=10`` (the shipped 50, cut for time) and
   ``vae_ckpt=random``: three mp4s of 16x512x512x3, ``t2v_launches(28, 30)``
   on the tensor-core and vector routes, the port's bf16 T5 loaded, its
   load and encode times, s a video to latents and with decode, peak
   memory, and the bf16 features against an fp32 T5 on the same ids
   (cosine >= 0.999 on the unmasked tokens). (b) The SVD temporal decoder
   (128, 256, 512, 512; 3 resnets a block): one ``LattePipeline`` call with
   ``enable_vae_temporal_decoder`` on (a)'s model and T5 (16 frames at
   512^2, chunks 14 + 2), a 2-frame chunk in fp32 (TF32 off) against fp64
   (relative L2 <= 1e-4), and (a)'s latents decoded in fp32 and bf16:
   s/video, peak memory, device ms by kind. (c) CLIP ViT-L/14's text tower
   (a stand-in tokenizer) encodes two prompts into (2, 77, 768); Latte-XL/2
   with ``extras: 78`` on them, a bf16 forward (B1, B2, B3 28 each) against
   the plain bf16 and fp32 paths (cosine >= 0.999, error <= 1.25x the plain
   bf16 path's + 1e-3); ``train.main`` on configs/ffs/ffs_train.yaml with
   ``extras=78`` for 3 steps (fp32, batch 5, full remat; 3 x STEP_LAUNCHES
   on the fp32 and vector routes), its step time, peak memory and that
   ``text_embedding_projection`` moved. Prints a ``text: {...}`` line. To
   run it alone: ``import chip_smoke as c; c.build.build();
   c.build.load_library(); c.text_phase(tmp, smi, torch.device("cuda", 0),
   c.Timer(torch.device("cuda", 0)))``.

10. dist: multi-GPU training and sampling over NCCL, one process a GPU,
   spawned at world size ``min(4, device_count)`` (1 on a one-GPU machine;
   each rank prints its device and the backend, which must be nccl). At
   world 1, before the process group exists, ``train.main`` (``gate_run``:
   no checkpoint written) takes 3 steps of configs/ffs/ffs_train.yaml as
   shipped and 2 of configs/ffs/ffs_train_moe.yaml at ``expert_parallel=1``
   on one GPU, and ``sample_many`` writes 4 DDIM-50 latents at batch 2;
   then, over the group, the same runs (DDP, ``zero1``, ``fsdp``, the MoE
   config with ``fsdp``) must equal them to the bit (DDP, ZeRO-1) or within
   1e-6 (FSDP) in losses, grad norms and parameters, each with
   STEP_LAUNCHES a step on the fp32 and vector routes, and ``sample_many``'s
   latents to the bit. Then ``train.main`` on
   ffs_train.yaml over the group (at 4 GPUs also ffs_train_moe.yaml as
   shipped, dp 1 x ep 4) for 3 steps, counted from 0 on every rank (the
   kernels line's ``launches_dist``), its step gaps, peak memory, the NCCL
   kernels of its profiled third step and the full checkpoint's gather and
   write. The world-1 DDP gate runs with ``tensor_parallel=1
   sequence_parallel=1`` named, through the (dp, ep, sp, tp) mesh. At 4
   GPUs (a one-GPU machine skips this part) it first takes, on one GPU,
   ffs_train.yaml's 3 steps from seeded Latte-XL/2 weights (``pretrained``)
   and a bf16 DDIM-50 of them (``one_gpu_refs``); then ffs_train.yaml trains
   from the same weights at ``tensor_parallel=4`` and at
   ``sequence_parallel=4`` (dp 1: the global batch of 5 is one GPU's; no
   checkpoint written), each held to the one-GPU losses and grad norms
   within TP_SP_REL, with its s/step, peak memory and NCCL device ms,
   and ``sample.main`` runs the DDIM-50 at ``tensor_parallel=4``, its
   latents held to one GPU's by phase 5's gate (``tp_sp_gates``). At 4 GPUs
   the dp 4 run also starts from those weights, and ffs_train.yaml trains
   at ``pipeline_parallel=2`` (dp 2, ``pp_microbatches=5``, its checkpoint
   gathered over dp and pp); the dp 4 and dp 2 x pp 2 losses are held to one
   GPU's 3 steps on their global batches of 20 and 10 in one chunk (the
   same draws) within DIST_REL, their grad norms within PP_GNORM_REL, and
   t2v_sample.yaml runs at ``pipeline_parallel=4`` and DDIM-10 through
   ``sample_t2x.main``, its latents within BF16_TOL of one GPU's
   (``pp_gates``). Prints a ``dist: {...}`` line. To run it alone: ``import chip_smoke as c;
   c.build.build(); c.build.load_library(); c.dist_phase(tmp, smi)``.

10a. tp/sp one card (before phase 10): the virtual ring (``virtual_ring``):
   Latte-XL/2's spatial attention at batch 1 and 5, its temporal one and
   T2V 512^2's spatial one (RING_SHAPES, 16 heads of 72), each cut into
   RING K/V shards and run through the ring's schedule in one process
   (``dist.ring.virtual_ring_attention``: B1 with its lse, the fp32 merge,
   B4/B5 fed the merged lse and delta), in bf16 and fp32, against B1, B4 and
   B5 on the whole sequence: output and q/k/v gradients within BF16_TOL /
   FP32_TOL of the largest magnitude, each shard on its dtype's route,
   RING² launches of each; then the virtual tp (``virtual_tp``): one
   full-width Latte-XL/2 block pair in fp32 at ffs_train.yaml's shapes
   against its RING tp shards run in turn with the row-parallel sums by
   hand (``dist.tp.virtual_tp``), output and every weight's gradient within
   TP_REL. Prints a ``tp_sp: {...}`` line.

10b. pp one card (before phase 10): pipeline parallelism's schedule in one
   process (``dist.pipeline.LocalHop``, the virtual pipeline) at full width
   (``pp_one_card``): one fp32 ffs_train step of Latte-XL/2 at batch 5
   through PP_STAGES stages of 2 pairs and PP_MICRO microbatches of a row
   against the one-model step from the same weights, generator and batch
   (loss and grad norm within DIST_REL, every parameter after the update
   within PP_PARAM_REL; PP_MICRO times the one-model step's B1-B5 launches,
   on the fp32 and vector routes), a second step of each timed; one bf16
   LatteT2V CFG forward (28 pairs, 16 x 512^2) through PP_T2V_STAGES stages
   and PP_T2V_MICRO microbatches against the whole model's (within
   BF16_TOL of the largest magnitude; B1, B2, B3 twice each block, norm_out
   once, on the tensor-core and vector routes), both timed. Prints a
   ``pp: {...}`` line.

Prints the phases' JSON lines (``train: {...}``, ``pixel_train: {...}``,
``train_more: {...}``, ``int8: {...}``, ``vae: {...}``, ``block_cache: {...}``, ``sample_many:
{...}``, ``eval: {...}``, ``t2v: {...}``, ``moe: {...}``, ``text: {...}``, ``tp_sp: {...}``, ``pp:
{...}``, ``dist: {...}``), the total seconds,
the kernels' JSON line (every row with phase "dist"'s per-rank launches, ``launches_dist``,
phase 10a's and the tp and sp runs' launches, ``launches_ring``, ``launches_tp`` and
``launches_sp`` (``tp_sp_launches``), phase 10b's and the 4-GPU pp runs' launches,
``launches_pp`` (``pp_launches``), phase 5f's FVD from the sampler's, ``launches_eval``,
phase "text"'s launches, ``launches_text`` or ``launches_text_train``, and
the MoE runs', ``launches_moe`` or ``launches_moe_train``; rows
B1, B2, B3 with ``launches_t2v``, ``launches_t2i`` and
``launches_t2v_block_cache``, phase 5e's, and B1 with its T2V shapes'
measurements under ``t2v``; rows B1, B2, B3 and both
B6 rows with ``launches_block_cache``, the block-cache DDIM-50's; the
training rows with ``launches_train_more``, phase 6f's) and ends with
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs a GPU: without one it exits non-zero and prints no result. What
it writes (checkpoints, latents) goes to a temporary directory, the kernel
library to the git-ignored build/.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from latte_tpu_torch.config import load_config
from latte_tpu_torch.core.block_cache import cached_sample_loop
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.kernels import (
    attention_bwd_dkv_reference,
    attention_bwd_dq_reference,
    attention_delta,
    attention_reference,
    build,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    ln_modulate,
    ln_modulate_reference,
    residual_ln_modulate,
    residual_ln_modulate_reference,
)
from latte_tpu_torch.kernels import flash_attention_int8, flash_scale_block, int8_attention
from latte_tpu_torch.kernels import adaln, attention, attention_int8
from latte_tpu_torch.kernels.adaln import EPS as ADALN_EPS, adaln_route
from latte_tpu_torch.kernels.attention import attention_tiled_reference, backward_route, forward_route
from latte_tpu_torch.kernels.attention_int8 import int8_route
from latte_tpu_torch.models import get_model
from latte_tpu_torch.models.moe import MoEMlp, moe_groups
from latte_tpu_torch.quant import calibrate_act_amax, merge_amax, quantize_params
from latte_tpu_torch.sample import sample, sample_many
from latte_tpu_torch.train import train
from latte_tpu_torch.train.callbacks import Callback
from latte_tpu_torch.train.checkpoint import find_model
from latte_tpu_torch.train.state import (
    create_train_state,
    make_lr_schedule,
    make_optimizer,
    trainable_temporal_attn_mask,
)
from latte_tpu_torch.train.step import make_train_step
from latte_tpu_torch.utils import save_video, to_uint8
from latte_tpu_torch.vae import cudnn_tf32, make_decode_fn

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense tensor-core bf16
FP32_FLOP_PER_S = 67e12     # CUDA-core fp32
INT8_OPS_PER_S = 1979e12    # dense tensor-core int8
# bf16 keeps 8 significant bits: a result may differ from the plain version
# by one rounding step, 2^-7 of the largest magnitude; allow two
BF16_TOL = 2.0**-6
# fp32: the same arithmetic summed in another order, a few ulp (~1e-6) apart
FP32_TOL = 1e-5
# the fp32 logsumexp (values of order 5) of the kernel and the plain version
LSE_TOL = 1e-4
# the tensor-core attention forward against the plain mirror of its tile
# schedule (attention_tiled_reference), which rounds q, p and the output at
# the same points: an output element may differ only where an fp32 sum in
# another order moves it across a bf16 rounding boundary, so at most this
# share of them, by one step (2^-7 of the largest magnitude) at most (the
# untiled plain version, rounding p once per row, differs on ~20%); the
# lse, fp32 on both sides, within fp32 rounding (relative and absolute).
# The tensor-core backward is held to its plain versions by the same share
# and step: its roundings are elementwise, so they mirror any tile schedule
TILED_SHARE_APART = 0.01
TILED_LSE_TOL = 1e-5
# the int8 kernel in fp32 against its plain version, by its arithmetic:
# relative L2 of the difference, the largest difference over the largest
# magnitude, and the share of elements more than 1e-6 of that apart. The
# int32 sums are exact and exp is the same function on both sides, so p is
# the same to the bit; only the fp32 sums of l and of the "qk" P.V run in
# another order, a few ulp apart. The flash arithmetic rounds p itself, so
# it is held at the CPU tests' limits. The fused one rounds p / l: where the
# other l moves that across a half-integer of p·127/p_max, P rounds to the
# neighbouring int8 value, which moves the D elements of one row by
# |v|·p_max/127. Hence its looser L2 limit, and the share limit for both:
# a wrong P scale or a skipped quantize moves nearly every element
INT8_FP32_TOL = {
    "flash": dict(rel_l2=1e-5, max_rel=2e-3, share_apart=1e-3),
    "fused": dict(rel_l2=1e-4, max_rel=2e-3, share_apart=1e-3),
}
HIDDEN, HEADS, HEAD_DIM, FRAMES, TOKENS, DEPTH = 1152, 16, 72, 16, 256, 28
TRAIN_BATCH, TRAIN_STEPS = 5, 6  # ffs_train.yaml's local_batch_size; steps of the entry-point run
IMG_BATCH, IMAGES = 4, 8  # the *_img_train.yaml's local_batch_size and use_image_num
KERNELS = {
    "flash_attention": dict(  # bf16; fp32 and other bf16 layouts: csrc/flash_attention.cu
        source="latte_tpu_torch/csrc/flash_attention_tc.cu",
        replaces="latte_tpu/kernels/attention.py:56",
        fn=flash_attention,
    ),
    "ln_modulate": dict(
        source="latte_tpu_torch/csrc/adaln.cu",
        replaces="latte_tpu/kernels/adaln.py:49",
        fn=ln_modulate,
    ),
    "residual_ln_modulate": dict(
        source="latte_tpu_torch/csrc/adaln.cu",
        replaces="latte_tpu/kernels/adaln.py:59",
        fn=residual_ln_modulate,
    ),
    # bf16; fp32: csrc/flash_attention_bwd_f32.cu (its own row in the JSON
    # line); misaligned views and other head dims: csrc/flash_attention_bwd.cu
    "flash_attention_bwd_dq": dict(
        source="latte_tpu_torch/csrc/flash_attention_bwd_tc.cu",
        replaces="latte_tpu/kernels/attention.py:143",
        fn=flash_attention_bwd_dq,
    ),
    "flash_attention_bwd_dkv": dict(
        source="latte_tpu_torch/csrc/flash_attention_bwd_tc.cu",
        replaces="latte_tpu/kernels/attention.py:184",
        fn=flash_attention_bwd_dkv,
    ),
    # pv_int8 at head_dim 72; the "qk" mode and other layouts:
    # csrc/flash_attention_int8.cu (its own row in the JSON line)
    "flash_attention_int8": dict(
        source="latte_tpu_torch/csrc/flash_attention_int8_tc.cu",
        replaces="latte_tpu/kernels/attention.py:330",
        fn=flash_attention_int8,
    ),
}
FORWARD = ("flash_attention", "ln_modulate", "residual_ln_modulate")
ADALN = ("ln_modulate", "residual_ln_modulate")
BACKWARD = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
INT8 = "flash_attention_int8"
# launches of each kernel in one train step with gradient checkpointing:
# every forward kernel twice per block (forward and recompute), each
# backward kernel once per block; training has no int8 attention
STEP_LAUNCHES = {**{k: 2 * DEPTH for k in FORWARD}, **{k: DEPTH for k in BACKWARD}, INT8: 0}
# the int8 kernel's cases: (rows of the block, tokens, P-scale rule); "flash"
# is the JAX flash wrapper's block of min(1024, N) keys (the main path's
# attention_mode: flash), "fused" one scale per row (attention_mode: auto at
# N < 512); t2v is the spatial attention of T2V 512^2 (1024 tokens a frame)
INT8_SHAPES = {
    "spatial": (FRAMES, TOKENS, "flash"),
    "temporal": (TOKENS, FRAMES, "flash"),
    "spatial_fused": (FRAMES, TOKENS, "fused"),
    "temporal_fused": (TOKENS, FRAMES, "fused"),
    "t2v": (FRAMES, 1024, "flash"),
    "n2048": (4, 2048, "flash"),
}
# the int8 kernel's "qk" mode in fp32: within this share of the plain
# version's largest magnitude (only the fp32 sums of l and P.V run in
# another order)
INT8_QK_FP32_TOL = 1e-6
# keys of the int8 kernel's K tiles: the deliberately wrong "qk" control
# takes p against the running maximum of each such tile
INT8_TILE = 32
INT8_ARCH = dict(input_size=32, num_frames=FRAMES, int8_attention=True, attention_mode="flash")
# (rows of the block, tokens per row) on the main path at batch 1
SHAPES = {"spatial": (FRAMES, TOKENS), "temporal": (TOKENS, FRAMES)}
# more cases of the adaLN kernels: (rows, tokens, width, dtype, storage offset
# of x in elements). b5 is the trainers' batch 5 (bf16: mixed precision,
# fp32: the training config as shipped); the other widths of the registry
# run every instantiation of the vector kernels; D = 1000 and x one element
# off a vector boundary must take the generic kernels, which stay checked
ADALN_SHAPES = {
    "spatial_b5": (TRAIN_BATCH * FRAMES, TOKENS, HIDDEN, torch.bfloat16, 0),
    "temporal_b5": (TRAIN_BATCH * TOKENS, FRAMES, HIDDEN, torch.bfloat16, 0),
    "spatial_b5_fp32": (TRAIN_BATCH * FRAMES, TOKENS, HIDDEN, torch.float32, 0),
    "temporal_b5_fp32": (TRAIN_BATCH * TOKENS, FRAMES, HIDDEN, torch.float32, 0),
    **{f"d{d}{sfx}": (FRAMES, TOKENS, d, dt, 0) for d in (384, 768, 1024)
       for sfx, dt in (("", torch.bfloat16), ("_fp32", torch.float32))},
    "d1000": (FRAMES, TOKENS, 1000, torch.bfloat16, 0),
    "misaligned": (FRAMES, TOKENS, HIDDEN, torch.bfloat16, 1),
    "misaligned_fp32": (FRAMES, TOKENS, HIDDEN, torch.float32, 1),
}
# more bf16 cases of the attention forward: (rows, tokens, storage offset in
# elements). t2v is T2V 512^2's spatial attention (1024 tokens a frame);
# ragged N masks the last K/V tile (and, at N <= 64, the short route's one
# tile); b5 is the mixed-precision trainer's batch 5; an offset of one
# element puts q/k/v 2 bytes past a 16-byte boundary, which the tensor-core
# kernel refuses and the CUDA-core kernel's bf16 instantiation takes
FLASH_SHAPES = {
    "t2v": (FRAMES, 1024, 0),
    "ragged": (FRAMES, 200, 0),
    "temporal_ragged": (FRAMES, 40, 0),
    "spatial_b5": (TRAIN_BATCH * FRAMES, TOKENS, 0),
    "temporal_b5": (TRAIN_BATCH * TOKENS, FRAMES, 0),
    "spatial_misaligned": (FRAMES, TOKENS, 1),
}
# the backward kernels' cases: (rows, tokens, dtype, storage offset in
# elements). b5 is the trainer's batch 5: in bf16 the mixed-precision
# trainer's shapes (spatial_b5 is the JSON line's row), in fp32 the training
# config's as shipped (spatial_b5_fp32 the fp32 rows'); an offset of one
# element puts every operand 2 (bf16) or 4 (fp32) bytes past a 16-byte
# boundary, which the tensor-core and fp32 kernels refuse and the CUDA-core
# kernels take: they stay checked, and timed beside the others
BWD_SHAPES = {
    "spatial": (FRAMES, TOKENS, torch.bfloat16, 0),
    "temporal": (TOKENS, FRAMES, torch.bfloat16, 0),
    "spatial_b5": (TRAIN_BATCH * FRAMES, TOKENS, torch.bfloat16, 0),
    "temporal_b5": (TRAIN_BATCH * TOKENS, FRAMES, torch.bfloat16, 0),
    "ragged": (FRAMES, 200, torch.bfloat16, 0),
    "spatial_misaligned": (FRAMES, TOKENS, torch.bfloat16, 1),
    "spatial_b5_misaligned": (TRAIN_BATCH * FRAMES, TOKENS, torch.bfloat16, 1),
    "spatial_fp32": (FRAMES, TOKENS, torch.float32, 0),
    "spatial_b5_fp32": (TRAIN_BATCH * FRAMES, TOKENS, torch.float32, 0),
    "temporal_b5_fp32": (TRAIN_BATCH * TOKENS, FRAMES, torch.float32, 0),
    "ragged_fp32": (FRAMES, 200, torch.float32, 0),
    "temporal_ragged_fp32": (FRAMES, 40, torch.float32, 0),
    "spatial_b5_fp32_misaligned": (TRAIN_BATCH * FRAMES, TOKENS, torch.float32, 1),
}
# the attention forward in fp32: (rows, tokens, storage offset in elements).
# batch 1 (the sampler with use_fp16: false) and the training config's batch
# 5 (spatial_b5_fp32 is the fp32 row of the JSON line, timed beside
# csrc/flash_attention.cu forced); ragged N masks the last K/V tile (N = 40:
# the temporal route's one tile); an offset of one element puts q/k/v 4
# bytes past a 16-byte boundary, which the fp32 kernel refuses and the
# CUDA-core kernel takes
FLASH_FP32_SHAPES = {
    "spatial_fp32": (FRAMES, TOKENS, 0),
    "temporal_fp32": (TOKENS, FRAMES, 0),
    "spatial_b5_fp32": (TRAIN_BATCH * FRAMES, TOKENS, 0),
    "temporal_b5_fp32": (TRAIN_BATCH * TOKENS, FRAMES, 0),
    "ragged_fp32": (FRAMES, 200, 0),
    "temporal_ragged_fp32": (FRAMES, 40, 0),
    "spatial_b5_fp32_misaligned": (TRAIN_BATCH * FRAMES, TOKENS, 1),
    # LatteIMG's (ffs_img_train.yaml): 16 video frames and 8 images at batch
    # 4 in the spatial blocks, the video frames alone in the temporal ones
    "spatial_img_fp32": (IMG_BATCH * (FRAMES + IMAGES), TOKENS, 0),
    "temporal_img_fp32": (IMG_BATCH * TOKENS, FRAMES, 0),
}
# pairs of runs in one process, a kernel's own route against its first
# version forced: DDIM-50 runs (phases 5, 7c), and steps in fp32 after the
# resume (phase 6b) and in mixed precision after its TRAIN_STEPS steps (6c);
# 2, and BC_TIMED_PAIRS 3, keep the whole script well inside its time limit
ROUTE_PAIRS = 2
# phase "block cache": bench.py:580's setting, also the sampler's default
# (14·2)//3 pairs. A DDIM-50 runs 25 full forwards and 25 of the back 5
# pairs (10 blocks): 950 launches of each per-block kernel, 0.679 of 1400
BC_PAIRS, BC_INTERVAL, BC_STEPS = 9, 2, 50
BC_FULL = -(-BC_STEPS // BC_INTERVAL)
BC_LAUNCHES = BC_FULL * DEPTH + (BC_STEPS - BC_FULL) * (DEPTH - 2 * BC_PAIRS)
# the block cache's latents against the exact sampler's: cosine above
# tests/test_block_cache.py:135's bound
BC_COSINE = 0.9
# pairs of DDIM-50 runs, block cache against exact: the host's speed drifts
# by up to 2x between runs on a shared host, so more than ROUTE_PAIRS
BC_TIMED_PAIRS = 3
# phase "sample many": batch 2, 3 videos asked for (rounded up to 4)
MANY_BATCH, MANY_SAMPLES = 2, 3
ROOT = os.path.dirname(os.path.abspath(__file__))
FFS_CONFIG = os.path.join(ROOT, "configs", "ffs", "ffs_sample.yaml")
# phase "t2v": the T2X sample configs as shipped (LatteT2V, 28 pairs, 16
# frames at 512^2, DDIM-50, CFG 7.5, bf16), on seeded random weights
T2V_CONFIG = os.path.join(ROOT, "configs", "t2x", "t2v_sample.yaml")
T2I_CONFIG = os.path.join(ROOT, "configs", "t2x", "t2i_sample.yaml")
T2V_INT8_STEPS = 10
# the block cache every 2nd call, at the pipeline's default (28·2)//3 = 18
# pairs cached: 25 full forwards and 25 of the back 10 pairs
T2V_BC_INTERVAL = 2
# B1 at the T2V CFG shapes: (B·F·H rows, N) spatially (2·16 frames, 1024
# tokens) and temporally (2·1024 patches, 16 frames)
T2V_B1_SHAPES = {"spatial": (2 * 16, 1024), "temporal": (2 * 1024, 16)}
FFS_TRAIN = os.path.join(ROOT, "configs", "ffs", "ffs_train.yaml")
# phase "train more": the training configs of the class-conditional and
# joint video-image slice, as shipped
UCF_TRAIN = os.path.join(ROOT, "configs", "ucf101", "ucf101_train.yaml")
FFS_IMG_TRAIN = os.path.join(ROOT, "configs", "ffs", "ffs_img_train.yaml")
UCF_IMG_TRAIN = os.path.join(ROOT, "configs", "ucf101", "ucf101_img_train.yaml")
OPTION_STEPS = 2  # steps of each option's run, and of the short config runs
ACCUM = 5  # gradient_accumulation_steps of the option check: a row a chunk at batch 5
ACCUM_REL_L2 = 1e-5  # K = ACCUM against K = 1 on the same rows and draws
DOTS_REL_L2 = 1e-6  # remat_policy: dots against full, same weights and batch


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0
    for name in ADALN:
        KERNELS[name]["fn"].vec_launches = 0
    for name in ("flash_attention", *BACKWARD, INT8):
        KERNELS[name]["fn"].tc_launches = 0
    for name in ("flash_attention", *BACKWARD):
        KERNELS[name]["fn"].f32_launches = 0


def bwd_counts(attr: str) -> dict:
    """Each backward kernel's counter ``attr``: "tc_launches" (tensor-core
    route) or "f32_launches" (fp32 route)."""
    return {name: getattr(KERNELS[name]["fn"], attr) for name in BACKWARD}


def check_bwd_routes(label: str, tc: int, f32: int) -> dict:
    """Each backward kernel's launches on the tensor-core and on the fp32
    route since the last reset_counts(): every bf16 call on the first, every
    fp32 one on the second."""
    got = dict(tensor_core=bwd_counts("tc_launches"), fp32_tiled=bwd_counts("f32_launches"))
    print(f"  {label}: backward launches by route {got} (expected {tc} and {f32} each)", flush=True)
    if any(c != tc for c in got["tensor_core"].values()) or \
            any(c != f32 for c in got["fp32_tiled"].values()):
        raise AssertionError(f"{label}: backward launches by route {got}, expected {tc} "
                             f"(tensor cores) and {f32} (fp32 route) each")
    return got


def check_tc(label: str, expect: int, f32: int = 0) -> int:
    """The attention forward's launches on the tensor-core route (every
    bf16 call) and on the fp32 route (every fp32 one) since the last
    reset_counts()."""
    got = (flash_attention.tc_launches, flash_attention.f32_launches)
    print(f"  {label}: {got[0]} tensor-core and {got[1]} fp32-route attention launches "
          f"(expected {expect} and {f32})", flush=True)
    if got != (expect, f32):
        raise AssertionError(f"{label}: {got} tensor-core and fp32-route attention launches, "
                             f"expected {(expect, f32)}")
    return got[0]


def check_vec(label: str) -> dict:
    """Every adaLN launch since the last reset_counts() took the vector
    route (csrc/adaln.cu's *_vec_kernel), and there was one."""
    got = {name: (KERNELS[name]["fn"].vec_launches, KERNELS[name]["fn"].launches) for name in ADALN}
    print(f"  {label}: adaLN launches on the vector route, of all: {got}", flush=True)
    if any(vec != n or n == 0 for vec, n in got.values()):
        raise AssertionError(f"{label}: an adaLN launch left the vector route: {got}")
    return {name: vec for name, (vec, _) in got.items()}


def check_int8_tc(label: str, expect: int) -> int:
    """The int8 attention's launches on the tensor-core route since the last
    reset_counts(): every call at head_dim 72, in both P.V modes."""
    got = flash_attention_int8.tc_launches
    print(f"  {label}: {got} tensor-core int8 attention launches (expected {expect})", flush=True)
    if got != expect:
        raise AssertionError(f"{label}: {got} tensor-core int8 attention launches, expected {expect}")
    return got


def counts() -> dict:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


class Timer:
    """Median device time of a call, each launch after a write of 64 MB so
    the 50 MB L2 holds none of its inputs (CUDA events around the call only).

    The events also count the host's time to reach the launch when the
    device runs dry before it: a wrapper's Python and the launch itself,
    tens of microseconds, which the 64 MB write does not always cover. With
    ``pad`` a spin kernel of ~0.5 ms keeps the device busy while the host
    records the start event and enqueues the call, so the events hold the
    device's time alone."""

    PAD_CYCLES = 1_000_000

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 15, pad: bool = False) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            if pad:
                torch.cuda._sleep(self.PAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]


def bound_ms(nbytes: float, flops: float, flop_rate: float, more_ops_s: float = 0.0):
    """The least time of a call: its bytes at the memory rate against its
    operations at their peak rate (``more_ops_s``: seconds of operations of
    another type, added to those of ``flops``)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate + more_ops_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    return (a.float() - b.float()).abs().max().item()


def max_abs(a) -> float:
    if isinstance(a, tuple):
        return max(max_abs(x) for x in a)
    return a.float().abs().max().item()


def flash_case(rows: int, n: int, device, gen, dtype=torch.bfloat16, offset: int = 0) -> dict:
    """The attention forward at one shape; q/k/v are views of one fused qkv
    output, as the model hands them over, ``offset`` elements into its
    storage. SDPA is the yardstick, but none for fp32 views off a 16-byte
    boundary, where SDPA's fp32 forward faults (misaligned address)."""
    shape = (rows, n, 3, HEADS, HEAD_DIM)
    numel = rows * n * 3 * HEADS * HEAD_DIM
    qkv = torch.randn(offset + numel, generator=gen, device=device, dtype=dtype)[offset:].view(shape)
    q, k, v = qkv.unbind(2)
    nbytes = 4 * rows * n * HEADS * HEAD_DIM * qkv.element_size()
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return dict(
        run=lambda: flash_attention(q, k, v),
        plain=lambda: attention_reference(q, k, v),
        tiled=(
            lambda: flash_attention(q, k, v, return_lse=True),
            lambda: attention_tiled_reference(q, k, v, return_lse=True),
        ),
        library=None if dtype == torch.float32 and offset % 4 else lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ),
        bound=bound_ms(nbytes, 4 * rows * HEADS * n * n * HEAD_DIM, rate),
        lse=(
            lambda: flash_attention(q, k, v, return_lse=True)[1],
            lambda: attention_reference(q, k, v, return_lse=True)[1],
        ),
        route=forward_route(q, k, v),
        cuda_core=lambda: forced(attention, "forward_route", flash_attention, q, k, v),
    )


def forced(module, name: str, fn, *args, to: str = "cuda_core"):
    """``fn(*args)`` with the route function ``module.name`` patched to send
    every call to the route ``to``: the CUDA-core kernel
    (csrc/flash_attention.cu, flash_attention_int8.cu) or the generic adaLN
    kernels, the earlier kernel, timed beside the new one."""
    route = getattr(module, name)
    setattr(module, name, lambda *a: route(*a) and to)
    try:
        return fn(*args)
    finally:
        setattr(module, name, route)


def kernel_cases(rows: int, n: int, device, gen, dtype=torch.bfloat16):
    """Inputs at one main-path shape, laid out as the model hands them over:
    q/k/v are views of one fused qkv output, the adaLN vectors column chunks
    of one modulation output."""
    return {"flash_attention": flash_case(rows, n, device, gen, dtype),
            **adaln_cases(rows, n, HIDDEN, device, gen, dtype)}


def adaln_cases(rows: int, n: int, d: int, device, gen, dtype=torch.bfloat16, offset: int = 0):
    """The two adaLN kernels at one shape: x and delta (rows, n, d), x
    ``offset`` elements into its storage; shift, scale and gate column chunks
    of one (rows, 6 d) modulation output, as the model passes them. Each
    case carries its route and the generic kernels forced. The yardstick of
    ln_modulate is F.layer_norm with 1 + scale[0] and shift[0] as its affine
    terms: at batch 1 every row of shift and scale is the same
    (latte_tpu_torch/models/dit.py:188-189), so on the sampler's shapes that
    one call computes the kernel's function; residual_ln_modulate has none.
    ``copy`` is a PyTorch copy of the activation bytes the kernel streams
    (x to a fresh tensor; x and delta for residual_ln_modulate): what the
    memory system gives those bytes under the same timer."""
    kw = dict(device=device, dtype=dtype)
    x = torch.randn(offset + rows * n * d, generator=gen, **kw)[offset:].view(rows, n, d)
    delta = torch.randn((rows, n, d), generator=gen, **kw)
    mod = torch.randn((rows, 6 * d), generator=gen, **kw)
    shift, scale, gate = mod[:, :d], mod[:, d:2 * d], mod[:, 2 * d:3 * d]
    weight, bias = 1.0 + scale[0], shift[0]
    e, el = x.element_size(), rows * n * d  # bytes per element, elements of one activation
    ln = (x, shift, scale)
    res = (x, delta, gate, shift, scale)
    src = torch.empty(2 * el, **kw)
    dst = torch.empty_like(src)
    return {
        "ln_modulate": dict(
            run=lambda: ln_modulate(*ln),
            plain=lambda: ln_modulate_reference(*ln),
            library=lambda: F.layer_norm(x, (d,), weight, bias, ADALN_EPS),
            bound=bound_ms((2 * el + 2 * rows * d) * e, 8 * el, FP32_FLOP_PER_S),
            route=adaln_route(x, (), (shift, scale)), dtype=dtype,
            generic=lambda: forced(adaln, "adaln_route", ln_modulate, *ln, to="generic"),
            copy=lambda: dst[:el].copy_(src[:el]),
        ),
        "residual_ln_modulate": dict(
            run=lambda: residual_ln_modulate(*res),
            plain=lambda: residual_ln_modulate_reference(*res),
            library=None,
            bound=bound_ms((4 * el + 3 * rows * d) * e, 11 * el, FP32_FLOP_PER_S),
            route=adaln_route(x, (delta,), (gate, shift, scale)), dtype=dtype,
            generic=lambda: forced(adaln, "adaln_route", residual_ln_modulate, *res, to="generic"),
            copy=lambda: dst.copy_(src),
        ),
    }


def measure_adaln(name: str, label: str, case: dict, timer, want: str) -> dict:
    """One adaLN kernel at one case: against its plain version (BF16_TOL or
    FP32_TOL of the largest magnitude), its route (``want``: the route
    function says so, and the vector count moved exactly when it is
    "vector"); in bf16 also to the bit: y equal, out equal on all but
    TILED_SHARE_APART of its elements. On the vector route it is timed
    beside the generic kernel forced and a copy of its activation bytes."""
    fn, bf16 = KERNELS[name]["fn"], case["dtype"] == torch.bfloat16
    before = fn.vec_launches, fn.launches
    r = measure(name, label, case, BF16_TOL if bf16 else FP32_TOL, timer)
    moved = fn.vec_launches - before[0], fn.launches - before[1]
    r["route"] = case["route"]
    print(f"  {name} {label}: route {case['route']}, vector launches {moved[0]} of {moved[1]}",
          flush=True)
    if case["route"] != want or moved[1] == 0 or moved[0] != (moved[1] if want == "vector" else 0):
        raise AssertionError(f"{name} {label}: route {case['route']} with {moved[0]} of "
                             f"{moved[1]} launches on the vector route; expected {want}")
    if bf16:
        got, plain = case["run"](), case["plain"]()
        if name == "residual_ln_modulate":
            r["y_share_apart"] = bits_apart(got[0], plain[0])[0]
            got, plain = got[1], plain[1]
        r["out_share_apart"] = bits_apart(got, plain)[0]
        print(f"  {name} {label} vs the plain version, to the bit: y {r.get('y_share_apart')}, "
              f"out {r['out_share_apart']} of the elements apart (limits: 0, {TILED_SHARE_APART})",
              flush=True)
        if r.get("y_share_apart", 0) > 0 or r["out_share_apart"] > TILED_SHARE_APART:
            raise AssertionError(f"{name} {label}: departs from the plain version: {r}")
    if want == "vector":
        r["generic_ms"] = timer.ms(case["generic"])
        r["generic_device_ms"] = timer.ms(case["generic"], pad=True)
        r["copy_device_ms"] = timer.ms(case["copy"], pad=True)
        print(f"  {name} {label}: generic kernel forced {r['generic_ms']:.4f} ms, device "
              f"{r['generic_device_ms']:.4f} ms; a copy of its activation bytes, device "
              f"{r['copy_device_ms']:.4f} ms", flush=True)
    return r


def backward_cases(rows: int, n: int, device, gen, dtype, offset: int = 0):
    """The dQ and dK/dV kernels at one shape: q/k/v are views of one fused
    qkv output and dq/dk/dv views of one fused gradient, as in the model,
    each ``offset`` elements into its storage (dO too); lse and delta come
    from the forward's plain version. The yardstick is the backward of
    torch's SDPA on the same q, k, v and dO (it computes dq, dk and dv
    together, so both rows carry the same time); none at an ``offset`` off
    a 16-byte boundary, where SDPA faults (misaligned address)."""
    kw = dict(device=device, dtype=dtype)
    shape = (rows, n, 3, HEADS, HEAD_DIM)

    def fused(*dims, randn=True):
        numel = offset + int(np.prod(dims))
        buf = torch.randn(numel, generator=gen, **kw) if randn else torch.empty(numel, **kw)
        return buf[offset:].view(dims)

    qkv = fused(*shape)
    q, k, v = qkv.unbind(2)
    dout = fused(rows, n, HEADS, HEAD_DIM)
    out, lse = attention_reference(q, k, v, return_lse=True)
    delta = attention_delta(out, dout)
    dq, dk, dv = fused(*shape, randn=False).unbind(2)
    e, bh = qkv.element_size(), rows * HEADS
    library = None
    if offset * e % 16 == 0:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in leaves))
        dout_t = dout.transpose(1, 2)
        library = lambda: torch.autograd.grad(sdpa_out, leaves, dout_t, retain_graph=True)  # noqa: E731
    el = bh * n * HEAD_DIM  # elements of one of q, k, v, dO
    reads = 4 * el * e + 2 * bh * n * 4  # q, k, v, dO and the fp32 lse, delta
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return {
        "flash_attention_bwd_dq": dict(
            run=lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta, dq),
            plain=lambda: attention_bwd_dq_reference(q, k, v, lse, dout, delta),
            library=library,
            bound=bound_ms(reads + el * e, 6 * bh * n * n * HEAD_DIM, rate),
            route=backward_route(q, k, v, dout, dq, None, None),
        ),
        "flash_attention_bwd_dkv": dict(
            run=lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta, dk, dv),
            plain=lambda: attention_bwd_dkv_reference(q, k, v, lse, dout, delta),
            library=library,
            bound=bound_ms(reads + 2 * el * e, 8 * bh * n * n * HEAD_DIM, rate),
            route=backward_route(q, k, v, dout, None, dk, dv),
        ),
    }


def int8_inputs(rows: int, n: int, device, gen, dtype=torch.bfloat16):
    """q, k, v as views of one fused qkv output, as in the model, and their
    per-head amax as a calibration gives them."""
    qkv = torch.randn((rows, n, 3, HEADS, HEAD_DIM), generator=gen, device=device, dtype=dtype)
    q, k, v = qkv.unbind(2)
    return q, k, v, [t.float().abs().amax(dim=(0, 1, 3)) for t in (q, k, v)]


def int8_cases(rows: int, n: int, rule: str, device, gen, dtype=torch.bfloat16) -> dict:
    """The int8 kernel at one shape, both P.V modes. The bound reads q, k, v
    and writes o in ``dtype``; QK^T is int8 and P.V int8 (pv_int8) or in
    ``dtype`` ("qk": bf16 on the tensor cores, fp32 on the CUDA cores).
    ``tile_max`` ("qk", N > INT8_TILE): the kernel at scale blocks of one K
    tile, p against the running maximum of each tile as a
    FlashAttention-2-style online softmax takes it, a function the check
    must tell apart."""
    q, k, v, amax = int8_inputs(rows, n, device, gen, dtype)
    block = flash_scale_block(n) if rule == "flash" else None
    nbytes = 4 * rows * n * HEADS * HEAD_DIM * q.element_size()
    half_ops = 2 * rows * HEADS * n * n * HEAD_DIM  # QK^T or P.V
    pv_rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    cases = {}
    for pv_int8, mode in ((True, "pv_int8"), (False, "qk")):
        pv_s = 0.0 if pv_int8 else half_ops / pv_rate
        cases[mode] = dict(
            run=lambda pv=pv_int8: flash_attention_int8(q, k, v, *amax, pv, block),
            plain=lambda pv=pv_int8: int8_attention(q, k, v, *amax, q.dtype, pv, block),
            library=None,
            bound=bound_ms(nbytes, half_ops * (2 if pv_int8 else 1), INT8_OPS_PER_S, pv_s),
            scale_block=block,
            route=int8_route(q, k, v, pv_int8, block),
            cuda_core=lambda pv=pv_int8: forced(attention_int8, "int8_route", flash_attention_int8,
                                                q, k, v, *amax, pv, block),
            tile_max=None if pv_int8 or n <= INT8_TILE else
            lambda: flash_attention_int8(q, k, v, *amax, False, INT8_TILE),
            inputs=(q, k, v), amax=amax,
        )
    sdpa = lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))  # noqa: E731
    return cases, sdpa


def dp4a_ms(case: dict, timer) -> dict:
    """The dp4a kernel (csrc/flash_attention_int8.cu, ``int8_route``
    patched) at a case, timed with events and on the device."""
    return dict(cuda_core_ms=timer.ms(case["cuda_core"]),
                cuda_core_device_ms=timer.ms(case["cuda_core"], pad=True))


def check_int8_kernel(device, timer) -> dict:
    """Phase 7a: the int8 kernel against its plain version at INT8_SHAPES,
    every case on the tensor-core route and timed beside the dp4a kernel
    forced, which is held to the same limit. Tolerance 2^-6 of the largest
    magnitude, as for the bf16 kernels: the int32 sums are exact on both
    sides, so the kernel and its plain version differ only where exp rounds
    an ulp apart, where p·127 then sits on the other side of a half-integer
    (one step of P moves a row by |v|/(127·l)), and in the final bf16
    rounding. The "qk" mode rounds p itself to bf16, as its plain version
    does, and sums P.V in fp32, so its output also equals the plain
    version's to the bit on all but TILED_SHARE_APART; its tile_max control
    (p against each K tile's running maximum) must not."""
    gen = torch.Generator(device=device).manual_seed(5)
    results = {}
    for shape, (rows, n, rule) in INT8_SHAPES.items():
        cases, sdpa = int8_cases(rows, n, rule, device, gen)
        sdpa_ms = timer.ms(sdpa)
        for mode, case in cases.items():
            label = f"{shape} B*H={rows * HEADS} N={n} {mode} scale_block={case['scale_block']}"
            tc_before = flash_attention_int8.tc_launches
            r = measure(INT8, label, case, BF16_TOL, timer)
            r["sdpa_bf16_ms"], r["route"] = sdpa_ms, case["route"]
            moved = flash_attention_int8.tc_launches - tc_before
            print(f"  {INT8} {label}: route {case['route']}, {moved} tensor-core launches", flush=True)
            if case["route"] != "tensor_core" or moved == 0:
                raise AssertionError(f"{INT8} {label}: route {case['route']} with {moved} "
                                     f"tensor-core launches; expected tensor_core")
            r.update(dp4a_ms(case, timer))
            want = case["plain"]()
            old_err = max_err(case["cuda_core"](), want)
            print(f"  {INT8} {label}: csrc/flash_attention_int8.cu forced {r['cuda_core_ms']:.4f} "
                  f"ms, device {r['cuda_core_device_ms']:.4f} ms, max abs err {old_err}", flush=True)
            if not old_err <= BF16_TOL * max_abs(want):
                raise AssertionError(f"{INT8} {label}: the dp4a kernel's max abs err {old_err}")
            if mode == "qk":
                r["vs_plain_bits"] = check_qk_bits(label, case["run"](), want, case["tile_max"])
            results[f"{shape}_{mode}"] = r
        print(f"  {INT8} {shape}: bf16 SDPA at the same shape {sdpa_ms:.4f} ms (context only)", flush=True)
        torch.cuda.empty_cache()
    return results


def check_qk_bits(label: str, got, want, tile_max) -> dict:
    """The bf16 "qk" output equal to the plain version's to the bit on all
    but TILED_SHARE_APART of the elements, and the tile-maximum control
    (where the shape has more than one K tile) apart on more."""
    share, err, _ = bits_apart(got, want)
    r = dict(share_apart=share, max_abs_err=err)
    if tile_max is not None:
        r["tile_max_share_apart"] = bits_apart(tile_max(), want)[0]
    print(f"  {INT8} {label} vs the plain version, to the bit: {json.dumps(r)} (limit: share "
          f"{TILED_SHARE_APART}; the control must exceed it)", flush=True)
    if not share <= TILED_SHARE_APART:
        raise AssertionError(f"{INT8} {label}: {share} of the outputs apart from the plain version")
    if tile_max is not None and r["tile_max_share_apart"] <= TILED_SHARE_APART:
        raise AssertionError(f"{INT8} {label}: the check passes p against each K tile's maximum: {r}")
    return r


def int8_gap(got, want) -> dict:
    """The int8 kernel's distance from its plain version, by INT8_FP32_TOL's
    measures, and the share of elements more than 1e-6 of the largest
    magnitude apart (the rows a rounding of P moved)."""
    d, w = (got - want).double(), want.double()
    scale = w.abs().max()
    return dict(
        rel_l2=(d.norm() / w.norm()).item(),
        max_rel=(d.abs().max() / scale).item(),
        share_apart=(d.abs() > 1e-6 * scale).double().mean().item(),
    )


def within_int8_tol(gap: dict, rule: str) -> bool:
    return all(gap[k] <= tol for k, tol in INT8_FP32_TOL[rule].items())


def check_int8_fp32(device, timer) -> dict:
    """Phase 7a, fp32: the kernel's arithmetic against its plain version at
    INT8_SHAPES, both P.V modes, held at INT8_FP32_TOL, the "qk" mode also
    within INT8_QK_FP32_TOL of the largest magnitude and timed beside the
    dp4a kernel forced (held to the same limits). bf16 hides a wrong P scale
    in its own rounding; fp32 does not. Three wrong kernels must fail the
    same check, or it could not see the faults it is for: the kernel with a
    P scale per 32-key K tile (its tile at N > 32) and with one P scale per
    row at N = 2048, where the flash rule has two, and fp attention (what a
    kernel that skipped the q/k/v quantize computes)."""
    gen = torch.Generator(device=device).manual_seed(6)
    gaps, controls, vs_dp4a, qk_times, failed = {}, {}, {}, {}, []
    for shape, (rows, n, rule) in INT8_SHAPES.items():
        cases, _ = int8_cases(rows, n, rule, device, gen, torch.float32)
        (q, k, v), amax, block = cases["qk"]["inputs"], cases["qk"]["amax"], cases["qk"]["scale_block"]
        for mode, case in cases.items():
            pv_int8 = mode == "pv_int8"
            want, got = case["plain"](), case["run"]()
            gap = int8_gap(got, want)
            gap["route"] = case["route"]
            gaps[f"{shape}_{mode}"] = gap
            print(f"  {INT8} fp32 {shape} N={n} {mode} scale_block={block}: {json.dumps(gap)}", flush=True)
            if gap["route"] != "tensor_core":
                failed.append(f"{shape} {mode}: route {gap['route']}, expected tensor_core")
            if not within_int8_tol(gap, rule):
                failed.append(f"{shape} {mode}: {gap} outside {INT8_FP32_TOL[rule]}")
            # against the dp4a kernel: the same arithmetic, l summed in another order
            old = case["cuda_core"]()
            d = dict(int8_gap(got, old), equal_bits=(got == old).double().mean().item())
            print(f"  {INT8} fp32 {shape} {mode} against csrc/flash_attention_int8.cu: {json.dumps(d)}",
                  flush=True)
            if not within_int8_tol(d, rule):
                failed.append(f"{shape} {mode}: the two int8 kernels differ by {d}")
            if not pv_int8:
                if not gap["max_rel"] <= INT8_QK_FP32_TOL:
                    failed.append(f"{shape} qk: {gap['max_rel']} of the largest magnitude apart "
                                  f"(limit {INT8_QK_FP32_TOL})")
                qk_times[shape] = t = dict(
                    ms=timer.ms(case["run"]), device_ms=timer.ms(case["run"], pad=True),
                    plain_ms=timer.ms(case["plain"]), **dp4a_ms(case, timer),
                    bound_ms=case["bound"][0], bound_by=case["bound"][1], vs_dp4a=d)
                print(f"  {INT8} fp32 {shape} N={n} qk times: {json.dumps(t)}", flush=True)
                continue
            vs_dp4a[shape] = d
            wrong = {}
            if shape == "spatial":
                wrong["P scale per 32-key tile"] = flash_attention_int8(q, k, v, *amax, True, 32)
            if shape == "n2048":
                wrong["one P scale per row"] = flash_attention_int8(q, k, v, *amax, True, n)
            if shape == "spatial_fused":
                wrong["no q/k/v quantize"] = attention_reference(q, k, v)
            for fault, got in wrong.items():
                controls[f"{shape}: {fault}"] = gap = int8_gap(got, want)
                print(f"  {INT8} fp32 {shape} control, {fault}: {json.dumps(gap)}", flush=True)
                if within_int8_tol(gap, rule):
                    failed.append(f"{shape}: the check passes a kernel with {fault}: {gap}")
        del q, k, v, want, cases
        torch.cuda.empty_cache()
    sharp = check_int8_sharp(device, failed)
    if failed:
        raise AssertionError(f"{INT8} fp32: " + "; ".join(failed))
    return dict(cases=gaps, controls=controls, vs_dp4a=vs_dp4a, qk_times=qk_times, sharp=sharp)


def check_int8_sharp(device, failed: list) -> dict:
    """Phase 7a, the int32 path alone: fp32 inputs scaled by 40, so that in
    nearly every row at most two keys keep a p above fp32's underflow. On
    such rows l has one value in any order of its sum, and the int32 sums
    are exact, so the tensor-core kernel, the dp4a kernel and the plain
    version must agree to the bit there (at least 90% of the rows qualify)."""
    gen = torch.Generator(device=device).manual_seed(7)
    out = {}
    for shape in ("spatial", "temporal", "spatial_fused"):
        rows, n, rule = INT8_SHAPES[shape]
        q, k, v, amax = int8_inputs(rows, n, device, gen, torch.float32)
        q, k = 40 * q, 40 * k
        amax = [40 * amax[0], 40 * amax[1], amax[2]]
        block = flash_scale_block(n) if rule == "flash" else None
        qs, ks, _, ls = attention_int8._scales(*amax, HEAD_DIM)
        head = lambda t, sc: attention_int8.quantize_int8(t, sc.view(1, 1, HEADS, 1))  # noqa: E731
        s = torch.einsum("bnhd,bmhd->bhnm", head(q, qs).double(), head(k, ks).double()).float()
        s = s * ls.view(1, HEADS, 1, 1)
        terms = (torch.exp(s - s.amax(-1, keepdim=True)) > 0).sum(-1).transpose(1, 2)  # (B, N, H)
        one_order = terms <= 2
        del s
        got = flash_attention_int8(q, k, v, *amax, True, block)
        old = forced(attention_int8, "int8_route", flash_attention_int8, q, k, v, *amax, True, block)
        want = int8_attention(q, k, v, *amax, q.dtype, True, block)
        sel = one_order.unsqueeze(-1).expand_as(got)
        out[shape] = r = dict(
            rows_one_order=one_order.double().mean().item(),
            equal_dp4a=(got[sel] == old[sel]).double().mean().item(),
            equal_plain=(got[sel] == want[sel]).double().mean().item(),
        )
        print(f"  {INT8} fp32 {shape}, rows of at most two terms of l: {json.dumps(r)}", flush=True)
        if r["rows_one_order"] < 0.9 or r["equal_dp4a"] < 1 or r["equal_plain"] < 1:
            failed.append(f"{shape}: not equal to the bit where l has one term order: {r}")
    return out


def measure(name: str, label: str, case: dict, tol_rel: float, timer) -> dict:
    """Check one kernel case against its plain version, then time both."""
    got, want = case["run"](), case["plain"]()
    torch.cuda.synchronize()
    err, tol = max_err(got, want), tol_rel * max_abs(want)
    r = dict(
        max_abs_err=err,
        tolerance=tol,
        ms=timer.ms(case["run"]),
        plain_ms=timer.ms(case["plain"]),
        library_ms=timer.ms(case["library"]) if case["library"] else None,
        device_ms=timer.ms(case["run"], pad=True),
        library_device_ms=timer.ms(case["library"], pad=True) if case["library"] else None,
        bound_ms=case["bound"][0],
        bound_by=case["bound"][1],
    )
    print(f"  {name} {label}: " + json.dumps(r), flush=True)
    if not err <= tol:
        raise AssertionError(f"{name} {label}: max abs err {err} > {tol}")
    return r


def fwd_routes() -> dict:
    return dict(tensor_core=flash_attention.tc_launches, fp32_tiled=flash_attention.f32_launches)


def check_route(label: str, case: dict, before: dict, want: str) -> None:
    """The attention forward took the kernel ``want`` names: the route
    function says so, and of the tensor-core and fp32 counts (``before``:
    fwd_routes() before the calls) only that route's moved."""
    moved = {k: c - before[k] for k, c in fwd_routes().items()}
    print(f"  flash_attention {label}: route {case['route']}, launches moved by route {moved}", flush=True)
    if case["route"] != want or any((m > 0) != (route == want) for route, m in moved.items()):
        raise AssertionError(f"flash_attention {label}: route {case['route']} with launches "
                             f"{moved}; expected {want}")


def bits_apart(got, want) -> tuple:
    """The share of elements of a bf16 kernel output not equal to the bit
    to its mirror's, the largest difference, and the limit of that
    difference: one bf16 step, 2^-7 of the largest magnitude."""
    diff = (got.float() - want.float()).abs()
    return (diff > 0).float().mean().item(), diff.max().item(), 2.0**-7 * max_abs(want)


def check_tiled(label: str, case: dict) -> dict:
    """The tensor-core forward against the plain mirror of its tile schedule
    on the same inputs: all but TILED_SHARE_APART of the output equal to the
    bit, the rest one bf16 step apart at most, the lse within TILED_LSE_TOL."""
    (out, lse), (want, want_lse) = (f() for f in case["tiled"])
    share, err, step = bits_apart(out, want)
    r = dict(share_apart=share, max_abs_err=err, lse_err=(lse - want_lse).abs().max().item())
    lse_tol = TILED_LSE_TOL * (1.0 + max_abs(want_lse))
    print(f"  flash_attention {label} vs its tiled mirror: {json.dumps(r)} (limits: share "
          f"{TILED_SHARE_APART}, err {step}, lse {lse_tol})", flush=True)
    if not (r["share_apart"] <= TILED_SHARE_APART and r["max_abs_err"] <= step
            and r["lse_err"] <= lse_tol):
        raise AssertionError(f"flash_attention {label}: the kernel departs from its tiled mirror: {r}")
    return r


def measure_backward(name: str, label: str, case: dict, tol_rel: float, timer, want: str) -> dict:
    """One backward kernel at one case: against its plain version at
    ``tol_rel``, its route (``want``: the route function says so, and of the
    tensor-core and fp32 counts only that route's moved), and on the
    tensor-core route each output to the bit against the plain version,
    which mirrors the kernel's rounding points: all but TILED_SHARE_APART of
    the elements equal, the rest one bf16 step apart at most."""
    fn = KERNELS[name]["fn"]
    before = dict(tensor_core=fn.tc_launches, fp32_tiled=fn.f32_launches)
    r = measure(name, label, case, tol_rel, timer)
    moved = dict(tensor_core=fn.tc_launches - before["tensor_core"],
                 fp32_tiled=fn.f32_launches - before["fp32_tiled"])
    print(f"  {name} {label}: route {case['route']}, launches moved by route {moved}", flush=True)
    if case["route"] != want or any((m > 0) != (route == want) for route, m in moved.items()):
        raise AssertionError(f"{name} {label}: route {case['route']} with launches {moved}; "
                             f"expected {want}")
    if want != "tensor_core":
        return r
    got, plain = case["run"](), case["plain"]()
    r["vs_plain_bits"] = bits = {}
    for out, g, w in zip(("dk", "dv") if isinstance(got, tuple) else ("dq",),
                         got if isinstance(got, tuple) else (got,),
                         plain if isinstance(plain, tuple) else (plain,)):
        share, err, step = bits_apart(g, w)
        bits[out] = dict(share_apart=share, max_abs_err=err)
        if not (share <= TILED_SHARE_APART and err <= step):
            raise AssertionError(f"{name} {label}: {out} departs from the plain version: "
                                 f"{share} of the elements apart (limit {TILED_SHARE_APART}), "
                                 f"largest by {err} (limit {step})")
    print(f"  {name} {label} vs the plain version, to the bit: {json.dumps(bits)} (limits: share "
          f"{TILED_SHARE_APART}, one bf16 step)", flush=True)
    return r


def measure_flash(label: str, case: dict, timer, want: str = "tensor_core", tol: float = BF16_TOL) -> dict:
    """The attention forward at one case: output (within ``tol`` of the
    largest magnitude) and lse against the plain version, its route
    (``want``), and on the tensor-core route the output and lse against the
    mirror of its tile schedule."""
    before = fwd_routes()
    r = measure("flash_attention", label, case, tol, timer)
    r["lse_err"] = lse_err = max_err(case["lse"][0](), case["lse"][1]())
    print(f"  flash_attention {label} lse: max abs err {lse_err} (tolerance {LSE_TOL})")
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_attention {label}: lse err {lse_err} > {LSE_TOL}")
    check_route(label, case, before, want)
    if want == "tensor_core":
        r["vs_tiled"] = check_tiled(label, case)
    return r


def check_kernels(device, timer) -> dict:
    """Each forward kernel against its plain version in bf16 at both shapes
    (and the attention's lse and route), the adaLN kernels at ADALN_SHAPES,
    the attention forward at FLASH_SHAPES, then each forward kernel in fp32;
    then the backward kernels at BWD_SHAPES. Returns the measurements by
    kernel and shape (the fp32 forward at FLASH_FP32_SHAPES among the
    attention forward's)."""
    gen = torch.Generator(device=device).manual_seed(0)
    results = {name: {} for name in KERNELS}
    # the timer's own floor: the device time of a kernel that does nothing
    # to speak of (one element zeroed)
    one = torch.zeros(1, device=device)
    results["floor_device_ms"] = timer.ms(one.zero_, pad=True)
    print(f"  timer floor: a one-element zero_ takes {results['floor_device_ms']:.4f} ms on the "
          f"device", flush=True)
    for shape, (rows, n) in SHAPES.items():
        for name, case in kernel_cases(rows, n, device, gen).items():
            label = f"{shape} rows={rows} N={n}"
            if name == "flash_attention":
                results[name][shape] = measure_flash(label, case, timer)
            else:
                results[name][shape] = measure_adaln(name, label, case, timer, "vector")
    for shape, (rows, n, d, dtype, offset) in ADALN_SHAPES.items():
        want = "vector" if d in adaln.VEC_DIMS and not offset else "generic"
        for name, case in adaln_cases(rows, n, d, device, gen, dtype, offset).items():
            label = f"{shape} rows={rows} N={n} D={d} offset={offset}"
            results[name][shape] = measure_adaln(name, label, case, timer, want)
        torch.cuda.empty_cache()
    for shape, (rows, n, offset) in FLASH_SHAPES.items():
        case = flash_case(rows, n, device, gen, offset=offset)
        label = f"{shape} B*H={rows * HEADS} N={n} offset={offset}"
        want = "cuda_core" if offset % 8 else "tensor_core"
        results["flash_attention"][shape] = measure_flash(label, case, timer, want)
        del case
        torch.cuda.empty_cache()
    # the fp32 instantiations (the sampler with use_fp16: false)
    rows, n = SHAPES["spatial"]
    for name, case in kernel_cases(rows, n, device, gen, torch.float32).items():
        before = fwd_routes()
        got, want = case["run"](), case["plain"]()
        err, tol = max_err(got, want), FP32_TOL * max_abs(want)
        print(f"  {name} spatial fp32: max abs err {err} (tolerance {tol})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name} fp32: max abs err {err} > {tol}")
        if name == "flash_attention":
            check_route("spatial fp32", case, before, "fp32_tiled")
        elif case["route"] != "vector":
            raise AssertionError(f"{name} spatial fp32: route {case['route']}, expected vector")
    for shape, (rows, n, offset) in FLASH_FP32_SHAPES.items():
        case = flash_case(rows, n, device, gen, torch.float32, offset)
        label = f"{shape} B*H={rows * HEADS} N={n} offset={offset}"
        want = "cuda_core" if offset % 4 else "fp32_tiled"
        r = results["flash_attention"][shape] = measure_flash(label, case, timer, want, FP32_TOL)
        if shape in ("spatial_b5_fp32", "temporal_b5_fp32"):  # beside csrc/flash_attention.cu
            r["cuda_core_ms"] = timer.ms(case["cuda_core"])
            r["cuda_core_device_ms"] = timer.ms(case["cuda_core"], pad=True)
            print(f"  flash_attention {label}: csrc/flash_attention.cu forced {r['cuda_core_ms']:.4f} "
                  f"ms, device {r['cuda_core_device_ms']:.4f} ms", flush=True)
        del case
        torch.cuda.empty_cache()
    for shape, (rows, n, dtype, offset) in BWD_SHAPES.items():
        bf16 = dtype == torch.bfloat16
        tol, route = (BF16_TOL, "tensor_core") if bf16 else (FP32_TOL, "fp32_tiled")
        want = "cuda_core" if offset * dtype.itemsize % 16 else route
        for name, case in backward_cases(rows, n, device, gen, dtype, offset).items():
            label = f"{shape} B*H={rows * HEADS} N={n} offset={offset}"
            results[name][shape] = measure_backward(name, label, case, tol, timer, want)
        torch.cuda.empty_cache()
    return results


TC_SOURCES = ("flash_attention_tc.cu", "flash_attention_bwd_tc.cu", "flash_attention_int8_tc.cu")
TC_KERNELS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc", "flash_int8_tc", "flash_int8_qk_tc")
F32_SOURCE = "latte_tpu_torch/csrc/flash_attention_bwd_f32.cu"
F32_FWD_SOURCE = "latte_tpu_torch/csrc/flash_attention_f32.cu"


def mma_wanted(fn: str):
    """The tensor-core instructions a kernel's SASS must hold (True) and
    must not (False), by its name: HMMA for bf16 products, IMMA for int8;
    the int8 "qk" kernels IMMA, and HMMA in bf16 alone (in fp32 their P.V
    runs on the CUDA cores). None for kernels of no TC_KERNELS family."""
    if "flash_int8_qk_tc" in fn:
        return {"IMMA": True, "HMMA": "bfloat16" in fn}
    if "flash_int8_tc" in fn:
        return {"IMMA": True}
    if any(k in fn for k in TC_KERNELS):
        return {"HMMA": True}
    return None


def report_build(path) -> dict:
    """Print ptxas's registers, shared memory and spills for each kernel of
    the tensor-core, register-tiled fp32 and adaLN sources (none may
    spill), and count the HMMA and IMMA instructions in the tensor-core
    kernels' SASS where cuobjdump sits beside nvcc: each must have those
    mma_wanted names, and no other."""
    spills = []
    f32_sources = (os.path.basename(F32_SOURCE), os.path.basename(F32_FWD_SOURCE))
    for src in (*TC_SOURCES, *f32_sources, "adaln.cu"):
        section = build.compile_log().split(f"== {src}\n")[1].split("\n== ")[0]
        for line in section.splitlines():
            if "entry function" in line or "spill" in line or "Used" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)
            if any(int(b) for b in re.findall(r"(\d+) bytes spill", line)):
                spills.append(line.strip())
    if spills:
        raise AssertionError(f"a tensor-core, fp32 or adaLN kernel spills: {spills}")
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("  cuobjdump not found beside nvcc: HMMA / IMMA counts not measured", flush=True)
        return {}
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    mma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if mma_wanted(fn) is not None:
                mma[fn] = {"HMMA": 0, "IMMA": 0}
        elif fn in mma:
            for op in ("HMMA", "IMMA"):
                mma[fn][op] += op in line
    print(f"  HMMA / IMMA instructions in the SASS of the tensor-core kernels: {json.dumps(mma)}", flush=True)
    wrong = {fn: c for fn, c in mma.items()
             if any((c[op] > 0) != want for op, want in mma_wanted(fn).items())}
    if any(not any(k in fn for fn in mma) for k in TC_KERNELS) or wrong:
        raise AssertionError(f"a tensor-core kernel lacks its tensor-core instructions or holds "
                             f"others: {wrong or mma}")
    return mma


def randomize_(model, seed: int) -> None:
    """Weights ~ N(0, 1/fan_in) and biases ~ N(0, 0.1²) from a seed, so every
    block (adaLN-Zero starts as the identity) and the output layer carry
    signal. The MoE layer's weights are (in, out) a matrix: the router
    (D, E), the experts (E, in, out); its biases (E, out)."""
    gen = torch.Generator(device=model.pos_embed.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".moe.bi", ".moe.bo")):
                std = 0.1
            elif name.endswith(".moe.router"):
                std = p.shape[0] ** -0.5
            elif name.endswith((".moe.wi", ".moe.wo")):
                std = p.shape[1] ** -0.5
            else:
                std = (p[0].numel() ** -0.5) if p.dim() > 1 else 0.1
            p.normal_(0.0, std, generator=gen)


def compare(name: str, got, want) -> dict:
    """Relative L2 error and cosine of two tensors, or of two lists of
    tensors taken as one vector each (a model's gradients, without a copy
    into one), summed in fp64 chunks (a gradient vector has 675M elements:
    an fp32 sum would drift)."""
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    dot = gg = ww = dd = 0.0
    finite = True
    for x, y in zip(got, want):
        x, y = x.float().flatten(), y.float().flatten()
        finite = finite and bool(torch.isfinite(x).all())
        for a, b in zip(x.split(1 << 24), y.split(1 << 24)):
            a, b = a.double(), b.double()
            dot += torch.dot(a, b).item()
            gg += torch.dot(a, a).item()
            ww += torch.dot(b, b).item()
            dd += torch.dot(a - b, a - b).item()
    r = dict(rel_l2=(dd / ww) ** 0.5, cosine=dot / (gg * ww) ** 0.5, finite=finite)
    print(f"  {name}: " + json.dumps(r), flush=True)
    return r


def kernel_kind(name: str) -> str:
    name = name.lower()
    for key, kind in (
        ("flash_int8_kernel", INT8),
        ("flash_int8_tc", INT8),
        ("flash_int8_qk_tc", INT8),
        ("flash_fwd_kernel", "flash_attention"),
        ("flash_fwd_f32", "flash_attention"),
        ("flash_fwd_tc", "flash_attention"),
        ("flash_bwd_dq_", "flash_attention_bwd_dq"),
        ("flash_bwd_dkv_", "flash_attention_bwd_dkv"),
        # both routes (*_vec_kernel and the generic kernels); "residual_"
        # first, since its name holds the other
        ("residual_ln_modulate", "residual_ln_modulate"),
        ("ln_modulate", "ln_modulate"),
    ):
        if key in name:
            return kind
    if any(g in name for g in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    if "multi_tensor" in name or "foreach" in name:
        return "optimizer_ema"
    return "other"


def device_ms_by_kind(prof, op_kinds: dict = None) -> tuple:
    """Device time (ms) of a profile by kind of kernel, the time the device
    was busy (the union of the kernels' intervals), and the largest kernels
    of kind "other". A kernel's kind is ``kernel_kind`` of its name or, with
    ``op_kinds`` (aten op name -> kind), that of the aten op at the root of
    the op that launched it. Annotation ranges are left out (they span
    kernels counted here), and a kernel reported twice with the same
    interval counts once."""
    kernels = {
        (ev.name, ev.time_range.start, ev.time_range.end)
        for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(ev, "is_user_annotation", False)
    }
    if op_kinds is None:
        timed = [(name, kernel_kind(name), end - start) for name, start, end in kernels]
    else:
        timed = []
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
                continue
            root = ev
            while root.cpu_parent is not None and root.cpu_parent.name.startswith("aten::"):
                root = root.cpu_parent
            timed += [(k.name, op_kinds.get(root.name, "other"), k.duration) for k in ev.kernels]
    groups, others = {}, {}
    for name, kind, us in timed:
        groups[kind] = groups.get(kind, 0.0) + us / 1e3
        if kind == "other":
            others[name[:60]] = others.get(name[:60], 0.0) + us / 1e3
    busy, last_end = 0.0, None
    for _, start, end in sorted(kernels, key=lambda k: k[1]):
        if last_end is None or start >= last_end:
            busy, last_end = busy + end - start, end
        elif end > last_end:
            busy, last_end = busy + end - last_end, end
    top = dict(sorted(others.items(), key=lambda kv: -kv[1])[:6])
    return groups, busy / 1e3, top


def print_profile(label: str, prof, wall_ms: float = None, op_kinds: dict = None) -> dict:
    """Print a profile's device time by kind (``op_kinds`` as in
    ``device_ms_by_kind``); return it by kind."""
    groups, busy, top = device_ms_by_kind(prof, op_kinds)
    if not busy:
        print(f"  {label} profile: the profiler saw no device time (not measured)", flush=True)
        return groups
    line = f"  {label} profile ms by kind: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(groups.items())}) + f"; device busy {busy:.4f}"
    if wall_ms:
        line += f" of {wall_ms:.4f} ms wall (device idle {1 - busy / wall_ms:.4f})"
    print(line, flush=True)
    print(f"  {label} largest other kernels (ms): "
          + json.dumps({k: round(v, 4) for k, v in top.items()}), flush=True)
    return groups


def profile_forward(model, x, t, wall_ms: float, label: str = "forward") -> float:
    """Device time of one forward by kind of kernel (torch.profiler), and
    the idle share against ``wall_ms``, the forward's unprofiled time;
    returns the adaLN kernels' device ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x, t)
        torch.cuda.synchronize()
    groups = print_profile(label, prof, wall_ms)
    return sum(groups.get(name, 0.0) for name in ADALN)


def route_runs(model, cfg, device, module, route_name: str, fn) -> dict:
    """Host seconds of DDIM runs of ``sample_latents``, each ending in a
    synchronize, in ROUTE_PAIRS pairs: the attention (``fn``: the bf16
    forward, or the int8 attention) on its tensor-core route, and with its
    CUDA-core kernel forced (``module.route_name`` patched for the run), the
    order alternating from pair to pair, so a drift in the host's speed
    falls on both. The sampler's host launches take about as long as its
    device work, so one run says little. Each run must launch ``fn`` for
    every attention call, all on the tensor cores or none."""
    route = getattr(module, route_name)
    secs = {"tensor_core": [], "cuda_core": []}
    calls = DEPTH * int(cfg.num_sampling_steps)
    try:
        for i in range(ROUTE_PAIRS):
            for name in (secs if i % 2 == 0 else reversed(secs)):
                setattr(module, route_name,
                        route if name == "tensor_core" else lambda *a: route(*a) and "cuda_core")
                before = (fn.launches, fn.tc_launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sample.sample_latents(model, cfg, device)
                torch.cuda.synchronize()
                secs[name].append(time.perf_counter() - t0)
                moved = (fn.launches - before[0], fn.tc_launches - before[1])
                if moved != (calls, calls if name == "tensor_core" else 0):
                    raise AssertionError(f"ddim run forced to {name}: attention launches and "
                                         f"tensor-core ones {moved}, expected {calls} and "
                                         f"{calls if name == 'tensor_core' else 0}")
    finally:
        setattr(module, route_name, route)
    return secs


def profile_sampler(model, cfg, device, wall_s: float, label: str = None) -> dict:
    """Device time of one DDIM run by kind of kernel, and the device's idle
    share against ``wall_s``, the same run's unprofiled host time (the
    profiler slows the host, not the device)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sample.sample_latents(model, cfg, device)
        torch.cuda.synchronize()
    groups = print_profile(label or f"ddim-{cfg.num_sampling_steps} sampler", prof, wall_s * 1e3)
    busy = device_ms_by_kind(prof)[1]
    return dict(device_ms_by_kind=groups, busy_ms=busy, wall_ms=wall_s * 1e3,
                idle=1 - busy / (wall_s * 1e3) if busy else None)


def profile_int8_forward(model, x, t, label: str = "int8 forward") -> dict:
    """Device time of one int8 forward by kind, where the int8 products
    (``torch._int_mm``) and the passes around them (quantize, dequantize,
    cast, bias) are kinds of their own. For the profile only, each int8
    layer's forward runs inside a profiler range; the kernels launched
    under a range are moved out of the kind their name gives them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from latte_tpu_torch.models.layers import QLinear

    forward = QLinear.forward

    def annotated(self, inp):
        if self.quantized not in (True, "static"):
            return forward(self, inp)
        with record_function("int8_linear"):
            return forward(self, inp)

    QLinear.forward = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(x, t)
            torch.cuda.synchronize()
    finally:
        QLinear.forward = forward
    groups, busy, top = device_ms_by_kind(prof)

    def kernels_under(ev, in_mm=False):
        in_mm = in_mm or ev.name == "aten::_int_mm"
        for kern in ev.kernels:
            yield kern, in_mm
        for child in ev.cpu_children:
            yield from kernels_under(child, in_mm)

    moved = 0
    for ev in prof.events():
        if ev.name != "int8_linear" or ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        for kern, in_mm in kernels_under(ev):
            ms, kind = kern.duration / 1e3, "matmul_int8" if in_mm else "int8_quantize"
            groups[kernel_kind(kern.name)] = groups.get(kernel_kind(kern.name), 0.0) - ms
            groups[kind] = groups.get(kind, 0.0) + ms
            moved += 1
    if not busy:
        print(f"  {label} profile: the profiler saw no device time (not measured)", flush=True)
        return {}
    print(f"  {label} profile ms by kind: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(groups.items())}) + f"; device busy {busy:.4f}"
          + f"; {moved} kernels found under the int8 layers", flush=True)
    print(f"  {label} largest other kernels (ms): "
          + json.dumps({k: round(v, 4) for k, v in top.items()}), flush=True)
    return dict(by_kind=groups, busy_ms=busy, kernels_under_int8_layers=moved)


def int8_forward(device, masters, x, t, out_p32, timer) -> dict:
    """Phase 7b: full-width Latte-XL/2 from the fp32 masters of phase 4,
    calibrated at t = 999, 500, 0 on one z in bf16, served in static W8A8
    with int8 attention through the flash route; kernel path against the
    plain int8 path, with the forward phase's rule against fp32."""
    with torch.device(device):
        calib = get_model("Latte-XL/2", quantized="calib", **INT8_ARCH)
    calib.load_state_dict(masters, strict=True)
    calib.to(torch.bfloat16).eval()
    zc = torch.randn((1, FRAMES, 4, 32, 32), generator=torch.Generator(device=device).manual_seed(4),
                     device=device)
    amax = None
    with torch.inference_mode():
        for tc in sample.CALIBRATION_TIMESTEPS:
            amax = merge_amax(amax, calibrate_act_amax(calib, zc, torch.tensor([tc], device=device)))
    del calib
    qsd = quantize_params(masters, act_amax=amax)
    with torch.device(device):
        qmodel = get_model("Latte-XL/2", quantized="static", **INT8_ARCH)
        qplain = get_model("Latte-XL/2", quantized="static", plain=True, **INT8_ARCH)
    for m in (qmodel, qplain):
        m.load_state_dict(qsd, strict=True)
        m.to(torch.bfloat16).eval()
    scale_dtypes = {b.dtype for n, b in qmodel.named_buffers() if n.endswith("_scale")}
    with torch.inference_mode():
        qmodel(x, t)  # warm-up: cuBLASLt's int8 handles
        torch.cuda.synchronize()
        reset_counts()
        out_q = qmodel(x, t)
        torch.cuda.synchronize()
        per_forward = counts()
        check_tc("one int8 forward", 0)
        check_vec("one int8 forward")
        check_int8_tc("one int8 forward", DEPTH)
        out_qp = qplain(x, t)
    expect = {k: 0 for k in KERNELS}
    expect.update({INT8: DEPTH, "ln_modulate": DEPTH, "residual_ln_modulate": DEPTH})
    print(f"  launches in one int8 forward: {per_forward}; scales kept in {scale_dtypes}", flush=True)
    if per_forward != expect:
        raise AssertionError(f"expected {expect} launches in one int8 forward, got {per_forward}")
    if scale_dtypes != {torch.float32}:
        raise AssertionError(f"the bf16 int8 model's scales are {scale_dtypes}, not fp32")
    vs_plain = compare("int8 kernel vs int8 plain", out_q, out_qp)
    vs32 = compare("int8 kernel vs plain fp32", out_q, out_p32)
    plain_vs32 = compare("int8 plain vs plain fp32", out_qp, out_p32)
    # the kernel may add no more error than the plain int8 arithmetic brings
    if not (vs_plain["finite"] and vs_plain["cosine"] >= 0.999
            and vs32["rel_l2"] <= 1.25 * plain_vs32["rel_l2"] + 1e-3):
        raise AssertionError("the int8 kernel path disagrees with the plain int8 path")
    with torch.inference_mode():
        fwd_ms = timer.ms(lambda: qmodel(x, t), iters=5)
        plain_fwd_ms = timer.ms(lambda: qplain(x, t), iters=5)
        prof = profile_int8_forward(qmodel, x, t)
    print(f"  int8 forward ms: kernels {fwd_ms:.3f}, plain {plain_fwd_ms:.3f}", flush=True)
    return dict(launches=per_forward, cosine_vs_plain=vs_plain["cosine"], rel_l2_vs_fp32=vs32["rel_l2"],
                plain_rel_l2_vs_fp32=plain_vs32["rel_l2"], ms=fwd_ms, plain_ms=plain_fwd_ms,
                profile=prof)


VAE_TOL = 1e-4         # fp32 decode/encode (TF32 off) against fp64: relative L2
VAE_UINT8_SHARE = 0.999  # share of uint8 values equal to fp64's
VAE_CHECK_FRAMES = (0, FRAMES // 2)  # the two DDIM latent frames held against fp64
VAE_RUNS = 5           # timed decodes of a 16-frame video per setting, after a warm-up
# the aten op at the root of the op that launched a VAE kernel -> the kernel's
# kind (cuDNN's and the elementwise kernels' names do not say which op they serve)
VAE_KINDS = {
    "aten::conv2d": "convolution", "aten::group_norm": "group_norm", "aten::silu": "silu",
    "aten::linear": "attention_matmul", "aten::bmm": "attention_matmul",
    "aten::softmax": "softmax", "aten::add": "residual_add", "aten::mul": "attention_scale",
    "aten::upsample_nearest2d": "upsample", "aten::to": "copies", "aten::copy_": "copies",
    "aten::reshape": "copies", "aten::contiguous": "copies", "aten::clone": "copies",
}


def read_mp4(path: str) -> np.ndarray:
    """(F, H, W, 3) uint8 frames of an mp4, read back through cv2."""
    import cv2

    cap, frames = cv2.VideoCapture(path), []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
    finally:
        cap.release()
    return np.stack(frames) if frames else np.zeros((0,), np.uint8)


def vae_decode_runs(fn, z) -> list:
    """Host seconds of ``fn(z)`` ending in a synchronize, VAE_RUNS times
    after a warm-up."""
    fn(z)
    secs = []
    for _ in range(VAE_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(z)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def vae_phase(tmp: str, ckpt: str, lat_bf16, ddim_s: float, device, smi: str) -> dict:
    """Phase 5b: the entry point with the full-width random VAE (DDIM-50 then
    a 16-frame fp32 decode to an mp4), the decode and encode at fp32 with
    TF32 off against fp64, and the decode's seconds, error, peak memory and
    device time in three settings."""
    cfg = load_config(FFS_CONFIG, [
        "sample_method=ddim", "num_sampling_steps=50", f"ckpt={ckpt}", "vae_ckpt=random",
        f"save_video_path={tmp}/ffs_vae.mp4",
    ])
    reset_counts()
    frames = read_mp4(sample.main(cfg))  # the entry point, on cuda by default
    launches = counts()
    tc = check_tc("ddim-50 and vae decode entry point", DEPTH * 50)
    vec = check_vec("ddim-50 and vae decode entry point")
    print(f"  entry point mp4 read back as {frames.shape} {frames.dtype}; launches {launches}",
          flush=True)
    size = int(cfg.image_size)
    if frames.shape != (FRAMES, size, size, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"expected ({FRAMES}, {size}, {size}, 3) uint8 frames, got {frames.shape}")
    # the VAE launches no hand-written kernel: the DiT's launches alone
    if any(launches[k] != DEPTH * 50 for k in FORWARD) or any(launches[k] for k in (*BACKWARD, INT8)):
        raise AssertionError(f"expected {DEPTH * 50} launches of each forward kernel, got {launches}")

    vae = sample.load_vae(cfg, device)  # the same seeded full-width VAE, fp32
    decode = make_decode_fn(vae)
    z16 = lat_bf16[0].to(device) / vae.scaling_factor  # the DDIM-50 video of phase 5
    z2 = z16[list(VAE_CHECK_FRAMES)]
    vae64 = copy.deepcopy(vae).double()
    with torch.inference_mode():
        ref = vae64.decode(z2.double())
        x2 = decode(z2)
        with cudnn_tf32(False):
            post, post64 = vae.encode(x2), vae64.encode(x2.double())
    dec = compare("vae decode of 2 frames, fp32 (TF32 off) vs fp64", x2, ref)
    u8 = to_uint8(x2.permute(0, 2, 3, 1).cpu().numpy())
    u8_64 = to_uint8(ref.permute(0, 2, 3, 1).cpu().numpy())
    equal = float((u8 == u8_64).mean())
    enc = {name: compare(f"vae encode of those frames, posterior {name}, fp32 vs fp64", a, b)
           for name, a, b in (("mean", post.mean, post64.mean), ("logvar", post.logvar, post64.logvar))}
    print(f"  uint8 frames equal to fp64's on {equal:.6f} of values; posterior mean "
          f"{tuple(post.mean.shape)}", flush=True)
    if dec["rel_l2"] > VAE_TOL or any(e["rel_l2"] > VAE_TOL for e in enc.values()) \
            or not (dec["finite"] and enc["mean"]["finite"]):
        raise AssertionError(f"the fp32 VAE is more than {VAE_TOL} off fp64")
    if equal < VAE_UINT8_SHARE or tuple(post.mean.shape) != (2, 4, size // 8, size // 8):
        raise AssertionError(f"uint8 frames equal on {equal} (< {VAE_UINT8_SHARE}) or posterior "
                             f"mean {tuple(post.mean.shape)} is not (2, 4, {size // 8}, {size // 8})")
    del vae64, post, post64
    torch.cuda.empty_cache()

    vae16 = copy.deepcopy(vae).to(torch.bfloat16)

    def with_tf32(z):
        with torch.inference_mode(), cudnn_tf32(True):
            return vae.decode(z)

    settings = {
        "fp32": decode,  # the sampler's: TF32 off
        "fp32_tf32": with_tf32,
        "bf16": make_decode_fn(vae16),  # GroupNorm and softmax in fp32 (bench.py:538's setting)
    }
    timed = {}
    for name, fn in settings.items():
        err = dec["rel_l2"] if name == "fp32" else \
            compare(f"vae decode of 2 frames, {name} vs fp64", fn(z2).float(), ref)["rel_l2"]
        secs = vae_decode_runs(fn, z16)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(z16)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        s_med = sorted(secs)[len(secs) // 2]
        timed[name] = dict(s_per_video=s_med, seconds=secs, rel_l2_vs_fp64=err,
                           peak_gib=peak / 2**30, allocated_before_gib=before / 2**30,
                           videos_per_min_with_decode=60.0 / (ddim_s + s_med))
        print(f"  vae decode {name}, {FRAMES} frames: {s_med:.4f} s/video (median of {secs}); "
              f"relative L2 vs fp64 {err:.3g}; peak memory {peak / 2**30:.3f} GiB "
              f"({before / 2**30:.3f} before) on {smi}", flush=True)

    from torch.profiler import ProfilerActivity, profile

    profiles = {}
    for name in ("fp32", "bf16"):  # the sampler's setting, and bf16 to see what holds it back
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            settings[name](z16)
            torch.cuda.synchronize()
        wall_ms = timed[name]["s_per_video"] * 1e3
        kinds = print_profile(f"vae {name} decode", prof, wall_ms, VAE_KINDS)
        _, busy, _ = device_ms_by_kind(prof)
        profiles[name] = dict(device_ms_by_kind=kinds, busy_ms=busy, wall_ms=wall_ms,
                              idle=1 - busy / wall_ms if busy else None)
    vpm = 60.0 / ddim_s
    print(f"  videos/min: {vpm:.3f} to latents (DDIM-50 {ddim_s:.4f} s, phase sampler), "
          f"{timed['fp32']['videos_per_min_with_decode']:.3f} with the fp32 decode on {smi}", flush=True)
    del vae, vae16
    torch.cuda.empty_cache()
    return dict(
        frames=list(frames.shape), launches=launches, tc_launches=tc,
        vec_launches=vec, decode_rel_l2=dec["rel_l2"], uint8_equal_share=equal,
        encode_rel_l2={k: e["rel_l2"] for k, e in enc.items()}, settings=timed,
        profiles=profiles, ddim_s=ddim_s, videos_per_min=vpm,
        videos_per_min_with_decode=timed["fp32"]["videos_per_min_with_decode"], device=smi,
    )


def int8_pairs(qmodel, cfg, device, label: str) -> dict:
    """DDIM runs of the entry point's model for ``cfg`` (built by
    ``sample.build_model``: the same calibration) in ROUTE_PAIRS
    alternating pairs against the dp4a kernel forced (``int8_route``
    patched for the run): seconds and videos/min of each, and ``s`` the
    median seconds a video on the tensor cores."""
    pairs = route_runs(qmodel, cfg, device, attention_int8, "int8_route", flash_attention_int8)
    tc_s, dp4a_s = (sorted(v)[len(v) // 2] for v in pairs.values())
    wins = sum(a < b for a, b in zip(pairs["tensor_core"], pairs["cuda_core"]))
    print(f"  {label} pairs: tensor-core int8 attention {tc_s:.3f} s -> {60.0 / tc_s:.3f} "
          f"videos/min (median of {pairs['tensor_core']}), csrc/flash_attention_int8.cu forced "
          f"{dp4a_s:.3f} s -> {60.0 / dp4a_s:.3f} videos/min (median of {pairs['cuda_core']}); "
          f"tensor cores faster in {wins} of {ROUTE_PAIRS}", flush=True)
    return dict(s=tc_s, pairs=pairs, pairs_won=wins,
                pair_videos_per_min={"tensor_core": 60.0 / tc_s, "cuda_core": 60.0 / dp4a_s})


def int8_ddim(cfg, lat_bf16, label: str) -> tuple:
    """``sample.main`` on ``cfg`` (static W8A8, DDIM-50, int8 attention):
    finite latents, the launches of 3 bf16 calibration forwards and 50 int8
    ones, every int8 attention on the tensor cores, and bench.py's int8
    quality guard against the bf16 kernel path's latents."""
    reset_counts()
    lat = torch.from_numpy(np.load(sample.main(cfg))["latents"])  # on cuda by default
    launches = counts()
    check_tc(f"{label}, its 3 bf16 calibration forwards", 3 * DEPTH)
    check_vec(f"{label} and its calibration")
    tc = check_int8_tc(label, 50 * DEPTH)
    # the calibration runs 3 floating-point forwards (flash_attention), the
    # 50 steps one int8 forward each
    expect = {k: 0 for k in KERNELS}
    expect.update({INT8: 50 * DEPTH, "flash_attention": 3 * DEPTH,
                   "ln_modulate": 53 * DEPTH, "residual_ln_modulate": 53 * DEPTH})
    print(f"  {label} latents {tuple(lat.shape)} finite={bool(torch.isfinite(lat).all())}; "
          f"launches {launches}", flush=True)
    if lat.shape != (1, FRAMES, 4, 32, 32) or not torch.isfinite(lat).all():
        raise AssertionError(f"the {label} latents are not finite (1, 16, 4, 32, 32)")
    if launches != expect:
        raise AssertionError(f"{label}: expected {expect} launches, got {launches}")
    guard = compare(f"{label} latents vs bf16 ddim-50 latents", lat, lat_bf16)
    if not (guard["cosine"] > 0.99 and guard["rel_l2"] < 0.1):
        raise AssertionError(f"the {label} latents fail the quality guard against bf16")
    return lat, launches, tc, guard


def int8_sampler(tmp: str, ckpt: str, lat_bf16, bf16_s: float, device, smi: str) -> dict:
    """Phase 7c: the entry point in static W8A8 with int8 attention (flash
    route), DDIM-50 from the checkpoint of phase 5, against the plain int8
    path and in pairs against the dp4a kernel forced; the same for the "qk"
    mode (P.V in bf16) under attention_mode: auto, which takes the fused
    rule at N = 256 and 16; then a short run of the dynamic mode."""
    base = ["sample_method=ddim", f"ckpt={ckpt}"]
    cfg = load_config(FFS_CONFIG, base + [
        "num_sampling_steps=50", "quantized=static", "int8_attention=true", "attention_mode=flash",
        f"save_video_path={tmp}/ffs_int8.mp4",
    ])
    lat, launches, int8_tc, guard = int8_ddim(cfg, lat_bf16, "int8 ddim-50")
    qmodel = sample.build_model(cfg, device)  # the entry point's model: same calibration
    with torch.device(device):
        qplain = get_model("Latte-XL/2", quantized="static", plain=True, **INT8_ARCH)
    qplain.load_state_dict(qmodel.state_dict(), strict=True)
    qplain.to(torch.bfloat16).eval()
    t1 = time.perf_counter()
    ref = sample.sample_latents(qplain, cfg, device)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    vs_plain = compare("int8 ddim-50 latents, entry point vs int8 plain path", lat, ref.cpu())
    if not vs_plain["cosine"] >= 0.99:
        raise AssertionError("the int8 DDIM latents disagree with the plain int8 path's")
    del qplain
    timed = int8_pairs(qmodel, cfg, device, "int8 ddim-50")
    del qmodel
    print(f"  int8 ddim-50 batch 1: {timed['s']:.3f} s -> {60.0 / timed['s']:.3f} videos/min "
          f"(the pairs' median; plain int8 path {plain_s:.3f} s); bf16 in this run {bf16_s:.3f} s -> "
          f"{60.0 / bf16_s:.3f} videos/min; on {smi}", flush=True)

    # the "qk" mode: P.V in bf16, every int8 attention on the tensor cores
    cfg = load_config(FFS_CONFIG, base + [
        "num_sampling_steps=50", "quantized=static", "int8_attention=qk", "attention_mode=auto",
        f"save_video_path={tmp}/ffs_qk.mp4",
    ])
    _, qk_launches, qk_tc, qk_guard = int8_ddim(cfg, lat_bf16, "qk ddim-50")
    qmodel = sample.build_model(cfg, device)
    qk = int8_pairs(qmodel, cfg, device, "qk ddim-50")
    # the device time of one of its forwards, on each route: what the pairs'
    # host clock may hide
    x = torch.randn((1, FRAMES, 4, 32, 32), generator=torch.Generator(device=device).manual_seed(8),
                    device=device)
    t = torch.tensor([500], device=device)
    with torch.inference_mode():
        qk["profile"] = profile_int8_forward(qmodel, x, t, "qk forward")
        qk["profile_dp4a"] = forced(attention_int8, "int8_route", profile_int8_forward, qmodel, x, t,
                                    "qk forward, csrc/flash_attention_int8.cu forced")
    del qmodel
    qk.update(launches=qk_launches, tc_launches=qk_tc, guard=qk_guard)

    # a short run of the dynamic mode: int8 products, the bf16 attention forward
    steps = 5
    cfg = load_config(FFS_CONFIG, base + [f"num_sampling_steps={steps}", "quantized=true",
                                          f"save_video_path={tmp}/ffs_dynamic.mp4"])
    reset_counts()
    lat_s = torch.from_numpy(np.load(sample.main(cfg))["latents"])
    got = counts()
    check_tc(f"dynamic ddim-{steps}", steps * DEPTH)
    check_vec(f"dynamic ddim-{steps}")
    check_int8_tc(f"dynamic ddim-{steps}", 0)
    expect = {k: steps * DEPTH if k in FORWARD else 0 for k in KERNELS}
    print(f"  dynamic ddim-{steps}: finite={bool(torch.isfinite(lat_s).all())}; launches {got}", flush=True)
    if not torch.isfinite(lat_s).all() or got != expect:
        raise AssertionError(f"the dynamic int8 run failed: expected {expect} launches")
    short = {"dynamic": got}
    return dict(launches=launches, tc_launches=int8_tc, guard=guard, cosine_vs_plain=vs_plain["cosine"],
                videos_per_min=60.0 / timed["s"], bf16_videos_per_min=60.0 / bf16_s, plain_s=plain_s,
                **timed, qk=qk, short_runs=short)


def cache_runs(model, cfg_bc, cfg_exact, device, fn, label: str) -> tuple:
    """Host seconds of DDIM-50 runs of ``sample_latents`` in BC_TIMED_PAIRS
    pairs, the block cache (``cfg_bc``) against the exact sampler
    (``cfg_exact``), the order alternating from pair to pair, so a drift in
    the host's speed falls on both. Each run must launch the attention
    kernel ``fn`` BC_LAUNCHES or 50 x DEPTH times, every one on the tensor
    cores. Returns the timings and the last latents of each."""
    cfgs = {"block_cache": cfg_bc, "exact": cfg_exact}
    calls = {"block_cache": BC_LAUNCHES, "exact": DEPTH * BC_STEPS}
    secs, lats = {name: [] for name in cfgs}, {}
    for i in range(BC_TIMED_PAIRS):
        for name in (cfgs if i % 2 == 0 else reversed(cfgs)):
            before = (fn.launches, fn.tc_launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lats[name] = sample.sample_latents(model, cfgs[name], device)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
            moved = (fn.launches - before[0], fn.tc_launches - before[1])
            if moved != (calls[name], calls[name]):
                raise AssertionError(f"{label} {name} run: attention launches and tensor-core ones "
                                     f"{moved}, expected {calls[name]} each")
    med = {name: sorted(v)[len(v) // 2] for name, v in secs.items()}
    wins = sum(a < b for a, b in zip(secs["block_cache"], secs["exact"]))
    r = dict(secs=secs, median_s=med, videos_per_min={k: 60.0 / v for k, v in med.items()},
             speedup=med["exact"] / med["block_cache"], pairs_won=wins)
    print(f"  {label} pairs: block cache {med['block_cache']:.4f} s -> {60.0 / med['block_cache']:.3f} "
          f"videos/min (median of {secs['block_cache']}), exact {med['exact']:.4f} s -> "
          f"{60.0 / med['exact']:.3f} videos/min (median of {secs['exact']}); {r['speedup']:.4f}x, "
          f"block cache faster in {wins} of {BC_TIMED_PAIRS}", flush=True)
    return r, lats


def check_fidelity(label: str, lat, want, against: str = "bf16") -> dict:
    """Latent cosine and relative L2 of block-cache latents against the
    exact sampler's (``against``): finite, cosine above BC_COSINE."""
    r = compare(f"{label} latents vs the exact {against} ddim-{BC_STEPS} latents", lat, want)
    if lat.shape != (1, FRAMES, 4, 32, 32) or not r["finite"] or not r["cosine"] > BC_COSINE:
        raise AssertionError(f"{label}: latents {tuple(lat.shape)} fail the block-cache guard {r} "
                             f"(finite, cosine > {BC_COSINE})")
    return r


def block_cache_int8(tmp: str, base: list, over: list, label: str, lat_bf16, device) -> dict:
    """The entry point in static W8A8 with int8 attention (``over``) and the
    block cache: 3 bf16 calibration forwards of the full model, then 950
    launches of each per-block kernel, every int8 attention on the tensor
    cores; the latents against the exact int8 sampler's and bf16's, and
    pairs against the exact int8 sampler from the entry point's model."""
    bc = [f"block_cache_pairs={BC_PAIRS}", f"block_cache_interval={BC_INTERVAL}"]
    cfg = load_config(FFS_CONFIG, base + over + bc + [f"save_video_path={tmp}/ffs_{label}.mp4"])
    reset_counts()
    lat = torch.from_numpy(np.load(sample.main(cfg))["latents"])  # on cuda by default
    launches = counts()
    check_tc(f"{label}, its 3 bf16 calibration forwards", 3 * DEPTH)
    vec = check_vec(f"{label} and its calibration")
    tc = check_int8_tc(label, BC_LAUNCHES)
    expect = {k: 0 for k in KERNELS}
    expect.update({INT8: BC_LAUNCHES, "flash_attention": 3 * DEPTH,
                   **{k: BC_LAUNCHES + 3 * DEPTH for k in ADALN}})
    print(f"  {label} latents {tuple(lat.shape)}; launches {launches}", flush=True)
    if launches != expect:
        raise AssertionError(f"{label}: expected {expect} launches, got {launches}")
    qmodel = sample.build_model(cfg, device)  # the entry point's model: same calibration
    pairs, lats = cache_runs(qmodel, cfg, load_config(FFS_CONFIG, base + over), device,
                             flash_attention_int8, label)
    del qmodel
    same = torch.equal(lats["block_cache"].cpu(), lat)
    print(f"  {label}: the pairs' block-cache latents equal the entry point's to the bit: {same}", flush=True)
    return dict(launches=launches, tc_launches=tc, vec_launches=vec, pairs=pairs,
                fidelity=check_fidelity(label, lat, lats["exact"].cpu(), against=label),
                fidelity_vs_bf16=check_fidelity(label, lat, lat_bf16))


def block_cache_phase(tmp: str, ckpt: str, lat_bf16, exact_profile: dict, device, smi: str) -> dict:
    """Phase 5c: ``sample.main`` with the block cache (BC_PAIRS pairs, every
    BC_INTERVAL-th step full) at DDIM-50 from phase 5's checkpoint: its
    launches (BC_LAUNCHES of each per-block kernel, on the tensor-core and
    vector routes) and its latents against phase 5's exact ones; at full
    width the staging split and interval 1 equal to the bit; pairs against
    the exact sampler and a profile; then the same launches, fidelity and
    pairs in static W8A8 with int8 attention, flash and "qk"."""
    base = ["sample_method=ddim", f"num_sampling_steps={BC_STEPS}", f"ckpt={ckpt}"]
    bc = [f"block_cache_pairs={BC_PAIRS}", f"block_cache_interval={BC_INTERVAL}"]
    cfg = load_config(FFS_CONFIG, base + bc + [f"save_video_path={tmp}/ffs_bc.mp4"])
    reset_counts()
    lat = torch.from_numpy(np.load(sample.main(cfg))["latents"])  # on cuda by default
    launches = counts()
    tc = check_tc("bf16 block-cache ddim-50 entry point", BC_LAUNCHES)
    vec = check_vec("bf16 block-cache ddim-50 entry point")
    ratio = BC_LAUNCHES / (DEPTH * BC_STEPS)
    print(f"  block-cache ddim-50 launches {launches}: {ratio:.4f} of the exact run's "
          f"{DEPTH * BC_STEPS}", flush=True)
    if launches != {k: BC_LAUNCHES if k in FORWARD else 0 for k in KERNELS}:
        raise AssertionError(f"expected {BC_LAUNCHES} launches of each forward kernel, got {launches}")
    fidelity = check_fidelity("bf16 block-cache", lat, lat_bf16)

    # exactness at full width: the staging split, and interval 1 against
    # phase 5's exact DDIM-50 from the same z
    model = sample.build_model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.randn((1, FRAMES, 4, 32, 32), generator=gen, device=device)
    t = torch.tensor([500], device=device)
    z = torch.randn(sample.latent_shape(cfg, 1), device=device,
                    generator=torch.Generator(device=device).manual_seed(int(cfg.seed)))
    with torch.inference_mode():
        out = model(x, t)
        out_full, front = model(x, t, return_front=BC_PAIRS)
        out_part = model(x, t, front_state=front, start_pair=BC_PAIRS)
        lat1 = cached_sample_loop(create_diffusion(str(BC_STEPS)), model, z, cache_pairs=BC_PAIRS,
                                  cache_interval=1).cpu()
    exact = dict(return_front_equals_forward=torch.equal(out_full, out),
                 partial_equals_full=torch.equal(out_part, out_full),
                 interval_1_equals_exact=torch.equal(lat1, lat_bf16))
    print(f"  to the bit at full width (front after pair {BC_PAIRS}, {tuple(front.shape)} "
          f"{front.dtype}): {json.dumps(exact)}", flush=True)
    if not all(exact.values()):
        raise AssertionError(f"the block cache's exactness checks failed: {exact}")

    cfg_exact = load_config(FFS_CONFIG, base)
    pairs, _ = cache_runs(model, cfg, cfg_exact, device, flash_attention, "bf16 ddim-50")
    prof = profile_sampler(model, cfg, device, pairs["median_s"]["block_cache"],
                           "block-cache ddim-50 sampler")
    busy_ratio = prof["busy_ms"] / exact_profile["busy_ms"] if exact_profile["busy_ms"] else None
    print(f"  block-cache device busy {prof['busy_ms']:.4f} ms against the exact run's "
          f"{exact_profile['busy_ms']:.4f} (ratio {busy_ratio}); idle {prof['idle']} against "
          f"{exact_profile['idle']}; on {smi}", flush=True)
    del model
    torch.cuda.empty_cache()

    int8 = {}
    for label, over in (("int8_flash", ["quantized=static", "int8_attention=true", "attention_mode=flash"]),
                        ("int8_qk", ["quantized=static", "int8_attention=qk", "attention_mode=auto"])):
        int8[label] = block_cache_int8(tmp, base, over, label, lat_bf16, device)
        torch.cuda.empty_cache()
    return dict(pairs_cached=BC_PAIRS, interval=BC_INTERVAL, steps=BC_STEPS, launch_ratio=ratio,
                launches=launches, tc_launches=tc, vec_launches=vec, fidelity=fidelity, exact=exact,
                bf16_pairs=pairs, profile=prof, exact_profile=exact_profile,
                device_busy_ratio=busy_ratio, int8=int8, device=smi)


def sample_many_phase(tmp: str, ckpt: str, ddim_s: float, device, smi: str) -> dict:
    """Phase 5d: ``sample_many.main`` at DDIM-50, batch MANY_BATCH, with the
    full random VAE: MANY_SAMPLES videos asked for, rounded up to a whole
    batch, as mp4s 0000.. read back at 16x256x256x3 and bundled by
    ``create_npz_from_sample_folder``; every launch on the tensor-core and
    vector routes; s per video at batch 2 (the generator's own runs, to
    latents) beside phase 5's batch 1."""
    base = ["sample_method=ddim", f"num_sampling_steps={BC_STEPS}", f"ckpt={ckpt}",
            f"per_proc_batch_size={MANY_BATCH}"]
    gen = sample_many.BatchGenerator(load_config(FFS_CONFIG, base))
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = gen.sample_latents()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    if lat.shape != (MANY_BATCH, FRAMES, 4, 32, 32) or not torch.isfinite(lat).all():
        raise AssertionError(f"sample_many latents {tuple(lat.shape)} are not finite")
    del gen, lat
    torch.cuda.empty_cache()
    s_video = sorted(secs)[1] / MANY_BATCH

    out_dir = os.path.join(tmp, "fvd_samples")
    cfg = load_config(FFS_CONFIG, base + [f"num_fvd_samples={MANY_SAMPLES}", "vae_ckpt=random",
                                          f"save_video_path={out_dir}"])
    total = -(-MANY_SAMPLES // MANY_BATCH) * MANY_BATCH
    calls = total * BC_STEPS * DEPTH // MANY_BATCH
    reset_counts()
    t0 = time.perf_counter()
    sample_many.main(cfg)  # on cuda by default
    main_s = time.perf_counter() - t0
    launches = counts()
    tc = check_tc(f"sample_many, {total} videos at batch {MANY_BATCH}", calls)
    vec = check_vec(f"sample_many, {total} videos at batch {MANY_BATCH}")
    if launches != {k: calls if k in FORWARD else 0 for k in KERNELS}:
        raise AssertionError(f"sample_many: expected {calls} launches of each forward kernel, got {launches}")
    files = sorted(os.listdir(out_dir))
    shapes = {f: read_mp4(os.path.join(out_dir, f)).shape for f in files}
    size = int(cfg.image_size)
    bundle = np.load(sample_many.create_npz_from_sample_folder(out_dir))["arr_0"]
    print(f"  sample_many wrote {shapes} in {main_s:.3f} s; bundle {bundle.shape} {bundle.dtype}; "
          f"launches {launches}", flush=True)
    if files != [f"{i:04d}.mp4" for i in range(total)] or \
            any(v != (FRAMES, size, size, 3) for v in shapes.values()):
        raise AssertionError(f"expected {total} mp4s of ({FRAMES}, {size}, {size}, 3), got {shapes}")
    if bundle.shape != (total, FRAMES, size, size, 3) or bundle.dtype != np.uint8:
        raise AssertionError(f"the sample folder's npz is {bundle.shape} {bundle.dtype}")
    print(f"  ddim-50 at batch {MANY_BATCH}: {s_video:.4f} s a video to latents (median of {secs}, "
          f"halved) against {ddim_s:.4f} s at batch 1 (phase sampler); sample_many.main "
          f"{main_s / total:.4f} s a video with the model's build, decode and mp4; on {smi}", flush=True)
    return dict(videos=total, batch=MANY_BATCH, files=files, bundle_shape=list(bundle.shape),
                launches=launches, tc_launches=tc, vec_launches=vec, batch_secs=secs,
                s_per_video_batch2=s_video, s_per_video_batch1=ddim_s, main_s=main_s, device=smi)


# phase "eval": the detectors on the card, the metric chain from files and
# from the sampler
EVAL_REL = 1e-4  # a detector on the card (fp32, TF32 off) against the same module on the CPU: relative L2
EVAL_REAL_CLIPS, EVAL_REAL_FRAMES = 8, 64  # the real frame folders, written from a seed at 256^2
EVAL_BATCH = 16  # clips of a timed I3D or C3D call; a timed Inception call takes the sampled videos' 64 frames
FVD_CLIPS = 2048  # clips a side of the fvd2048_16f protocol
EVAL_CLI_S = 240  # the calc_metrics process's time limit


def randomize_detector_(model, seed: int) -> None:
    """Seeded random detector weights on the model's device: conv and
    linear weights N(0, 2/fan_in) (the variance kept through the ReLUs),
    BatchNorm scales in [0.8, 1.2], biases in [-0.1, 0.1] and the
    statistics near 0 and 1 (means in [-0.2, 0.2], variances in [0.5,
    1.5]), so the activations stay finite through the depth."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():  # tensors that share the weights' storage
            leaf = name.rsplit(".", 1)[1]
            if leaf == "running_var":
                t.uniform_(0.5, 1.5, generator=gen)
            elif leaf == "running_mean":
                t.uniform_(-0.2, 0.2, generator=gen)
            elif leaf == "bias":
                t.uniform_(-0.1, 0.1, generator=gen)
            elif t.dim() == 1:
                t.uniform_(0.8, 1.2, generator=gen)
            else:
                t.normal_(0.0, (2.0 / t[0].numel()) ** 0.5, generator=gen)


def eval_models(device) -> dict:
    """I3D, Inception and C3D on ``device`` from seeded random weights; C3D's
    first conv scaled by 1/128, as its input is pixels less the mean, not
    [-1, 1] (its softmax would saturate)."""
    from latte_tpu_torch.eval import c3d, i3d, inception

    with torch.device(device):
        models = dict(i3d=i3d.InceptionI3d(), inception=inception.FIDInceptionV3(), c3d=c3d.C3D())
    for seed, model in enumerate(models.values()):
        randomize_detector_(model, 40 + seed)
    with torch.no_grad():
        models["c3d"].conv1a.weight.div_(128.0)
    return models


def eval_detector(name: str, model, device):
    from latte_tpu_torch.eval import c3d, i3d, inception

    if name == "i3d":
        return i3d.i3d_detector(model, device)
    if name == "c3d":
        return c3d.c3d_detector(model, None, device)
    return inception.inception_detector(model, device)


class DetectorFile(torch.nn.Module):
    """A stand-in for the reference's torchscript detector file (not in the
    repository): the port's module under ``net.``, a prefix the converters
    strip. The loader reads only the file's weights, so the traced graph
    passes its input through."""

    def __init__(self, model):
        super().__init__()
        self.net = model

    def forward(self, x):
        return x


def save_torchscript_detector(name: str, model, folder: str) -> None:
    """The I3D or Inception stand-in file under its reference name."""
    from latte_tpu_torch.eval.detectors import DETECTOR_FILES

    os.makedirs(folder, exist_ok=True)
    traced = torch.jit.trace(DetectorFile(model), torch.zeros(1, device=next(model.parameters()).device))
    torch.jit.save(traced, os.path.join(folder, DETECTOR_FILES[name]))


def write_real_frames(folder: str) -> None:
    """EVAL_REAL_CLIPS frame folders of EVAL_REAL_FRAMES jpgs at 256^2 from
    a numpy seed: noise at 1/16 of the size, blown up (as
    ``write_pixel_videos``)."""
    import cv2

    rng = np.random.default_rng(12)
    for c in range(EVAL_REAL_CLIPS):
        small = rng.integers(0, 256, size=(EVAL_REAL_FRAMES, 16, 16, 3), dtype=np.uint8)
        os.makedirs(os.path.join(folder, f"{c:03d}"))
        for i, frame in enumerate(small.repeat(16, axis=1).repeat(16, axis=2)):
            cv2.imwrite(os.path.join(folder, f"{c:03d}", f"{i:06d}.jpg"), frame)


EVAL_CASES = dict(i3d=[("features", 2)], inception=[("pool3", 8), ("probs_no_bias", 8)], c3d=[("probs", 2)])


def eval_check_outputs(dets: dict, videos: np.ndarray) -> dict:
    """(a)'s checked outputs of each detector on the sampler's 256^2 frames
    (EVAL_CASES): I3D's features of 2 clips of 16 frames, Inception's pool3
    and the IS call's probabilities of 8 frames, C3D's probabilities of 2
    clips."""
    from latte_tpu_torch.eval import detectors

    fns = dict(features=detectors.i3d_features, pool3=detectors.inception_features,
               probs_no_bias=detectors.inception_probs, probs=detectors.c3d_probs)
    return {(name, label): fns[label](dets[name], videos[:n] if name != "inception" else videos[0, :n])
            for name, cases in EVAL_CASES.items() for label, n in cases}


def eval_time_detectors(dets: dict, videos: np.ndarray, smi: str) -> dict:
    """(a) A batch of EVAL_BATCH clips (Inception: the 64 frames of the
    videos) through each detector on the card, timed host to host (median
    of 3 after a warm-up), its device time and idle share (profiler), the
    convolutions' and the input's pageable copy's share of it (a profile
    records that copy in some calls and not in others), and its bound from
    the FLOPs of its convolutions and products (``FlopCounterMode``) at the
    fp32 rate."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from latte_tpu_torch.eval import detectors

    timed = dict(i3d=detectors.i3d_features, inception=detectors.inception_features, c3d=detectors.c3d_probs)
    clips = np.concatenate([videos] * (EVAL_BATCH // len(videos)))
    out = {}
    for name, det in dets.items():
        batch = videos.reshape(-1, *videos.shape[2:]) if name == "inception" else clips
        timed[name](det, batch)  # warm-up: cuDNN's first choices
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed[name](det, batch)
            secs.append(time.perf_counter() - t0)
        call_ms = sorted(secs)[1] * 1e3
        counter = FlopCounterMode(display=False)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, counter:
            timed[name](det, batch)
        groups, busy, top = device_ms_by_kind(prof)
        copy = sum(ms for kernel, ms in top.items() if kernel.startswith("Memcpy"))
        conv = groups.get("matmul", 0.0)
        flops = counter.get_total_flops()
        bound = flops / FP32_FLOP_PER_S * 1e3
        out[name] = dict(items=len(batch), call_ms=call_ms, call_secs=secs, device_busy_ms=busy, copy_ms=copy,
                         conv_ms=conv, idle=1 - busy / call_ms if busy else None, gflop=flops / 1e9, bound_ms=bound)
        print(f"  {name}: {len(batch)} {'frames' if name == 'inception' else 'clips'} a call {call_ms:.2f} ms host "
              f"to host (median of {[round(s * 1e3, 2) for s in secs]}), device busy {busy:.2f} ms (the input's "
              f"copy {copy:.2f} of it as traced, the convolutions {conv:.2f}; idle {1 - busy / call_ms:.3f}), bound "
              f"{bound:.2f} ms ({flops / 1e9:.1f} GFLOP at the fp32 rate) on {smi}", flush=True)
    return out


def eval_phase(tmp: str, ckpt: str, device, smi: str) -> dict:
    """Phase 5f: evaluation (``latte_tpu_torch.eval``) with the port's
    detectors on the card, from seeded random weights.

    - Files: EVAL_REAL_CLIPS real clips written as frame folders, phase 5d's
      mp4s converted by ``tools.convert_videos_to_frames``, torchscript
      stand-ins of I3D and Inception (``save_torchscript_detector``).
    - fid50k_full through the ``calc_metrics`` CLI on the card, in a process
      of its own that runs beside the rest of the phase (its fp64
      ``scipy.linalg.sqrtm`` of a 2048^2 matrix holds the host's interpreter
      for ~25 s), its Inception loaded from the torchscript file by
      ``load_detector``.
    - (a) The detectors' outputs on the card (``eval_check_outputs``)
      against the same modules' on the CPU, computed in a thread beside the
      chain, within EVAL_REL; each detector timed (``eval_time_detectors``).
    - (b) fvd2048_16f, kid50k_full, is50k and isv2048_ucf through
      ``calc_metric`` with the port's detectors, budgets cut to the clip
      counts, every result finite; the FVD again from ``cache_dir``, equal
      to the bit; the real folder's cached FVD stats against a fresh run's
      0 within 1e-3 of FVD(real, fake); the FVD through ``load_detector``
      from the I3D torchscript file within EVAL_REL of the injected
      detector's.
    - (c) fvd2048_16f with ``fake_gen`` a ``sample_many.BatchGenerator``
      (ffs_sample.yaml, DDIM-50, batch 2, the full random VAE): 1400
      launches of B1, B2 and B3 on the tensor-core and vector routes, none
      of another kernel.
    - (d) The file route's host time to decode a clip against the
      detector's, and the 2 x 2048-clip fvd2048_16f projected from them."""
    from concurrent.futures import ThreadPoolExecutor

    from latte_tpu_torch.eval import detectors, metrics
    from latte_tpu_torch.eval.dataset import MetricVideoDataset
    from latte_tpu_torch.eval.feature_stats import FeatureStats
    from latte_tpu_torch.eval.scores import frechet_distance
    from latte_tpu_torch.tools import convert_videos_to_frames
    from latte_tpu_torch.utils import read_video

    parts, t_part = {}, time.perf_counter()

    def part(name: str) -> None:
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    many = os.path.join(tmp, "fvd_samples")
    videos = np.stack([read_video(v) for v in convert_videos_to_frames.find_videos(many)])
    models = eval_models(device)
    root = os.path.join(tmp, "eval")
    real, fake, cache, ts_dir, report = (os.path.join(root, d) for d in ("real", "fake", "cache", "detectors",
                                                                          "report"))
    write_real_frames(real)
    # each video through the converter's per-video step (its pool would spawn
    # processes that import this script again)
    frames = [convert_videos_to_frames.convert_one(v, many, fake) for v in convert_videos_to_frames.find_videos(many)]
    if frames != [FRAMES] * len(videos):
        raise AssertionError(f"convert_videos_to_frames wrote {frames} frames, expected {FRAMES} a video")
    save_torchscript_detector("inception", models["inception"], ts_dir)
    total, sampled = EVAL_REAL_CLIPS * EVAL_REAL_FRAMES, len(videos) * FRAMES
    cli = subprocess.Popen(
        [sys.executable, "-m", "latte_tpu_torch.eval.calc_metrics", "--real_data_path", real, "--fake_data_path",
         fake, "--metrics", "fid50k_full", "--report_dir", report, "--max_real", str(total), "--max_fake",
         str(sampled)],
        cwd=ROOT, env=dict(os.environ, LATTE_TPU_DETECTORS=ts_dir),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        save_torchscript_detector("i3d", models["i3d"], ts_dir)
        part("files")
        dets = {name: eval_detector(name, model, device) for name, model in models.items()}
        on_card = eval_check_outputs(dets, videos)
        timing = eval_time_detectors(dets, videos, smi)
        part("detectors")
        # (a)'s CPU side in a thread beside the chain (torch's CPU kernels
        # release the interpreter)
        cpu_models = {name: copy.deepcopy(model).cpu() for name, model in models.items()}
        on_cpu = pool.submit(lambda: eval_check_outputs(
            {name: eval_detector(name, model, "cpu") for name, model in cpu_models.items()}, videos))

        # (b) the chain from files, in this process
        common = dict(real_path=real, fake_path=fake, seed=0, report_dir=report)
        results, protocol_s = {}, {}
        for name, det, kw in (
            ("fvd2048_16f", dets["i3d"], dict(max_real=EVAL_REAL_CLIPS, max_fake=len(videos), cache_dir=cache)),
            ("kid50k_full", dets["inception"], dict(max_real=total, max_fake=sampled)),
            ("is50k", dets["inception"], dict(max_fake=sampled)),
            # the protocol's 10 splits need 10 clips: every clip of the phase, real and fake
            ("isv2048_ucf", dets["c3d"], dict(fake_path=root, max_fake=EVAL_REAL_CLIPS + len(videos))),
        ):
            t1 = time.perf_counter()
            results.update(metrics.calc_metric(name, detector=det, **dict(common, **kw))["results"])
            protocol_s[name] = time.perf_counter() - t1
        fvd = results["fvd2048_16f"]
        again = metrics.calc_metric("fvd2048_16f", detector=dets["i3d"], max_real=EVAL_REAL_CLIPS,
                                    max_fake=len(videos), cache_dir=cache, **common)["results"]["fvd2048_16f"]
        (cached,) = os.listdir(cache)
        fresh = metrics._video_stats(real, dets["i3d"], detectors.i3d_features, FRAMES, EVAL_REAL_CLIPS,
                                     subsample_factor=3)
        self_fvd = frechet_distance(*FeatureStats.load(os.path.join(cache, cached)).get_mean_cov(),
                                    *fresh.get_mean_cov())
        print(f"  fvd {fvd!r}, from the cache {again!r}; the real stats, cached against fresh, {self_fvd!r}",
              flush=True)
        if again != fvd or os.listdir(cache) != [cached]:
            raise AssertionError(f"the cached FVD {again!r} is not the first run's {fvd!r}")
        if not abs(self_fvd) <= 1e-3 * fvd:
            raise AssertionError(f"FVD of the real stats against themselves {self_fvd!r}, FVD(real, fake) {fvd!r}")
        i3d_file = detectors.load_detector("i3d", path=os.path.join(ts_dir, detectors.DETECTOR_FILES["i3d"]),
                                           device=device)
        loaded = metrics.calc_metric("fvd2048_16f", detector=i3d_file, max_real=EVAL_REAL_CLIPS,
                                     max_fake=len(videos), **common)["results"]["fvd2048_16f"]
        print(f"  fvd through load_detector from a torchscript file: {loaded!r} against {fvd!r}", flush=True)
        if not abs(loaded - fvd) <= EVAL_REL * fvd:
            raise AssertionError(f"FVD through load_detector {loaded!r}, with the injected detector {fvd!r}")
        part("chain")

        # (c) the chain from the sampler, no file
        cfg = load_config(FFS_CONFIG, ["sample_method=ddim", f"num_sampling_steps={BC_STEPS}", f"ckpt={ckpt}",
                                       f"per_proc_batch_size={MANY_BATCH}", "vae_ckpt=random"])
        gen = sample_many.BatchGenerator(cfg)
        reset_counts()
        t0 = time.perf_counter()
        gen_fvd = metrics.calc_metric("fvd2048_16f", real_path=real, fake_gen=gen, detector=dets["i3d"],
                                      max_real=EVAL_REAL_CLIPS, max_fake=MANY_BATCH, cache_dir=cache,
                                      seed=0)["results"]["fvd2048_16f"]
        gen_s = time.perf_counter() - t0
        launches = counts()
        calls = BC_STEPS * DEPTH
        tc = check_tc(f"fvd from the sampler, {MANY_BATCH} videos at DDIM-{BC_STEPS}", calls)
        vec = check_vec(f"fvd from the sampler, {MANY_BATCH} videos at DDIM-{BC_STEPS}")
        if launches != {k: calls if k in FORWARD else 0 for k in KERNELS} or not np.isfinite(gen_fvd) or gen.it != 1:
            raise AssertionError(f"fvd from the sampler: {gen_fvd!r} after {gen.it} batches, launches {launches}")
        launches.update({f"{n}_f32": KERNELS[n]["fn"].f32_launches for n in ("flash_attention", *BACKWARD)})
        launches[f"{INT8}_qk"] = launches[INT8]
        del gen
        part("generator")
        print(f"  fvd from BatchGenerator ({MANY_BATCH} videos, DDIM-{BC_STEPS}, the real side from the cache): "
              f"{gen_fvd!r} in {gen_s:.2f} s; launches {launches}", flush=True)

        # (a) the card against the CPU
        on_cpu = on_cpu.result()
        errs = {}
        for (name, label), got in on_card.items():
            want = on_cpu[(name, label)]
            errs.setdefault(name, {})[label] = err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            if got.shape != want.shape or not np.isfinite(got).all() or err > EVAL_REL:
                raise AssertionError(f"{name} {label} on the card: {got.shape}, relative L2 {err:.3g} against "
                                     f"the CPU (limit {EVAL_REL})")
        print(f"  the detectors on the card against the CPU, relative L2: {errs}", flush=True)
        part("cpu_check")

        # (d) the file route's host wait for clips against the detector's time
        decode = {}
        for label, path, sub in (("real_frames", real, 3), ("fake_frames", fake, 1), ("fake_mp4", many, 1)):
            ds = MetricVideoDataset(path, num_frames=FRAMES, subsample_factor=sub, seed=0)
            t0 = time.perf_counter()
            for i in range(len(ds)):
                ds[i]
            decode[label] = (time.perf_counter() - t0) / len(ds)
        part("decode")
        out, err = cli.communicate(timeout=EVAL_CLI_S)
    finally:
        pool.shutdown(wait=True)
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
    part("cli_wait")
    if cli.returncode != 0:
        raise AssertionError(f"calc_metrics exited {cli.returncode}: {err[-3000:]}")
    records = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    for rec in records:
        results.update(rec["results"])
        protocol_s[rec["metric"]] = rec["total_time"]
    print(f"  from files ({EVAL_REAL_CLIPS} real clips of {EVAL_REAL_FRAMES} frames, {len(videos)} sampled): "
          f"{results} ({protocol_s} s; fid by the calc_metrics CLI on the card in a process of its own)", flush=True)
    if [r["metric"] for r in records] != ["fid50k_full"] or not all(np.isfinite(v) for v in results.values()):
        raise AssertionError(f"a metric is missing or not finite: {results}")
    per_clip = 1e3 * timing["i3d"]["items"]
    i3d_call_s, i3d_busy_s = timing["i3d"]["call_ms"] / per_clip, timing["i3d"]["device_busy_ms"] / per_clip
    protocol = FVD_CLIPS * (decode["real_frames"] + decode["fake_mp4"] + 2 * i3d_call_s)
    idle = 1 - 2 * FVD_CLIPS * i3d_busy_s / protocol
    print(f"  fvd2048_16f file route: decode s a clip {decode}; I3D {i3d_call_s * 1e3:.3f} ms a clip host to host, "
          f"{i3d_busy_s * 1e3:.3f} device; 2 x {FVD_CLIPS} clips (real frames, sampled mp4s) projected "
          f"{protocol / 60:.3f} min on one card, the device idle {idle:.3f} of it; eval parts (s) {parts}; "
          f"on {smi}", flush=True)
    del models, dets, cpu_models
    return dict(detectors=dict(rel_l2=errs, timing=timing), parts_s=parts, protocol_s=protocol_s, results=results,
                fvd_cached=again, fvd_self=self_fvd, fvd_from_file=loaded,
                generator=dict(fvd=gen_fvd, s=gen_s, tc_launches=tc, vec_launches=vec),
                launches=launches, decode_s_per_clip=decode, i3d_ms_per_clip=i3d_call_s * 1e3,
                i3d_device_ms_per_clip=i3d_busy_s * 1e3, fvd_protocol_min=protocol / 60, fvd_protocol_idle=idle,
                device=smi)


def t2v_launches(pairs: int, forwards: int = 1, temporal: bool = True) -> dict:
    """Launches of each kernel in ``forwards`` LatteT2V forwards over
    ``pairs`` pairs: B1 in every block's self-attention, B2 in every block's
    norm1 and in norm_out, B3 in every block's norm3; no other kernel."""
    blocks = pairs * (2 if temporal else 1)
    per = {"flash_attention": blocks, "ln_modulate": blocks + 1, "residual_ln_modulate": blocks}
    return {k: forwards * per.get(k, 0) for k in KERNELS}


def expect_launches(label: str, want: dict) -> dict:
    """The launches since the last reset_counts() are ``want``, B1's all on
    the tensor cores and B2's and B3's all on the vector route."""
    got = counts()
    print(f"  {label}: launches {got} (expected {want})", flush=True)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    check_tc(label, want["flash_attention"])
    check_vec(label)
    return got


def profile_t2v_step(step, wall_ms: float, label: str = "t2v ddim step") -> dict:
    """Device time of one DDIM step by kind of kernel and the idle share
    against ``wall_ms``, the step's unprofiled time. Beside them the device
    time of three ranges, from CUDA events around each call on the step's
    one stream in a run without the profiler (the host keeps ahead of the
    device there, so a range's span is its kernels' time; under the
    profiler's host cost it is not): "cross_attention" (``models.t2v.cross_attention``, plain
    torch: by kernel its products are matmuls and the rest glue) and, in a
    quantized model, "int8_layers" (``QLinear``'s forward: quantize, the
    product, dequantize, bias) and "matmul_int8" (``torch._int_mm`` in
    them)."""
    from torch.profiler import ProfilerActivity, profile

    from latte_tpu_torch.models import t2v as t2v_model
    from latte_tpu_torch.models.layers import QLinear

    spans = {"cross_attention": [], "int8_layers": [], "matmul_int8": []}

    def timed(kind, fn):
        def call(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            spans[kind].append((start, end))
            return out
        return call

    cross, linear, int_mm = t2v_model.cross_attention, QLinear.forward, torch._int_mm
    timed_linear = timed("int8_layers", linear)

    def annotated_linear(self, inp):
        if self.quantized not in (True, "static"):
            return linear(self, inp)
        return timed_linear(self, inp)

    t2v_model.cross_attention, QLinear.forward = timed("cross_attention", cross), annotated_linear
    torch._int_mm = timed("matmul_int8", int_mm)
    try:
        step()
        torch.cuda.synchronize()
    finally:
        t2v_model.cross_attention, QLinear.forward, torch._int_mm = cross, linear, int_mm
    ranges = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items() if v}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    groups, busy, top = device_ms_by_kind(prof)
    if not busy:
        print(f"  {label} profile: the profiler saw no device time (not measured)", flush=True)
        return dict(by_kind=None, busy_ms=None, wall_ms=wall_ms, idle=None, ranges_ms=ranges)
    groups["adaln"] = groups.pop("ln_modulate", 0.0) + groups.pop("residual_ln_modulate", 0.0)
    groups["glue"] = groups.pop("other", 0.0)
    print(f"  {label} profile ms by kind: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(groups.items())}) + f"; device busy {busy:.4f} of "
          f"{wall_ms:.4f} ms wall (device idle {1 - busy / wall_ms:.4f}); ranges by CUDA events "
          f"(ms): " + json.dumps({k: round(v, 4) for k, v in ranges.items()}), flush=True)
    print(f"  {label} largest other kernels (ms): " + json.dumps({k: round(v, 4) for k, v in top.items()}),
          flush=True)
    return dict(by_kind=groups, busy_ms=busy, wall_ms=wall_ms, idle=1 - busy / wall_ms, ranges_ms=ranges,
                top_other=top)


def time_t2v_step(step) -> float:
    """The median wall ms of ``step`` over three runs after a warm-up."""
    import statistics

    step_s = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return statistics.median(step_s[1:]) * 1e3


def t2v_adaln_checks(model, args) -> dict:
    """B2 and B3 on the operands one LatteT2V forward hands them: pair 0's
    spatial block (norm1; norm3, whose gate is the seventh, unit row of its
    (B, 7, D) vectors), pair 0's temporal block (norm1; norm3) and norm_out.
    Each is on the vector route and equal to its plain version to the bit:
    y equal, out equal on all but TILED_SHARE_APART of its elements."""
    from latte_tpu_torch.models import t2v as t2v_model

    plains = {"ln_modulate": ln_modulate_reference,
              "residual_ln_modulate": residual_ln_modulate_reference}
    real = {name: getattr(t2v_model, name) for name in plains}
    calls = {name: [] for name in plains}

    def recorder(name):
        def call(*a):
            kept = calls[name]
            if len(kept) < 2:
                kept.append(a)
            elif name == "ln_modulate":
                kept[2:] = [a]  # the last: norm_out
            return real[name](*a)
        return call

    for name in plains:
        setattr(t2v_model, name, recorder(name))
    try:
        with torch.inference_mode():
            model(*args)
    finally:
        for name, fn in real.items():
            setattr(t2v_model, name, fn)
    picked = {
        "spatial norm1": ("ln_modulate", calls["ln_modulate"][0]),
        "temporal norm1": ("ln_modulate", calls["ln_modulate"][1]),
        "norm_out": ("ln_modulate", calls["ln_modulate"][2]),
        "spatial norm3, unit gate": ("residual_ln_modulate", calls["residual_ln_modulate"][0]),
        "temporal norm3": ("residual_ln_modulate", calls["residual_ln_modulate"][1]),
    }
    out = {}
    for label, (name, a) in picked.items():
        res = name == "residual_ln_modulate"
        route = adaln_route(a[0], a[1:2] if res else (), a[2:] if res else a[1:])
        with torch.inference_mode():
            got, plain = real[name](*a), plains[name](*a)
        r = dict(x=list(a[0].shape), vec_stride=a[-1].stride(0), route=route)
        if res:
            r["y_share_apart"] = bits_apart(got[0], plain[0])[0]
            got, plain = got[1], plain[1]
        r["out_share_apart"], r["max_abs_err"] = bits_apart(got, plain)[:2]
        print(f"  t2v {name} at {label}: x {r['x']}, vector row stride {r['vec_stride']}, route "
              f"{route}; y {r.get('y_share_apart')}, out {r['out_share_apart']} of the elements "
              f"apart from the plain version (limits: 0, {TILED_SHARE_APART}), largest "
              f"{r['max_abs_err']:.4g}", flush=True)
        if (route != "vector" or r.get("y_share_apart", 0) > 0
                or r["out_share_apart"] > TILED_SHARE_APART):
            raise AssertionError(f"t2v {name} at {label} departs from its plain version: {r}")
        out[label] = r
    return out


def t2v_phase(tmp: str, smi: str, device, timer) -> dict:
    """Phase "t2v": text-to-video serving at full width through
    ``sample_t2x.main`` and ``LattePipeline`` (see the module docstring);
    returns the ``t2v: {...}`` line's dict."""
    import statistics

    import cv2

    from latte_tpu_torch.core.scheduler import get_scheduler
    from latte_tpu_torch.models.t2v import LatteT2V
    from latte_tpu_torch.sample import sample_t2x
    from latte_tpu_torch.sample.pipeline_t2v import LattePipeline

    # 1. the entry point on t2v_sample.yaml as shipped, decoded with the SD VAE
    cfg = load_config(T2V_CONFIG, ["vae_ckpt=random", f"save_video_path={tmp}/t2v"])
    prompts = list(cfg.text_prompt)
    kw = sample_t2x.transformer_kwargs(cfg)
    pairs, steps, frames = kw["num_layers"], int(cfg.num_sampling_steps), int(cfg.video_length)
    (H, W), bc_pairs = sample_t2x.image_hw(cfg), (pairs * 2) // 3
    run = dict(video_length=frames, height=H, width=W, num_inference_steps=steps,
               guidance_scale=float(cfg.guidance_scale))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    records = sample_t2x.main(cfg)  # on cuda by default
    main_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = expect_launches(f"t2v_sample.yaml, {len(prompts)} videos",
                               t2v_launches(pairs, len(prompts) * steps))
    shapes = [read_mp4(r["path"]).shape for r in records]
    print(f"  t2v mp4s {[os.path.basename(r['path']) for r in records]}: {shapes}", flush=True)
    if shapes != [(frames, H, W, 3)] * len(prompts):
        raise AssertionError(f"expected {len(prompts)} mp4s of {frames} frames of {H}x{W}x3, got {shapes}")
    lat_s = statistics.median(r["latents_s"] for r in records[1:])
    dec_s = statistics.median(r["decode_s"] for r in records[1:])
    print(f"  t2v DDIM-{steps} + CFG, {frames}x{H}x{W} bf16: {lat_s:.4f} s a video to latents, decode "
          f"{dec_s:.4f} s (median of prompts 2-3; prompt 1 {records[0]['latents_s']:.4f} + "
          f"{records[0]['decode_s']:.4f}) -> {60 / lat_s:.4f} videos/min, {60 / (lat_s + dec_s):.4f} "
          f"with decode; peak {peak / 2**30:.3f} GiB; main {main_s:.2f} s; on {smi}", flush=True)

    # 2. one CFG forward against the plain paths, the same seeded weights as main's
    model = sample_t2x.build_transformer(load_config(T2V_CONFIG, ["use_fp16=false"]), device)
    with torch.device(device):
        plain32 = LatteT2V(**kw, plain=True)
    plain32.load_state_dict(model.state_dict())
    plain32.eval()
    model.to(torch.bfloat16)
    with torch.device(device):
        plain16 = LatteT2V(**kw, plain=True)
    plain16.load_state_dict(model.state_dict())
    plain16.to(torch.bfloat16).eval()
    stub = sample_t2x.build_text_encoder(cfg)
    pipe = LattePipeline(model, get_scheduler("DDIM"), stub)
    ctx, mask = pipe.encode_prompt([prompts[0]])  # [uncond | cond]
    gen = torch.Generator(device=device).manual_seed(2)
    latent = (4, frames, H // 8, W // 8)
    x = torch.randn((2, *latent), generator=gen, device=device)
    t = torch.full((2,), 500.0, device=device)
    with torch.inference_mode():
        model(x, t, ctx, mask)
        torch.cuda.synchronize()
        reset_counts()
        out_k = model(x, t, ctx, mask)
        torch.cuda.synchronize()
        expect_launches("one t2v CFG forward", t2v_launches(pairs))
        out_p16, out_p32 = plain16(x, t, ctx, mask), plain32(x, t, ctx, mask)
        fwd_ms = timer.ms(lambda: model(x, t, ctx, mask), iters=5)
    adaln_checks = t2v_adaln_checks(model, (x, t, ctx, mask))
    del plain32
    torch.cuda.empty_cache()
    vs_plain = compare("t2v forward, kernels bf16 vs plain bf16", out_k, out_p16)
    vs32 = compare("t2v forward, kernels bf16 vs plain fp32", out_k, out_p32)
    plain_vs32 = compare("t2v forward, plain bf16 vs plain fp32", out_p16, out_p32)
    # the kernels may add no more error than bf16 itself brings
    if not (vs32["finite"] and vs32["cosine"] >= 0.999
            and vs32["rel_l2"] <= 1.25 * plain_vs32["rel_l2"] + 1e-3):
        raise AssertionError("the t2v kernel path disagrees with the plain fp32 path")
    del out_p16, out_p32
    t0 = time.perf_counter()
    ref = LattePipeline(plain16, get_scheduler("DDIM"), stub).sample_latents(prompts[0], **run)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del plain16
    torch.cuda.empty_cache()
    lat_vs_plain = compare(f"t2v DDIM-{steps} latents of prompt 1, entry point vs plain path",
                           records[0]["latents"], ref.float().cpu())
    if not lat_vs_plain["cosine"] >= 0.99:
        raise AssertionError("the t2v DDIM-50 latents disagree with the plain path's")

    # 3. one DDIM step profiled: the CFG forward and the scheduler's update
    sched = pipe.scheduler
    ts, state = sched.timesteps(steps), sched.init_state(steps)
    z = torch.randn((1, *latent), generator=gen, device=device)

    def one_step():
        with torch.inference_mode():
            return pipe._step(z, state, ctx, mask, 0, ts, run["guidance_scale"], True, None)

    step_ms = time_t2v_step(one_step)
    profile = profile_t2v_step(one_step, step_ms)

    # 4. t2i_sample.yaml as shipped: one 512^2 png
    reset_counts()
    (rec_i,) = sample_t2x.main(load_config(T2I_CONFIG, ["vae_ckpt=random", f"save_video_path={tmp}/t2i"]))
    t2i_launches = expect_launches("t2i_sample.yaml", t2v_launches(pairs, steps, temporal=False))
    png = cv2.imread(rec_i["path"])
    print(f"  t2i png {os.path.basename(rec_i['path'])}: {None if png is None else png.shape}; "
          f"{rec_i['latents_s']:.4f} s to latents, decode {rec_i['decode_s']:.4f} s", flush=True)
    if png is None or png.shape != (H, W, 3):
        raise AssertionError(f"t2i_sample.yaml did not write a {H}x{W} png")
    torch.cuda.empty_cache()

    # 5. the block cache, on the bf16 model of 2 (main's weights)
    bc = LattePipeline(model, get_scheduler("DDIM"), stub, block_cache_interval=T2V_BC_INTERVAL)
    full = -(-steps // T2V_BC_INTERVAL)
    want = t2v_launches(pairs, full)
    for k, n in t2v_launches(pairs - bc_pairs, steps - full).items():
        want[k] += n
    reset_counts()
    t0 = time.perf_counter()
    lat_bc = bc.sample_latents(prompts[0], **run)
    torch.cuda.synchronize()
    bc_s = time.perf_counter() - t0
    bc_launches = expect_launches(f"t2v block cache, {bc_pairs} of {pairs} pairs, interval "
                                  f"{T2V_BC_INTERVAL}", want)
    bc_vs_exact = compare(f"t2v block-cache latents vs the exact DDIM-{steps}", lat_bc.float().cpu(),
                          records[0]["latents"])
    one = LattePipeline(model, get_scheduler("DDIM"), stub, block_cache_interval=1).sample_latents(
        prompts[0], **run)
    interval1_exact = torch.equal(one.float().cpu(), records[0]["latents"])
    print(f"  t2v block cache: {bc_s:.4f} s a video to latents against the exact {lat_s:.4f}; "
          f"interval 1 equal to the exact loop to the bit: {interval1_exact}", flush=True)
    if not interval1_exact:
        raise AssertionError("the t2v block cache at interval 1 differs from the exact loop")
    del lat_bc, one
    torch.cuda.empty_cache()

    # 6. quantized: true, from the same seeded fp32 weights
    qmodel = sample_t2x.build_transformer(load_config(T2V_CONFIG, ["quantized=true"]), device)
    with torch.inference_mode():
        out_q = qmodel(x, t, ctx, mask)
    int8_vs_bf16 = compare("t2v int8 forward vs the bf16 kernel forward", out_q, out_k)
    if not (int8_vs_bf16["finite"] and int8_vs_bf16["cosine"] >= 0.99):
        raise AssertionError("the t2v int8 forward disagrees with the bf16 forward")
    ddim10 = {}
    for name, m in (("bf16", model), ("int8", qmodel)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        LattePipeline(m, get_scheduler("DDIM"), stub).sample_latents(
            prompts[1], **{**run, "num_inference_steps": T2V_INT8_STEPS})
        torch.cuda.synchronize()
        ddim10[name] = time.perf_counter() - t0
    print(f"  t2v DDIM-{T2V_INT8_STEPS} s: {json.dumps(ddim10)}", flush=True)
    qpipe = LattePipeline(qmodel, get_scheduler("DDIM"), stub)

    def int8_step():
        with torch.inference_mode():
            return qpipe._step(z, state, ctx, mask, 0, ts, run["guidance_scale"], True, None)

    int8_step_ms = time_t2v_step(int8_step)
    int8_profile = profile_t2v_step(int8_step, int8_step_ms, "t2v int8 ddim step")
    del qmodel, qpipe, out_q, out_k, model, pipe, bc
    torch.cuda.empty_cache()

    # 7. B1 at the T2V CFG shapes, with its bound and SDPA beside it
    gen = torch.Generator(device=device).manual_seed(17)
    b1 = {name: measure_flash(f"t2v {name}", flash_case(rows, n, device, gen), timer)
          for name, (rows, n) in T2V_B1_SHAPES.items()}
    return dict(
        device=smi, videos=len(records), files=[os.path.basename(r["path"]) for r in records],
        mp4_shapes=[list(sh) for sh in shapes], s_per_video_latents=lat_s, s_decode=dec_s,
        videos_per_min=60 / lat_s, videos_per_min_with_decode=60 / (lat_s + dec_s),
        prompt_seconds=[(r["latents_s"], r["decode_s"]) for r in records], main_s=main_s,
        peak_gib=peak / 2**30, launches=launches, forward_ms=fwd_ms,
        forward=dict(vs_plain_bf16=vs_plain, vs_plain_fp32=vs32, plain_bf16_vs_fp32=plain_vs32),
        latents_vs_plain=lat_vs_plain, plain_ddim50_s=plain_s, step_ms=step_ms, step_profile=profile,
        t2i=dict(path=os.path.basename(rec_i["path"]), launches=t2i_launches,
                 latents_s=rec_i["latents_s"], decode_s=rec_i["decode_s"]),
        block_cache=dict(pairs=bc_pairs, interval=T2V_BC_INTERVAL, launches=bc_launches, s=bc_s,
                         vs_exact=bc_vs_exact, interval1_exact=interval1_exact),
        int8=dict(vs_bf16=int8_vs_bf16, ddim10_s=ddim10, step_ms=int8_step_ms,
                  step_profile=int8_profile),
        adaln=adaln_checks, b1=b1,
    )


def train_quant(tmp: str, smi: str) -> dict:
    """Phase 6d: two steps of ffs_train.yaml with quant_train: true at batch
    1: the block matmuls run W8A8 forwards with straight-through backwards,
    attention and the adaLN glue run kernels 1-5."""
    log = StepLog()
    reset_counts()
    with NoCheckpoints():
        out = train.main(load_config(FFS_TRAIN, [
            f"results_dir={tmp}/results", "max_train_steps=2", "log_every=1", "local_batch_size=1",
            "quant_train=true",
        ]), callbacks=[log])
    launches = counts()
    check_tc("quant_train fp32", 0, f32=2 * STEP_LAUNCHES["flash_attention"])
    check_vec("quant_train fp32")
    check_bwd_routes("quant_train fp32", tc=0, f32=2 * DEPTH)
    blk = log.state.model.blocks[0]
    modes = (blk.attn.qkv.quantized, blk.mlp.fc1.quantized, blk.adaLN_modulation[1].quantized)
    secs = log.step_seconds()
    log.state = None
    print(f"  quant_train batch 1: {out}; layer modes {modes}; launches {launches}; "
          f"step 2 {secs[-1]:.4f} s on {smi}", flush=True)
    if out["final_step"] != 2 or not log.finite() or modes != ("train", "train", False):
        raise AssertionError("the int8 training run failed")
    if launches != {k: 2 * c for k, c in STEP_LAUNCHES.items()}:
        raise AssertionError(f"expected 2 x {STEP_LAUNCHES} launches, got {launches}")
    shutil.rmtree(out["experiment_dir"])
    return dict(launches=launches, losses=[r[2] for r in log.records], s_step2=secs[-1])


class StepLog(Callback):
    """Records each logged step's host time and metrics (the loop syncs with
    the device at every log, so the gaps are step times), keeps the train
    state, and profiles the step after ``profile_after`` when given."""

    def __init__(self, profile_after: int = 0):
        self.records, self.state, self.profile_after, self.prof = [], None, profile_after, None

    def on_train_start(self, config, state, experiment_dir):
        self.state = state

    def on_log(self, step, metrics):
        self.records.append((step, time.perf_counter(), metrics["loss"], metrics["grad_norm"]))
        if self.profile_after and step == self.profile_after:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
        elif self.prof is not None and step == self.profile_after + 1:
            self.prof.stop()

    def step_seconds(self) -> list:
        return [b[1] - a[1] for a, b in zip(self.records, self.records[1:])]

    def finite(self) -> bool:
        return bool(self.records) and all(np.isfinite(r[2]) and np.isfinite(r[3]) for r in self.records)


def train_step_parity(device) -> dict:
    """Phase 6a: one full-width train step (fp32, batch 1, gradient
    checkpointing), kernel path against plain path from the same weights,
    batch, t and noise; then both in mixed precision."""
    arch = dict(input_size=32, num_frames=FRAMES, gradient_checkpointing=True)
    with torch.device(device):
        model = get_model("Latte-XL/2", **arch)
        plain = get_model("Latte-XL/2", plain=True, **arch)
    randomize_(model, seed=2)
    plain.load_state_dict(model.state_dict())
    gen = torch.Generator(device=device).manual_seed(3)
    x0 = torch.randn((1, FRAMES, 4, 32, 32), generator=gen, device=device)
    noise = torch.randn(x0.shape, generator=gen, device=device)
    t = torch.tensor([137], device=device)
    diffusion = create_diffusion("")

    def step(m, compute_dtype):
        m.compute_dtype = compute_dtype
        loss = diffusion.training_losses(m, x0, t, noise)["loss"].mean()
        loss.backward()
        g = torch.cat([p.grad.flatten() for p in m.parameters()])
        m.zero_grad(set_to_none=True)
        return loss.detach(), g

    reset_counts()
    loss_k, g_k = step(model, None)
    torch.cuda.synchronize()
    step_counts = counts()
    check_tc("fp32 train step", 0, f32=STEP_LAUNCHES["flash_attention"])
    check_vec("fp32 train step")
    check_bwd_routes("fp32 train step", tc=0, f32=DEPTH)
    loss_p, g_p = step(plain, None)
    print(f"  launches in one train step: {step_counts}", flush=True)
    if step_counts != STEP_LAUNCHES:
        raise AssertionError(f"expected {STEP_LAUNCHES} launches in one step, got {step_counts}")
    loss_rel = abs((loss_k - loss_p) / loss_p).item()
    fp32 = compare("fp32 step: kernel grads vs plain grads", g_k, g_p)
    norms = dict(kernel=g_k.norm().item(), plain=g_p.norm().item())
    print(f"  fp32 step: loss {loss_k.item()} vs {loss_p.item()} (rel err {loss_rel}); "
          f"grad norms {norms}", flush=True)
    # fp32 on both paths: the plain path's own error is 0, so the rule of the
    # forward phase leaves 1e-3
    if not (fp32["finite"] and fp32["cosine"] >= 0.999 and fp32["rel_l2"] <= 1e-3 and loss_rel <= 1e-4):
        raise AssertionError("the kernel path's train step disagrees with the plain path's")
    reset_counts()
    _, g_km = step(model, torch.bfloat16)
    check_tc("mixed-precision train step", STEP_LAUNCHES["flash_attention"])
    check_vec("mixed-precision train step")
    check_bwd_routes("mixed-precision train step", tc=DEPTH, f32=0)
    _, g_pm = step(plain, torch.bfloat16)
    vs32 = compare("mixed step: kernel grads vs plain fp32 grads", g_km, g_p)
    plain_vs32 = compare("mixed step: plain grads vs plain fp32 grads", g_pm, g_p)
    compare("mixed step: kernel grads vs plain grads", g_km, g_pm)
    # the kernels may add no more error than bf16 itself brings
    if not (vs32["finite"] and vs32["rel_l2"] <= 1.25 * plain_vs32["rel_l2"] + 1e-3):
        raise AssertionError("the kernel path's mixed-precision step disagrees with the plain path's")
    return dict(step_launches=step_counts, loss_rel_err=loss_rel, grad_cosine=fp32["cosine"],
                grad_rel_l2=fp32["rel_l2"], grad_norms=norms, mixed_rel_l2_vs_fp32=vs32["rel_l2"],
                mixed_plain_rel_l2_vs_fp32=plain_vs32["rel_l2"])


def train_entry_point(tmp: str, smi: str) -> dict:
    """Phase 6b: ``train.main`` on ffs_train.yaml as shipped, then a resume
    that runs the pairs of PairLog against the CUDA-core backward (the
    fp32 backward's own route is "fp32_tiled"), and the sampler on the
    trained EMA."""
    overrides = [f"results_dir={tmp}/results", f"max_train_steps={TRAIN_STEPS}", "log_every=1",
                 f"ckpt_every={TRAIN_STEPS}"]
    log = StepLog(profile_after=TRAIN_STEPS - 1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = train.main(load_config(FFS_TRAIN, overrides), callbacks=[log])  # on cuda by default
    torch.cuda.synchronize()
    launches = counts()
    vec = check_vec("ffs_train fp32")
    flash_f32 = flash_attention.f32_launches
    check_tc("ffs_train fp32", 0, f32=TRAIN_STEPS * STEP_LAUNCHES["flash_attention"])
    routes = check_bwd_routes("ffs_train fp32", tc=0, f32=TRAIN_STEPS * DEPTH)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    secs = log.step_seconds()
    print(f"  ffs_train fp32 batch {TRAIN_BATCH}: {out}; launches {launches}", flush=True)
    if out["final_step"] != TRAIN_STEPS or not log.finite():
        raise AssertionError(f"the training run failed: {out}, {log.records}")
    if any(launches[k] == 0 for k in FORWARD + BACKWARD):
        raise AssertionError(f"a kernel of the training path never launched: {launches}")
    if launches != {k: TRAIN_STEPS * c for k, c in STEP_LAUNCHES.items()}:
        raise AssertionError(f"expected {TRAIN_STEPS} x {STEP_LAUNCHES} launches, got {launches}")
    log.state = None  # free the run's model, EMA and moments
    # the first gap follows step 1, whose launches warm up cuBLAS; the last
    # one ran under the profiler: the median is of the three between
    warm = secs[1:-1]
    s_step = sorted(warm)[len(warm) // 2]
    print(f"  step gaps (s): {secs}; median of the unprofiled warm ones {s_step:.4f} s/step "
          f"= {1 / s_step:.4f} steps/s; "
          f"peak memory {peak_gib:.3f} GiB on {smi}", flush=True)
    print_profile("train step", log.prof, secs[-1] * 1e3)

    ckpt = os.path.join(out["experiment_dir"], "checkpoints", f"{TRAIN_STEPS:07d}.pt")
    print(f"  checkpoint {os.path.getsize(ckpt) / 2**30:.3f} GiB; "
          f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB free in {tmp}", flush=True)

    class Resumed(PairLog):
        def on_train_start(self, config, state, experiment_dir):
            super().on_train_start(config, state, experiment_dir)
            shutil.rmtree(out["experiment_dir"])  # restored: keep one checkpoint on disk

    # the backward's pairs, then the forward's (csrc/flash_attention.cu forced)
    resumed_log = Resumed("fp32_tiled", first=TRAIN_STEPS + 2)
    fwd_log = PairLog("fp32_tiled", first=resumed_log.steps + 2, forward=True)
    try:
        resumed = train.main(load_config(FFS_TRAIN, [
            f"results_dir={tmp}/results", f"max_train_steps={fwd_log.steps}", "log_every=1",
            f"resume_from_checkpoint={ckpt}",
        ]), callbacks=[resumed_log, fwd_log])
    finally:
        resumed_log.restore()
        fwd_log.restore()
    print(f"  resumed from step {TRAIN_STEPS}: {resumed}", flush=True)
    check_vec("ffs_train fp32 and its resume")
    steps = list(range(TRAIN_STEPS + 1, fwd_log.steps + 1))
    if resumed["final_step"] != fwd_log.steps or [r[0] for r in fwd_log.records] != steps:
        raise AssertionError("the resumed run did not carry the step counter on")
    if resumed_log.state.step != fwd_log.steps or not fwd_log.finite():
        raise AssertionError("the resumed run failed")
    resumed_log.state = fwd_log.state = None
    pairs = resumed_log.pair_summary()
    print(f"  fp32 pairs, batch {TRAIN_BATCH}: " + pairs.pop("line") + f" on {smi}", flush=True)
    fwd_pairs = fwd_log.pair_summary()
    print(f"  fp32 pairs, batch {TRAIN_BATCH}: " + fwd_pairs.pop("line") + f" on {smi}", flush=True)
    trained = os.path.join(resumed["experiment_dir"], "checkpoints", f"{fwd_log.steps:07d}.pt")
    lat = torch.from_numpy(np.load(sample.main(load_config(FFS_CONFIG, [
        "sample_method=ddim", "num_sampling_steps=5", f"ckpt={trained}",
        f"save_video_path={tmp}/trained.mp4",
    ])))["latents"])
    print(f"  ddim-5 from the trained EMA: latents {tuple(lat.shape)} "
          f"finite={bool(torch.isfinite(lat).all())}", flush=True)
    if lat.shape != (1, FRAMES, 4, 32, 32) or not torch.isfinite(lat).all():
        raise AssertionError("the sampler on the trained EMA gave no finite latents")
    shutil.rmtree(resumed["experiment_dir"])
    return dict(launches=launches, vec_launches=vec, f32_launches=routes["fp32_tiled"],
                s_per_step=s_step,
                fwd_f32_launches=flash_f32, steps_per_s=1 / s_step, step_seconds=secs,
                peak_gib=peak_gib, forward_pairs=fwd_pairs, **pairs)


class PairLog(StepLog):
    """StepLog of a run that ends in ROUTE_PAIRS pairs of steps from step
    ``first``: one on an attention kernel's own route (``own``: the
    backward's "tensor_core" in mixed precision or "fp32_tiled" in fp32,
    the fp32 forward's "fp32_tiled" with ``forward``) and one with its
    CUDA-core kernel forced (``backward_route`` or ``forward_route``
    patched for the step), the order alternating from pair to pair, so a
    drift in the host's or the card's speed falls on both. Records the
    launch counts at each step's log."""

    def __init__(self, own: str, first: int, profile_after: int = 0, forward: bool = False):
        super().__init__(profile_after=profile_after)
        self.own, self.forward, self.arms, self.counts = own, forward, {}, {}
        self.patch = "forward_route" if forward else "backward_route"
        self.route = getattr(attention, self.patch)
        for i in range(ROUTE_PAIRS):
            pair = (own, "cuda_core") if i % 2 == 0 else ("cuda_core", own)
            for j, arm in enumerate(pair):
                self.arms[first + 2 * i + j] = arm
        self.steps = first + 2 * ROUTE_PAIRS - 1

    def on_log(self, step, metrics):
        super().on_log(step, metrics)
        self.counts[step] = dict(counts(), **{
            f"{name} {route}": c for name, by_route in (
                ("backward", dict(tensor_core=bwd_counts("tc_launches"),
                                  fp32_tiled=bwd_counts("f32_launches"))),
                ("forward", fwd_routes())) for route, c in by_route.items()})
        route = self.route
        setattr(attention, self.patch, (
            route if self.arms.get(step + 1, self.own) == self.own
            else lambda *a: route(*a) and "cuda_core"
        ))

    def restore(self) -> None:
        setattr(attention, self.patch, self.route)

    def pair_summary(self) -> dict:
        """Each arm's step seconds, their medians and the pairs the own
        route won, after checking that every pair step made its launches of
        the patched kernels (DEPTH of each backward kernel, 2 DEPTH forward
        attentions), all on its arm's route."""
        times = {r[0]: r[1] for r in self.records}
        arm_s = {self.own: [], "cuda_core": []}
        kind = "forward" if self.forward else "backward"
        for step, arm in sorted(self.arms.items()):
            c1, c0 = self.counts[step], self.counts[step - 1]
            moved = {k: (c1[k] - c0[k]) if isinstance(c1[k], int)
                     else {n: c1[k][n] - c0[k][n] for n in c1[k]} for k in c1}
            if self.forward:
                calls = STEP_LAUNCHES["flash_attention"]
                got = (moved["flash_attention"], moved["forward fp32_tiled"], moved["forward tensor_core"])
                want = (calls, calls if arm == "fp32_tiled" else 0, 0)
            else:
                got = tuple(tuple(m.values()) for m in (
                    {n: moved[n] for n in BACKWARD}, moved["backward tensor_core"],
                    moved["backward fp32_tiled"]))
                want = tuple((c,) * len(BACKWARD) for c in (
                    DEPTH, DEPTH if arm == "tensor_core" else 0, DEPTH if arm == "fp32_tiled" else 0))
            if got != want:
                raise AssertionError(f"step {step} ({arm}): {kind} launches, on the tensor-core "
                                     f"and fp32 routes {got}, expected {want}")
            arm_s[arm].append(times[step] - times[step - 1])
        own_s, cc_s = (sorted(v)[len(v) // 2] for v in arm_s.values())
        wins = sum(a < b for a, b in zip(arm_s[self.own], arm_s["cuda_core"]))
        line = (f"pairs: {self.own} {kind} {own_s:.4f} s/step (median of {arm_s[self.own]}), "
                f"CUDA-core {kind} forced {cc_s:.4f} s/step (median of {arm_s['cuda_core']}), "
                f"{self.own} faster in {wins} of {ROUTE_PAIRS}")
        return dict(pairs=arm_s, pair_median_s={self.own: own_s, "cuda_core": cc_s},
                    pairs_won=wins, line=line)


def train_mixed_precision(tmp: str, smi: str) -> dict:
    """Phase 6c: ``train.main`` with mixed_precision: true at batch 5 (bf16
    compute over fp32 masters; their gradients, the AdamW moments and the
    EMA stay fp32), the path of the tensor-core backward: TRAIN_STEPS steps
    with all 28 backward launches of each kernel a step on the tensor cores,
    their s/step (median of the unprofiled steps 3-5) and a profile of the
    last by kind; then, after one step that absorbs the profiler's stop, the
    pairs of PairLog against the CUDA-core backward."""
    log = PairLog("tensor_core", first=TRAIN_STEPS + 2, profile_after=TRAIN_STEPS - 1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        with NoCheckpoints():
            out = train.main(load_config(FFS_TRAIN, [
                f"results_dir={tmp}/results", f"max_train_steps={log.steps}", "log_every=1",
                "mixed_precision=true",
            ]), callbacks=[log])
    finally:
        log.restore()
    check_vec(f"mixed precision, all {log.steps} steps")
    c = log.counts[TRAIN_STEPS]
    main_counts = {k: c[k] for k in KERNELS}
    main_bwd_tc, main_f32 = c["backward tensor_core"], c["backward fp32_tiled"]
    main_fwd_tc = c["forward tensor_core"]
    print(f"  mixed precision, {TRAIN_STEPS} steps: launches {main_counts}, tensor-core backward "
          f"{main_bwd_tc}, fp32-route backward {main_f32}, tensor-core forward {main_fwd_tc}",
          flush=True)
    if main_counts != {k: TRAIN_STEPS * c for k, c in STEP_LAUNCHES.items()}:
        raise AssertionError(f"expected {TRAIN_STEPS} x {STEP_LAUNCHES} launches, got {main_counts}")
    if any(c != TRAIN_STEPS * DEPTH for c in main_bwd_tc.values()) or any(main_f32.values()) or \
            main_fwd_tc != TRAIN_STEPS * STEP_LAUNCHES["flash_attention"]:
        raise AssertionError("a bf16 attention launch of the mixed-precision run left the tensor cores")
    secs = log.step_seconds()  # secs[i]: step i + 2
    pairs = log.pair_summary()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    state = log.state
    dtypes = {p.dtype for p in state.model.parameters()} | {p.dtype for p in state.ema.parameters()}
    dtypes |= {v.dtype for s in state.optimizer.state.values() for k, v in s.items() if k != "step"}
    compute = state.model.compute_dtype
    log.state = state = None
    if out["final_step"] != log.steps or not log.finite() or dtypes != {torch.float32}:
        raise AssertionError("the mixed-precision run failed or its state left fp32")
    if compute != torch.bfloat16:
        raise AssertionError("mixed_precision did not switch the compute to bf16")
    warm = secs[1:TRAIN_STEPS - 2]  # steps 3-5
    s_step = sorted(warm)[len(warm) // 2]
    print(f"  mixed precision batch {TRAIN_BATCH}: {out}; compute {compute}, state dtypes {dtypes}; "
          f"step gaps (s) {secs}; median of steps 3-5 {s_step:.4f} s/step = {1 / s_step:.4f} steps/s; "
          + pairs.pop("line") + f"; peak memory {peak_gib:.3f} GiB on {smi}", flush=True)
    print_profile("mixed-precision train step", log.prof, secs[TRAIN_STEPS - 2] * 1e3)
    shutil.rmtree(out["experiment_dir"])
    return dict(launches=main_counts, tc_launches=main_bwd_tc, s_per_step=s_step,
                steps_per_s=1 / s_step, step_seconds=secs, peak_gib=peak_gib, **pairs)


# phase 6e: the folder of mp4s the pixel trainer reads: 6 videos of 64 frames
# at 320x288 (W x H), so the ffs stack really resizes (the shorter side 288 ->
# 256) and the temporal crop of 16 x frame_interval 3 = 48 frames can move
PIXEL_VIDEOS, PIXEL_VIDEO_FRAMES, PIXEL_H, PIXEL_W = 6, 64, 288, 320
PIXEL_LOSS_REL = 1e-5  # the fused-encode step's loss against the latent-cache step's
PIXEL_SHORT_STEPS = 2  # the runs from the cache and from synthetic pixels


def write_pixel_videos(folder: str) -> None:
    """PIXEL_VIDEOS mp4s from a numpy seed (``utils.save_video``): noise at
    1/16 of the size, blown up, so the codec keeps the frames apart."""
    rng = np.random.default_rng(11)
    for i in range(PIXEL_VIDEOS):
        small = rng.integers(0, 256, size=(PIXEL_VIDEO_FRAMES, PIXEL_H // 16, PIXEL_W // 16, 3), dtype=np.uint8)
        save_video(os.path.join(folder, f"{i:03d}.mp4"), small.repeat(16, axis=1).repeat(16, axis=2))


class TimedBatches:
    """The trainer's batch iterator, with the host seconds that each
    ``next`` blocked the step loop (``waits[i]``: step i + 1)."""

    def __init__(self, batches):
        self.batches, self.waits = batches, []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.batches)
        self.waits.append(time.perf_counter() - t0)
        return batch


class NoCheckpoints:
    """Within it ``train.main`` writes no checkpoint (the callbacks still
    hear of it): a cut of the script's time, ~10 s a 10.8 GB write, for the
    runs whose checkpoint nothing reads (the MoE run's 44 GB one takes ~50
    s). Phase 6b's run and its resume, the ucf101 run that feeds
    ``pretrained`` and phase "dist"'s gathered checkpoint are written."""

    def __enter__(self):
        self.real = train.save_checkpoint
        train.save_checkpoint = lambda path, *args, **kwargs: path
        return self

    def __exit__(self, *exc):
        train.save_checkpoint = self.real


def run_timed(config, callbacks) -> tuple:
    """``train.main(config)`` with its batch iterator timed; returns its
    result, the data kind and the TimedBatches."""
    real, seen = train.make_batch_iterator, []

    def timed(*args):
        batches, kind = real(*args)
        seen.append((TimedBatches(batches), kind))
        return seen[-1]

    train.make_batch_iterator = timed
    try:
        with NoCheckpoints():
            out = train.main(config, callbacks=callbacks)  # on cuda by default
    finally:
        train.make_batch_iterator = real
    return out, seen[0][1], seen[0][0]


def encode_device_ms(prof) -> float:
    """Device ms of the kernels launched under the trainer's
    ``record_function("vae_encode")`` range (the fused encode)."""
    total = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
            continue
        parent = ev
        while parent is not None and parent.name != "vae_encode":
            parent = parent.cpu_parent
        if parent is not None:
            total += sum(k.duration for k in ev.kernels) / 1e3
    return total


def check_pixel_launches(label: str, steps: int) -> dict:
    """``steps`` train steps' launches, all attention on the fp32 routes and
    every adaLN launch on the vector route; the encode adds none."""
    launches = counts()
    check_tc(label, 0, f32=steps * STEP_LAUNCHES["flash_attention"])
    check_vec(label)
    check_bwd_routes(label, tc=0, f32=steps * DEPTH)
    if launches != {k: steps * c for k, c in STEP_LAUNCHES.items()}:
        raise AssertionError(f"{label}: expected {steps} x {STEP_LAUNCHES} launches, got {launches}")
    return launches


def pixel_step_parity(cfg, cache: str, device) -> dict:
    """One ffs_train step from the first five clips of the dataset through
    the fused encode, and one from their moments in the cache that
    ``tools.cache_latents`` wrote, from the same weights and generator seed:
    the losses within PIXEL_LOSS_REL. A fresh dataset from the same seed
    draws the clips the writer's ordered walk drew."""
    from latte_tpu_torch.data import LatentCacheDataset, get_dataset
    from latte_tpu_torch.models import get_models
    from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
    from latte_tpu_torch.train.step import make_train_step

    batch = int(cfg.local_batch_size)
    dataset, cached = get_dataset(cfg), LatentCacheDataset(cache)
    video = torch.from_numpy(np.stack([dataset[i]["video"] for i in range(batch)])).to(device)
    moments = {k: torch.from_numpy(np.stack([cached[i][k] for i in range(batch)])).to(device)
               for k in ("latent_mean", "latent_std")}
    encode = train.build_encode_fn(cfg, device)
    with torch.device(device):
        model = get_models(cfg)
    randomize_(model, seed=4)
    weights = copy.deepcopy(model.state_dict())
    diffusion = create_diffusion("", diffusion_steps=1000)
    losses = {}
    for name, b, fn in (("fused", {"video": video}, encode), ("cached", moments, None)):
        model.load_state_dict(weights)
        state = create_train_state(model, make_optimizer(model), make_lr_schedule(1e-4))
        step = make_train_step(diffusion, vae_scale=float(cfg.vae_scale), encode_fn=fn)
        losses[name] = step(state, b, torch.Generator(device=device).manual_seed(21))["loss"].item()
        del state
    rel = abs(losses["fused"] - losses["cached"]) / abs(losses["cached"])
    print(f"  fused-encode step vs latent-cache step, batch {batch}: losses {losses}, relative "
          f"difference {rel} (limit {PIXEL_LOSS_REL})", flush=True)
    if not (np.isfinite(losses["fused"]) and rel <= PIXEL_LOSS_REL):
        raise AssertionError(f"the fused-encode loss departs from the latent-cache loss: {losses}")
    return dict(losses=losses, rel_diff=rel)


def pixel_train(tmp: str, smi: str, device) -> dict:
    """Phase 6e: ``train.main`` on ffs_train.yaml (fp32, batch 5) from a
    folder of mp4s with ``vae_ckpt: random``, the fused encode in every
    step: TRAIN_STEPS steps, their launches, s/step (median of steps 3-5),
    the encode's share of the profiled step 6, peak memory and the loader's
    wait; then the fused-encode step against the latent-cache step, and two
    steps each from that cache and from synthetic pixels."""
    from latte_tpu_torch.tools import cache_latents

    videos = os.path.join(tmp, "videos")
    write_pixel_videos(videos)
    base = [f"results_dir={tmp}/results", "log_every=1", "vae_ckpt=random"]
    log = StepLog(profile_after=TRAIN_STEPS - 1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, kind, timed = run_timed(load_config(FFS_TRAIN, base + [
        f"data_path={videos}", f"max_train_steps={TRAIN_STEPS}"]), [log])
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = check_pixel_launches("pixel train", TRAIN_STEPS)
    log.state = None
    if kind != "real" or out["final_step"] != TRAIN_STEPS or not log.finite():
        raise AssertionError(f"the pixel training run failed: {kind}, {out}, {log.records}")
    secs = log.step_seconds()  # secs[i]: step i + 2
    warm = secs[1:-1]  # steps 3-5; step 6 ran under the profiler
    s_step = sorted(warm)[len(warm) // 2]
    wait = timed.waits[2:5]
    groups = print_profile("pixel train step", log.prof, secs[-1] * 1e3)
    enc_ms, total_ms = encode_device_ms(log.prof), sum(groups.values())
    share = enc_ms / total_ms if total_ms else None
    shutil.rmtree(out["experiment_dir"])
    print(f"  pixel train fp32 batch {TRAIN_BATCH}: {out}; step gaps (s) {secs}; median of steps 3-5 "
          f"{s_step:.4f} s/step; loader waits (s) {timed.waits}; encode {enc_ms:.4f} of {total_ms:.4f} "
          f"device ms in step {TRAIN_STEPS}; peak memory {peak_gib:.3f} GiB on {smi}", flush=True)

    # the latent-cache writer, and its step against the fused one
    cfg = load_config(FFS_TRAIN, base + [f"data_path={videos}", "cache_batch_size=5"])
    t0 = time.perf_counter()
    cache = cache_latents.main(cfg, os.path.join(tmp, "cache"))  # on cuda by default
    cache_s = time.perf_counter() - t0
    parity = pixel_step_parity(cfg, cache, device)
    torch.cuda.empty_cache()

    short = {}
    for name, extra in (("cache", [f"data_path={cache}"]),
                        ("synthetic_pixels", [f"data_path={tmp}/none", "synthetic_kind=pixels"])):
        slog = StepLog()
        reset_counts()
        sout, skind, _ = run_timed(load_config(FFS_TRAIN, base + extra + [
            f"max_train_steps={PIXEL_SHORT_STEPS}"]), [slog])
        slaunches = check_pixel_launches(f"pixel train from {name}", PIXEL_SHORT_STEPS)
        slog.state = None
        print(f"  {PIXEL_SHORT_STEPS} steps from {name} ({skind}): {sout}", flush=True)
        if sout["final_step"] != PIXEL_SHORT_STEPS or not slog.finite() or \
                skind != {"cache": "latents_cached", "synthetic_pixels": "synthetic_pixels"}[name]:
            raise AssertionError(f"the run from {name} failed: {skind}, {sout}, {slog.records}")
        shutil.rmtree(sout["experiment_dir"])
        short[name] = dict(losses=[r[2] for r in slog.records], launches=slaunches)
        torch.cuda.empty_cache()
    return dict(
        s_per_step=s_step, step_seconds=secs, loader_wait_s=timed.waits, loader_wait_steps_3_5_s=wait,
        encode_device_ms=enc_ms, step_device_ms=total_ms, encode_share=share,
        device_ms_by_kind=groups, peak_gib=peak_gib, launches=launches,
        losses=[r[2] for r in log.records], grad_norms=[r[3] for r in log.records],
        cache_write_s=cache_s, parity=parity, short_runs=short, device=smi,
    )


def check_routes(label: str, launches: dict, expect: dict = None, mixed: bool = False) -> dict:
    """Every attention launch since the last reset_counts() on the fp32
    route, or with ``mixed`` on the tensor-core route (none on a first
    version), every adaLN launch on the vector route, and, with ``expect``,
    the launches of each kernel. Returns the launches by route."""
    routes = dict(fwd_tc=flash_attention.tc_launches, fwd_f32=flash_attention.f32_launches,
                  bwd_tc=bwd_counts("tc_launches"), bwd_f32=bwd_counts("f32_launches"))
    check_vec(label)
    print(f"  {label}: launches {launches}, by route {routes}", flush=True)
    own, other = ("tc", "f32") if mixed else ("f32", "tc")
    if routes[f"fwd_{own}"] != launches["flash_attention"] or routes[f"fwd_{other}"] or any(
            routes[f"bwd_{own}"][n] != launches[n] or routes[f"bwd_{other}"][n] for n in BACKWARD):
        raise AssertionError(f"{label}: an attention launch left the {own} route: {launches}, {routes}")
    if expect is not None and launches != expect:
        raise AssertionError(f"{label}: expected launches {expect}, got {launches}")
    return routes


def opt_state_bytes(optimizer) -> dict:
    """The bytes of the optimizer's moments, and their types."""
    tensors = [v for st in optimizer.state.values() for k, v in st.items() if k != "step"]
    return dict(bytes=sum(v.numel() * v.element_size() for v in tensors),
                exp_avg_dtypes=sorted({str(st["exp_avg"].dtype) for st in optimizer.state.values()}))


def run_config(path: str, tmp: str, steps: int, label: str, overrides=(), mixed: bool = False,
               profile: bool = False, keep: bool = False, launches_per_step: dict = STEP_LAUNCHES,
               log: "StepLog" = None) -> dict:
    """``train.main`` on a config as shipped for ``steps`` steps (synthetic
    latents): finite losses, every launch on the fp32 routes (the
    tensor-core ones with ``mixed``) and the vector route, ``steps`` x
    ``launches_per_step`` launches, the step gaps (with ``profile`` the
    last step profiled, its device time by kind), the median of steps 3-5
    when there are 6, peak memory, the optimizer state's bytes, and the
    train state (under "state"). ``log`` is the callback (a ``StepLog``,
    made here unless given; a given one profiles as it was made to). The
    experiment's directory is deleted unless ``keep``; its final checkpoint
    is written only with ``keep`` (``NoCheckpoints``)."""
    log = log or StepLog(profile_after=steps - 1 if profile else 0)
    gc.collect()  # an earlier stage's state, so that the peak is this run's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with contextlib.nullcontext() if keep else NoCheckpoints():
        out = train.main(load_config(path, [
            f"results_dir={tmp}/results", f"max_train_steps={steps}", "log_every=1", f"ckpt_every={steps}",
            *overrides,
        ]), callbacks=[log])
    torch.cuda.synchronize()
    launches = counts()
    routes = check_routes(label, launches, {k: steps * c for k, c in launches_per_step.items()}, mixed)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    secs = log.step_seconds()  # secs[i]: step i + 2
    if out["final_step"] != steps or not log.finite():
        raise AssertionError(f"{label}: the training run failed: {out}, {log.records}")
    r = dict(launches=launches, routes=routes, step_seconds=secs, peak_gib=peak_gib,
             losses=[rec[2] for rec in log.records], **opt_state_bytes(log.state.optimizer))
    if steps >= 6:
        warm = secs[1:4]  # steps 3-5
        r["s_per_step"] = sorted(warm)[1]
    line = (f"  {label}: {out}; step gaps (s) {secs}"
            + (f"; median of steps 3-5 {r['s_per_step']:.4f} s/step" if "s_per_step" in r else "")
            + f"; peak memory {peak_gib:.3f} GiB; optimizer state {r['bytes'] / 2**30:.3f} GiB "
            f"({r['exp_avg_dtypes']})")
    print(line, flush=True)
    if profile:
        r["profile_ms"] = print_profile(label, log.prof, secs[-1] * 1e3)
    r["state"], log.state = log.state, None
    r["checkpoint"] = os.path.join(out["experiment_dir"], "checkpoints", f"{steps:07d}.pt")
    if not keep:
        shutil.rmtree(out["experiment_dir"])
    return r


def step_grads(model, batch: dict, grad_accum: int = 1, mu_dtype=None, lr: float = 0.0):
    """One train step of ``model`` on ``batch`` (its t, noise, labels and
    drop ids fixed) through ``make_train_step``, without clipping; at lr 0
    AdamW leaves the weights as they were. Returns the gradients (flat),
    the step's seconds, its working memory in GiB (the peak above what was
    allocated when it started: of the forwards and backwards, up to the
    optimizer's update, and of the whole step, which allocates the AdamW
    moments of its new state) and the train state."""
    state = create_train_state(model, make_optimizer(model, mu_dtype=mu_dtype), make_lr_schedule(lr))
    step = make_train_step(create_diffusion(""), clip_max_norm=1e30, grad_accum=grad_accum)
    update, peaks = state.optimizer.step, []

    def measured_update(*args, **kwargs):
        peaks.append(torch.cuda.max_memory_allocated())
        return update(*args, **kwargs)

    state.optimizer.step = measured_update
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    metrics = step(state, batch, torch.Generator(device=batch["noise"].device))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    working = dict(backward_gib=(peaks[0] - held) / 2**30,
                   step_gib=(torch.cuda.max_memory_allocated() - held) / 2**30)
    del state.optimizer.step  # the method again, and no cycle through the wrapper
    if not torch.isfinite(metrics["loss"]):
        raise AssertionError("a step gave a non-finite loss")
    return torch.cat([p.grad.flatten() for p in model.parameters()]), secs, working, state


def full_width_batch(device, batch: int, frames: int, class_conditional: bool, seed: int) -> dict:
    """A batch of the configs' shapes from a seed: latents, t, noise, and for
    a class-conditional model labels over ucf101's 101 classes with every
    third row's label dropped (the same drop ids on every path)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = dict(latents=torch.randn((batch, frames, 4, 32, 32), generator=gen, device=device),
             t=torch.randint(0, 1000, (batch,), generator=gen, device=device))
    b["noise"] = torch.randn(b["latents"].shape, generator=gen, device=device)
    if class_conditional:
        b["y"] = torch.randint(0, 101, (batch,), generator=gen, device=device)
        b["force_drop_ids"] = (torch.arange(batch, device=device) % 3 == 2).long()
    return b


def kernel_vs_plain(name: str, arch: dict, batch: dict, label: str, seed: int):
    """One step's gradients of the model on the kernel path against the
    plain path from the same weights and batch (cosine >= 0.999, relative
    L2 <= 1e-3, as train_step_parity); returns the kernel path's model and
    the comparison with the step's launches."""
    with torch.device(batch["latents"].device):
        model = get_model(name, **arch)
        plain = get_model(name, plain=True, **arch)
    randomize_(model, seed=seed)
    plain.load_state_dict(model.state_dict())
    reset_counts()
    g_k = step_grads(model, batch)[0]
    launches = counts()
    check_routes(f"{label} step", launches, STEP_LAUNCHES)
    g_p = step_grads(plain, batch)[0]
    del plain
    r = compare(f"{label}: kernel grads vs plain grads", g_k, g_p)
    del g_k, g_p
    torch.cuda.empty_cache()
    if not (r["finite"] and r["cosine"] >= 0.999 and r["rel_l2"] <= 1e-3):
        raise AssertionError(f"{label}: the kernel path's gradients disagree with the plain path's")
    return model, dict(r, launches=launches)


def ucf101_options(model, batch: dict, smi: str) -> dict:
    """Phase "train more" (c) on (a)'s model and batch, two steps each (the
    first's gradients compared, the second timed with its working memory):
    one chunk under full remat, ACCUM chunks and "dots" against it; then
    two steps with bf16 first moments."""
    r = {}
    for opt, kw in (("full", {}), ("grad_accum", dict(grad_accum=ACCUM)), ("dots", {})):
        model.remat_policy = "dots" if opt == "dots" else "full"
        reset_counts()
        g, _, _, state = step_grads(model, batch, **kw)
        del state
        _, secs, working, state = step_grads(model, batch, **kw)
        del state
        launches = counts()
        # each chunk a forward, its recompute and a backward
        chunks = OPTION_STEPS * kw.get("grad_accum", 1)
        check_routes(f"ucf101 {opt}", launches, {k: chunks * c for k, c in STEP_LAUNCHES.items()})
        r[opt] = dict(step_s=secs, working=working, launches=launches)
        if opt == "full":
            g_full = g
        else:
            r[opt].update(compare(f"ucf101 {opt} grads vs one chunk, full remat", g, g_full),
                          equal_to_the_bit=bool(torch.equal(g, g_full)))
            del g
        torch.cuda.empty_cache()
        print(f"  ucf101 {opt}: step {secs:.4f} s, working memory {working} (one chunk under full "
              f"remat {r['full']['step_s']:.4f} s, {r['full']['working']}); grads equal to full "
              f"remat's to the bit: {r[opt].get('equal_to_the_bit')} on {smi}", flush=True)
    model.remat_policy = "full"
    del g_full
    # chunks hold one chunk's activations: the forwards and backwards need
    # less; the update's peak (gradients, moments, AdamW's temporaries) is
    # the same
    accum, full = r["grad_accum"], r["full"]
    if not (accum["rel_l2"] <= ACCUM_REL_L2 and accum["working"]["backward_gib"] < full["working"]["backward_gib"]):
        raise AssertionError(f"gradient accumulation: {accum} against {full}")
    if not r["dots"]["rel_l2"] <= DOTS_REL_L2:
        raise AssertionError(f"remat_policy dots: {r['dots']}")
    # two steps with the first moment in bf16 (lr 1e-4: the weights move)
    state = None
    for _ in range(OPTION_STEPS):
        del state
        _, secs, working, state = step_grads(model, batch, mu_dtype=torch.bfloat16, lr=1e-4)
    r["adam_mu_bf16"] = dict(step_s=secs, working=working, **opt_state_bytes(state.optimizer))
    del state
    print(f"  ucf101 adam_mu_dtype bfloat16: {r['adam_mu_bf16']}", flush=True)
    if r["adam_mu_bf16"]["exp_avg_dtypes"] != ["torch.bfloat16"]:
        raise AssertionError(f"adam_mu_dtype: bfloat16 left a first moment in another type: {r}")
    return r


def train_more(tmp: str, smi: str, device) -> dict:
    """Phase "train more": (a) ucf101_train.yaml (class-conditional over 101
    classes, fp32, batch 5, full remat) through ``train.main``, TRAIN_STEPS
    steps, then one step's gradients against the plain path, then
    OPTION_STEPS steps with mixed_precision: true; (b) ffs_img_train.yaml
    (LatteIMG-XL/2, 16 frames and 8 images, batch 4) the same with the last
    step profiled, then OPTION_STEPS steps of ucf101_img_train.yaml
    (y_image); (c) the options on (a)'s model: gradient accumulation, the
    "dots" remat policy, bf16 first moments, and through ``train.main``
    ``pretrained`` from (a)'s checkpoint with ``fixed_spatial``."""
    res = {}
    a = run_config(UCF_TRAIN, tmp, TRAIN_STEPS, "ucf101_train fp32", keep=True)
    ckpt, a_state = a.pop("checkpoint"), a.pop("state")
    a_opt = opt_state_bytes(a_state.optimizer)
    del a_state
    torch.cuda.empty_cache()
    res["ucf101_train"] = a
    batch = full_width_batch(device, TRAIN_BATCH, FRAMES, True, seed=11)
    arch = dict(input_size=32, num_frames=FRAMES, extras=2, num_classes=101, gradient_checkpointing=True)
    model, res["ucf101_parity"] = kernel_vs_plain("Latte-XL/2", arch, batch, "ucf101 fp32", seed=12)
    res["options"] = ucf101_options(model, batch, smi)
    res["options"]["adam_mu_bf16"]["fp32_state_bytes"] = a_opt["bytes"]
    del model
    torch.cuda.empty_cache()
    res["ucf101_mixed"] = run_config(UCF_TRAIN, tmp, OPTION_STEPS, "ucf101_train mixed precision",
                                     ["mixed_precision=true"], mixed=True)
    res["ucf101_mixed"].pop("state")

    b = run_config(FFS_IMG_TRAIN, tmp, TRAIN_STEPS, "ffs_img_train fp32", profile=True)
    b.pop("state")
    res["ffs_img_train"] = b
    batch = full_width_batch(device, IMG_BATCH, FRAMES + IMAGES, False, seed=13)
    arch = dict(input_size=32, num_frames=FRAMES, use_image_num=IMAGES, gradient_checkpointing=True)
    model, res["ffs_img_parity"] = kernel_vs_plain("LatteIMG-XL/2", arch, batch, "ffs_img fp32", seed=14)
    del model, batch
    torch.cuda.empty_cache()
    res["ucf101_img_train"] = run_config(UCF_IMG_TRAIN, tmp, OPTION_STEPS, "ucf101_img_train fp32")
    res["ucf101_img_train"].pop("state")

    # (c) fine-tuning: the temporal attention of (a)'s EMA, the rest frozen;
    # block 0 is frozen and its input needs no gradient, so its backward
    # kernels do not run
    fine = run_config(UCF_TRAIN, tmp, OPTION_STEPS, "ucf101 pretrained fixed_spatial",
                      [f"pretrained={ckpt}", "fixed_spatial=true"],
                      launches_per_step={**STEP_LAUNCHES, **{k: DEPTH - 1 for k in BACKWARD}})
    state = fine.pop("state")
    loaded = find_model(ckpt)
    mask = trainable_temporal_attn_mask(state.model)
    moved = {name: not torch.equal(p.detach(), loaded[name].to(p.device))
             for name, p in state.model.named_parameters()}
    del state, loaded
    fine["changed"] = sum(moved.values())
    fine["trainable"] = sum(mask.values())
    print(f"  pretrained + fixed_spatial: {fine['changed']} parameters changed of {len(moved)}; "
          f"{fine['trainable']} trainable", flush=True)
    if moved != mask:
        wrong = sorted(n for n in mask if moved[n] != mask[n])[:8]
        raise AssertionError(f"fixed_spatial: parameters changed other than the temporal attention: {wrong}")
    res["options"]["pretrained_fixed_spatial"] = fine
    shutil.rmtree(os.path.dirname(os.path.dirname(ckpt)))
    torch.cuda.empty_cache()
    return res


# phase "moe": the Mixture-of-Experts feed-forward at full width
MOE_TRAIN = os.path.join(ROOT, "configs", "ffs", "ffs_train_moe.yaml")
MOE_EXPERTS = 8
MOE_ARCH = dict(input_size=32, num_frames=FRAMES, moe_experts=MOE_EXPERTS, moe_top_k=2)
MOE_AUX_WEIGHT = 0.01  # ffs_train_moe.yaml's moe_aux_weight
MOE_AUX_MIN = 1 - 1e-3  # E·Σ f·P is 1 at a uniform split and more otherwise
MOE_T2V_STEPS = 10
MOE_PARTS = ("route", "dispatch", "experts", "combine")


def set_plain(model, plain: bool) -> None:
    """Every module of ``model`` with a ``plain`` switch (blocks, attention,
    LatteT2V itself) onto the kernels' plain versions, or back: the plain
    path on the same weights, without a second copy of them."""
    for m in model.modules():
        if hasattr(m, "plain"):
            m.plain = plain


class Routes:
    """Context: the routing choices, (k, S) a call, of every MoE layer call
    inside it, in call order (``MoEMlp.route`` patched)."""

    def __enter__(self):
        self.calls, self.route = [], MoEMlp.route
        route = self.route

        def recording(mod, xf):
            out = route(mod, xf)
            self.calls.append(torch.stack(out[1]).detach())
            return out

        MoEMlp.route = recording
        return self

    def __exit__(self, *exc):
        MoEMlp.route = self.route

    def apart(self, other: "Routes") -> dict:
        """How many routing choices differ between two runs of the same calls."""
        if [c.shape for c in self.calls] != [c.shape for c in other.calls]:
            raise AssertionError("the two runs made different MoE calls")
        apart = sum(int((a != b).sum()) for a, b in zip(self.calls, other.calls))
        total = sum(c.numel() for c in self.calls)
        return dict(calls=len(self.calls), choices=total, apart=apart, share_apart=apart / total)


def _grad_tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj] if obj.requires_grad else []
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _grad_tensors(o)]
    return []


def _part_nodes(outputs, inputs) -> list:
    """The autograd nodes between a part's outputs and its inputs: from the
    outputs' nodes down to (not including) the inputs' nodes and the leaves'
    accumulators."""
    stop = {t.grad_fn for t in inputs if t.grad_fn is not None}
    seen, todo = [], [t.grad_fn for t in outputs if t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None or node in stop or node in seen or type(node).__name__ == "AccumulateGrad":
            continue
        seen.append(node)
        todo.extend(f for f, _ in node.next_functions)
    return seen


class MoESpans:
    """Context: device ms of the MoE layer's parts (``MoEMlp.route``,
    ``dispatch``, ``experts``, ``combine``, patched while inside), by CUDA
    events on the stream: each call (forward, and under gradient
    checkpointing the recompute), and, where the graph is recorded, each of
    the part's autograd nodes in the backward (a pre-hook to a hook). Read
    ``ms()`` after a synchronize. The host must keep ahead of the device for
    a span to be its kernels' time, so it is taken in a run without the
    profiler."""

    def __enter__(self):
        self.saved = {name: getattr(MoEMlp, name) for name in MOE_PARTS}
        self.fwd = {name: [] for name in MOE_PARTS}
        self.bwd = {name: [] for name in MOE_PARTS}
        for name, method in self.saved.items():
            setattr(MoEMlp, name, self._spanned(name, method))
        return self

    def __exit__(self, *exc):
        for name, method in self.saved.items():
            setattr(MoEMlp, name, method)

    def _spanned(self, name, method):
        def call(mod, *args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = method(mod, *args, **kwargs)
            end.record()
            self.fwd[name].append((start, end))
            if torch.is_grad_enabled():
                for node in _part_nodes(_grad_tensors(out), _grad_tensors(args)):
                    self._hook(name, node)
            return out
        return call

    def _hook(self, name, node) -> None:
        span = []

        def pre(grad_outputs):
            span.append(torch.cuda.Event(enable_timing=True))
            span[-1].record()

        def post(grad_inputs, grad_outputs):
            span.append(torch.cuda.Event(enable_timing=True))
            span[-1].record()
            self.bwd[name].append(tuple(span))

        node.register_prehook(pre)
        node.register_hook(post)

    def ms(self) -> dict:
        return dict(
            forward={n: sum(a.elapsed_time(b) for a, b in v) for n, v in self.fwd.items()},
            backward={n: sum(a.elapsed_time(b) for a, b in v) for n, v in self.bwd.items()},
            calls=len(self.fwd["route"]), backward_nodes={n: len(v) for n, v in self.bwd.items()},
        )


class MoELog(StepLog):
    """StepLog that also keeps each step's ``moe_aux``, block 0's router and
    ``wi`` before the run and whether each moved by steps 1 and 2 (adaLN-Zero
    holds the experts' gradient at 0 in step 1, so only the Switch loss moves
    the router there)."""

    def on_train_start(self, config, state, experiment_dir):
        super().on_train_start(config, state, experiment_dir)
        moe = state.model.blocks[0].moe
        self.aux, self.moved = [], {}
        self.start = {name: getattr(moe, name).detach().clone() for name in ("router", "wi")}

    def on_log(self, step, metrics):
        super().on_log(step, metrics)
        self.aux.append(metrics["moe_aux"])
        if step in (1, 2):
            moe = self.state.model.blocks[0].moe
            self.moved[step] = {name: not torch.equal(getattr(moe, name).detach(), v)
                                for name, v in self.start.items()}


def moe_train_step_parity(device) -> dict:
    """Phase "moe" (a): one full-width step of Latte-XL/2 with 8 experts,
    top-2 (fp32, batch 1, gradient checkpointing; the diffusion loss plus
    the Switch loss at 0.01, as the train step adds it), kernel path against
    plain path on the same weights, t and noise: every gradient, router
    included, and the routing choices of the two paths."""
    with torch.device(device):
        model = get_model("Latte-XL/2", **MOE_ARCH, gradient_checkpointing=True)
    randomize_(model, seed=41)
    gen = torch.Generator(device=device).manual_seed(42)
    x0 = torch.randn((1, FRAMES, 4, 32, 32), generator=gen, device=device)
    noise = torch.randn(x0.shape, generator=gen, device=device)
    t = torch.tensor([137], device=device)
    diffusion = create_diffusion("")

    def step():
        aux = []

        def fn(x, tt):
            out, columns = model(x, tt, return_aux=True)
            aux.append(columns)
            return out

        loss = diffusion.training_losses(fn, x0, t, noise)["loss"].mean()
        loss = loss + MOE_AUX_WEIGHT * aux[0].mean(dim=1).sum() / aux[0].shape[0]
        loss.backward()
        return loss.detach()

    reset_counts()
    with Routes() as routes_k:
        loss_k = step()
    torch.cuda.synchronize()
    launches = counts()
    check_routes("moe fp32 train step", launches, STEP_LAUNCHES)
    g_k = [p.grad for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    set_plain(model, True)
    reset_counts()
    with Routes() as routes_p:
        loss_p = step()
    set_plain(model, False)
    if any(counts().values()):
        raise AssertionError(f"the plain path launched kernels: {counts()}")
    g_p = [p.grad for p in model.parameters()]
    r = compare("moe fp32 step: kernel grads vs plain grads", g_k, g_p)
    router = compare("moe fp32 step: routers' grads, kernel vs plain",
                     [g for (n, _), g in zip(model.named_parameters(), g_k) if n.endswith(".router")],
                     [g for (n, _), g in zip(model.named_parameters(), g_p) if n.endswith(".router")])
    apart = routes_k.apart(routes_p)
    loss_rel = abs((loss_k - loss_p) / loss_p).item()
    print(f"  moe fp32 step: loss {loss_k.item()} vs {loss_p.item()} (rel err {loss_rel}); routing "
          f"choices apart between the paths {apart}", flush=True)
    del model, g_k, g_p
    torch.cuda.empty_cache()
    if not (r["finite"] and r["cosine"] >= 0.999 and r["rel_l2"] <= 1e-3 and router["cosine"] >= 0.999
            and router["rel_l2"] <= 1e-3):
        raise AssertionError("the MoE kernel path's gradients disagree with the plain path's")
    return dict(launches=launches, grads=r, router_grads=router, routing=apart, loss_rel_err=loss_rel)


def moe_train(tmp: str, smi: str, device) -> dict:
    """Phase "moe" (b): ``train.main`` on ffs_train_moe.yaml with
    expert_parallel=1 its one override (8 experts, fp32, batch 5, full remat,
    synthetic latents) for TRAIN_STEPS steps (step 6 profiled); then one more
    step of the same state with the MoE parts timed by CUDA events."""
    disk = shutil.disk_usage(tmp)
    print(f"  disk under {tmp}: {disk.free / 1e9:.1f} GB free of {disk.total / 1e9:.1f} GB", flush=True)
    log = MoELog(profile_after=TRAIN_STEPS - 1)
    r = run_config(MOE_TRAIN, tmp, TRAIN_STEPS, "ffs_train_moe fp32", ["expert_parallel=1"], profile=True,
                   log=log)
    state = r.pop("state")
    n_params = sum(p.numel() for p in state.model.parameters())
    r.update(parameters=n_params, moe_aux=log.aux, moved=log.moved, disk_free_gb=disk.free / 1e9)
    print(f"  ffs_train_moe: {n_params:,} parameters; moe_aux by step {log.aux}; block 0 moved by step "
          f"{log.moved} on {smi}", flush=True)
    if not (all(a >= MOE_AUX_MIN for a in log.aux) and log.moved[1] == dict(router=True, wi=False)
            and log.moved[2]["wi"]):
        raise AssertionError(f"ffs_train_moe: moe_aux {log.aux}, block 0 moved {log.moved}")

    step = make_train_step(create_diffusion(""), clip_max_norm=0.1, moe_aux_weight=MOE_AUX_WEIGHT)
    batch = full_width_batch(device, TRAIN_BATCH, FRAMES, False, seed=43)
    gen = torch.Generator(device=device).manual_seed(44)
    with MoESpans() as spans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    parts = spans.ms()
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    routing = sum(parts[d][n] for d in ("forward", "backward") for n in ("route", "dispatch", "combine"))
    experts = parts["forward"]["experts"] + parts["backward"]["experts"]
    r["step7"] = dict(step_ms=step_ms, parts_ms=parts, routing_ms=routing, experts_ms=experts,
                      routing_share=routing / step_ms, experts_share=experts / step_ms,
                      moe_aux=float(metrics["moe_aux"]))
    print(f"  ffs_train_moe one more step: {step_ms:.2f} ms; MoE parts by CUDA events (ms) "
          f"{json.dumps(parts)}; routing (router, dispatch, combine) {routing:.2f} ms = "
          f"{routing / step_ms:.4f} of the step, expert products and activation {experts:.2f} ms = "
          f"{experts / step_ms:.4f}", flush=True)
    return r


def moe_part_ms(moe, x, timer) -> dict:
    """Device ms of each part of one MoE layer call on ``x`` (B, N, D),
    each part timed alone (``Timer`` with the pad, so that the host's
    launches stay out of the events). In the host-bound sampler, events
    around the parts inside a run would time the host's gaps too."""
    B, N, D = x.shape
    g, C = moe_groups(B * N, moe.num_experts, moe.top_k, moe.capacity_factor, moe.group_size)
    xf = x.reshape(B * N, D)
    with torch.inference_mode():
        _, choices, gates, _ = moe.route(xf)
        xin, slots, weights = moe.dispatch(xf, choices, gates, g, C)
        out = moe.experts(xin)
        return dict(route=timer.ms(lambda: moe.route(xf), pad=True),
                    dispatch=timer.ms(lambda: moe.dispatch(xf, choices, gates, g, C), pad=True),
                    experts=timer.ms(lambda: moe.experts(xin), pad=True),
                    combine=timer.ms(lambda: moe.combine(out, slots, weights), pad=True))


def moe_sampler(tmp: str, smi: str, device, timer) -> dict:
    """Phase "moe" (c): ``sample.main`` on ffs_sample.yaml with moe_experts: 8,
    DDIM-50, batch 1, bf16, from a checkpoint of seeded random weights: 1400
    launches of B1, B2, B3, finite latents, s a video (median of 3), the idle
    share of a profiled DDIM-10 against its unprofiled run, the MoE parts
    at the sampler's spatial and temporal shapes timed alone, the latents
    against the plain path's (cosine >= 0.99); quantized: static with MoE
    refused."""
    with torch.device(device):
        model = get_model("Latte-XL/2", **MOE_ARCH)
    randomize_(model, seed=45)
    ckpt = os.path.join(tmp, "latte_xl2_moe_random.pt")
    torch.save({"ema": {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}}, ckpt)
    del model
    torch.cuda.empty_cache()
    over = ["sample_method=ddim", "num_sampling_steps=50", "per_proc_batch_size=1", f"ckpt={ckpt}",
            f"save_video_path={tmp}/moe.mp4", f"moe_experts={MOE_EXPERTS}"]
    cfg = load_config(FFS_CONFIG, over)
    reset_counts()
    lat = torch.from_numpy(np.load(sample.main(cfg))["latents"])
    launches = counts()
    check_tc("moe bf16 ddim-50 entry point", DEPTH * 50)
    check_vec("moe bf16 ddim-50 entry point")
    print(f"  moe ddim-50 latents {tuple(lat.shape)} finite={bool(torch.isfinite(lat).all())}; launches "
          f"{launches}", flush=True)
    if lat.shape != (1, FRAMES, 4, 32, 32) or not torch.isfinite(lat).all():
        raise AssertionError("the MoE sampler's latents are not finite (1, 16, 4, 32, 32)")
    if any(launches[k] != DEPTH * 50 for k in FORWARD) or any(launches[k] for k in (*BACKWARD, INT8)):
        raise AssertionError(f"expected {DEPTH * 50} launches of each forward kernel, got {launches}")

    model = sample.build_model(cfg, device)
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample.sample_latents(model, cfg, device)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    video_s = sorted(secs)[1]
    cfg10 = load_config(FFS_CONFIG, over + ["num_sampling_steps=10"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample.sample_latents(model, cfg10, device)
    torch.cuda.synchronize()
    prof = profile_sampler(model, cfg10, device, time.perf_counter() - t0, "moe ddim-10 sampler")
    gen = torch.Generator(device=device).manual_seed(47)
    parts = {}
    for name, (blk, rows, n) in (("spatial", (0, FRAMES, TOKENS)), ("temporal", (1, TOKENS, FRAMES))):
        x = torch.randn((rows, n, HIDDEN), generator=gen, device=device).to(torch.bfloat16)
        parts[name] = moe_part_ms(model.blocks[blk].moe, x, timer)
    per_video = {k: 50 * DEPTH // 2 * (parts["spatial"][k] + parts["temporal"][k]) for k in MOE_PARTS}
    set_plain(model, True)
    ref = sample.sample_latents(model, cfg, device)
    set_plain(model, False)
    vs_plain = compare("moe ddim-50 latents, entry point vs plain path", lat, ref.float().cpu())
    print(f"  moe ddim-50 batch 1 bf16: {video_s:.4f} s a video (runs {secs}) -> {60 / video_s:.3f} "
          f"videos/min; MoE parts of one layer call, each alone (device ms) {json.dumps(parts)}, "
          f"so in a video {json.dumps(per_video)} on {smi}", flush=True)
    del model, ref
    os.remove(ckpt)
    torch.cuda.empty_cache()
    if not vs_plain["cosine"] >= 0.99:
        raise AssertionError("the MoE DDIM latents disagree with the plain path's")
    refusal = refused(lambda: sample.main(load_config(FFS_CONFIG, over + ["quantized=static"])))
    return dict(launches=launches, s_per_video=video_s, runs_s=secs, profile_ddim10=prof, parts_ms=parts,
                parts_ms_per_video=per_video, latents_vs_plain=vs_plain, quantized_static=refusal)


def refused(fn) -> str:
    """``fn()`` must raise ``NotImplementedError`` (MoE has no int8 expert
    path); its message."""
    try:
        fn()
    except NotImplementedError as e:
        print(f"  refused as it must be: {e}", flush=True)
        return str(e)
    raise AssertionError("an int8 MoE run was not refused")


def moe_t2v(tmp: str, smi: str, device) -> dict:
    """Phase "moe" (d): ``sample_t2x.main`` on t2v_sample.yaml as shipped
    (three prompts, 16 frames at 512^2, CFG 7.5, bf16) with moe_experts=8 at
    DDIM-10: launches, finite latents, s a step, peak memory (the entry
    point's, with the fp32 build, and the serving's after it); one CFG
    forward against the plain path (cosine >= 0.999) with the routing
    choices of both; one DDIM step profiled by kind and the MoE parts by
    CUDA events in another; quantized: true with MoE refused."""
    import statistics

    from latte_tpu_torch.core.scheduler import get_scheduler
    from latte_tpu_torch.sample import sample_t2x
    from latte_tpu_torch.sample.pipeline_t2v import LattePipeline

    over = [f"moe_experts={MOE_EXPERTS}", f"num_sampling_steps={MOE_T2V_STEPS}",
            f"save_video_path={tmp}/t2v_moe"]
    cfg = load_config(T2V_CONFIG, over)
    prompts, steps = list(cfg.text_prompt), MOE_T2V_STEPS
    kw = sample_t2x.transformer_kwargs(cfg)
    pairs, frames, (H, W) = kw["num_layers"], int(cfg.video_length), sample_t2x.image_hw(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    records = sample_t2x.main(cfg)
    main_peak = torch.cuda.max_memory_allocated() / 2**30
    launches = expect_launches(f"t2v moe, {len(prompts)} prompts", t2v_launches(pairs, len(prompts) * steps))
    if not all(torch.isfinite(r["latents"]).all() and r["latents"].shape == (1, 4, frames, H // 8, W // 8)
               for r in records):
        raise AssertionError("the MoE T2V latents are not finite or not of the expected shape")
    step_s = statistics.median(r["latents_s"] for r in records[1:]) / steps

    model = sample_t2x.build_transformer(cfg, device)
    n_params = sum(p.numel() for p in model.parameters())
    stub = sample_t2x.build_text_encoder(cfg)
    pipe = LattePipeline(model, get_scheduler("DDIM"), stub)
    ctx, mask = pipe.encode_prompt([prompts[0]])
    gen = torch.Generator(device=device).manual_seed(46)
    latent = (4, frames, H // 8, W // 8)
    x = torch.randn((2, *latent), generator=gen, device=device)
    t = torch.full((2,), 500.0, device=device)
    with torch.inference_mode():
        with Routes() as routes_k:
            out_k = model(x, t, ctx, mask)
        set_plain(model, True)
        with Routes() as routes_p:
            out_p = model(x, t, ctx, mask)
        set_plain(model, False)
    vs_plain = compare("t2v moe CFG forward, kernels bf16 vs plain bf16", out_k, out_p)
    apart = routes_k.apart(routes_p)
    print(f"  t2v moe forward: routing choices apart between the paths {apart}", flush=True)
    del out_k, out_p
    if not (vs_plain["finite"] and vs_plain["cosine"] >= 0.999):
        raise AssertionError("the MoE T2V kernel path disagrees with the plain path")

    sched = pipe.scheduler
    ts, state = sched.timesteps(steps), sched.init_state(steps)
    z = torch.randn((1, *latent), generator=gen, device=device)

    def one_step():
        with torch.inference_mode():
            return pipe._step(z, state, ctx, mask, 0, ts, float(cfg.guidance_scale), True, None)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_t2v_step(one_step)
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    profile = profile_t2v_step(one_step, step_ms, "t2v moe ddim step")
    with MoESpans() as spans:
        one_step()
        torch.cuda.synchronize()
    parts = spans.ms()
    print(f"  t2v moe ({n_params:,} parameters) DDIM-{steps} + CFG bf16: {step_s:.4f} s a step through "
          f"the entry point (median of prompts 2-3), {step_ms:.2f} ms a step alone; peak "
          f"{main_peak:.3f} GiB in the entry point (fp32 build included), {serve_peak:.3f} GiB serving; "
          f"MoE parts of a step by CUDA events (ms) {json.dumps(parts['forward'])} on {smi}", flush=True)
    del model, pipe
    torch.cuda.empty_cache()
    refusal = refused(lambda: sample_t2x.main(load_config(T2V_CONFIG, over + ["quantized=true"])))
    return dict(parameters=n_params, launches=launches, s_per_step=step_s,
                prompt_latents_s=[r["latents_s"] for r in records], peak_gib_entry=main_peak,
                peak_gib_serving=serve_peak, forward_vs_plain=vs_plain, routing=apart, step_ms=step_ms,
                step_profile=profile, parts_ms=parts, quantized_true=refusal)


def moe_phase(tmp: str, smi: str, device, timer) -> dict:
    """Phase "moe" (a)-(d); returns the ``moe: {...}`` line's dict."""
    out = {}
    t0 = time.perf_counter()
    out["grads"] = moe_train_step_parity(device)
    phase("moe (a) gradients", t0)
    t0 = time.perf_counter()
    out["train"] = moe_train(tmp, smi, device)
    phase("moe (b) train", t0)
    t0 = time.perf_counter()
    out["latte"] = moe_sampler(tmp, smi, device, timer)
    phase("moe (c) latte serving", t0)
    t0 = time.perf_counter()
    out["t2v"] = moe_t2v(tmp, smi, device)
    phase("moe (d) t2v serving", t0)
    out["device"] = smi
    return out


# ---- phase "text": T5 v1.1-XXL through sample_t2x, the SVD temporal decoder,
# CLIP's text tower and extras: 78, at full width on seeded random weights ----

# T5 v1.1-XXL's encoder (4.76 B parameters, 9.5 GB in bf16)
T5_XXL = dict(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64,
              relative_attention_num_buckets=32, relative_attention_max_distance=128,
              layer_norm_epsilon=1e-6, feed_forward_proj="gated-gelu", model_type="t5")
T5_SHARDS = 2  # the t5_ckpt's safetensors shards, with their index
TEXT_STEPS = 10  # DDIM steps of the phase's T2V run: t2v_sample.yaml's 50, cut for time
T5_COSINE = 0.999  # the bf16 T5 features against fp32 on the same ids, unmasked tokens
TD_CHECK_FRAMES = 2  # the temporal decoder's fp32 chunk held against fp64 (VAE_TOL)
# the aten op at the root of a temporal-decoder kernel's op -> its kind
TD_KINDS = {**VAE_KINDS, "aten::conv3d": "temporal_convolution", "aten::_to_copy": "copies",
            "aten::sigmoid": "mix", "aten::rsub": "mix", "aten::clamp": "to_frames",
            "aten::div": "to_frames"}
CLIP_PROMPTS = ["a dog jumping over fences", "Sunset over the sea."]
TEXT_TRAIN_STEPS = 3  # train.main steps of ffs_train.yaml with extras=78
_ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_field(field: int, wire: int, payload: bytes) -> bytes:
    key = _pb_varint((field << 3) | wire)
    return key + (_pb_varint(len(payload)) + payload if wire == 2 else payload)


def write_spiece_model(path: str, words) -> int:
    """A synthetic unigram ``spiece.model`` (protobuf): <pad>, </s>, <unk>,
    ▁, every character of ``words`` and ▁ + each word, whole words scoring
    highest; the nmt_nfkc normalizer's flags. Returns the piece count."""
    words = sorted(set(words))
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -4.0, 1)]
    pieces += [(c, -8.0, 1) for c in sorted(set("".join(words)))]
    pieces += [("▁" + w, -2.0 - 1e-3 * i, 1) for i, w in enumerate(words)]
    out = b""
    for piece, score, kind in pieces:
        out += _pb_field(1, 2, _pb_field(1, 2, piece.encode()) + _pb_field(2, 5, np.float32(score).tobytes())
                         + _pb_field(3, 0, _pb_varint(kind)))
    out += _pb_field(2, 2, _pb_field(3, 0, _pb_varint(1)))  # unigram
    out += _pb_field(3, 2, _pb_field(1, 2, b"nmt_nfkc") + b"".join(
        _pb_field(f, 0, _pb_varint(1)) for f in (3, 4, 5)))
    with open(path, "wb") as f:
        f.write(out)
    return len(pieces)


def write_safetensors(path: str, tensors: dict) -> int:
    """``tensors`` as a .safetensors file, written without the package (the
    format ``convert.read_safetensors`` reads); returns its data bytes."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = dict(dtype=_ST_DTYPES[t.dtype], shape=list(t.shape), data_offsets=[offset, offset + n])
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return offset


def write_t5_ckpt(folder: str, device, words) -> dict:
    """A Hugging Face T5 directory of T5 v1.1-XXL's encoder: config.json, its
    seeded random weights made on the card in bf16 (Hugging Face's init; the
    norms fp32), T5_SHARDS safetensors shards with their index, and a
    synthetic spiece.model of ``words``."""
    from latte_tpu_torch.text.t5 import T5Config, T5EncoderModel

    os.makedirs(folder)
    t0 = time.perf_counter()
    with torch.device("meta"):
        t5 = T5EncoderModel(T5Config.from_dict(T5_XXL))
    t5 = t5.to(torch.bfloat16).to_empty(device=device)
    t5.initialize_weights(torch.Generator(device=device).manual_seed(19))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sd = t5.state_dict()
    n_params = sum(v.numel() for v in sd.values())
    total = sum(v.numel() * v.element_size() for v in sd.values())
    shards, cur, size = [], [], 0
    for name, v in sd.items():
        cur.append(name)
        size += v.numel() * v.element_size()
        if size >= total / T5_SHARDS and len(shards) < T5_SHARDS - 1:
            shards, cur, size = shards + [cur], [], 0
    shards.append(cur)
    t0 = time.perf_counter()
    weight_map = {}
    for i, names in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(os.path.join(folder, fname), {n: sd[n] for n in names})
        weight_map.update({n: fname for n in names})
    with open(os.path.join(folder, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(T5_XXL, f)
    pieces = write_spiece_model(os.path.join(folder, "spiece.model"), words)
    write_s = time.perf_counter() - t0
    del t5, sd
    torch.cuda.empty_cache()
    return dict(parameters=n_params, gb=total / 1e9, shards=len(shards), pieces=pieces, init_s=init_s,
                write_s=write_s)


class StandInTokenizer:
    """A stand-in for CLIP's BPE tokenizer (no vocabulary is in the repo)
    with the Hugging Face call signature: each word's crc32 into CLIP's
    vocabulary, start and end tokens (49406, 49407), padded with the end
    token and masked to ``max_length``, as tests/test_text.py's
    FakeTokenizer stands in on the CPU."""

    def __call__(self, texts, padding=None, max_length=None, truncation=None, return_tensors=None, **kw):
        import zlib

        ids = np.full((len(texts), max_length), 49407, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            toks = [49406] + [zlib.crc32(w.encode()) % 49406 for w in text.lower().split()][: max_length - 2]
            toks.append(49407)
            ids[i, : len(toks)], mask[i, : len(toks)] = toks, 1
        return {"input_ids": ids, "attention_mask": mask}


def peak_gib_of(fn) -> tuple:
    """The peak memory (GiB) while ``fn()`` runs, and what was allocated
    before it."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30, before / 2**30


def text_t5(tmp: str, smi: str, device) -> tuple:
    """Phase "text" (a): a T5 v1.1-XXL ``t5_ckpt`` directory, then the entry
    point ``sample_t2x.cli`` on t2v_sample.yaml with it (three prompts,
    DDIM-10, CFG 7.5, bf16, 16x512^2, ``vae_ckpt=random``); the encoder's
    load and encode times, the bf16 features against an fp32 T5 on the same
    ids. Returns the record, the entry point's records, its LatteT2V and
    its T5 encoder."""
    from latte_tpu_torch.sample import sample_t2x
    from latte_tpu_torch.text import T5EncoderModel, clean_caption

    cfg = load_config(T2V_CONFIG)
    prompts = list(cfg.text_prompt)
    folder = os.path.join(tmp, "t5_ckpt")
    written = write_t5_ckpt(folder, device, " ".join(clean_caption(p) for p in prompts).split())
    print(f"  t5_ckpt: {written['parameters']:,} parameters, {written['gb']:.3f} GB in {written['shards']} "
          f"shards, {written['pieces']} pieces; made on the card in {written['init_s']:.2f} s, written in "
          f"{written['write_s']:.2f} s", flush=True)

    built, real = {}, (sample_t2x.build_text_encoder, sample_t2x.build_transformer)

    def build_text_encoder(config, device=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built["t5"] = real[0](config, device)
        torch.cuda.synchronize()
        built["load_s"] = time.perf_counter() - t0
        return built["t5"]

    def build_transformer(config, device, ctx=None):
        built["model"] = real[1](config, device, ctx)
        return built["model"]

    sample_t2x.build_text_encoder, sample_t2x.build_transformer = build_text_encoder, build_transformer
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        t0 = time.perf_counter()
        records = sample_t2x.cli(["--config", T2V_CONFIG, f"t5_ckpt={folder}", f"num_sampling_steps={TEXT_STEPS}",
                                  "vae_ckpt=random", f"save_video_path={tmp}/text_t2v"])
        main_s = time.perf_counter() - t0
    finally:
        sample_t2x.build_text_encoder, sample_t2x.build_transformer = real
    peak = torch.cuda.max_memory_allocated() / 2**30
    pairs, frames = sample_t2x.transformer_kwargs(cfg)["num_layers"], int(cfg.video_length)
    launches = expect_launches(f"t2v_sample.yaml with T5-XXL, {len(prompts)} videos, DDIM-{TEXT_STEPS}",
                               t2v_launches(pairs, len(prompts) * TEXT_STEPS))
    shapes = [read_mp4(r["path"]).shape for r in records]
    H, W = sample_t2x.image_hw(cfg)
    if shapes != [(frames, H, W, 3)] * len(prompts):
        raise AssertionError(f"expected {len(prompts)} mp4s of {frames}x{H}x{W}x3, got {shapes}")
    enc = built["t5"]
    if not (isinstance(enc.model, T5EncoderModel) and enc.model.shared.weight.dtype == torch.bfloat16):
        raise AssertionError(f"sample_t2x did not load the port's bf16 T5: {type(enc.model)}")
    lat_s = statistics.median(r["latents_s"] for r in records[1:])
    dec_s = statistics.median(r["decode_s"] for r in records[1:])

    # the encoder: a video's encode (its prompt and the negative) and all six rows at once
    one_ms = time_t2v_step(lambda: enc.encode_with_negative(prompts[:1]))
    six_ms = time_t2v_step(lambda: enc.encode_with_negative(prompts))
    ids, mask = enc.tokenize(prompts)
    ids, mask = torch.as_tensor(ids, device=device), torch.as_tensor(mask, device=device)
    with torch.inference_mode():
        f16 = enc.model(ids, mask)
    with torch.device("meta"):
        t5_32 = T5EncoderModel(enc.model.config)
    t5_32 = t5_32.to_empty(device=device)
    t5_32.load_state_dict(enc.model.state_dict())
    with torch.inference_mode():
        f32 = t5_32(ids, mask)
    del t5_32
    torch.cuda.empty_cache()
    keep = mask.bool()
    vs32 = compare("T5-XXL features, bf16 vs fp32 on the same ids, unmasked tokens", f16[keep], f32[keep])
    tokens = [int(m.sum()) for m in mask]
    print(f"  T5-XXL: load {built['load_s']:.2f} s; encode of a video's prompt and negative (2 x 120 "
          f"tokens) {one_ms:.2f} ms, of all {2 * len(prompts)} rows {six_ms:.2f} ms (medians of 3); "
          f"tokens a prompt {tokens}", flush=True)
    print(f"  t2v with T5-XXL, DDIM-{TEXT_STEPS} + CFG, {frames}x{H}x{W} bf16: {lat_s:.4f} s a video to "
          f"latents, decode {dec_s:.4f} s (median of prompts 2-3; prompt 1 {records[0]['latents_s']:.4f} + "
          f"{records[0]['decode_s']:.4f}); peak {peak:.3f} GiB; cli {main_s:.2f} s on {smi}", flush=True)
    if f16.shape != (len(prompts), enc.max_length, T5_XXL["d_model"]) or not vs32["finite"] \
            or vs32["cosine"] < T5_COSINE:
        raise AssertionError(f"the bf16 T5-XXL features {tuple(f16.shape)} disagree with fp32: {vs32}")
    r = dict(t5_ckpt=written, load_s=built["load_s"], encode_video_ms=one_ms, encode_six_rows_ms=six_ms,
             tokens=tokens, bf16_vs_fp32=vs32, s_per_video_latents=lat_s, s_decode=dec_s,
             prompt_seconds=[(x["latents_s"], x["decode_s"]) for x in records], main_s=main_s,
             peak_gib=peak, launches=launches, mp4_shapes=[list(s) for s in shapes], steps=TEXT_STEPS)
    return r, records, built["model"], enc


def text_temporal_decoder(records, model, enc, smi: str, device) -> dict:
    """Phase "text" (b): the SVD temporal decoder at full width (128, 256,
    512, 512; 3 resnets a block; seeded random weights): one
    ``LattePipeline`` call with ``enable_vae_temporal_decoder`` on (a)'s
    LatteT2V and T5, then (a)'s first latents decoded (16 frames, chunks
    14 + 2) in fp32 with cuDNN's TF32 off and in bf16: s/video, peak memory,
    device ms by kind; an fp32 chunk of TD_CHECK_FRAMES against fp64."""
    from latte_tpu_torch.core.scheduler import get_scheduler
    from latte_tpu_torch.sample.pipeline_t2v import LattePipeline
    from latte_tpu_torch.vae.temporal_decoder import TemporalDecoder
    from torch.profiler import ProfilerActivity, profile

    with torch.device(device):
        td = TemporalDecoder()
    td.initialize_weights(torch.Generator(device=device).manual_seed(23))
    td.eval()
    n_params = sum(p.numel() for p in td.parameters())
    prompt = load_config(T2V_CONFIG).text_prompt[0]
    pipe = LattePipeline(model, get_scheduler("DDIM"), enc, temporal_decoder=td)
    t0 = time.perf_counter()
    video = pipe(prompt, num_inference_steps=TEXT_STEPS, enable_vae_temporal_decoder=True).video
    call_s = time.perf_counter() - t0
    print(f"  LattePipeline call with the temporal decoder: {video.shape} {video.dtype} in {call_s:.2f} s "
          f"(DDIM-{TEXT_STEPS}, T5 and the decode)", flush=True)
    lat = records[0]["latents"].to(device)
    want = (1, FRAMES, 8 * lat.shape[-2], 8 * lat.shape[-1], 3)
    if video.shape != want or not np.isfinite(video).all() or video.min() < 0 or video.max() > 1:
        raise AssertionError(f"the temporal decode gave {video.shape}, not {want} in [0, 1]")
    z2 = lat[0, :, :TD_CHECK_FRAMES].transpose(0, 1) / pipe.vae_scale
    td64 = copy.deepcopy(td).double()
    with torch.inference_mode(), cudnn_tf32(False):
        x32, x64 = td.decode(z2, TD_CHECK_FRAMES), td64.decode(z2.double(), TD_CHECK_FRAMES)
    vs64 = compare(f"temporal decode of a {TD_CHECK_FRAMES}-frame chunk, fp32 (TF32 off) vs fp64", x32, x64)
    del td64, x32, x64
    torch.cuda.empty_cache()
    if vs64["rel_l2"] > VAE_TOL or not vs64["finite"]:
        raise AssertionError(f"the fp32 temporal decoder is more than {VAE_TOL} off fp64: {vs64}")
    out = dict(parameters=n_params, call_s=call_s, fp32_vs_fp64=vs64)
    for name in ("fp32", "bf16"):
        if name == "bf16":
            pipe.temporal_decoder = copy.deepcopy(td).to(torch.bfloat16)
        s = time_t2v_step(lambda: pipe.decode_latents_with_temporal_decoder(lat)) / 1e3
        peak, before = peak_gib_of(lambda: pipe.decode_latents_with_temporal_decoder(lat))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe.decode_latents_with_temporal_decoder(lat)
            torch.cuda.synchronize()
        kinds = print_profile(f"temporal decode {name}", prof, s * 1e3, TD_KINDS)
        _, busy, _ = device_ms_by_kind(prof)
        out[name] = dict(s_per_video=s, peak_gib=peak, allocated_before_gib=before,
                         device_ms_by_kind=kinds, busy_ms=busy, idle=1 - busy / (s * 1e3) if busy else None)
        print(f"  temporal decode {name}, {FRAMES} frames at 512^2 (chunks 14 + 2): {s:.4f} s/video "
              f"(median of 3); peak {peak:.3f} GiB ({before:.3f} before) on {smi}", flush=True)
    del td, pipe
    torch.cuda.empty_cache()
    return out


class TextLog(StepLog):
    """StepLog that keeps text_embedding_projection's weight before the run."""

    def on_train_start(self, config, state, experiment_dir):
        super().on_train_start(config, state, experiment_dir)
        self.start = state.model.text_embedding_projection.weight.detach().clone()


def text_extras78(tmp: str, smi: str, device, timer) -> dict:
    """Phase "text" (c): CLIP ViT-L/14's text tower (seeded random weights, a
    stand-in tokenizer) encodes two prompts; Latte-XL/2 with extras: 78 on
    those features, a bf16 forward on the kernels against the plain bf16
    and fp32 paths; ``train.main`` on ffs_train.yaml with extras=78 (fp32,
    batch 5, full remat, synthetic latents and text) for TEXT_TRAIN_STEPS
    steps."""
    from latte_tpu_torch.text import CLIPTextModel, FrozenCLIPEmbedder

    with torch.device(device):
        clip = CLIPTextModel()
    clip.initialize_weights(torch.Generator(device=device).manual_seed(29))
    emb = FrozenCLIPEmbedder(clip, StandInTokenizer())
    feats = emb.encode(CLIP_PROMPTS)
    clip_ms = timer.ms(lambda: emb.encode(CLIP_PROMPTS), iters=5)
    print(f"  CLIP ViT-L/14 text tower ({sum(p.numel() for p in clip.parameters()):,} parameters): "
          f"{tuple(feats.shape)} features of {len(CLIP_PROMPTS)} prompts in {clip_ms:.3f} ms", flush=True)
    if feats.shape != (len(CLIP_PROMPTS), 77, 768) or not torch.isfinite(feats).all():
        raise AssertionError(f"CLIP features {tuple(feats.shape)}, not finite ({len(CLIP_PROMPTS)}, 77, 768)")
    del emb, clip

    arch = dict(input_size=32, num_frames=FRAMES, extras=78)
    with torch.device(device):
        model = get_model("Latte-XL/2", **arch)
        plain32 = get_model("Latte-XL/2", plain=True, **arch)
    randomize_(model, seed=31)
    plain32.load_state_dict(model.state_dict())
    model.to(torch.bfloat16).eval()
    plain32.eval()
    with torch.device(device):
        plain16 = get_model("Latte-XL/2", plain=True, **arch)
    plain16.load_state_dict(model.state_dict())
    plain16.to(torch.bfloat16).eval()
    gen = torch.Generator(device=device).manual_seed(37)
    x = torch.randn((len(CLIP_PROMPTS), FRAMES, 4, 32, 32), generator=gen, device=device)
    t = torch.full((len(CLIP_PROMPTS),), 500, device=device)
    with torch.inference_mode():
        model(x, t, text_embedding=feats)
        torch.cuda.synchronize()
        reset_counts()
        out_k = model(x, t, text_embedding=feats)
        torch.cuda.synchronize()
        launches = expect_launches("Latte-XL/2 extras: 78 bf16 forward",
                                   {k: DEPTH if k in FORWARD else 0 for k in KERNELS})
        out_p16, out_p32 = plain16(x, t, text_embedding=feats), plain32(x, t, text_embedding=feats)
        fwd_ms = timer.ms(lambda: model(x, t, text_embedding=feats), iters=5)
    vs_plain = compare("extras 78 forward, kernels bf16 vs plain bf16", out_k, out_p16)
    vs32 = compare("extras 78 forward, kernels bf16 vs plain fp32", out_k, out_p32)
    plain_vs32 = compare("extras 78 forward, plain bf16 vs plain fp32", out_p16, out_p32)
    del model, plain16, plain32, out_k, out_p16, out_p32
    torch.cuda.empty_cache()
    if not (vs32["finite"] and vs32["cosine"] >= 0.999 and vs32["rel_l2"] <= 1.25 * plain_vs32["rel_l2"] + 1e-3):
        raise AssertionError("the extras: 78 kernel path disagrees with the plain fp32 path")

    log = TextLog()
    r = run_config(FFS_TRAIN, tmp, TEXT_TRAIN_STEPS, "ffs_train extras=78 fp32", ["extras=78"], log=log)
    state = r.pop("state")
    proj = state.model.text_embedding_projection
    moved = not torch.equal(proj.weight.detach(), log.start)
    n_params = sum(p.numel() for p in state.model.parameters())
    del state, log
    gc.collect()
    torch.cuda.empty_cache()
    r.update(parameters=n_params, projection=list(proj.weight.shape), projection_moved=moved,
             s_per_step=r["step_seconds"][-1])
    print(f"  ffs_train extras=78: {n_params:,} parameters (projection {tuple(proj.weight.shape)}); step "
          f"{TEXT_TRAIN_STEPS} {r['s_per_step']:.4f} s; peak {r['peak_gib']:.3f} GiB; projection moved "
          f"{moved} on {smi}", flush=True)
    if not moved:
        raise AssertionError("text_embedding_projection did not move in the extras=78 run")
    return dict(clip_features=list(feats.shape), clip_ms=clip_ms, forward_launches=launches, forward_ms=fwd_ms,
                forward=dict(vs_plain_bf16=vs_plain, vs_plain_fp32=vs32, plain_bf16_vs_fp32=plain_vs32),
                train=r)


def text_phase(tmp: str, smi: str, device, timer) -> dict:
    """Phase "text": (a) T5-XXL through sample_t2x, (b) the temporal
    decoder, (c) CLIP and extras: 78; returns the ``text: {...}`` line's
    dict."""
    t0 = time.perf_counter()
    t5, records, model, enc = text_t5(tmp, smi, device)
    t5["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    td = text_temporal_decoder(records, model, enc, smi, device)
    td["s"] = time.perf_counter() - t0
    shutil.rmtree(os.path.join(tmp, "t5_ckpt"))
    del records, model, enc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    clip = text_extras78(tmp, smi, device, timer)
    clip["s"] = time.perf_counter() - t0
    return dict(device=smi, t5=t5, temporal_decoder=td, extras78=clip)


# phase "dist": the world size (one process a GPU, NCCL), the steps of each
# run, and the tolerance of FSDP against the plain trainer
# the ring of the virtual ring, and the shards of the virtual tp
RING = 4
# the virtual ring's attentions, (rows, tokens) at 16 heads of 72: Latte-XL/2's
# spatial at batch 1 and at the trainer's batch 5, its temporal (blocks of 4
# tokens), T2V 512^2's spatial (1024 tokens a frame)
RING_SHAPES = {"spatial": (FRAMES, TOKENS), "spatial_b5": (TRAIN_BATCH * FRAMES, TOKENS),
               "temporal": (TOKENS, FRAMES), "t2v": (FRAMES, 1024)}
# the virtual tp's pair against the whole pair, fp32: relative L2 of the
# output and of each weight's gradient (the row-parallel sums run in
# another order, a few fp32 ulp apart)
TP_REL = 1e-5


def ring_case(rows: int, n: int, dtype, device, gen) -> dict:
    """One virtual-ring case: the ring's schedule over RING K/V shards
    (``dist.ring.virtual_ring_attention``: B1 with its lse, the fp32 merge,
    B4/B5 with the merged lse and delta) against B1, B4 and B5 on the whole
    sequence, forward and the q/k/v gradients of one dO."""
    from latte_tpu_torch.dist.ring import virtual_ring_attention

    q, k, v, dout = (torch.randn((rows, n, HEADS, HEAD_DIM), generator=gen, device=device).to(dtype)
                     for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def run(fn):
        out = fn()
        return (out.detach(), *torch.autograd.grad(out, (q, k, v), dout))

    reset_counts()
    whole = run(lambda: flash_attention(q, k, v))
    torch.cuda.synchronize()
    whole_launches = {name: KERNELS[name]["fn"].launches for name in ("flash_attention", *BACKWARD)}
    reset_counts()
    ring = run(lambda: virtual_ring_attention(q, k, v, RING))
    torch.cuda.synchronize()
    ring_launches = {name: KERNELS[name]["fn"].launches for name in ("flash_attention", *BACKWARD)}
    m = n // RING
    blk = [t[:, :m].detach().contiguous() for t in (q, k, v, dout)]
    routes = dict(forward=forward_route(*blk[:3]), backward=backward_route(*blk, *[torch.empty_like(blk[0])] * 3))
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    errs = {name: max_err(r, w) / max_abs(w) for name, r, w in zip(("out", "dq", "dk", "dv"), ring, whole)}
    return dict(errs=errs, tolerance=tol, shard_routes=routes, ring_launches=ring_launches,
                whole_launches=whole_launches, run=lambda: run(lambda: virtual_ring_attention(q, k, v, RING)),
                whole=lambda: run(lambda: flash_attention(q, k, v)))


def virtual_ring(device, timer) -> dict:
    """Phase 10a's ring: each RING_SHAPES case in bf16 and fp32 (see
    ring_case); every error within the kernels' gates (BF16_TOL, FP32_TOL
    of the largest magnitude), each shard on the route of its dtype, RING²
    launches of B1, B4 and B5 for the ring and one each for the whole; ms of
    the ring's forward and backward beside the whole sequence's."""
    gen = torch.Generator(device=device).manual_seed(21)
    out, launches = {}, {name: 0 for name in KERNELS}
    for label, (rows, n) in RING_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            case = ring_case(rows, n, dtype, device, gen)
            name = f"{label}_{'bf16' if dtype == torch.bfloat16 else 'fp32'}"
            want_route = "tensor_core" if dtype == torch.bfloat16 else "fp32_tiled"
            r = {k: case[k] for k in ("errs", "tolerance", "shard_routes", "ring_launches", "whole_launches")}
            r.update(ms=timer.ms(case["run"], iters=3), whole_ms=timer.ms(case["whole"], iters=3))
            print(f"  virtual ring {name} ({rows} rows x {n} tokens, {RING} shards of {n // RING}): "
                  + json.dumps(r), flush=True)
            for k, c in case["ring_launches"].items():
                launches[k] += c
            if any(e > case["tolerance"] for e in case["errs"].values()):
                raise AssertionError(f"virtual ring {name}: {case['errs']} beyond {case['tolerance']}")
            if set(case["shard_routes"].values()) != {want_route}:
                raise AssertionError(f"virtual ring {name}: shard routes {case['shard_routes']}, want {want_route}")
            if any(c != RING * RING for c in case["ring_launches"].values()) or \
                    any(c != 1 for c in case["whole_launches"].values()):
                raise AssertionError(f"virtual ring {name}: launches {case['ring_launches']} (ring), "
                                     f"{case['whole_launches']} (whole)")
            out[name] = r
    return dict(cases=out, launches=launches, device=torch.cuda.get_device_name(device))


def virtual_tp(device) -> dict:
    """Phase 10a's tp: one Latte-XL/2 block pair (spatial, then temporal,
    with the (b f) t d <-> (b t) f d relayouts between) at ffs_train.yaml's
    shapes (batch 5, 16 frames of 256 tokens, fp32), weights from a seed,
    against its RING tp shards (``dist.sharding.tp_shard``) run in turn
    with the row-parallel sums taken by hand (``dist.tp.virtual_tp``, the
    seam where ``tp_reduce`` all-reduces): the output and every weight's
    gradient (the shards' joined by ``tp_unshard``) within TP_REL relative
    L2, and the launches of each kernel (RING times the whole pair's for
    B1, B4, B5)."""
    from latte_tpu_torch.dist.sharding import tp_shard, tp_unshard
    from latte_tpu_torch.dist.tp import virtual_tp as join
    from latte_tpu_torch.models.layers import AdaLNBlock

    B, F, T, D = TRAIN_BATCH, FRAMES, TOKENS, HIDDEN
    gen = torch.Generator(device=device).manual_seed(22)
    with torch.device(device):
        whole = [AdaLNBlock(D, HEADS) for _ in range(2)]
    with torch.no_grad():
        for blk in whole:
            for p in blk.parameters():
                p.normal_(0.0, (p[0].numel() ** -0.5) if p.dim() > 1 else 0.1, generator=gen)
    shards = []
    for i, blk in enumerate(whole):
        with torch.device(device):
            parts = [AdaLNBlock(D, HEADS, tp=RING) for _ in range(RING)]
        for r, part in enumerate(parts):
            part.load_state_dict({k: tp_shard(f"blocks.{i}.{k}", v, RING, r) for k, v in blk.state_dict().items()})
        shards.append(parts)
    joined = [join(parts) for parts in shards]
    x = torch.randn((B * F, T, D), generator=gen, device=device)
    c_s = torch.randn((B * F, D), generator=gen, device=device)
    c_t = torch.randn((B * T, D), generator=gen, device=device)
    w = torch.randn((B * F, T, D), generator=gen, device=device)

    def pair(blocks, x):
        y = blocks[0](x, c_s).reshape(B, F, T, D).transpose(1, 2).contiguous().view(B * T, F, D)
        return blocks[1](y, c_t).reshape(B, T, F, D).transpose(1, 2).contiguous().view(B * F, T, D)

    res = {}
    for label, blocks in (("whole", whole), ("shards", joined)):
        xi = x.clone().requires_grad_()
        reset_counts()
        out = pair(blocks, xi)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        res[label] = dict(out=out.detach(), dx=xi.grad, launches=counts())
    out_err = compare("virtual tp pair: output, shards vs whole", res["shards"]["out"], res["whole"]["out"])
    dx_err = compare("virtual tp pair: input gradient", res["shards"]["dx"], res["whole"]["dx"])
    worst, worst_name = 0.0, None
    for i, blk in enumerate(whole):
        for k, p in blk.named_parameters():
            grads = [dict(part.named_parameters())[k].grad for part in shards[i]]
            g = grads[0] if grads[1] is None else tp_unshard(f"blocks.{i}.{k}", grads)
            err = float((g.double() - p.grad.double()).norm() / p.grad.double().norm().clamp_min(1e-30))
            if err > worst:
                worst, worst_name = err, f"blocks.{i}.{k}"
    r = dict(out_rel_l2=out_err["rel_l2"], dx_rel_l2=dx_err["rel_l2"], worst_grad_rel_l2=worst,
             worst_grad=worst_name, launches=res["shards"]["launches"], whole_launches=res["whole"]["launches"])
    print("  virtual tp pair (4 shards, fp32, batch 5): " + json.dumps(r), flush=True)
    if max(out_err["rel_l2"], dx_err["rel_l2"], worst) > TP_REL:
        raise AssertionError(f"virtual tp: the shards disagree with the whole pair beyond {TP_REL}: {r}")
    for name in ("flash_attention", *BACKWARD):
        if r["launches"][name] != RING * r["whole_launches"][name]:
            raise AssertionError(f"virtual tp: {name} launched {r['launches'][name]} times, want "
                                 f"{RING} x {r['whole_launches'][name]}")
    return r


# phase "pp one card": the virtual pipeline (dist.pipeline.LocalHop) of the fp32
# ffs_train step, 7 stages of 2 pairs, a row a microbatch at batch 5; of one
# bf16 T2V CFG forward, 4 stages of 7 pairs, a video a microbatch
PP_STAGES, PP_MICRO = 7, 5
PP_T2V_STAGES, PP_T2V_MICRO = 4, 2
# every parameter after the update against the one-model step's, relative L2
# (the weight gradients sum over the microbatches in another order); the k
# third of each qkv bias, whose gradient is zero but for rounding (softmax
# does not see a shift of every key) and which AdamW moves by up to the
# learning rate on that rounding, within 2 learning rates elementwise
PP_PARAM_REL = 1e-5


def pp_param_gate(got: dict, want: dict, lr: float) -> dict:
    """Every parameter of ``got`` against ``want`` (state dicts on the
    card): the worst relative L2 (the k third of each qkv bias aside) and
    the k thirds' largest difference in learning rates."""
    worst, worst_name, k_bias = 0.0, None, 0.0
    for name, w in want.items():
        g = got[name]
        if name.endswith("qkv.bias"):
            third = w.shape[0] // 3
            k_bias = max(k_bias, float((g[third:2 * third] - w[third:2 * third]).abs().max()) / lr)
            g, w = torch.cat([g[:third], g[2 * third:]]), torch.cat([w[:third], w[2 * third:]])
        err = float((g.double() - w.double()).norm() / w.double().norm().clamp_min(1e-30))
        if err > worst:
            worst, worst_name = err, name
    return dict(worst_rel_l2=worst, worst=worst_name, qkv_k_bias_lr=k_bias)


def pp_one_card(device, smi: str, timer) -> dict:
    """Phase "pp one card": pipeline parallelism's schedule at full width in
    one process (see the module docstring). (a) Latte-XL/2 as
    configs/ffs/ffs_train.yaml builds it (fp32, full remat), seeded weights
    (``randomize_``), one train step at batch 5 through the virtual
    pipeline of PP_STAGES stages and PP_MICRO microbatches
    (``make_pipelined_apply``) against the one-model step on the same
    weights, generator and batch (AdamW at the config's rate, constant, so
    the update moves every weight): loss and grad norm within DIST_REL,
    every parameter after the update within PP_PARAM_REL
    (``pp_param_gate``), B1-B5 launched PP_MICRO times the one-model step's,
    all on the fp32 and vector routes; then a second step of each, timed.
    (b) LatteT2V at full width (t2v_sample.yaml, 28 pairs, bf16, seeded
    init), one CFG forward through the virtual pipeline of PP_T2V_STAGES
    stages and PP_T2V_MICRO microbatches against the whole model's: within
    BF16_TOL of the largest magnitude, B1 and B3 PP_T2V_MICRO times each
    block, B2 too and once for norm_out, on the tensor-core and vector
    routes; both forwards timed."""
    from latte_tpu_torch.core.scheduler import get_scheduler
    from latte_tpu_torch.dist.pipeline import make_pipelined_apply, pipelined_t2v_forward
    from latte_tpu_torch.models import get_models
    from latte_tpu_torch.sample import sample_t2x
    from latte_tpu_torch.sample.pipeline_t2v import LattePipeline

    cfg = load_config(FFS_TRAIN, [])
    lr = float(cfg.learning_rate)
    with torch.device(device):
        whole = get_models(cfg)
        virt = get_models(cfg)
    randomize_(whole, seed=7)
    virt.load_state_dict(whole.state_dict())
    gen = torch.Generator(device=device).manual_seed(8)
    batch = dict(latents=torch.randn((TRAIN_BATCH, FRAMES, 4, 32, 32), generator=gen, device=device))
    diffusion = create_diffusion("", diffusion_steps=1000)
    runs = {}
    for label, model in (("one_model", whole), ("virtual_pp", virt)):
        state = create_train_state(model, make_optimizer(model, float(getattr(cfg, "weight_decay", 0.0))),
                                   make_lr_schedule(lr))
        apply_fn = make_pipelined_apply(model, PP_STAGES, PP_MICRO) if model is virt else None
        step = make_train_step(diffusion, ema_decay=float(cfg.ema_decay), clip_max_norm=float(cfg.clip_max_norm),
                               start_clip_iter=int(getattr(cfg, "start_clip_iter", 0) or 0), apply_fn=apply_fn)
        factor = PP_MICRO if model is virt else 1
        secs = []
        for i in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # both models, and what earlier steps left
            reset_counts()
            t0 = time.perf_counter()
            m = step(state, batch, torch.Generator(device=device).manual_seed(9 + i))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if i == 0:
                launches = counts()
                routes = check_routes(f"pp one card, {label} step", launches,
                                      {k: factor * c for k, c in STEP_LAUNCHES.items()})
                metrics = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
                params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        # the second step's working memory: its peak above what it started with
        runs[label] = dict(metrics, launches=launches, routes=routes, first_step_s=secs[0], step_s=secs[1],
                           working_gib=(torch.cuda.max_memory_allocated() - held) / 2**30, params=params)
        del state, step, apply_fn
        gc.collect()
        torch.cuda.empty_cache()
    del whole, virt
    one, pp = runs["one_model"], runs["virtual_pp"]
    gate = pp_param_gate(pp.pop("params"), one.pop("params"), lr)
    rel = {k: abs(pp[k] - one[k]) / abs(one[k]) for k in ("loss", "grad_norm")}
    train_r = dict(stages=PP_STAGES, microbatches=PP_MICRO, one_model=one, virtual_pp=pp, metric_rel=rel, **gate)
    print(f"  pp one card, ffs_train step (fp32, batch 5, {PP_STAGES} stages x {PP_MICRO} microbatches): "
          f"{json.dumps({k: v for k, v in train_r.items() if k not in ('one_model', 'virtual_pp')})}; "
          f"s/step {pp['step_s']:.4f} (one model {one['step_s']:.4f}), a step's working memory "
          f"{pp['working_gib']:.3f} GiB (one model {one['working_gib']:.3f}) on {smi}", flush=True)
    if max(rel.values()) > DIST_REL or gate["worst_rel_l2"] > PP_PARAM_REL or gate["qkv_k_bias_lr"] > 2.0:
        raise AssertionError(f"pp one card: the virtual pipeline's step departs from the one-model step: {train_r}")
    gc.collect()
    torch.cuda.empty_cache()

    tcfg = load_config(T2V_CONFIG, ["use_fp16=false"])
    model = sample_t2x.build_transformer(tcfg, device).to(torch.bfloat16)
    pairs = model.num_layers
    stub = sample_t2x.build_text_encoder(tcfg)
    ctx, mask = LattePipeline(model, get_scheduler("DDIM"), stub).encode_prompt([tcfg.text_prompt[0]])
    H, W = sample_t2x.image_hw(tcfg)
    gen = torch.Generator(device=device).manual_seed(10)
    x = torch.randn((2, 4, int(tcfg.video_length), H // 8, W // 8), generator=gen, device=device)
    t = torch.full((2,), 500.0, device=device)
    with torch.inference_mode():
        model(x, t, ctx, mask)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        want = model(x, t, ctx, mask)
        torch.cuda.synchronize()
        whole_launches = expect_launches("pp one card, whole t2v CFG forward", t2v_launches(pairs))
        reset_counts()
        got = pipelined_t2v_forward(model, x, t, ctx, mask, mesh=PP_T2V_STAGES, microbatches=PP_T2V_MICRO)
        torch.cuda.synchronize()
        expect = {k: PP_T2V_MICRO * c for k, c in t2v_launches(pairs).items()}
        expect["ln_modulate"] -= PP_T2V_MICRO - 1  # norm_out runs once, on the whole batch
        pp_launches = expect_launches("pp one card, virtual pipeline t2v CFG forward", expect)
        whole_ms = timer.ms(lambda: model(x, t, ctx, mask), iters=3)
        pp_ms = timer.ms(lambda: pipelined_t2v_forward(model, x, t, ctx, mask, mesh=PP_T2V_STAGES,
                                                       microbatches=PP_T2V_MICRO), iters=3)
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    t2v_r = dict(stages=PP_T2V_STAGES, microbatches=PP_T2V_MICRO, max_err_over_max=err,
                 finite=bool(torch.isfinite(got).all()), launches=pp_launches, whole_launches=whole_launches,
                 ms=pp_ms, whole_ms=whole_ms,
                 vs_whole=compare("pp one card, t2v forward, virtual pipeline vs whole", got, want))
    print(f"  pp one card, t2v CFG forward (bf16, {PP_T2V_STAGES} stages x {PP_T2V_MICRO} microbatches): "
          f"{json.dumps(t2v_r)} on {smi}", flush=True)
    if not t2v_r["finite"] or err > BF16_TOL:
        raise AssertionError(f"pp one card: the virtual pipeline's t2v forward departs from the whole model's: {t2v_r}")
    del model, got, want
    torch.cuda.empty_cache()
    return dict(train=train_r, t2v=t2v_r, device=smi)


DIST_WORLD = min(4, torch.cuda.device_count()) if torch.cuda.is_available() else 0
DIST_STEPS, DIST_MOE_STEPS = 3, 2
DIST_REL = 1e-6


def nccl_kernels(prof) -> dict:
    """Device ms and count of the NCCL kernels in a profile."""
    ms, n = 0.0, 0
    for ev in prof.key_averages():
        if "nccl" in ev.key.lower() and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            ms += ev.self_device_time_total / 1e3
            n += ev.count
    return dict(ms=ms, count=n)


def gate_run(path: str, overrides, tmp: str, label: str) -> dict:
    """``train.main`` on the config at ``path`` with ``overrides`` (over the
    process group when one exists), a log every step and no checkpoint
    written (``NoCheckpoints``): the logged losses and grad norms, the full
    parameters after the steps (on the CPU), the step gaps, the peak memory
    and the launches by route."""
    from torch.distributed.tensor import DTensor

    log = StepLog()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # what earlier work still holds
    reset_counts()
    with NoCheckpoints():
        out = train.main(load_config(path, [f"results_dir={tmp}/gates", "log_every=1", *overrides]),
                         callbacks=[log])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = counts()
    routes = check_routes(label, launches, {k: out["final_step"] * c for k, c in STEP_LAUNCHES.items()})
    params = {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach().cpu()
              for k, v in log.state.model.state_dict().items()}
    log.state = None
    shutil.rmtree(out["experiment_dir"])
    metrics = [dict(loss=r[2], grad_norm=r[3]) for r in log.records]
    secs = log.step_seconds()
    print(f"  {label}: losses {[m['loss'] for m in metrics]}, step gaps {secs}, "
          f"peak {peak:.3f} GiB ({held:.3f} held before the run)", flush=True)
    return dict(metrics=metrics, params=params, step_seconds=secs, peak_gib=peak, held_gib=held,
                launches=launches, routes=routes)


def check_gate(label: str, got: dict, want: dict, rel: float = 0.0) -> dict:
    """``got``'s metrics and parameters against ``want``'s: equal to the bit
    (``rel`` 0) or within ``rel`` relative L2 (relative error for the
    metrics)."""
    worst_param, worst_metric = 0.0, 0.0
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm"):
            worst_metric = max(worst_metric, abs(g[k] - w[k]) / max(abs(w[k]), 1e-30))
    bits = all(g == w for g, w in zip(got["metrics"], want["metrics"]))
    device = torch.device("cuda", torch.cuda.current_device())
    for k, w in want["params"].items():
        g = got["params"][k]
        if not torch.equal(g, w):  # the relative L2 on the card, a tensor at a time
            bits = False
            g, w = g.to(device, torch.float64), w.to(device, torch.float64)
            worst_param = max(worst_param, float((g - w).norm() / w.norm().clamp_min(1e-30)))
    r = dict(bit_equal=bits, worst_param_rel_l2=worst_param, worst_metric_rel=worst_metric,
             s_per_step=statistics.median(got["step_seconds"]), peak_gib=got["peak_gib"],
             held_gib=got["held_gib"], launches=got["launches"])
    print(f"  {label}: {json.dumps({k: v for k, v in r.items() if k != 'launches'})}", flush=True)
    if (rel == 0.0 and not bits) or worst_param > rel or worst_metric > rel:
        raise AssertionError(f"{label}: against the plain trainer {r}, tolerance {rel}")
    return r


def dist_sample(device, out: str) -> dict:
    """``sample_many.main`` at DDIM-50, batch 2, four videos, to latents."""
    cfg = load_config(FFS_CONFIG, ["sample_method=ddim", f"num_sampling_steps={BC_STEPS}",
                                   f"per_proc_batch_size={MANY_BATCH}", "num_fvd_samples=4",
                                   f"save_video_path={out}"])
    reset_counts()
    t0 = time.perf_counter()
    sample_many.main(cfg, device=str(device))
    secs = time.perf_counter() - t0
    return dict(seconds=secs, launches=counts(),
                latents={f: np.load(os.path.join(out, f))["latents"] for f in sorted(os.listdir(out))})


def dist_worker(rank: int, world: int, port: int, tmp: str, smi: str) -> None:
    """One rank of phase "dist" (see the module docstring); writes its
    results to ``tmp/dist.<rank>.json``."""
    from latte_tpu_torch.dist.mesh import initialize_distributed

    build.load_library()
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    res = dict(rank=rank, world=world, device=f"{device} {torch.cuda.get_device_name(device)}")
    ffs, moe_cfg = [f"max_train_steps={DIST_STEPS}"], ["expert_parallel=1", f"max_train_steps={DIST_MOE_STEPS}"]
    plain = {}
    if world == 1:
        # the plain trainer and the one-process sampler, before any process group
        plain["ffs"] = gate_run(FFS_TRAIN, ffs, tmp, "ffs_train plain")
        plain["moe"] = gate_run(MOE_TRAIN, moe_cfg, tmp, "ffs_train_moe plain")
        plain["sample"] = dist_sample(device, os.path.join(tmp, "many_plain"))
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    initialize_distributed()
    backend = torch.distributed.get_backend()
    res["backend"] = backend
    print(f"  rank {rank} of {world}: {res['device']}, backend {backend}", flush=True)
    if backend != "nccl":
        raise AssertionError(f"rank {rank}: the process group's backend is {backend}, not nccl")
    if world == 1:
        # the same runs over the group: DDP, ZeRO-1 and FSDP
        gates = {}
        # DDP through the (dp, ep, sp, tp) mesh with tp and sp named at 1
        gates["ddp"] = check_gate("ffs_train ddp, tensor_parallel=1 sequence_parallel=1, world 1",
                                  gate_run(FFS_TRAIN, ffs + ["tensor_parallel=1", "sequence_parallel=1"], tmp, "ddp"),
                                  plain["ffs"])
        gates["zero1"] = check_gate("ffs_train zero1, world 1", gate_run(FFS_TRAIN, ffs + ["zero1=true"], tmp,
                                                                          "zero1"), plain["ffs"])
        gates["fsdp"] = check_gate("ffs_train fsdp, world 1", gate_run(FFS_TRAIN, ffs + ["fsdp=true"], tmp,
                                                                        "fsdp"), plain["ffs"], DIST_REL)
        gates["plain"] = dict(s_per_step=statistics.median(plain["ffs"]["step_seconds"]),
                              peak_gib=plain["ffs"]["peak_gib"], held_gib=plain["ffs"]["held_gib"])
        moe_fsdp = gate_run(MOE_TRAIN, moe_cfg + ["fsdp=true"], tmp, "ffs_train_moe fsdp")
        gates["moe_fsdp"] = check_gate("ffs_train_moe fsdp, world 1", moe_fsdp, plain["moe"], DIST_REL)
        gates["moe_plain"] = dict(s_per_step=statistics.median(plain["moe"]["step_seconds"]),
                                  peak_gib=plain["moe"]["peak_gib"], held_gib=plain["moe"]["held_gib"])
        del moe_fsdp
        plain["ffs"]["params"] = plain["moe"]["params"] = None
        res["gates"] = gates
        got = dist_sample(device, os.path.join(tmp, "many_dist"))
        want = plain.pop("sample")
        same = sorted(got["latents"]) == sorted(want["latents"]) and all(
            np.array_equal(got["latents"][f], want["latents"][f]) for f in want["latents"])
        res["sample_many"] = dict(bit_equal=same, files=sorted(got["latents"]), seconds=got["seconds"],
                                  plain_seconds=want["seconds"], launches=got["launches"])
        print(f"  sample_many world 1 against one process: bit-equal {same}, {got['seconds']:.3f} s "
              f"(one process {want['seconds']:.3f} s)", flush=True)
        if not same:
            raise AssertionError("sample_many over NCCL at world 1 wrote other latents than one process")
    # the main path: train.main on ffs_train.yaml over this process group
    # (world 1: DDP; world 4: dp 4), its launches, s/step, peak memory, one
    # profiled step's NCCL kernels and the full checkpoint's gather and write
    # (name, config, overrides, checkpoint written, launches a rank against one GPU's step)
    runs = [("ffs_train", FFS_TRAIN, [], True, 1.0)]
    if world >= 4:
        seeded = f"pretrained={seeded_xl(tmp)}"
        # dp 4 from one_gpu_refs' seeded weights, held to one GPU's batch of 20
        runs = [("ffs_train", FFS_TRAIN, [seeded], True, 1.0),
                ("ffs_train_moe", MOE_TRAIN, [], False, 1.0)]  # as shipped: dp 1 x ep 4
        # tensor and sequence parallelism at dp 1: the global batch of 5 is one
        # GPU's; from one_gpu_refs' seeded weights, as its one-GPU run
        runs += [("ffs_train_tp4", FFS_TRAIN, ["tensor_parallel=4", seeded], False, 1.0),
                 ("ffs_train_sp4", FFS_TRAIN, ["sequence_parallel=4", seeded], False, 1.0),
                 # pipeline parallelism at dp 2: each rank its stage's 14 blocks over PP_MICRO
                 # microbatches of a row; its checkpoint gathered over dp and pp
                 ("ffs_train_dp2_pp2", FFS_TRAIN, ["pipeline_parallel=2", f"pp_microbatches={PP_MICRO}", seeded],
                  True, PP_MICRO / 2)]
    # CHIP_SMOKE_DIST_RUNS (names, comma-separated) runs a subset, for a 4-GPU call
    # that measures one slice's runs alone; unset, all of them
    only = os.environ.get("CHIP_SMOKE_DIST_RUNS")
    if only:
        runs = [r for r in runs if r[0] in only.split(",")]
    res["train"] = {}
    for name, path, extra, write_ckpt, factor in runs:
        log = StepLog(profile_after=DIST_STEPS - 1)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device) / 2**30
        reset_counts()
        # the tp, sp and MoE runs write no checkpoint (the dp and pp runs gather one)
        with contextlib.nullcontext() if write_ckpt else NoCheckpoints():
            out = train.main(load_config(path, [f"results_dir={tmp}/results_{name}", f"max_train_steps={DIST_STEPS}",
                                                "log_every=1", f"ckpt_every={DIST_STEPS}", *extra]), callbacks=[log])
        torch.cuda.synchronize(device)
        launches = counts()
        routes = check_routes(f"rank {rank} {name}", launches,
                              {k: round(DIST_STEPS * c * factor) for k, c in STEP_LAUNCHES.items()})
        t_end = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        secs = log.step_seconds()
        nccl = nccl_kernels(log.prof)
        if out["final_step"] != DIST_STEPS or not log.finite():
            raise AssertionError(f"rank {rank} {name}: the run failed: {out}, {log.records}")
        ckpt = os.path.join(out["experiment_dir"], "checkpoints", f"{DIST_STEPS:07d}.pt")
        res["train"][name] = dict(
            launches=launches, routes=routes, step_seconds=secs, peak_gib=peak, held_gib=held,
            nccl_profiled_step=nccl,
            losses=[r[2] for r in log.records], grad_norms=[r[3] for r in log.records],
            checkpoint_seconds=t_end - log.records[-1][1] if write_ckpt else None,
            checkpoint_gib=os.path.getsize(ckpt) / 2**30 if rank == 0 and write_ckpt else None,
            checkpoint_keys=hashlib.sha1("\n".join(sorted(torch.load(ckpt, mmap=True, weights_only=True)["model"]))
                                         .encode()).hexdigest() if rank == 0 and write_ckpt else None,
            profile_ms=print_profile(f"rank {rank} {name} step {DIST_STEPS}", log.prof, secs[-1] * 1e3))
        log.state = None
        print(f"  rank {rank} {name} at world {world}: step gaps {secs} s, peak {peak:.3f} GiB, NCCL kernels "
              f"in the profiled step {nccl}, launches {launches}", flush=True)
        torch.distributed.barrier(device_ids=[rank])
        if rank == 0:
            shutil.rmtree(out["experiment_dir"])
    if world >= 4 and {"ffs_train_tp4", "ffs_train_sp4"} <= set(res["train"]):
        res["tp_sp"] = tp_sp_gates(res["train"], tmp, rank, device)
    if world >= 4 and {"ffs_train", "ffs_train_dp2_pp2"} <= set(res["train"]):
        res["pp"] = pp_gates(res["train"], tmp, rank, device)
    with open(os.path.join(tmp, f"dist.{rank}.json"), "w") as f:
        json.dump(res, f, default=str)
    torch.distributed.destroy_process_group()


# the tp and sp runs' first losses and grad norms against one GPU's (fp32: the
# row-parallel sums and the relayouts' gradients run in another order)
TP_SP_REL = 1e-4


def seeded_xl(tmp: str) -> str:
    """The path of Latte-XL/2's weights from ``randomize_`` (seed 0) under
    ``tmp``: the 4-GPU tp and sp runs' ``pretrained`` (the reference init's
    zero adaLN gates would leave the blocks out of the first losses) and the
    DDIM-50's ``ckpt``."""
    return os.path.join(tmp, "seeded_xl.pt")


def one_gpu_refs(tmp: str, smi: str) -> None:
    """For phase "dist" at 4 GPUs, before the ranks start: Latte-XL/2's
    seeded weights (``seeded_xl``), ffs_train.yaml's DIST_STEPS steps from
    them on one GPU (``gate_run``) at its batch of 5, at 20 and at 10, a
    bf16 DDIM-50 of them through ``sample.main`` and t2v_sample.yaml's
    DDIM-10 latents through ``sample_t2x.main``, written under ``tmp`` for
    the ranks to hold the tp, sp, dp and pp runs to."""
    from latte_tpu_torch.sample import sample_t2x

    with torch.device("cuda", 0):
        model = get_model("Latte-XL/2", input_size=32, num_frames=FRAMES)
    randomize_(model, seed=0)
    ckpt = seeded_xl(tmp)
    torch.save({"ema": model.state_dict()}, ckpt)
    del model
    ref = gate_run(FFS_TRAIN, [f"max_train_steps={DIST_STEPS}", f"pretrained={ckpt}"], tmp, "ffs_train one GPU")
    cfg = load_config(FFS_CONFIG, ["sample_method=ddim", f"num_sampling_steps={BC_STEPS}", f"ckpt={ckpt}",
                                   f"save_video_path={tmp}/one_gpu_ddim/v.mp4"])
    reset_counts()
    t0 = time.perf_counter()
    lat = np.load(sample.main(cfg))["latents"]
    secs = time.perf_counter() - t0
    # the dp 4 and dp 2 x pp 2 runs' global batches on one GPU, one chunk each:
    # their t and noise drawn for the whole batch at once, as the ranks draw them
    big = {n: gate_run(FFS_TRAIN, [f"max_train_steps={DIST_STEPS}", f"pretrained={ckpt}", f"local_batch_size={n}"],
                       tmp, f"ffs_train one GPU, batch {n}") for n in (4 * TRAIN_BATCH, 2 * TRAIN_BATCH)}
    # t2v_sample.yaml at DDIM-10 to latents (the stub encoder, three prompts)
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    t2v = sample_t2x.main(load_config(T2V_CONFIG, [f"num_sampling_steps={PP_T2V_STEPS}",
                                                   f"save_video_path={tmp}/one_gpu_t2v"]))
    with open(os.path.join(tmp, "one_gpu.json"), "w") as f:
        json.dump(dict(metrics=ref["metrics"], step_seconds=ref["step_seconds"], peak_gib=ref["peak_gib"],
                       ddim_seconds=secs, ckpt=ckpt, device=smi,
                       big={n: dict(metrics=r["metrics"], step_seconds=r["step_seconds"], peak_gib=r["peak_gib"])
                            for n, r in big.items()},
                       t2v_latents_s=[r["latents_s"] for r in t2v]), f)
    np.save(os.path.join(tmp, "one_gpu_ddim.npy"), lat)
    np.save(os.path.join(tmp, "one_gpu_t2v.npy"), np.stack([r["latents"].numpy() for r in t2v]))
    print(f"  one-GPU references: ffs_train losses {[m['loss'] for m in ref['metrics']]}, DDIM-50 {secs:.3f} s",
          flush=True)


def tp_sp_gates(train_runs: dict, tmp: str, rank: int, device) -> dict:
    """At 4 GPUs: the tp 4 and sp 4 runs' losses and grad norms against the
    one-GPU run's (within TP_SP_REL), then a bf16 DDIM-50 of the same
    Latte-XL/2 weights at ``tensor_parallel=4`` through ``sample.main``
    against the one-GPU latents (finite, cosine >= 0.99, phase 5's gate),
    its seconds and launches."""
    with open(os.path.join(tmp, "one_gpu.json")) as f:
        one = json.load(f)
    out = {}
    for name in ("ffs_train_tp4", "ffs_train_sp4"):
        got = train_runs[name]
        rel = [max(abs(a - m[k]) / abs(m[k]) for a, k in ((got["losses"][i], "loss"),
                                                         (got["grad_norms"][i], "grad_norm")))
               for i, m in enumerate(one["metrics"])]
        out[name] = dict(rel=rel, losses=got["losses"], one_gpu_losses=[m["loss"] for m in one["metrics"]],
                         grad_norms=got["grad_norms"], one_gpu_grad_norms=[m["grad_norm"] for m in one["metrics"]],
                         s_per_step=statistics.median(got["step_seconds"]),
                         one_gpu_s_per_step=statistics.median(one["step_seconds"]),
                         peak_gib=got["peak_gib"], one_gpu_peak_gib=one["peak_gib"],
                         nccl_profiled_step=got["nccl_profiled_step"])
        print(f"  rank {rank} {name} against one GPU: {json.dumps(out[name])}", flush=True)
        if max(rel) > TP_SP_REL:
            raise AssertionError(f"rank {rank} {name}: losses/grad norms {rel} apart from one GPU's (limit {TP_SP_REL})")
    cfg = load_config(FFS_CONFIG, ["sample_method=ddim", f"num_sampling_steps={BC_STEPS}", f"ckpt={one['ckpt']}",
                                   "tensor_parallel=4", f"save_video_path={tmp}/tp4_ddim/v.mp4"])
    reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    path = sample.main(cfg)
    secs = time.perf_counter() - t0
    r = dict(seconds=secs, one_gpu_seconds=one["ddim_seconds"], launches=counts(),
             peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    if rank == 0:
        lat, want = torch.from_numpy(np.load(path)["latents"]), torch.from_numpy(np.load(
            os.path.join(tmp, "one_gpu_ddim.npy")))
        r["vs_one_gpu"] = compare("tp 4 DDIM-50 latents vs one GPU's", lat, want)
        if lat.shape != want.shape or not r["vs_one_gpu"]["finite"] or r["vs_one_gpu"]["cosine"] < 0.99:
            raise AssertionError(f"the tp 4 DDIM-50 latents disagree with one GPU's: {r['vs_one_gpu']}")
    if any(r["launches"][k] != DEPTH * BC_STEPS for k in FORWARD):
        raise AssertionError(f"rank {rank} tp 4 DDIM-50: launches {r['launches']}, want {DEPTH * BC_STEPS} each")
    print(f"  rank {rank} tp 4 DDIM-50: {json.dumps(r)}", flush=True)
    out["ddim50_tp4"] = r
    return out


PP_T2V_STEPS = 10  # phase "dist"'s pp 4 t2v run: t2v_sample.yaml's DDIM-50, cut for time
# the 4-GPU runs against one GPU's of the same global batch, fp32: the losses
# within DIST_REL, the grad norms within PP_GNORM_REL (the dp average and the
# microbatches' sums of the weight gradients run in another order)
PP_GNORM_REL = 1e-5


def pp_gates(train_runs: dict, tmp: str, rank: int, device) -> dict:
    """At 4 GPUs: the dp 4 run's and the dp 2 x pp 2 run's losses and grad
    norms against one GPU's on their global batches of 20 and 10 (one chunk,
    the same draws; ``one_gpu_refs``), the pp run's checkpoint in the
    one-process layout (the dp run's keys), then t2v_sample.yaml at
    ``pipeline_parallel=4`` and DDIM-10 through ``sample_t2x.main`` against
    one GPU's latents (finite, within BF16_TOL of the largest magnitude),
    its s a video and launches."""
    from latte_tpu_torch.sample import sample_t2x

    with open(os.path.join(tmp, "one_gpu.json")) as f:
        one = json.load(f)
    out = {}
    for name, n in (("ffs_train", 4 * TRAIN_BATCH), ("ffs_train_dp2_pp2", 2 * TRAIN_BATCH)):
        got, want = train_runs[name], one["big"][str(n)]
        loss_rel = [abs(a - m["loss"]) / abs(m["loss"]) for a, m in zip(got["losses"], want["metrics"])]
        gnorm_rel = [abs(a - m["grad_norm"]) / abs(m["grad_norm"]) for a, m in zip(got["grad_norms"], want["metrics"])]
        out[name] = dict(global_batch=n, loss_rel=loss_rel, grad_norm_rel=gnorm_rel, losses=got["losses"],
                         one_gpu_losses=[m["loss"] for m in want["metrics"]],
                         s_per_step=statistics.median(got["step_seconds"]),
                         one_gpu_s_per_step=statistics.median(want["step_seconds"]), peak_gib=got["peak_gib"],
                         one_gpu_peak_gib=want["peak_gib"], nccl_profiled_step=got["nccl_profiled_step"])
        print(f"  rank {rank} {name} against one GPU's batch of {n}: {json.dumps(out[name])}", flush=True)
        if len(loss_rel) != DIST_STEPS or max(loss_rel) > DIST_REL or max(gnorm_rel) > PP_GNORM_REL:
            raise AssertionError(f"rank {rank} {name}: against one GPU's batch of {n}: {out[name]}")
    if rank == 0 and train_runs["ffs_train_dp2_pp2"]["checkpoint_keys"] != train_runs["ffs_train"]["checkpoint_keys"]:
        raise AssertionError("the pp run's checkpoint is not in the one-process layout")
    reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    records = sample_t2x.main(load_config(T2V_CONFIG, [f"num_sampling_steps={PP_T2V_STEPS}", "pipeline_parallel=4",
                                                       f"save_video_path={tmp}/pp4_t2v"]))
    r = dict(launches=counts(), latents_s=[rec["latents_s"] for rec in records],
             one_gpu_latents_s=one["t2v_latents_s"], peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    r["s_per_video"] = statistics.median(r["latents_s"][1:])
    r["one_gpu_s_per_video"] = statistics.median(r["one_gpu_latents_s"][1:])
    want = torch.from_numpy(np.load(os.path.join(tmp, "one_gpu_t2v.npy")))
    got = torch.stack([rec["latents"] for rec in records])
    r["max_err_over_max"] = float((got - want).abs().max() / want.abs().max())
    r["vs_one_gpu"] = compare(f"rank {rank} pp 4 t2v DDIM-{PP_T2V_STEPS} latents vs one GPU's", got, want)
    pairs = 28 // 4  # each rank's pairs; norm_out runs on every rank
    per = {"flash_attention": 2 * pairs * 2, "ln_modulate": 2 * pairs * 2 + 1, "residual_ln_modulate": 2 * pairs * 2}
    expect = {k: len(records) * PP_T2V_STEPS * per.get(k, 0) for k in KERNELS}
    print(f"  rank {rank} pp 4 t2v DDIM-{PP_T2V_STEPS}: {json.dumps(r)}", flush=True)
    if not r["vs_one_gpu"]["finite"] or r["max_err_over_max"] > BF16_TOL or r["launches"] != expect:
        raise AssertionError(f"rank {rank} pp 4 t2v: {r}, launches wanted {expect}")
    check_tc(f"rank {rank} pp 4 t2v", expect["flash_attention"])
    check_vec(f"rank {rank} pp 4 t2v")
    out["t2v_pp4"] = r
    return out


def dist_phase(tmp: str, smi: str) -> dict:
    """Phase 10 "dist": ``dist_worker`` in DIST_WORLD processes, one a GPU,
    spawned from here; any rank's failure fails the phase. Returns every
    rank's results."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    print(f"  world size {DIST_WORLD} (NCCL, one process a GPU) on {smi}", flush=True)
    if DIST_WORLD >= 4:
        one_gpu_refs(tmp, smi)
    mp.spawn(dist_worker, args=(DIST_WORLD, port, tmp, smi), nprocs=DIST_WORLD, join=True)
    ranks = []
    for r in range(DIST_WORLD):
        with open(os.path.join(tmp, f"dist.{r}.json")) as f:
            ranks.append(json.load(f))
    return dict(world=DIST_WORLD, device=smi, ranks=ranks)



def tp_sp_launches(name: str, ring: dict, vtp: dict, dist: dict) -> dict:
    """A kernel's launches (all routes) in this slice's runs: ``launches_ring``
    in each virtual-ring case, ``launches_tp`` in the virtual tp pair and,
    per rank, in the 4-GPU tp 4 training and DDIM-50, ``launches_sp`` per
    rank in the 4-GPU sp 4 training; both with the world-1 DDP run over the
    (dp, ep, sp, tp) mesh at tp = sp = 1 where the machine has one GPU."""
    ranks = dist["ranks"]
    tp = {"virtual_tp4_pair": vtp["launches"][name]}
    sp = {}
    if dist["world"] == 1:
        tp["world1_tp1_sp1_ddp"] = sp["world1_tp1_sp1_ddp"] = ranks[0]["gates"]["ddp"]["launches"][name]
    elif dist["world"] >= 4:
        for r in ranks:
            tp[f"tp4_train_rank{r['rank']}"] = r["train"]["ffs_train_tp4"]["launches"][name]
            tp[f"tp4_ddim50_rank{r['rank']}"] = r["tp_sp"]["ddim50_tp4"]["launches"][name]
            sp[f"sp4_train_rank{r['rank']}"] = r["train"]["ffs_train_sp4"]["launches"][name]
    return dict(launches_ring={case: c["ring_launches"].get(name, 0) for case, c in ring["cases"].items()},
                launches_tp=tp, launches_sp=sp)


def pp_launches(name: str, pp_run: dict, dist: dict) -> dict:
    """A kernel's launches (all routes) in pipeline parallelism's runs: the
    virtual pipeline's fp32 train step and t2v CFG forward (phase "pp one
    card") and, per rank at 4 GPUs, the dp 2 x pp 2 training and the pp 4
    t2v DDIM-10."""
    out = {"virtual_pp_train_step": pp_run["train"]["virtual_pp"]["launches"][name],
           "virtual_pp_t2v_forward": pp_run["t2v"]["launches"][name]}
    if dist["world"] >= 4:
        for r in dist["ranks"]:
            out[f"dp2_pp2_train_rank{r['rank']}"] = r["train"]["ffs_train_dp2_pp2"]["launches"][name]
            out[f"pp4_t2v_ddim10_rank{r['rank']}"] = r["pp"]["t2v_pp4"]["launches"][name]
    return out


def kernel_row(name: str, source: str, replaces: str, launches: int, row: dict, **extra) -> dict:
    """One kernel's entry of the JSON line: its main-path launches and its
    measurements at the main path's shape (``row``)."""
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=row["max_abs_err"], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        library_ms=row["library_ms"], device_ms=row["device_ms"],
        library_device_ms=row["library_device_ms"], **extra,
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    device = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} (count {count}); torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    import cv2  # the sampler's mp4 writer

    print(f"  cv2 {cv2.__version__}", flush=True)
    phase("device", t0)

    t0 = time.perf_counter()
    path = build.build()
    build.load_library()
    print(f"  library {path.name}, built in {time.perf_counter() - t0:.2f} s", flush=True)
    mma = report_build(path)
    phase("build", t0)

    t0 = time.perf_counter()
    timer = Timer(device)
    measured = check_kernels(device, timer)
    phase("kernels", t0)
    t0 = time.perf_counter()
    measured[INT8] = check_int8_kernel(device, timer)
    int8_fp32 = check_int8_fp32(device, timer)
    phase("int8 kernel", t0)

    # 4. one full-width forward: kernel path against plain paths
    t0 = time.perf_counter()
    arch = dict(input_size=32, num_frames=FRAMES)
    with torch.device(device):
        model = get_model("Latte-XL/2", **arch)
        plain32 = get_model("Latte-XL/2", plain=True, **arch)
    randomize_(model, seed=0)
    plain32.load_state_dict(model.state_dict())
    model.to(torch.bfloat16).eval()
    plain32.eval()
    with torch.device(device):
        plain16 = get_model("Latte-XL/2", plain=True, **arch)
    plain16.load_state_dict(model.state_dict())
    plain16.to(torch.bfloat16).eval()
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((1, FRAMES, 4, 32, 32), generator=gen, device=device)
    t = torch.tensor([500], device=device)
    with torch.inference_mode():
        model(x, t)  # warm-up: cuBLAS handles, first launches
        torch.cuda.synchronize()
        reset_counts()
        out_k = model(x, t)
        torch.cuda.synchronize()
        per_forward = counts()
        check_tc("one bf16 forward", DEPTH)
        check_vec("one bf16 forward")
        out_p16, out_p32 = plain16(x, t), plain32(x, t)
    print(f"  launches in one forward: {per_forward}", flush=True)
    if any(per_forward[k] != DEPTH for k in FORWARD) or any(per_forward[k] for k in (*BACKWARD, INT8)):
        raise AssertionError(f"expected {DEPTH} launches of each forward kernel, got {per_forward}")
    if out_k.shape != (1, FRAMES, 8, 32, 32):
        raise AssertionError(f"forward shape {tuple(out_k.shape)}")
    vs_plain = compare("kernel bf16 vs plain bf16", out_k, out_p16)
    vs32 = compare("kernel bf16 vs plain fp32", out_k, out_p32)
    plain_vs32 = compare("plain bf16 vs plain fp32", out_p16, out_p32)
    # the kernels may add no more error than bf16 itself brings
    if not (vs_plain["finite"] and vs_plain["cosine"] >= 0.999
            and vs32["rel_l2"] <= 1.25 * plain_vs32["rel_l2"] + 1e-3):
        raise AssertionError("the kernel path disagrees with the plain path")
    with torch.inference_mode():
        fwd_ms = timer.ms(lambda: model(x, t), iters=5)
        plain_fwd_ms = timer.ms(lambda: plain16(x, t), iters=5)
        adaln_ms = profile_forward(model, x, t, fwd_ms)
        # the same forward with the adaLN kernels' first versions forced
        reset_counts()
        generic_adaln_ms = forced(adaln, "adaln_route", profile_forward, model, x, t, fwd_ms,
                                  "forward, generic adaLN kernels forced", to="generic")
        forced_vec = {name: KERNELS[name]["fn"].vec_launches for name in ADALN}
    print(f"  forward ms: kernels {fwd_ms:.3f}, plain {plain_fwd_ms:.3f}; adaLN device ms "
          f"{adaln_ms:.4f}, with the generic kernels forced {generic_adaln_ms:.4f} "
          f"(vector launches there {forced_vec})", flush=True)
    if any(forced_vec.values()):
        raise AssertionError(f"the forced forward ran vector adaLN kernels: {forced_vec}")
    phase("forward", t0)

    # 7b. the same weights served in int8
    t0 = time.perf_counter()
    int8_fwd = int8_forward(device, plain32.state_dict(), x, t, out_p32, timer)
    del plain32
    torch.cuda.empty_cache()
    phase("int8 forward", t0)

    # 5. the entry point, from a checkpoint of the same random weights
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "latte_xl2_random.pt")
        torch.save({"ema": model.state_dict()}, ckpt)
        overrides = [
            "sample_method=ddim", "num_sampling_steps=50", "per_proc_batch_size=1",
            f"ckpt={ckpt}", f"save_video_path={tmp}/ffs.mp4",
        ]
        cfg = load_config(FFS_CONFIG, overrides)
        reset_counts()
        lat_path = sample.main(cfg)  # the entry point, on cuda by default
        main_launches = counts()
        main_tc = check_tc("bf16 ddim-50 entry point", DEPTH * 50)
        main_vec = check_vec("bf16 ddim-50 entry point")
        lat = torch.from_numpy(np.load(lat_path)["latents"])
        print(f"  ddim-50 latents {tuple(lat.shape)} finite={bool(torch.isfinite(lat).all())}; "
              f"launches {main_launches}", flush=True)
        if lat.shape != (1, FRAMES, 4, 32, 32) or not torch.isfinite(lat).all():
            raise AssertionError("the sampler's latents are not finite (1, 16, 4, 32, 32)")
        if any(main_launches[k] != DEPTH * 50 for k in FORWARD) or main_launches[INT8]:
            raise AssertionError(f"expected {DEPTH * 50} launches each, got {main_launches}")
        lat_bf16 = lat

        t1 = time.perf_counter()
        ref = sample.sample_latents(plain16, cfg, device)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        if not compare("ddim-50 latents, entry point vs plain path", lat, ref.cpu())["cosine"] >= 0.99:
            raise AssertionError("the DDIM latents disagree with the plain path's")
        route_s = route_runs(model, cfg, device, attention, "forward_route", flash_attention)
        kernel_s, core_s = (sorted(v)[len(v) // 2] for v in route_s.values())
        print(f"  ddim-50 batch 1: {kernel_s:.3f} s -> {60.0 / kernel_s:.3f} videos/min "
              f"(median of {route_s['tensor_core']}; with the CUDA-core attention forward "
              f"{core_s:.3f} s -> {60.0 / core_s:.3f} videos/min, median of "
              f"{route_s['cuda_core']}; plain path {plain_s:.3f} s) on {smi}", flush=True)
        exact_prof = profile_sampler(model, cfg, device, kernel_s)

        cfg = load_config(FFS_CONFIG, [
            "sample_method=ddpm", "num_sampling_steps=5", f"ckpt={ckpt}",
            f"save_video_path={tmp}/ffs_ddpm.mp4",
        ])
        reset_counts()
        lat = torch.from_numpy(np.load(sample.main(cfg))["latents"])
        ddpm_launches = counts()
        check_tc("ddpm-5", DEPTH * 5)
        check_vec("ddpm-5")
        print(f"  ddpm-5 latents finite={bool(torch.isfinite(lat).all())}; "
              f"launches {ddpm_launches}", flush=True)
        if not torch.isfinite(lat).all() or any(ddpm_launches[k] != DEPTH * 5 for k in FORWARD):
            raise AssertionError("the DDPM path failed")
        del model, plain16
        torch.cuda.empty_cache()
        phase("sampler", t0)

        # 5b. the entry point to decoded frames, and the VAE at full width
        t0 = time.perf_counter()
        vae_run = vae_phase(tmp, ckpt, lat_bf16, kernel_s, device, smi)
        phase("vae", t0)

        # 7c. the entry point in int8, from the same checkpoint
        t0 = time.perf_counter()
        int8_run = int8_sampler(tmp, ckpt, lat_bf16, kernel_s, device, smi)
        torch.cuda.empty_cache()
        phase("int8 sampler", t0)

        # 5c. block-cache sampling through the entry point, bf16 and int8
        t0 = time.perf_counter()
        bc_run = block_cache_phase(tmp, ckpt, lat_bf16, exact_prof, device, smi)
        phase("block cache", t0)

        # 5d. sample_many at batch 2, to mp4s
        t0 = time.perf_counter()
        many = sample_many_phase(tmp, ckpt, kernel_s, device, smi)
        torch.cuda.empty_cache()
        phase("sample many", t0)

        # 5f. evaluation: the detectors on the card, the metrics from 5d's files and from the sampler
        t0 = time.perf_counter()
        eval_run = eval_phase(tmp, ckpt, device, smi)
        torch.cuda.empty_cache()
        phase("eval", t0)

        # 5e. text-to-video and text-to-image serving, LatteT2V at full width
        t0 = time.perf_counter()
        t2v_run = t2v_phase(tmp, smi, device, timer)
        torch.cuda.empty_cache()
        phase("t2v", t0)

    # 6. training
    t0 = time.perf_counter()
    parity = train_step_parity(device)
    torch.cuda.empty_cache()
    phase("train parity", t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        entry = train_entry_point(tmp, smi)
        torch.cuda.empty_cache()
        phase("train entry point", t0)
        t0 = time.perf_counter()
        mixed = train_mixed_precision(tmp, smi)
        phase("train mixed precision", t0)
        t0 = time.perf_counter()
        quant = train_quant(tmp, smi)
        torch.cuda.empty_cache()
        phase("train int8", t0)
        t0 = time.perf_counter()
        pixel = pixel_train(tmp, smi, device)
        phase("pixel train", t0)
        t0 = time.perf_counter()
        more = train_more(tmp, smi, device)
    phase("train more", t0)

    # 8. Mixture-of-Experts: gradients, training, Latte and T2V serving
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        moe = moe_phase(tmp, smi, device, timer)
    torch.cuda.empty_cache()
    phase("moe", t0)
    print("train: " + json.dumps(dict(parity=parity, entry_point=entry, mixed_precision=mixed,
                                      quant_train=quant), default=str), flush=True)
    print("pixel_train: " + json.dumps(pixel, default=str), flush=True)
    print("train_more: " + json.dumps(more, default=str), flush=True)
    print("int8: " + json.dumps(dict(kernel_fp32=int8_fp32, forward=int8_fwd, sampler=int8_run),
                                default=str), flush=True)

    print("vae: " + json.dumps(vae_run, default=str), flush=True)
    print("block_cache: " + json.dumps(bc_run, default=str), flush=True)
    print("sample_many: " + json.dumps(many, default=str), flush=True)
    print("eval: " + json.dumps(eval_run, default=str), flush=True)
    print("t2v: " + json.dumps(t2v_run, default=str), flush=True)
    print("moe: " + json.dumps(moe, default=str), flush=True)

    # 9. text: T5-XXL through sample_t2x, the SVD temporal decoder, CLIP and extras: 78
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        text = text_phase(tmp, smi, device, timer)
    torch.cuda.empty_cache()
    phase("text", t0)
    print("text: " + json.dumps(text, default=str), flush=True)

    # 10a. tensor parallelism and ring attention on the one card
    t0 = time.perf_counter()
    ring = virtual_ring(device, timer)
    vtp = virtual_tp(device)
    torch.cuda.empty_cache()
    phase("tp/sp one card", t0)
    print("tp_sp: " + json.dumps(dict(ring=ring, tp=vtp, device=smi), default=str), flush=True)

    # 10b. pipeline parallelism on the one card: the virtual pipeline at full width
    t0 = time.perf_counter()
    pp_run = pp_one_card(device, smi, timer)
    phase("pp one card", t0)
    print("pp: " + json.dumps(pp_run, default=str), flush=True)

    # 10. multi-GPU training and sampling over NCCL, one process a GPU
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist = dist_phase(tmp, smi)
    phase("dist", t0)
    print("dist: " + json.dumps(dist, default=str), flush=True)
    # each kernel's launches on each rank in the phase's train.main run (ffs_train)
    dist_launches = {name: {f"rank{r['rank']}": r["train"]["ffs_train"]["launches"][name] for r in dist["ranks"]}
                     for name in KERNELS}

    # each kernel's launches in the runs of phase "train more"
    more_launches = {name: {run: more[run]["launches"][name] for run in (
        "ucf101_train", "ucf101_mixed", "ffs_img_train", "ucf101_img_train")} for name in KERNELS}
    # and in phase "moe": 6 ffs_train_moe steps, the MoE DDIM-50, the MoE T2V DDIM-10
    moe_launches = {name: dict(train=moe["train"]["launches"][name], latte_ddim50=moe["latte"]["launches"][name],
                               t2v_ddim10=moe["t2v"]["launches"][name]) for name in KERNELS}
    # and in phase "text": T2V with T5-XXL (three DDIM-10 videos), the extras: 78
    # forward and its 3 ffs_train steps
    text_launches = {name: dict(t5_t2v_ddim10=text["t5"]["launches"][name],
                                extras78_forward=text["extras78"]["forward_launches"][name],
                                extras78_train=text["extras78"]["train"]["launches"][name]) for name in KERNELS}
    kernels = []
    for name, k in KERNELS.items():
        if name == INT8:  # the int8 sampler's path (bf16, batch 1, flash route, pv_int8)
            row = measured[name]["spatial_pv_int8"]
            extra = dict(shape="spatial bf16 batch 1, pv_int8, flash scale block",
                         sdpa_bf16_ms=row["sdpa_bf16_ms"], tc_launches=int8_run["tc_launches"],
                         launches_forward=int8_fwd["launches"][name], sass_mma=mma,
                         cuda_core_ms=row["cuda_core_ms"], cuda_core_device_ms=row["cuda_core_device_ms"],
                         cases={c: {f: r.get(f) for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                          "bound_by", "max_abs_err", "sdpa_bf16_ms",
                                                          "route", "cuda_core_device_ms")}
                                for c, r in measured[name].items() if c.endswith("_pv_int8")},
                         ddim_pairs=dict(pairs=int8_run["pairs"], pairs_won=int8_run["pairs_won"],
                                         videos_per_min=int8_run["pair_videos_per_min"]),
                         launches_block_cache=bc_run["int8"]["int8_flash"]["launches"][name])
            launches = int8_run["launches"][name]
        elif name in FORWARD:  # the sampler's path, at its shapes (bf16, batch 1)
            row, extra = measured[name]["spatial"], dict(
                shape="spatial bf16 batch 1", launches_train=entry["launches"][name],
                temporal=measured[name]["temporal"], launches_block_cache=bc_run["launches"][name],
                launches_t2v=t2v_run["launches"][name], launches_t2i=t2v_run["t2i"]["launches"][name],
                launches_t2v_block_cache=t2v_run["block_cache"]["launches"][name])
            launches = main_launches[name]
            if name == "flash_attention":
                extra.update(
                    tc_launches=main_tc, fp32_source=F32_FWD_SOURCE, t2v=t2v_run["b1"],
                    cuda_core_source="latte_tpu_torch/csrc/flash_attention.cu", sass_mma=mma,
                    cases={c: measured[name][c] for c in FLASH_SHAPES})
            else:  # the vector route; the generic kernels (first versions) timed beside it
                extra.update(
                    vec_launches=main_vec[name], launches_train_vec=entry["vec_launches"][name],
                    generic_ms=row["generic_ms"], generic_device_ms=row["generic_device_ms"],
                    copy_device_ms=row["copy_device_ms"],
                    timer_floor_device_ms=measured["floor_device_ms"],
                    forward_adaln_ms=dict(vector=adaln_ms, generic=generic_adaln_ms),
                    cases={c: measured[name][c] for c in ADALN_SHAPES})
        else:  # the mixed-precision trainer's path, at its shapes (bf16, batch 5)
            row, extra = measured[name]["spatial_b5"], dict(
                shape="spatial bf16 batch 5", tc_launches=mixed["tc_launches"][name],
                fp32_source=F32_SOURCE, cuda_core_source="latte_tpu_torch/csrc/flash_attention_bwd.cu",
                sass_mma=mma, launches_fp32_train=entry["launches"][name],
                cases={c: measured[name][c] for c in BWD_SHAPES if c != "spatial_b5"})
            launches = mixed["launches"][name]
        kernels.append(kernel_row(name, k["source"], k["replaces"], launches, row,
                                  launches_train_more=more_launches[name], launches_moe=moe_launches[name],
                                  launches_text=text_launches[name], launches_dist=dist_launches[name], **extra))
    # the fp32 trainer's path, at its shapes (fp32, batch 5)
    fwd32 = measured["flash_attention"]
    kernels.append(kernel_row(
        "flash_attention_f32", F32_FWD_SOURCE, KERNELS["flash_attention"]["replaces"],
        entry["fwd_f32_launches"], fwd32["spatial_b5_fp32"], shape="spatial fp32 batch 5",
        temporal=fwd32["temporal_b5_fp32"], cases={c: fwd32[c] for c in FLASH_FP32_SHAPES},
        train_pairs=entry["forward_pairs"], launches_train_more=more_launches["flash_attention"],
        launches_moe_train=moe["train"]["launches"]["flash_attention"],
        launches_text_train=text["extras78"]["train"]["launches"]["flash_attention"],
        launches_dist=dist_launches["flash_attention"],
        img=dict(spatial=fwd32["spatial_img_fp32"], temporal=fwd32["temporal_img_fp32"])))
    for name in BACKWARD:
        kernels.append(kernel_row(
            f"{name}_f32", F32_SOURCE, KERNELS[name]["replaces"], entry["f32_launches"][name],
            measured[name]["spatial_b5_fp32"], shape="spatial fp32 batch 5",
            temporal=measured[name]["temporal_b5_fp32"],
            cases={c: measured[name][c] for c in BWD_SHAPES if BWD_SHAPES[c][2] == torch.float32},
            train_pairs=dict(pairs=entry["pairs"], pair_median_s=entry["pair_median_s"],
                             pairs_won=entry["pairs_won"]), launches_train_more=more_launches[name],
            launches_moe_train=moe["train"]["launches"][name],
            launches_text_train=text["extras78"]["train"]["launches"][name], launches_dist=dist_launches[name]))
    # the "qk" mode (int8_attention: qk under attention_mode: auto, the fused
    # rule), on the same source's "qk" kernels
    qk, qk_cases = int8_run["qk"], {c: r for c, r in measured[INT8].items() if c.endswith("_qk")}
    row = qk_cases["spatial_fused_qk"]
    kernels.append(kernel_row(
        f"{INT8}_qk", KERNELS[INT8]["source"], KERNELS[INT8]["replaces"], qk["launches"][INT8], row,
        shape="spatial bf16 batch 1, qk mode, fused rule", tc_launches=qk["tc_launches"],
        temporal=qk_cases["temporal_fused_qk"], sdpa_bf16_ms=row["sdpa_bf16_ms"],
        cuda_core_source="latte_tpu_torch/csrc/flash_attention_int8.cu",
        cuda_core_ms=row["cuda_core_ms"], cuda_core_device_ms=row["cuda_core_device_ms"],
        cases=qk_cases, fp32=int8_fp32["qk_times"],
        ddim_pairs=dict(pairs=qk["pairs"], pairs_won=qk["pairs_won"],
                        videos_per_min=qk["pair_videos_per_min"]),
        launches_block_cache=bc_run["int8"]["int8_qk"]["launches"][INT8], launches_moe=moe_launches[INT8],
        launches_text=text_launches[INT8], launches_dist=dist_launches[INT8]))
    for row in kernels:
        name = row["name"].removesuffix("_f32").removesuffix("_qk")
        row.update(tp_sp_launches(name, ring, vtp, dist))
        row["launches_pp"] = pp_launches(name, pp_run, dist)
        row["launches_eval"] = eval_run["launches"][row["name"]]
    print(f"total: {time.perf_counter() - t_all:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
