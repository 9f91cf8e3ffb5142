"""The training step (port of ``latte_tpu/train/step.py``), on one device or
on each rank of a (dp, ep, sp, tp, pp) mesh.

[VAE encode of a pixel batch ->] q_sample -> model forward (``train=True``:
class labels dropped to the null class at the model's dropout rate) ->
hybrid MSE + VB loss -> backward [-> the next chunk under gradient
accumulation] -> global grad norm (always reported) -> clipping once
``step >= start_clip_iter`` -> AdamW -> EMA every ``ema_every`` steps at
``decay**ema_every``.

Only the parameters that require a gradient train: ``fixed_spatial`` freezes
all but the temporal attention's (``train.state.trainable_temporal_attn_mask``),
so the norm, the clipping and AdamW see those alone, as the JAX step's zeroed
gradients leave the others unchanged.

A Mixture-of-Experts model adds the Switch load-balancing loss at
``moe_aux_weight`` (> 0): the forward hands out its blocks' losses
(``return_aux``), and ``aux`` is the mean over each block column (spatial,
temporal) of its blocks' losses, then over the columns, as the JAX step
averages its sown leaves; ``metrics["moe_aux"]`` reports it (under gradient
accumulation the mean over the chunks).

The step leaves its metrics on the device: it never waits for the host, so
the loop syncs only when it logs.

Over several ranks (``shards``, a :class:`~latte_tpu_torch.dist.sharding.
ShardedParams`) each rank holds the rows of its dp index of the global batch
(``local_batch_size·dp`` rows; the ranks of an ep, sp or tp group hold the
same rows, and the model splits them over sp), and the step is the
one-process step on that global batch: t, the noise, the posterior sample
and the label dropout are drawn for the global batch from the shared
generator and each rank takes its rows; the gradients are averaged over the
ranks that share a parameter, the norm is the full gradient's, and the
metrics are the global batch's means (all-reduced on the device, without a
host sync).

Under pipeline parallelism the step takes the pipelined forward
(``apply_fn``, ``dist.pipeline.make_pipelined_apply``; the JAX step's
``apply_fn``): every stage of a dp row draws from the same generator in the
same order as one process (posterior, t, noise, label dropout), runs the
forward whose output every stage holds, and takes the same loss; the
backward runs the schedule in reverse, and ``ShardedParams`` sums each
non-block gradient over the stages.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from latte_tpu_torch.core.diffusion import GaussianDiffusion
from latte_tpu_torch.train.state import TrainState, update_ema

__all__ = ["dequantize_video", "global_norm", "make_train_step"]

Batch = Dict[str, torch.Tensor]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32. On the CPU each
    tensor's sum accumulates in fp64: the CPU's fp32 norm sums long runs in
    fp32, 3e-4 off for the 8.5 M-element gradient of ``extras: 78``'s
    projection at hidden 144, where the card's and XLA's tree reductions
    are not."""
    tensors = list(tensors)
    if tensors and tensors[0].device.type == "cpu":
        norms = [torch.linalg.vector_norm(t, dtype=torch.float64) for t in tensors]
        return torch.linalg.vector_norm(torch.stack(norms)).float()
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def dequantize_video(video: torch.Tensor) -> torch.Tensor:
    """uint8 transport -> fp32 [-1, 1] on the device (the inverse of
    ``data.loader.quantize_video_u8``); another dtype passes through."""
    if video.dtype == torch.uint8:
        return video.float() / 127.5 - 1.0
    return video


class Draws:
    """Random draws of a batch whose rows are block ``index`` of ``parts``
    equal blocks of a global batch: each draw is taken for the global batch
    (leading axis times ``parts``) and cut to this block, so that every
    split of a batch draws what one process draws for the whole. One part
    draws directly."""

    def __init__(self, parts: int = 1, index: int = 0):
        self.parts, self.index = parts, index

    def _rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        return t if self.parts == 1 else t[self.index * n : (self.index + 1) * n]

    def randn(self, shape, generator, device, dtype=torch.float32) -> torch.Tensor:
        full = (shape[0] * self.parts,) + tuple(shape[1:])
        return self._rows(torch.randn(full, generator=generator, device=device, dtype=dtype), shape[0])

    def randint(self, high: int, n: int, generator, device) -> torch.Tensor:
        return self._rows(torch.randint(0, high, (n * self.parts,), generator=generator, device=device), n)

    def rand(self, shape, generator, device) -> torch.Tensor:
        full = (shape[0] * self.parts,) + tuple(shape[1:])
        return self._rows(torch.rand(full, generator=generator, device=device), shape[0])


def _latents(
    batch: Batch, generator: torch.Generator, vae_scale: float, encode_fn: Optional[Callable] = None,
    draws: Draws = Draws(),
) -> torch.Tensor:
    if "video" in batch:
        # pixels: the frozen VAE's encode and a posterior sample, scaled
        if encode_fn is None:
            raise ValueError("the batch holds pixels (\"video\") but the step has no encode_fn")
        if draws.parts > 1:
            return encode_fn(dequantize_video(batch["video"]), generator, draws=draws)
        return encode_fn(dequantize_video(batch["video"]), generator)
    if "latent_mean" not in batch:
        return batch["latents"]
    # latent cache: a fresh posterior sample from the cached moments each
    # step, drawn on the frame-flattened (B·F, C, h, w) layout, as the
    # encode's posterior draws it: the same moments and generator give the
    # same latents as the encode path
    mean, std = batch["latent_mean"], batch["latent_std"]
    flat = (mean.shape[0] * mean.shape[1],) + tuple(mean.shape[2:])
    eps = draws.randn(flat, generator, mean.device, mean.dtype)
    return ((mean.reshape(flat) + std.reshape(flat) * eps) * vae_scale).reshape(mean.shape)


def make_train_step(
    diffusion: GaussianDiffusion,
    *,
    ema_decay: float = 0.9999,
    ema_every: int = 1,
    clip_max_norm: float = 0.1,
    start_clip_iter: int = 0,
    vae_scale: float = 0.18215,
    encode_fn: Optional[Callable] = None,
    grad_accum: int = 1,
    moe_aux_weight: float = 0.0,
    shards=None,
    apply_fn: Optional[Callable] = None,
) -> Callable[[TrainState, Batch, torch.Generator], Dict[str, torch.Tensor]]:
    """Build ``train_step(state, batch, generator) -> metrics``, which updates
    ``state`` in place.

    ``batch``: ``"latents"`` (B, F, C, H, W) fp32 (already scaled), the
    latent cache's ``"latent_mean"``/``"latent_std"``, or pixels,
    ``"video"`` (B, F, 3, H, W) uint8 or fp32 in [-1, 1], which
    ``encode_fn(video, generator) -> scaled latents`` turns into latents
    (``train.build_encode_fn``); for a class-conditional model (``extras:
    2``) ``"y"`` (B,) and, for LatteIMG's still images, ``"y_image"``
    (B, I); for a text-conditioned one (``extras: 78``) ``"text_embedding"``
    (B, 77, 768), or (B, 1 + I, 768) for LatteIMG; optionally ``"t"`` (importance-sampled timesteps) with
    ``"t_weights"``, ``"noise"`` (the diffusion noise, else drawn from
    ``generator``) and ``"force_drop_ids"`` / ``"force_drop_ids_image"``
    (1 = drop the label; else drawn from ``generator``). Draw order from the
    generator: posterior sample, t, noise, the label dropout of ``y``, then
    of ``y_image``.

    ``grad_accum`` = K > 1 splits the batch into K chunks, row r into chunk
    r mod K (the JAX step's interleaving), each with its own draws, in
    chunk order; the gradients are summed over the chunks and divided by K,
    then clipped and applied once, and the loss is the mean of the chunks'.

    ``moe_aux_weight`` > 0 adds that times the MoE model's Switch loss to
    each chunk's loss (nothing is collected at 0, nor for a dense model).

    ``shards`` (a ``ShardedParams``) runs the step on this rank's rows of the
    global batch, as the module docstring says; the batch then holds those
    rows alone, and ``"t"``/``"noise"``/``"force_drop_ids"``, when given,
    too.

    ``apply_fn(x, t, train=, generator=, **conditioning)`` replaces the
    model's call (the pipelined forward).
    """
    ctx = shards.ctx if shards is not None else None
    draws = Draws(ctx.dp, ctx.dp_rank) if ctx is not None else Draws()

    def chunk_loss(model, batch: Batch, generator: torch.Generator):
        latents = _latents(batch, generator, vae_scale, encode_fn, draws)
        B = latents.shape[0]
        if "t" in batch:
            t = batch["t"].long()
        else:
            t = draws.randint(diffusion.num_timesteps, B, generator, latents.device)
        noise = batch.get("noise")
        if noise is None:
            noise = draws.randn(latents.shape, generator, latents.device, latents.dtype)
        kwargs = {}
        if getattr(model, "extras", 1) == 2:
            kwargs["y"] = batch["y"]
            if "y_image" in batch:
                kwargs["y_image"] = batch["y_image"]
        elif getattr(model, "extras", 1) == 78:
            kwargs["text_embedding"] = batch["text_embedding"]
        for key, label in (("force_drop_ids", "y"), ("force_drop_ids_image", "y_image")):
            if key in batch and label in kwargs:
                kwargs[key] = batch[key]
            elif draws.parts > 1 and label in kwargs and model.y_embedder.dropout_prob > 0:
                # the model's own draw, taken for the global batch
                u = draws.rand(kwargs[label].shape, generator, latents.device)
                kwargs[key] = (u < model.y_embedder.dropout_prob).long()
        aux_box = []

        def model_fn(x, tt, **kw):
            if moe_aux_weight <= 0.0:
                return (apply_fn or model)(x, tt, train=True, generator=generator, **kw)
            # training_losses calls the model once: its losses land here
            out, aux = (apply_fn or model)(x, tt, train=True, generator=generator, return_aux=True, **kw)
            aux_box.append(aux)
            return out

        terms = diffusion.training_losses(model_fn, latents, t, model_kwargs=kwargs, noise=noise)
        per_sample = terms["loss"]
        if "t_weights" in batch:
            # importance-sampling correction: E_p[w(t) L(t)] = E_U[L]
            per_sample = per_sample * batch["t_weights"]
        loss = per_sample.mean()
        if aux_box and aux_box[0] is not None:
            columns = aux_box[0]  # (columns, n_pairs)
            aux = columns.mean(dim=1).sum() / columns.shape[0]
            terms["moe_aux"] = aux
            loss = loss + moe_aux_weight * aux
        return loss, terms, t

    def train_step(state: TrainState, batch: Batch, generator: torch.Generator):
        model = state.model
        params = [p for p in model.parameters() if p.requires_grad]
        state.optimizer.zero_grad(set_to_none=True)
        if shards is not None:
            model.zero_grad(set_to_none=True)
        K = grad_accum
        losses, mses, vbs, auxes, ts, per_sample = [], [], [], [], [], []
        for k in range(K):
            part = batch if K == 1 else {key: v[k::K] for key, v in batch.items()}
            loss, terms, t = chunk_loss(model, part, generator)
            loss.backward()
            losses.append(loss.detach())
            mses.append(terms["mse"].detach().mean())
            if "vb" in terms:
                vbs.append(terms["vb"].detach().mean())
            if "moe_aux" in terms:
                auxes.append(terms["moe_aux"].detach())
            ts.append(t)
            per_sample.append(terms["loss"].detach())

        if shards is None:
            grads = [p.grad for p in params]
            if K > 1:
                torch._foreach_div_(grads, K)
            grad_norm = global_norm(grads)
        else:
            grad_norm = shards.grad_norm(shards.reduce_grads(K))
            grads = [leaf.grad for leaf in shards.leaves]
        ema_fn = update_ema if shards is None else shards.update_ema
        with torch.no_grad():
            if state.step >= start_clip_iter:
                torch._foreach_mul_(grads, torch.clamp(clip_max_norm / (grad_norm + 1e-6), max=1.0))
            for group in state.optimizer.param_groups:
                group["lr"] = state.schedule(state.step)
            state.optimizer.step()
            if shards is not None:
                shards.gather_params()
            if ema_every <= 1:
                ema_fn(state.ema, model, ema_decay)
            elif (state.step + 1) % ema_every == 0:
                ema_fn(state.ema, model, ema_decay**ema_every)
        state.step += 1

        t = torch.cat(ts)
        metrics = {
            "loss": torch.stack(losses).mean(),
            "mse": torch.stack(mses).mean(),
            "grad_norm": grad_norm.detach(),
            "t_mean": t.float().mean(),
        }
        if vbs:
            metrics["vb"] = torch.stack(vbs).mean()
        if auxes:
            metrics["moe_aux"] = torch.stack(auxes).mean()
        if ctx is not None:
            # the global batch's means: each rank's over its equal share of rows
            keys = [k for k in ("loss", "mse", "t_mean", "vb", "moe_aux") if k in metrics]
            means = torch.stack([metrics[k].float() for k in keys])
            torch.distributed.all_reduce(means)
            for k, v in zip(keys, (means / ctx.world).unbind()):
                metrics[k] = v
        if "t" in batch:
            # per-sample feedback for the loss-aware resampler (unweighted)
            metrics["t_sampled"] = t
            metrics["per_sample_loss"] = torch.cat(per_sample)
        return metrics

    return train_step
