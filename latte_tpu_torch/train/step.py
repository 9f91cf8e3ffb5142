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

A step is a host prologue and a device body (:class:`TrainStep`): the
prologue draws every random number of the step from the generator, before
any arithmetic, and writes the step's scalars (the learning rate, Adam's
count and bias corrections, the clip switch) into device tensors; the body
reads only tensors. On one process the trainer replays the body as a CUDA
graph (:class:`GraphedTrainStep`, the counterpart of the JAX trainer's
``jax.jit(train_step, donate_argnums=(0,))``); the eager step runs the same
prologue and body, so the two give the same numbers to the bit. Over
several ranks, and under pipeline parallelism, the step stays eager: its
collectives (NCCL) are not captured in a graph.

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

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from latte_tpu_torch.core.diffusion import GaussianDiffusion
from latte_tpu_torch.core.step_graph import StepGraph
from latte_tpu_torch.train.state import TrainState, update_ema

__all__ = ["GraphedTrainStep", "StepInputs", "TrainStep", "dequantize_video", "global_norm", "make_train_step"]

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




def _posterior_noise(batch: Batch, generator: torch.Generator, encode_fn: Optional[Callable] = None,
                     draws: Draws = Draws()) -> Optional[torch.Tensor]:
    """The noise of a batch's posterior sample (None for latents): of the
    encode's posterior for pixels, or for the latent cache's moments on the
    frame-flattened (B·F, C, h, w) layout, as the encode's posterior draws
    it, so that the same moments and generator give the same latents as the
    encode path."""
    if "video" in batch:
        if encode_fn is None:
            raise ValueError("the batch holds pixels (\"video\") but the step has no encode_fn")
        video = batch["video"]
        shape, dtype = encode_fn.posterior_spec(tuple(video.shape))
        return draws.randn(shape, generator, video.device, dtype)
    if "latent_mean" in batch:
        mean = batch["latent_mean"]
        flat = (mean.shape[0] * mean.shape[1],) + tuple(mean.shape[2:])
        return draws.randn(flat, generator, mean.device, mean.dtype)
    return None


def _latents_from(batch: Batch, eps: Optional[torch.Tensor], vae_scale: float,
                  encode_fn: Optional[Callable] = None) -> torch.Tensor:
    """The step's latents from the batch and its posterior noise ``eps``:
    pixels through the frozen VAE's encode, a fresh posterior sample of the
    latent cache's moments each step, or the batch's latents."""
    if "video" in batch:
        return encode_fn(dequantize_video(batch["video"]), None, noise=eps)
    if "latent_mean" not in batch:
        return batch["latents"]
    mean, std = batch["latent_mean"], batch["latent_std"]
    return ((mean.reshape(eps.shape) + std.reshape(eps.shape) * eps) * vae_scale).reshape(mean.shape)


def _latents(batch: Batch, generator: torch.Generator, vae_scale: float, encode_fn: Optional[Callable] = None,
             draws: Draws = Draws()) -> torch.Tensor:
    """A batch's latents, its posterior sample drawn from ``generator``."""
    return _latents_from(batch, _posterior_noise(batch, generator, encode_fn, draws), vae_scale, encode_fn)


@dataclasses.dataclass
class StepInputs:
    """What a step's host prologue hands its device body: the batch (on the
    device), each accumulation chunk's draws (``"eps"``: the posterior
    sample's noise of a pixel or latent-cache batch, ``"t"``, ``"noise"``,
    ``"force_drop_ids"``/``"force_drop_ids_image"``: the label dropout, 1 =
    drop; each present when the batch does not give it) and whether the
    EMA runs after this step's update (the host's ``ema_every`` cadence)."""

    batch: Batch
    draws: List[Dict[str, torch.Tensor]]
    ema: bool = True

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor, in an order fixed by the keys."""
        return [self.batch[k] for k in sorted(self.batch)] + [d[k] for d in self.draws for k in sorted(d)]


class TrainStep:
    """``train_step(state, batch, generator) -> metrics`` (see
    :func:`make_train_step`), in two parts: :meth:`prologue` on the host
    draws every random number of the step from ``generator`` and writes the
    step's scalars (the learning rate, Adam's count and bias corrections,
    the clip switch) on the device, then counts the step; :meth:`body` reads
    only tensors: the forward, the backward of every chunk, the norm, the
    clip, AdamW and, at ``ema_every`` 1, the EMA. At ``ema_every`` K > 1 the
    EMA at ``decay**K`` is :meth:`ema_update`, run after the body on the
    steps the prologue marks (the JAX step's ``lax.cond``). A call is the
    three in that order, the eager step; :class:`GraphedTrainStep` replays
    the body (and the EMA) as CUDA graphs."""

    def __init__(self, diffusion: GaussianDiffusion, *, ema_decay: float, ema_every: int, clip_max_norm: float,
                 start_clip_iter: int, vae_scale: float, encode_fn: Optional[Callable], grad_accum: int,
                 moe_aux_weight: float, shards, apply_fn: Optional[Callable]):
        self.diffusion, self.ema_decay, self.ema_every = diffusion, ema_decay, ema_every
        self.clip_max_norm, self.start_clip_iter, self.vae_scale = clip_max_norm, start_clip_iter, vae_scale
        self.encode_fn, self.grad_accum, self.moe_aux_weight = encode_fn, grad_accum, moe_aux_weight
        self.shards, self.apply_fn = shards, apply_fn
        self.ctx = shards.ctx if shards is not None else None
        self.draws = Draws(self.ctx.dp, self.ctx.dp_rank) if self.ctx is not None else Draws()
        self._clip_on: Optional[torch.Tensor] = None  # device bool: step >= start_clip_iter

    def _chunks(self, batch: Batch) -> List[Batch]:
        K = self.grad_accum
        return [batch] if K == 1 else [{key: v[k::K] for key, v in batch.items()} for k in range(K)]

    # -- the host's part ----------------------------------------------------

    def _draw(self, model, part: Batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One chunk's draws, in the order of the step's arithmetic: the
        posterior sample, t, the noise, the label dropout of ``y``, then of
        ``y_image``."""
        drawn, draws = {}, self.draws
        eps = _posterior_noise(part, generator, self.encode_fn, draws)
        if eps is not None:
            drawn["eps"] = eps
        if "video" in part:
            lat_shape = tuple(part["video"].shape[:2]) + tuple(eps.shape[1:])
            lat_dtype, device = eps.dtype, eps.device
        else:
            lat = part["latent_mean"] if "latent_mean" in part else part["latents"]
            lat_shape, lat_dtype, device = tuple(lat.shape), lat.dtype, lat.device
        if "t" not in part:
            drawn["t"] = draws.randint(self.diffusion.num_timesteps, lat_shape[0], generator, device)
        if "noise" not in part:
            drawn["noise"] = draws.randn(lat_shape, generator, device, lat_dtype)
        if getattr(model, "extras", 1) == 2 and model.y_embedder.dropout_prob > 0:
            for key, label in (("force_drop_ids", "y"), ("force_drop_ids_image", "y_image")):
                if label in part and key not in part:
                    # the label embedder's own draw (one uniform a label)
                    u = draws.rand(part[label].shape, generator, device)
                    drawn[key] = (u < model.y_embedder.dropout_prob).long()
        return drawn

    def prologue(self, state: TrainState, batch: Batch, generator: torch.Generator) -> StepInputs:
        """The host's part of a step: each chunk's draws from ``generator``
        in chunk order, the step's scalars written on the device
        (``schedule(step)`` into the optimizer's learning rate, then
        :meth:`~latte_tpu_torch.train.state.AdamW.prepare`; the clip switch
        ``step >= start_clip_iter``), the EMA's cadence, and
        ``state.step += 1``."""
        draws = [self._draw(state.model, part, generator) for part in self._chunks(batch)]
        device = next(iter(batch.values())).device
        if self._clip_on is None or self._clip_on.device != device:
            self._clip_on = torch.zeros((), dtype=torch.bool, device=device)
        self._clip_on.fill_(state.step >= self.start_clip_iter)
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.prepare()
        ema = self.ema_every <= 1 or (state.step + 1) % self.ema_every == 0
        state.step += 1
        return StepInputs(batch, draws, ema)

    # -- the device's part --------------------------------------------------

    def _chunk_loss(self, model, batch: Batch, drawn: Dict[str, torch.Tensor]):
        latents = _latents_from(batch, drawn.get("eps"), self.vae_scale, self.encode_fn)
        t = batch["t"].long() if "t" in batch else drawn["t"]
        noise = batch["noise"] if "noise" in batch else drawn["noise"]
        kwargs = {}
        if getattr(model, "extras", 1) == 2:
            kwargs["y"] = batch["y"]
            if "y_image" in batch:
                kwargs["y_image"] = batch["y_image"]
        elif getattr(model, "extras", 1) == 78:
            kwargs["text_embedding"] = batch["text_embedding"]
        for key, label in (("force_drop_ids", "y"), ("force_drop_ids_image", "y_image")):
            if label in kwargs and (key in batch or key in drawn):
                kwargs[key] = batch[key] if key in batch else drawn[key]
        aux_box = []
        forward = self.apply_fn or model

        def model_fn(x, tt, **kw):
            if self.moe_aux_weight <= 0.0:
                return forward(x, tt, train=True, **kw)
            # training_losses calls the model once: its losses land here
            out, aux = forward(x, tt, train=True, return_aux=True, **kw)
            aux_box.append(aux)
            return out

        terms = self.diffusion.training_losses(model_fn, latents, t, model_kwargs=kwargs, noise=noise)
        per_sample = terms["loss"]
        if "t_weights" in batch:
            # importance-sampling correction: E_p[w(t) L(t)] = E_U[L]
            per_sample = per_sample * batch["t_weights"]
        loss = per_sample.mean()
        if aux_box and aux_box[0] is not None:
            columns = aux_box[0]  # (columns, n_pairs)
            aux = columns.mean(dim=1).sum() / columns.shape[0]
            terms["moe_aux"] = aux
            loss = loss + self.moe_aux_weight * aux
        return loss, terms, t

    def body(self, state: TrainState, inputs: StepInputs) -> Dict[str, torch.Tensor]:
        """The device's part of a step, after :meth:`prologue`: reads only
        tensors (the batch, the draws, the model's parameters, gradients and
        moments, the scalars the prologue wrote) and draws nothing. The
        gradients stay allocated across steps (zeroed in place)."""
        model, shards = state.model, self.shards
        params = [p for p in model.parameters() if p.requires_grad]
        if shards is None:
            state.optimizer.zero_grad(set_to_none=False)
        else:
            state.optimizer.zero_grad(set_to_none=True)
            model.zero_grad(set_to_none=True)
        K = self.grad_accum
        losses, mses, vbs, auxes, ts, per_sample = [], [], [], [], [], []
        for part, drawn in zip(self._chunks(inputs.batch), inputs.draws):
            loss, terms, t = self._chunk_loss(model, part, drawn)
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
        with torch.no_grad():
            # the clip from start_clip_iter on: JAX's where on the scale (1
            # leaves the gradients as they are, to the bit)
            scale = torch.clamp(self.clip_max_norm / (grad_norm + 1e-6), max=1.0)
            torch._foreach_mul_(grads, torch.where(self._clip_on, scale, torch.ones_like(scale)))
            state.optimizer.apply()
            if shards is not None:
                shards.gather_params()
            if self.ema_every <= 1:
                self._ema_fn()(state.ema, model, self.ema_decay)

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
        if self.ctx is not None:
            # the global batch's means: each rank's over its equal share of rows
            keys = [k for k in ("loss", "mse", "t_mean", "vb", "moe_aux") if k in metrics]
            means = torch.stack([metrics[k].float() for k in keys])
            torch.distributed.all_reduce(means)
            for k, v in zip(keys, (means / self.ctx.world).unbind()):
                metrics[k] = v
        if "t" in inputs.batch:
            # per-sample feedback for the loss-aware resampler (unweighted)
            metrics["t_sampled"] = t
            metrics["per_sample_loss"] = torch.cat(per_sample)
        return metrics

    def _ema_fn(self):
        return update_ema if self.shards is None else self.shards.update_ema

    def ema_update(self, state: TrainState) -> None:
        """The EMA of an ``ema_every`` K > 1 step, at ``decay**K``."""
        with torch.no_grad():
            self._ema_fn()(state.ema, state.model, self.ema_decay ** self.ema_every)

    def __call__(self, state: TrainState, batch: Batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        inputs = self.prologue(state, batch, generator)
        metrics = self.body(state, inputs)
        if self.ema_every > 1 and inputs.ema:
            self.ema_update(state)
        return metrics


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
) -> TrainStep:
    """Build ``train_step(state, batch, generator) -> metrics`` (a
    :class:`TrainStep`), which updates ``state`` in place.

    ``batch``: ``"latents"`` (B, F, C, H, W) fp32 (already scaled), the
    latent cache's ``"latent_mean"``/``"latent_std"``, or pixels,
    ``"video"`` (B, F, 3, H, W) uint8 or fp32 in [-1, 1], which
    ``encode_fn(video, generator, noise=) -> scaled latents`` turns into
    latents (``train.build_encode_fn``; ``encode_fn.posterior_spec(shape)``
    gives its posterior noise's shape and type); for a class-conditional
    model (``extras: 2``) ``"y"`` (B,) and, for LatteIMG's still images,
    ``"y_image"`` (B, I); for a text-conditioned one (``extras: 78``)
    ``"text_embedding"`` (B, 77, 768), or (B, 1 + I, 768) for LatteIMG;
    optionally ``"t"`` (importance-sampled timesteps) with ``"t_weights"``,
    ``"noise"`` (the diffusion noise, else drawn from ``generator``) and
    ``"force_drop_ids"`` / ``"force_drop_ids_image"`` (1 = drop the label;
    else drawn from ``generator``). Draw order from the generator, all
    before the forward: posterior sample, t, noise, the label dropout of
    ``y``, then of ``y_image``.

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

    ``apply_fn(x, t, train=, **conditioning)`` replaces the model's call
    (the pipelined forward).
    """
    return TrainStep(diffusion, ema_decay=ema_decay, ema_every=ema_every, clip_max_norm=clip_max_norm,
                     start_clip_iter=start_clip_iter, vae_scale=vae_scale, encode_fn=encode_fn,
                     grad_accum=grad_accum, moe_aux_weight=moe_aux_weight, shards=shards, apply_fn=apply_fn)


def _put(buf: torch.Tensor, value: torch.Tensor) -> None:
    if value is not buf:
        buf.copy_(value)


class GraphedTrainStep:
    """A one-process :class:`TrainStep` as CUDA graphs, the counterpart of
    ``jax.jit(train_step, donate_argnums=(0,))``: called as the step,
    ``(state, batch, generator) -> metrics``.

    Each call runs the step's host prologue (its draws and scalars), copies
    the batch and the draws into the static buffers (those of the first
    call), and runs :meth:`TrainStep.body` as a
    :class:`~latte_tpu_torch.core.step_graph.StepGraph`: the first call
    eagerly on a side stream (the step itself, and the warm-up), then the
    capture; every later call replays it. The state is updated in place: the
    graph reads and writes the model's own parameters, gradients, moments
    and EMA, which stay where they are (JAX's donation). At ``ema_every`` K
    > 1 the EMA is a second graph, replayed after the step's on the steps of
    the cadence. The returned metrics are the graph's static outputs: a
    later call overwrites them, so read them first (the first call's are the
    eager warm-up's own).

    A new capture (with its warm-up) is taken when an input's shape or type
    changes, or when a tensor the graph reads in place moves (a parameter,
    gradient, moment or EMA leaf: a restored optimizer state, a
    ``zero_grad(set_to_none=True)``). On the card a step that cannot be
    captured raises :class:`~latte_tpu_torch.core.step_graph.CaptureError`;
    on the CPU every call runs the body (the runner's plain version)."""

    def __init__(self, step: TrainStep):
        if step.shards is not None:
            raise ValueError("the graphed train step runs on one process: a sharded step stays eager")
        self.step = step
        self.graphs: Dict[str, StepGraph] = {}
        self.inputs: Optional[StepInputs] = None
        self.metrics: Optional[Dict[str, torch.Tensor]] = None
        self._state: Optional[TrainState] = None
        self._shapes = self._ptrs = None
        self._outs: list = []

    @property
    def launches(self) -> Dict[str, Dict[str, int]]:
        """One replay's hand-written kernel launches, by program ("step",
        and "ema" at ``ema_every`` > 1)."""
        return {name: dict(g.launches) for name, g in self.graphs.items()}

    @staticmethod
    def _addresses(state: TrainState) -> tuple:
        model = [p.data_ptr() for p in state.model.parameters()]
        grads = [-1 if p.grad is None else p.grad.data_ptr() for p in state.model.parameters()]
        moments = [v.data_ptr() for st in state.optimizer.state.values() for v in st.values()
                   if isinstance(v, torch.Tensor) and v.device.type != "cpu"]
        return (tuple(model), tuple(grads), tuple(moments), tuple(p.data_ptr() for p in state.ema.parameters()))

    def _body(self) -> None:
        self._outs.append(self.step.body(self._state, self.inputs))

    def _ema(self) -> None:
        self.step.ema_update(self._state)

    def _run(self, name: str, fn) -> None:
        graph = self.graphs.get(name)
        if graph is None:
            device = next(iter(self.inputs.batch.values())).device
            graph = self.graphs[name] = StepGraph(fn, device, program="the train step")
        graph()

    def __call__(self, state: TrainState, batch: Batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        inputs = self.step.prologue(state, batch, generator)
        shapes = tuple((tuple(t.shape), t.dtype, t.device) for t in inputs.tensors())
        if (state is not self._state or shapes != self._shapes or self.inputs is None
                or self._addresses(state) != self._ptrs):
            self.release()
            self._state, self._shapes, self.inputs = state, shapes, inputs
        else:
            for buf, value in zip(self.inputs.tensors(), inputs.tensors()):
                _put(buf, value)
        self._outs = []
        self._run("step", self._body)
        if self._outs:  # the eager warm-up and the capture, or on the CPU the body's call
            result = self._outs[0]
            self.metrics = self._outs[-1]
        else:
            result = self.metrics
        self._outs = []
        if self.step.ema_every > 1 and inputs.ema:
            self._run("ema", self._ema)
        self._ptrs = self._addresses(state)
        return result

    def release(self) -> None:
        """Drop the graphs, their memory and the static buffers."""
        for graph in self.graphs.values():
            graph.release()
        self.graphs, self.inputs, self.metrics, self._state, self._shapes, self._ptrs = {}, None, None, None, None, None
